"""ec_ms: median host ms per job of error correction
(asm/ec.py): the ec stage, from the
program's own SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('ec',)


def read(ctx):
    return median_ms(ctx, KEYS)
