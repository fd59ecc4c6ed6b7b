"""load_ms: median host ms per job of the loader (asm/reads.py,
native/fastx_hoco.c): the load stage, from the
program's own SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('load',)


def read(ctx):
    return median_ms(ctx, KEYS)
