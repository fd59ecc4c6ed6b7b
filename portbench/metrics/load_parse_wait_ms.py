"""load_parse_wait_ms: median host ms per job that the loader's main
thread spends blocked on its parse workers (asm/reads.py), the span
load.parse_wait of the program's own SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('load.parse_wait',)


def read(ctx):
    return median_ms(ctx, KEYS)
