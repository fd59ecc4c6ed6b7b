"""load_parse_work_ms: median ms per job of the loader's parse workers'
busy time, parse and 2-bit pack summed over the workers (asm/reads.py,
native/fastx_hoco.c): the worker keys load_workers.parse_work and
load_workers.pack_work of the program's own SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('load_workers.parse_work', 'load_workers.pack_work')


def read(ctx):
    return median_ms(ctx, KEYS)
