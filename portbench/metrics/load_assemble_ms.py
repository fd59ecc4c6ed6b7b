"""load_assemble_ms: median host ms per job of the ReadDB's serial
assembly after the parse (asm/reads.py): the span load.assemble_total
of the program's own SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('load.assemble_total',)


def read(ctx):
    return median_ms(ctx, KEYS)
