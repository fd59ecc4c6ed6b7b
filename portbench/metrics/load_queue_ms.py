"""load_queue_ms: median host ms per job of the loader's main thread
queueing the card's work (asm/reads.py: staging copies, slot waits,
the extraction chain's launches): the span load.extract of the
program's own SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('load.extract',)


def read(ctx):
    return median_ms(ctx, KEYS)
