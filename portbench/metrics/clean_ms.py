"""clean_ms: median host ms per job of the graph's cleanup loops with
their unitigging and the graph statistics (graph/clean.py, asm/scg.py):
the spans clean and graph_stat of the program's own
SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('clean', 'graph_stat')


def read(ctx):
    return median_ms(ctx, KEYS)
