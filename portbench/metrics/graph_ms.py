"""graph_ms: median host ms per job of the graph (graph/,
asm/scg.py): ec_graph0 + make_graph + unitig, from the
program's own SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('ec_graph0', 'make_graph', 'unitig')


def read(ctx):
    return median_ms(ctx, KEYS)
