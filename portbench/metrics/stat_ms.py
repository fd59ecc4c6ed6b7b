"""stat_ms: median host ms per job of the read statistics
(index/histogram.py:read_db_stat), its passes before and after error
correction: the spans stat and stat2 of the program's own
SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('stat', 'stat2')


def read(ctx):
    return median_ms(ctx, KEYS)
