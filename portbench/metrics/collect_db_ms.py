"""collect_db_ms: median host ms per job of the count
(index/devcount.py): collect_db, from the
program's own SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('collect_db',)


def read(ctx):
    return median_ms(ctx, KEYS)
