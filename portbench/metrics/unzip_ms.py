"""unzip_ms: median host ms per job of unzip (asm/unzip.py):
multiplex + demux, from the
program's own SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('multiplex', 'demux')


def read(ctx):
    return median_ms(ctx, KEYS)
