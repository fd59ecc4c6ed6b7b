"""align_ms: median host ms per job of alignment
(asm/align.py): unzip_align + unzip_align2 + final_align, from the
program's own SyncasmResult.timings."""
from portbench.core.stages import median_ms

KEYS = ('unzip_align', 'unzip_align2', 'final_align')


def read(ctx):
    return median_ms(ctx, KEYS)
