"""extract_roofline_pct: the extraction chain's least time for one job's
reads (portbench/core/roofline.py: its bytes over HBM bandwidth or its
operations over the 32-bit integer rate, whichever is larger) over its
device time per job, in %."""
from portbench.core import roofline
from portbench.core.stages import device_ms_per_job

CHAIN = ("blob_decode_kernel", "blob_n_scatter_kernel", "syncmer_select_kernel",
         "sel_tiles_kernel")


def read(ctx):
    ms = device_ms_per_job(ctx, CHAIN)
    if ms is None:
        return None
    n = ctx["nums"]
    least, _ = roofline.least_seconds(n["ref_hoco"], n["ref_n"], n["ref_syncmers"], ctx["k"])
    return 100.0 * least / (ms / 1000.0)
