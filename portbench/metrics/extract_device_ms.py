"""extract_device_ms: device ms per job of the extraction chain's kernels
(K3d blob_decode_kernel and blob_n_scatter_kernel, K1
syncmer_select_kernel, K4 sel_tiles_kernel), from the traced window."""
from portbench.core.stages import device_ms_per_job

CHAIN = ("blob_decode_kernel", "blob_n_scatter_kernel", "syncmer_select_kernel",
         "sel_tiles_kernel")


def read(ctx):
    return device_ms_per_job(ctx, CHAIN)
