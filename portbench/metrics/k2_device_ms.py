"""k2_device_ms: device ms per job of EC's wavefront kernel K2
(wf_ed_kernel), from the traced window; nothing where it did not run."""
from portbench.core.stages import device_ms_per_job


def read(ctx):
    return device_ms_per_job(ctx, ("wf_ed_kernel",))
