"""k2_roofline_pct: the wavefront kernel's least time for one job's
rounds (portbench/core/wf_roofline.py, from the work that the rounds'
split counts) over its device time per job (k2_device_ms), in %.
Nothing without a trace, without rounds or without the split's
counters of the kernel's work."""
from portbench.core import wf_roofline
from portbench.core.stages import device_ms_per_job

KERNEL = ("wf_ed_kernel",)


def read(ctx):
    ms = device_ms_per_job(ctx, KERNEL)
    splits = [sp for _, sp in ctx["recs"] if sp and sp.get("rounds") and "wave_cells" in sp]
    if ms is None or not splits:
        return None
    least = sum(wf_roofline.least_seconds_of(sp)[0] for sp in splits) / len(splits)
    return 100.0 * least / (ms / 1000.0)
