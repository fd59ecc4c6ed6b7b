"""mbp_per_s: raw Mbp of reads assembled per second of the window (every
completed job over the first job's start to the last job's end)."""
from portbench.core import window


def read(ctx):
    return window.rate(ctx["job_mbp"], ctx["spans"])
