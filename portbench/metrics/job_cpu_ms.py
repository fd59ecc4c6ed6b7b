"""job_cpu_ms: median process CPU ms (user + system, every thread) per
job, which the program counts over each syncasm call
(syncasm_cpu of its own SyncasmResult.timings): against the job's wall
it tells a stalled host from more work."""
from portbench.core.stages import median_ms

KEYS = ('syncasm_cpu',)


def read(ctx):
    return median_ms(ctx, KEYS)
