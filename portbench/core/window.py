"""The measured window: whole jobs back to back.

The window opens when the first job starts and closes when the first job
that ends at or after ``seconds`` ends.  Its rate is the raw bases of
every job it completed over the time from the first job's start to the
last job's end, so the job at the edge counts whole and nothing divides
by ``seconds``.  Between two jobs the loop only reads the clock, keeps
what the job returned and hands over the next call."""
from __future__ import annotations

import time


def run(job, seconds: float, clock=time.perf_counter):
    """Call ``job()`` until the window closes.  Returns ([(start, end)],
    [what each job returned]), one entry per job."""
    spans, results = [], []
    t0 = clock()
    while True:
        s = clock()
        result = job()
        e = clock()
        spans.append((s, e))
        results.append(result)
        if e - t0 >= seconds:
            return spans, results


def rate(job_units: float, spans: list) -> float:
    """Units per second over the window: every completed job's units over
    the first start to the last end."""
    if not spans:
        raise ValueError("no job completed")
    return job_units * len(spans) / (spans[-1][1] - spans[0][0])


def seconds_of(spans: list) -> float:
    return spans[-1][1] - spans[0][0]
