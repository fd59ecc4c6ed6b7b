"""Per-job readings from the program's own ``SyncasmResult.timings``
(host seconds per stage) and EC's device driver split, as medians over
the window's jobs."""
from __future__ import annotations

import statistics


def median_ms(ctx, keys) -> float | None:
    """Median over the window's jobs of the summed ``timings`` of
    ``keys``, in ms; None when no job has any of them."""
    vals = []
    for timings, _ in ctx["recs"]:
        got = [timings[k] for k in keys if k in (timings or {})]
        if got:
            vals.append(1000.0 * sum(got))
    return statistics.median(vals) if vals else None


def driver_ms(ctx) -> float | None:
    """Median host ms of EC's device driver (layout + pack + unpack of
    ``wf_ed_lockstep.last``) per job; None where EC ran no lockstep."""
    vals = [1000.0 * (sp["layout_s"] + sp["pack_s"] + sp["unpack_s"])
            for _, sp in ctx["recs"] if sp]
    return statistics.median(vals) if vals else None


def device_ms_per_job(ctx, names) -> float | None:
    """Device ms per job of the ops whose name holds one of ``names``,
    from the traced window; None without a trace or without such ops."""
    r = ctx.get("trace")
    if r is None:
        return None
    tot = sum(v for k, v in r.kernel_s.items() if any(n in k for n in names))
    return 1000.0 * tot / ctx["n_jobs"] if tot > 0 else None
