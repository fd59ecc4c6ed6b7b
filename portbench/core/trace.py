"""The traced window: a torch.profiler trace of host and device, reduced
to the device's busy time, each kernel's time, and the device's idle
gaps by the host span they fell in.

Spans are the stage wrappers of :mod:`.program` and a ``job`` span
around each whole job; idle time in no stage span is ``outside_spans``
(the pipeline's own code between stages, and the loop between jobs)."""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


def profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


@dataclass
class Reading:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)  # device op name -> seconds
    idle_by_span: dict = field(default_factory=dict)  # span name -> idle seconds


def _union(iv: list) -> list:
    iv.sort()
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(events, w0_ns: int, w1_ns: int, stage_names: set) -> Reading:
    """``events``: (name, is_device, start_ns, end_ns) of the trace;
    ``[w0_ns, w1_ns]`` the window on the trace's clock."""
    dev_iv, spans = [], []
    kernel = defaultdict(float)
    for name, is_dev, s, e in events:
        if e <= w0_ns or s >= w1_ns:
            continue
        s, e = max(s, w0_ns), min(e, w1_ns)
        if is_dev:
            dev_iv.append([s, e])
            kernel[name] += (e - s) * 1e-9
        elif name in stage_names:
            spans.append((s, e, name))
    busy = _union(dev_iv)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    # idle gaps between busy intervals, split over the stage spans they meet
    gaps, t = [], w0_ns
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1_ns:
        gaps.append((t, w1_ns))
    spans.sort()
    # stage spans do not nest inside one another; keep the outermost
    flat, end = [], -1
    for s, e, n in spans:
        if s >= end:
            flat.append((s, e, n))
            end = e
    idle = defaultdict(float)
    j = 0
    for gs, ge in gaps:
        covered = 0
        while j < len(flat) and flat[j][1] <= gs:
            j += 1
        k = j
        while k < len(flat) and flat[k][0] < ge:
            s, e, n = flat[k]
            ov = min(e, ge) - max(s, gs)
            if ov > 0:
                idle[n] += ov * 1e-9
                covered += ov
            k += 1
        idle["outside_spans"] += (ge - gs - covered) * 1e-9
    return Reading((w1_ns - w0_ns) * 1e-9, busy_s, dict(kernel), dict(idle))


def events_of(prof, span_names: set):
    """(name, is_device, start_ns, end_ns) of every event of a finished
    profile.  The device's copies of host spans (user annotations on the
    GPU timeline) are no device work and are left out."""
    from torch.autograd import DeviceType

    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        on_dev = ev.device_type() == DeviceType.CUDA
        if on_dev and (ev.is_user_annotation() or ev.name() in span_names):
            continue
        yield ev.name(), on_dev, s, s + ev.duration_ns()


def top(d: dict, n: int = 10) -> list:
    return [[k[:96], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
