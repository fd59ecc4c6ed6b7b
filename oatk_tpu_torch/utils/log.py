"""Logging in the reference's ``[M::func]`` framing for diffability.

Mirrors the stderr conventions of the reference CLIs
(reference misc.c:129-154 prints Real time / CPU time / Peak RSS;
message framing ``[M::fn]`` / ``[W::fn]`` / ``[E::fn]`` used throughout).
"""
from __future__ import annotations

import inspect
import resource
import sys
import time
from contextlib import contextmanager

realtime0 = time.time()
VERBOSE = 0


def _caller_name(depth: int = 2) -> str:
    frame = inspect.stack()[depth]
    return frame.function


def log_info(msg: str, func: str | None = None) -> None:
    print(f"[M::{func or _caller_name()}] {msg}", file=sys.stderr, flush=True)


def log_warn(msg: str, func: str | None = None) -> None:
    print(f"[W::{func or _caller_name()}] {msg}", file=sys.stderr, flush=True)


def log_error(msg: str, func: str | None = None) -> None:
    print(f"[E::{func or _caller_name()}] {msg}", file=sys.stderr, flush=True)


def cputime() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def peakrss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0 / 1024.0


@contextmanager
def timed_stage(name: str):
    t0, c0 = time.time(), cputime()
    yield
    log_info(
        f"Real time: {time.time() - t0:.3f} sec; CPU: {cputime() - c0:.3f} sec",
        func=name,
    )


VERSION = "1.0"


class _StageTimer:
    """Accumulates named sub-stage durations; prints one
    ``[T::tag] a=..ms b=..ms`` stderr line on :meth:`done`."""

    __slots__ = ("tag", "marks", "last")

    def __init__(self, tag: str):
        self.tag = tag
        self.marks: list[tuple[str, float]] = []
        self.last = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.marks.append((name, now - self.last))
        self.last = now

    def done(self) -> None:
        import sys as _sys

        print(
            f"[T::{self.tag}] "
            + " ".join(f"{k}={v*1e3:.1f}ms" for k, v in self.marks),
            file=_sys.stderr,
            flush=True,
        )


def stage_timer(tag: str) -> _StageTimer | None:
    """OATK_TPU_TIMEIT sub-stage timer, or None when timing is off
    (call sites guard with ``if _t:``)."""
    import os as _os

    return _StageTimer(tag) if _os.environ.get("OATK_TPU_TIMEIT") else None


def print_exit_stats(func: str = "main", with_cmd: bool = True) -> None:
    """Version/CMD/time footer as printed by every reference binary
    (reference run_syncasm.c:442-449, misc.c:129-154)."""
    import sys as _sys

    if with_cmd:
        log_info(f"Version: {VERSION}", func=func)
        log_info("CMD: " + " ".join([_sys.argv[0]] + _sys.argv[1:]), func=func)
    log_info(
        f"Real time: {time.time() - realtime0:.3f} sec; "
        f"CPU: {cputime():.3f} sec; "
        f"Peak RSS: {peakrss_gb():.3f} GB",
        func=func,
    )
