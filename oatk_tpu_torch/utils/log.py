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


VERSION = "1.0"


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
