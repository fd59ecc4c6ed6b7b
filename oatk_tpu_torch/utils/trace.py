"""The port's one stage recorder: named spans of host wall time.

``with span("load"):`` times a block with ``time.perf_counter``.  Spans
nest through a per-thread stack, and a child's key is
``<parent>.<name>``; entering a name again adds to the same key.  A
span's seconds go to every recording open on its thread
(:func:`record`), keyed by its path from where that recording was
opened, so a stage's callee and the stage's caller each read the keys
they expect.  On a thread with no recording open a span records
nothing.

:func:`add` books busy seconds summed on worker threads under
``<span>_workers.<name>``, a key that no span's children take in.
:func:`book` books seconds that the caller timed itself (summed over a
loop that a span per pass would slow) as the child ``<span>.<name>``.

While a ``torch.profiler`` session runs, each span also enters
``torch.profiler.record_function`` under its key from the outermost
recording, so the stages sit on the profiler's clock beside the device's
events.  With no profiler running a span reads the clock twice and
updates a dict per open recording.

:func:`once` names first-use work of the process (a library built and
loaded, a device's context): ``<stage>.once.<what>``.  A job that
records a ``once`` key built or loaded something.

:func:`timeit_lines` renders a recording for ``OATK_TPU_TIMEIT``: the
top-level keys on one ``[T::<tag>] key=ms ...`` line, then each parent's
children on a ``[T::<parent>]`` line."""
from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager

from .log import cputime

_WORKERS = "_workers"


class _Stack(threading.local):
    def __init__(self):
        self.path: list[str] = []  # names of the open spans, outermost first
        self.sinks: list[tuple[dict, int]] = []  # (recording, len(path) at its start)


_stack = _Stack()


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


class span:
    """Time the block under ``name`` in every open recording."""

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _stack
        st.path.append(self.name)
        self.rf = None
        if _profiling():
            import torch

            base = st.sinks[0][1] if st.sinks else 0
            self.rf = torch.profiler.record_function(".".join(st.path[base:]))
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        st = _stack
        if self.rf is not None:
            self.rf.__exit__(*exc)
        for sink, base in st.sinks:
            key = ".".join(st.path[base:])
            sink[key] = sink.get(key, 0.0) + dt
        st.path.pop()
        return False


@contextmanager
def once(what: str):
    """A span for first-use work: ``once.<what>`` under the open span."""
    with span("once"), span(what):
        yield


def add(name: str, seconds: float) -> None:
    """Book ``seconds`` of worker-thread busy time as
    ``<open span>_workers.<name>`` (just ``name`` where the recording
    itself is the innermost level)."""
    st = _stack
    for sink, base in st.sinks:
        own = ".".join(st.path[base:])
        key = f"{own}{_WORKERS}.{name}" if own else name
        sink[key] = sink.get(key, 0.0) + seconds


def book(name: str, seconds: float) -> None:
    """Book ``seconds`` as the child ``name`` of the open span, as a span
    of that name inside it would have."""
    st = _stack
    for sink, base in st.sinks:
        key = ".".join(st.path[base:] + [name])
        sink[key] = sink.get(key, 0.0) + seconds


class record:
    """Open a recording: the spans below it on this thread fill the dict
    that ``with`` yields, keyed by their path from here.  With a ``name``
    the recording is itself a span of that name (in the recordings around
    it) and keeps its own wall seconds under ``name`` and the process's
    CPU seconds (user + system, every thread) under ``name_cpu``."""

    __slots__ = ("name", "sink", "sp", "t0", "c0")

    def __init__(self, name: str | None = None):
        self.name = name

    def __enter__(self) -> dict:
        self.sink = {}
        self.sp = span(self.name).__enter__() if self.name else None
        _stack.sinks.append((self.sink, len(_stack.path)))
        self.c0 = cputime() if self.name else 0.0
        self.t0 = time.perf_counter()
        return self.sink

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        _stack.sinks.pop()
        if self.sp is not None:
            self.sink[self.name] = dt
            self.sink[self.name + "_cpu"] = cputime() - self.c0
            self.sp.__exit__(*exc)
        return False


def timeit_lines(timings: dict, tag: str) -> list[str]:
    """``[T::<tag>]`` with the top-level keys, then ``[T::<parent>]`` per
    parent with its children, in ms: stage by stage, each parent before
    its children."""
    order = {k: i for i, k in enumerate(timings)}
    groups: dict[str, list[str]] = {}
    for k, v in timings.items():
        parent, _, leaf = k.rpartition(".")
        groups.setdefault(parent, []).append(f"{leaf}={v * 1000:.1f}ms")
    lines = [f"[T::{tag}] " + " ".join(groups.pop("", []))]

    def rank(p):
        top = p.split(".", 1)[0].removesuffix(_WORKERS)
        return order.get(top, -1), p.count("."), p

    lines += [f"[T::{p}] " + " ".join(groups[p]) for p in sorted(groups, key=rank)]
    return lines
