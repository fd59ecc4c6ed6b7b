"""The readers of the program's recorder spans (``portbench/metrics/``):
each one's value from a window's ``SyncasmResult.timings``, None where a
program records no such key, and every one listed for the cell.

Run from the checkout's root: ``python -m pytest portbench/tests -q``."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.core import cells  # noqa: E402

# reader -> the timings keys it sums per job
READERS = {
    "load_parse_wait_ms": ("load.parse_wait",),
    "load_parse_work_ms": ("load_workers.parse_work", "load_workers.pack_work"),
    "load_queue_ms": ("load.extract",),
    "load_assemble_ms": ("load.assemble_total",),
    "stat_ms": ("stat", "stat2"),
    "clean_ms": ("clean", "graph_stat"),
    "job_cpu_ms": ("syncasm_cpu",),
}


def _ctx(timings: list) -> dict:
    return {"recs": [(t, None) for t in timings], "n_jobs": len(timings), "trace": None}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_of_the_recorder(name):
    read = cells.metric_reader(name)
    keys = READERS[name]
    # three jobs: the keys at 0.1 s, 0.3 s and 0.2 s each, beside keys it must not read
    jobs = [dict({k: x for k in keys}, load=9.0, syncasm=9.0, other=5.0) for x in (0.1, 0.3, 0.2)]
    assert read(_ctx(jobs)) == pytest.approx(200.0 * len(keys))
    # the parent commit's timings hold none of the keys
    parent = [{"load": 1.4, "collect_db": 0.2, "ec": 0.2}] * 3
    assert read(_ctx(parent)) is None
    assert read(_ctx([None, None])) is None
    assert name in {m["name"] for m in cells.find("athal-syncasm.wgs-1G").per_layer}
