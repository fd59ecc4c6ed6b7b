"""The device-EC cell's readers and K2's roofline functions: ec_trip_ms
from the program's ``ec.wf.trip``, k2_roofline_pct from the rounds'
counted work over the traced device time, each None where a run has
nothing to read; ``wf_roofline`` on a hand-counted item; and the cell
as ``BENCHMARK.json`` lists it.

Run from the checkout's root: ``python -m pytest portbench/tests -q``."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.core import cells, roofline, wf_roofline  # noqa: E402
from portbench.core.trace import Reading  # noqa: E402

CELL = "athal-syncasm-wfdev.q27-110M"
WORK = ("seq_bytes", "wave_in", "wave_out", "wave_cells")


def _split(**kw) -> dict:
    sp = dict(rounds=2, items=[3, 1], layout_s=0.01, pack_s=0.002, trip_s=0.004, unpack_s=0.003,
              seq_bytes=4000, wave_in=10, wave_out=30, wave_cells=500.0)
    sp.update(kw)
    return sp


def _ctx(recs, kernel_s=None, n_jobs=None) -> dict:
    trace = None if kernel_s is None else Reading(1.0, 0.1, kernel_s=kernel_s)
    return {"recs": recs, "n_jobs": n_jobs or len(recs), "trace": trace}


def test_ec_trip_ms_reads_the_programs_key():
    read = cells.metric_reader("ec_trip_ms")
    jobs = [{"ec": 0.2, "ec.wf": 0.1, "ec.wf.trip": x, "syncasm": 0.7} for x in (0.03, 0.01, 0.02)]
    assert read(_ctx([(t, _split()) for t in jobs])) == pytest.approx(20.0)
    # the parent commit records ec alone; the default route runs no rounds
    assert read(_ctx([({"ec": 0.2, "syncasm": 0.7}, _split())] * 3)) is None
    assert read(_ctx([(None, None)] * 2)) is None


def test_k2_roofline_pct_from_counted_work_and_device_time():
    read = cells.metric_reader("k2_roofline_pct")
    sp = _split()
    least, _ = wf_roofline.least_seconds_of(sp)
    # 2 jobs, 0.5 ms of wf_ed_kernel in all: 0.25 ms a job
    ctx = _ctx([({}, sp), ({}, sp)], {"void wf_ed_kernel<256>(int const*)": 5e-4, "other": 1.0})
    assert read(ctx) == pytest.approx(100.0 * least / 2.5e-4)
    assert 0 < read(ctx) <= 100
    assert read(_ctx([({}, sp)] * 2)) is None  # no trace
    assert read(_ctx([({}, sp)] * 2, {"other": 1.0})) is None  # the kernel did not run
    assert read(_ctx([({}, None)] * 2, {"wf_ed_kernel": 1e-3})) is None  # no rounds
    assert read(_ctx([({}, _split(rounds=0, items=[]))] * 2, {"wf_ed_kernel": 1e-3})) is None
    # the parent commit's split has no counters of the kernel's work
    old = {k: v for k, v in sp.items() if k not in WORK}
    assert read(_ctx([({}, old)] * 2, {"wf_ed_kernel": 1e-3})) is None


def test_wf_roofline_on_a_hand_counted_item():
    """One item: tl 1,000, ql 1,200, a wave of 1 diagonal in and 21 out
    after 10 steps: 2,200 bases, 88 B of waves, 64 B of meta = 2,352 B;
    10 x 22 / 2 = 110 cells, 440 operations."""
    assert wf_roofline.k2_bytes(2200, 1, 21, 1) == 2352
    assert wf_roofline.k2_ops32(110) == 440
    p = roofline.peaks()["H100"]
    s, what = wf_roofline.least_seconds(2200, 1, 21, 1, 110)
    assert what == "bytes" and s == pytest.approx(2352 / p["hbm_bytes_per_s"])
    # many cells on few bytes: operations bound it
    s, what = wf_roofline.least_seconds(10, 1, 1, 1, 1e9)
    assert what == "operations" and s == pytest.approx(4e9 / p["int32_ops_per_s"])
    sp = _split(seq_bytes=2200, wave_in=1, wave_out=21, items=[1], wave_cells=110.0)
    assert wf_roofline.least_seconds_of(sp) == wf_roofline.least_seconds(2200, 1, 21, 1, 110)


def test_the_device_ec_cell_in_benchmark_json():
    """The cell reports exactly the four metrics of its route, each listing
    it alone, and takes nothing from the accepted cell."""
    c = cells.find(CELL)
    assert c.config_name == "athal-syncasm-wfdev" and c.traffic_name == "q27-110M"
    assert c.chips == 1 and c.config["env"] == {"OATK_TPU_WF_BACKEND": "device"}
    assert [m["name"] for m in c.end_to_end] == ["mbp_per_s", "setup_s"]
    assert sorted(m["name"] for m in c.per_layer) == sorted(
        ["ec_driver_ms", "k2_device_ms", "ec_trip_ms", "k2_roofline_pct"])
    assert all(m["workloads"] == [CELL] and m["moves"] == "mbp_per_s" for m in c.per_layer)
    assert all(callable(cells.metric_reader(m["name"])) for m in c.per_layer)
    b = cells.benchmark()
    assert all(len(e["why"]) <= 200 for e in b["configs"] + b["workloads"])
    wgs = cells.find("athal-syncasm.wgs-1G")
    assert not {m["name"] for m in c.per_layer} & {m["name"] for m in wgs.per_layer}
