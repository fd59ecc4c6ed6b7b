"""The port's stage recorder (oatk_tpu_torch/utils/trace.py) on the CPU:
the recorder's own rules, then whole syncasm calls on a 1.2 Mbp set:
every stage key present, the top-level keys covering the call's wall,
children nesting inside their parents, the spans on a torch.profiler
session's clock and no profiler range entered without one, no first-use
key on a second call, and the outputs and -v stderr unchanged by a
profiler."""
import re
import threading

import numpy as np
import pytest
import torch

from genome_sim import random_genome, sample_reads, write_reads
from oatk_tpu_torch.utils import trace

K, S, C = 151, 13, 3

STAGES = ("load", "collect_db", "stat", "ec_graph0", "ec_consensus0", "ec", "stat2",
          "make_graph", "unitig", "utg_gfa", "unzip_align", "multiplex", "demux",
          "unzip_align2", "unzip_cov", "unzip_consensus", "final_align", "final_cov",
          "final_gfa", "clean", "graph_stat")
LOAD = ("setup", "read_bytes", "cuts", "submit", "parse_wait", "extract", "finalize_dispatch",
        "assemble_total", "nsel_drain", "flats")
SUBSTAGES = ("make_graph.vtx", "make_graph.pairs", "make_graph.arcs", "make_graph.index",
             "make_graph.finalize", "make_graph.finalize.cleanup", "make_graph.finalize.sort",
             "make_graph.finalize.index", "make_graph.finalize.fix_symm",
             "make_graph.finalize.resort", "make_graph.finalize.shrink",
             "utg_gfa.flats", "utg_gfa.va_flat", "utg_gfa.emit_batch", "utg_gfa.lens_covs",
             "utg_gfa.emit_gfa", "utg_gfa.arc_batch", "utg_gfa.arcs")


# --- the recorder ---------------------------------------------------------------

def test_spans_nest_accumulate_and_fill_each_recording():
    with trace.record("job") as outer:
        with trace.span("a"):
            with trace.span("b"):
                pass
            with trace.record() as inner:
                with trace.span("c"):
                    trace.add("w", 0.5)
                trace.add("w", 0.25)
        with trace.span("a"):
            pass
    assert set(outer) == {"a", "a.b", "a.c", "a.c_workers.w", "a_workers.w", "job", "job_cpu"}
    assert set(inner) == {"c", "c_workers.w", "w"}
    assert inner["c"] == outer["a.c"] and inner["w"] == outer["a_workers.w"] == 0.25
    assert outer["a.b"] + outer["a.c"] <= outer["a"] <= outer["job"]
    assert outer["job_cpu"] >= 0.0


def test_no_recording_records_nothing_and_threads_keep_their_own():
    with trace.span("x"):  # nothing open: no error, nowhere to record
        trace.add("w", 1.0)
    seen = {}

    def worker():
        with trace.span("on_worker"):
            pass
        seen["path"] = list(trace._stack.path)

    with trace.record("job") as tm:
        with trace.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    assert "on_worker" not in str(list(tm)) and seen["path"] == []
    assert trace._stack.path == [] and trace._stack.sinks == []


def test_a_raising_block_still_closes_its_span():
    with trace.record() as tm:
        with pytest.raises(ValueError):
            with trace.span("bad"):
                raise ValueError
        with trace.span("next"):
            pass
    assert set(tm) == {"bad", "next"} and trace._stack.path == []


def test_timeit_lines_put_each_parent_before_its_children():
    tm = {"a.x": 1e-3, "a_workers.w": 2e-3, "a": 3e-3, "b.y.z": 1e-3, "b.y": 2e-3, "b": 4e-3,
          "job": 8e-3, "job_cpu": 9e-3}
    assert trace.timeit_lines(tm, "job") == [
        "[T::job] a=3.0ms b=4.0ms job=8.0ms job_cpu=9.0ms",
        "[T::a] x=1.0ms",
        "[T::a_workers] w=2.0ms",
        "[T::b] y=2.0ms",
        "[T::b.y] z=1.0ms",
    ]


# --- whole syncasm calls --------------------------------------------------------

@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    """a(20 kbp) + rep(1.5 kbp) + b(16 kbp) + rep at 30x of 4 kbp reads
    (about 1.2 Mbp)."""
    rng = np.random.default_rng(7)
    a = random_genome(rng, 20_000)
    rep = random_genome(rng, 1_500)
    b = random_genome(rng, 16_000)
    reads = sample_reads(rng, a + rep + b + rep, coverage=30, read_len=4000,
                         err_rate=0.002, hp_frac=0.85)
    path = tmp_path_factory.mktemp("trace") / "reads.fa"
    write_reads(str(path), reads)
    return str(path)


def _run(fa, out, monkeypatch, verbose=0):
    from oatk_tpu_torch.asm import pipeline
    from oatk_tpu_torch.asm import reads as TR

    monkeypatch.setattr(TR, "_SEG_BYTES", 1 << 18)  # several parse segments
    return pipeline.syncasm([fa], k=K, s=S, min_k_cov=C, do_ec=True, do_unzip=3,
                            out=out, device="cpu", verbose=verbose)


@pytest.fixture(scope="module")
def two_calls(reads_fa, tmp_path_factory):
    """The timings of two calls in a row, the first with the native
    library to load again."""
    from oatk_tpu_torch import native

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(native, "_lib", None)
        out = str(tmp_path_factory.mktemp("two") / "o")
        return [_run(reads_fa, out, mp).timings for _ in range(2)]
    finally:
        mp.undo()


def test_every_stage_key_is_recorded(two_calls):
    tm = two_calls[1]
    want = set(STAGES) | {f"load.{k}" for k in LOAD} | set(SUBSTAGES) | {
        "syncasm", "syncasm_cpu", "load.extract.append", "load_workers.parse_work",
        "load_workers.pack_work"}
    assert want <= set(tm), sorted(want - set(tm))
    assert tm["syncasm_cpu"] > 0


def test_top_level_keys_cover_the_call(two_calls):
    tm = two_calls[1]
    top = sum(v for k, v in tm.items() if "." not in k and k not in ("syncasm", "syncasm_cpu"))
    assert top <= tm["syncasm"]
    assert tm["syncasm"] - top <= max(0.02 * tm["syncasm"], 0.020), (top, tm["syncasm"])


def test_children_fit_inside_their_parents(two_calls):
    for tm in two_calls:
        for k, v in tm.items():
            parent = k.rpartition(".")[0]
            if parent in tm:
                assert v <= tm[parent], k
        main = sum(v for k, v in tm.items() if k.startswith("load.") and k.count(".") == 1)
        assert main <= tm["load"]


def test_first_use_is_named_once_and_only_the_first_time(two_calls):
    first, second = two_calls
    assert "load.once.native" in first and first["load.once"] >= first["load.once.native"]
    assert not [k for k in second if "once" in k.split(".")]


def test_loader_timings_keep_their_names(reads_fa, tmp_path, monkeypatch):
    """A direct call, with no recording around it, fills load_timings."""
    from oatk_tpu_torch.asm import reads as TR

    monkeypatch.setattr(TR, "_SEG_BYTES", 1 << 18)
    db = TR.load_and_extract([reads_fa], K, S, device="cpu")
    assert set(LOAD) | {"append", "parse_work", "pack_work"} <= set(db.load_timings)
    assert sum(db.load_timings[k] for k in LOAD) > 0


def test_no_profiler_range_without_a_profiler(reads_fa, tmp_path, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        entered.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _run(reads_fa, str(tmp_path / "o"), monkeypatch)
    assert entered == []


def test_profiler_sees_the_spans_nested(reads_fa, tmp_path, monkeypatch):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _run(reads_fa, str(tmp_path / "o"), monkeypatch)
    keys = set(res.timings) - {"syncasm_cpu"}
    keys = {k for k in keys if "_workers." not in k}
    evs = [e for e in prof.events() if e.name in keys]
    assert {e.name for e in evs} == keys
    by_name = {}
    for e in evs:
        by_name.setdefault(e.name, []).append(e)
    for e in evs:
        parent = e.name.rpartition(".")[0] or ("syncasm" if e.name != "syncasm" else None)
        if parent is None:
            continue
        assert any(p.thread == e.thread and p.time_range.start <= e.time_range.start
                   and e.time_range.end <= p.time_range.end for p in by_name[parent]), e.name


def _untimed(err: str) -> str:
    """-v stderr without its clock readings (EC prints its real and CPU
    time), as tests/test_stderr_parity.py compares it."""
    return "\n".join(ln for ln in err.splitlines() if not re.search(r"real time|CPU time", ln))


def test_a_profiler_changes_no_output(reads_fa, tmp_path, monkeypatch, capsys):
    capsys.readouterr()
    _run(reads_fa, str(tmp_path / "plain"), monkeypatch, verbose=1)
    err_plain = capsys.readouterr().err
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _run(reads_fa, str(tmp_path / "prof"), monkeypatch, verbose=1)
    err_prof = capsys.readouterr().err
    assert "[M::" in err_plain and "[T::" not in err_plain
    assert _untimed(err_plain) == _untimed(err_prof)
    for suf in (".utg.gfa", ".utg.final.gfa"):
        with open(str(tmp_path / "plain") + suf, "rb") as f:
            a = f.read()
        with open(str(tmp_path / "prof") + suf, "rb") as f:
            b = f.read()
        assert a.count(b"\nS\t") >= 1 and a == b, suf


@pytest.mark.cuda
def test_cuda_upload_spans_and_context_touch(reads_fa, tmp_path, monkeypatch):
    """On the card the upload ring's waits and copies are children of
    load.extract, and the device's first use is named once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from oatk_tpu_torch.asm import pipeline
    from oatk_tpu_torch.asm import reads as TR

    monkeypatch.setattr(TR, "_SEG_BYTES", 1 << 18)
    monkeypatch.setattr(TR, "_cuda_used", set())
    runs = [pipeline.syncasm([reads_fa], k=K, s=S, min_k_cov=C, out=str(tmp_path / "o"),
                             device="cuda") for _ in range(2)]
    first, second = (r.timings for r in runs)
    assert "load.once.cuda" in first
    assert {"load.extract.upload_wait", "load.extract.upload_stage",
            "load.extract.upload_copy", "load.extract.append"} <= set(second)
    assert not [k for k in second if "once" in k.split(".")]
    lt = runs[1].read_db.load_timings
    assert {"upload_wait", "upload_stage", "upload_copy", "extract"} <= set(lt)
