"""Error correction through the port's ``device`` wavefront backend
(OATK_TPU_WF_BACKEND=device), on the CPU, where the lockstep rounds run
the kernel's plain PyTorch version (ragged contract): reads spliced
exactly as the JAX package's EC through its Pallas backend (interpret
mode) splices them, and a full syncasm whose GFAs are byte-identical to
the JAX package's default run.  With the native library there the DFS
runs in C (``csrc/ec_lockstep.c``), else in Python; every branch
extension of either is one item of one round, and the lockstep gives
the sequential loop's reads and stats at any number of reads in flight.
Tolerance: exact."""
import numpy as np
import pytest

from genome_sim import random_genome, sample_reads, write_reads

import oatk_tpu_torch.kernels.wavefront as TW
from oatk_tpu_torch.asm import ec as TEC
from oatk_tpu_torch.kernels import wf_ed as WE


@pytest.fixture
def count_plain(monkeypatch):
    """Count calls of the ragged plain version (what a launch is on a
    card) and the items they ran."""
    seen = {"launches": 0, "items": 0}
    real = WE.wf_ed_core_ragged_plain

    def counted(inp, out, B):
        seen["launches"] += 1
        seen["items"] += B
        return real(inp, out, B)

    monkeypatch.setattr(WE, "wf_ed_core_ragged_plain", counted)
    return seen


def test_ec_splices_as_jax_pallas(tmp_path, monkeypatch, count_plain):
    """9 kbp genome at 10x of 1.6 kbp reads, k=151/s=13 (the setup of
    test_ec_through_pallas_backend): the port's Python EC on the device
    backend against oatk_tpu's on its pallas backend."""
    import oatk_tpu.kernels.wavefront as W
    import oatk_tpu.kernels.wavefront_pallas as WP
    from oatk_tpu.asm import ec as JEC
    from oatk_tpu.asm.consensus import scg_consensus as j_consensus
    from oatk_tpu.asm.pipeline import load_reads as j_load
    from oatk_tpu.asm.scg import make_syncmer_graph as j_graph
    from oatk_tpu.index.syncmer_db import collect_syncmer_db as j_collect
    from oatk_tpu_torch.asm.consensus import scg_consensus as t_consensus
    from oatk_tpu_torch.asm.pipeline import load_reads as t_load
    from oatk_tpu_torch.asm.scg import make_syncmer_graph as t_graph
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db as t_collect

    rng = np.random.default_rng(12345)
    g = random_genome(rng, 9000)
    fa = str(tmp_path / "r.fa")
    write_reads(fa, sample_reads(rng, g, coverage=10, read_len=1600, err_rate=0.003))

    j_calls = [0]
    real_pallas = WP.wf_ed_core_pallas

    def j_counted(st, interpret=True):
        j_calls[0] += 1
        return real_pallas(st, interpret=interpret)

    monkeypatch.setattr(WP, "wf_ed_core_pallas", j_counted)
    monkeypatch.setattr(W, "WF_BACKEND", "pallas")
    rd_j = j_load([fa], 151, 13, 0, True)
    scg = j_graph(rd_j, j_collect(rd_j), 0, 0.0)
    j_consensus(rd_j, scg, hoco_seq=True, save_seq=True, fo=None)
    JEC.read_error_correction(rd_j, scg, 0.02, 2, 20, 2, 0.35, 0)

    monkeypatch.setattr(TW, "WF_BACKEND", "device")
    monkeypatch.setattr(TEC.read_error_correction, "wf_calls", 0)
    rd_t = t_load([fa], 151, 13, 0, "cpu")
    scg = t_graph(rd_t, t_collect(rd_t), 0, 0.0)
    t_consensus(rd_t, scg, hoco_seq=True, save_seq=True, fo=None)
    TEC.read_error_correction(rd_t, scg, 0.02, 2, 20, 2, 0.35, 0, device="cpu")

    assert len(rd_j.reads) == len(rd_t.reads) > 0
    for r1, r2 in zip(rd_j.reads, rd_t.reads):
        assert np.array_equal(r1.k_mer, r2.k_mer)
        assert np.array_equal(r1.m_pos, r2.m_pos)
    calls = TEC.read_error_correction.wf_calls
    assert calls > 0 and count_plain["items"] == calls == j_calls[0]
    assert count_plain["launches"] <= calls


@pytest.fixture(scope="module")
def reads_1p2mbp(tmp_path_factory):
    """a(20 kbp) + rep(1.5 kbp) + b(16 kbp) + rep at 30x of 4 kbp reads
    (about 1.2 Mbp; the set of test_torch_syncasm.py)."""
    rng = np.random.default_rng(7)
    a = random_genome(rng, 20_000)
    rep = random_genome(rng, 1_500)
    b = random_genome(rng, 16_000)
    reads = sample_reads(rng, a + rep + b + rep, coverage=30, read_len=4000,
                         err_rate=0.002, hp_frac=0.85)
    path = tmp_path_factory.mktemp("ecdev") / "reads.fa"
    write_reads(str(path), reads)
    return str(path)


def test_syncasm_device_backend_gfa_byte_identical(reads_1p2mbp, tmp_path, monkeypatch, count_plain):
    """Full syncasm, k=151/s=13/c=3, EC on, 3 unzip rounds: the port on
    the CPU with OATK_TPU_WF_BACKEND=device against oatk_tpu's default
    run (native batch EC)."""
    import oatk_tpu.asm.pipeline as J
    import oatk_tpu_torch.asm.pipeline as T

    oj, ot = str(tmp_path / "jax"), str(tmp_path / "torch")
    rj = J.syncasm([reads_1p2mbp], k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=3, out=oj)
    monkeypatch.setattr(TW, "WF_BACKEND", "device")
    monkeypatch.setattr(TEC.read_error_correction, "wf_calls", 0)
    rt = T.syncasm([reads_1p2mbp], k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=3,
                   out=ot, device="cpu")
    assert rj.scg is not None and rt.scg is not None
    for suf in (".utg.gfa", ".utg.final.gfa"):
        with open(oj + suf, "rb") as f:
            a = f.read()
        with open(ot + suf, "rb") as f:
            b = f.read()
        assert a.count(b"\nS\t") >= 1
        assert a == b, suf
    # every branch extension of the DFS was an item of a round (the
    # count is a property of the data: 1,159 calls on this set)
    calls = TEC.read_error_correction.wf_calls
    assert count_plain["items"] == calls == 1159
    assert count_plain["launches"] <= calls


def test_default_backend_makes_no_wavefront_calls(reads_1p2mbp, tmp_path, monkeypatch, count_plain):
    """The default backend keeps the native batch corrector: no Python
    DFS call, no plain-version call, and the same GFA bytes."""
    import oatk_tpu_torch.asm.pipeline as T

    monkeypatch.setattr(TW, "WF_BACKEND", "auto")
    monkeypatch.setattr(TEC.read_error_correction, "wf_calls", 0)
    T.syncasm([reads_1p2mbp], k=151, s=13, min_k_cov=3, do_ec=True, do_unzip=0,
              out=str(tmp_path / "auto"), device="cpu")
    assert TEC.read_error_correction.wf_calls == 0 and count_plain["launches"] == 0


EC_ARGS = (0.02, 3, 30, 3, 0.35, 0)  # syncasm's EC at c=3


def _corrected(mod_ec, fa, load, stage, during_ec=(), **kw):
    """EC of ``mod_ec`` on the 1.2 Mbp set after syncasm's pre-EC steps
    (``load``/``stage`` build the reads and the graph): each read's
    (k_mer, m_pos) and the stats vector, caught from ``_correct_read``
    or from the port's C lockstep driver.  ``during_ec``: (object, name,
    value) settings that hold only while EC runs."""
    rd, scg = stage(load(fa))
    caught = []
    real = mod_ec._correct_read

    def catch(r, scg_, max_edist, stats, *rest):
        caught.append(stats)
        return real(r, scg_, max_edist, stats, *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod_ec, "_correct_read", catch)
        real_native = getattr(mod_ec, "_correct_reads_lockstep_native", None)
        if real_native is not None:
            def catch_native(rd_, scg_, max_edist, stats, *rest, **kw_):
                caught.append(stats)
                return real_native(rd_, scg_, max_edist, stats, *rest, **kw_)

            mp.setattr(mod_ec, "_correct_reads_lockstep_native", catch_native)
        for obj, name, value in during_ec:
            mp.setattr(obj, name, value)
        mod_ec.read_error_correction(rd, scg, *EC_ARGS, **kw)
    return [(r.k_mer.copy(), r.m_pos.copy()) for r in rd.reads], caught[0].copy()


def _stage(mods):
    graph, collect, consensus = mods

    def run(rd):
        scg = graph(rd, collect(rd), 0, 0.0)
        consensus(rd, scg, hoco_seq=True, save_seq=True, fo=None)
        return rd, scg
    return run


def _port_ec(fa, route="native", device="cpu"):
    """The port's EC on ``device``; ``route="python"`` hides the native
    library while EC runs, so the device backend takes the Python DFS."""
    import oatk_tpu_torch.native as native
    from oatk_tpu_torch.asm.consensus import scg_consensus
    from oatk_tpu_torch.asm.pipeline import load_reads
    from oatk_tpu_torch.asm.scg import make_syncmer_graph
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db

    during = [(native, "available", lambda: False)] if route == "python" else []
    return _corrected(TEC, fa, lambda f: load_reads([f], 151, 13, 0, "cpu"),
                      _stage((make_syncmer_graph, collect_syncmer_db, scg_consensus)),
                      during_ec=during, device=device)


@pytest.fixture(scope="module")
def ec_references(reads_1p2mbp):
    """The JAX package's EC on its Pallas backend (interpret mode) and
    the port's sequential loop (the native C core per request), both
    with the calls they made."""
    import oatk_tpu.kernels.wavefront as W
    import oatk_tpu.kernels.wavefront_pallas as WP
    from oatk_tpu.asm import ec as JEC
    from oatk_tpu.asm.consensus import scg_consensus
    from oatk_tpu.asm.pipeline import load_reads
    from oatk_tpu.asm.scg import make_syncmer_graph
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    real_pallas = WP.wf_ed_core_pallas
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(WP, "wf_ed_core_pallas", lambda st, interpret=True: real_pallas(st, interpret=True))
        mp.setattr(W, "WF_BACKEND", "pallas")
        jax_ref = _corrected(JEC, reads_1p2mbp, lambda f: load_reads([f], 151, 13, 0, True),
                             _stage((make_syncmer_graph, collect_syncmer_db, scg_consensus)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TW, "WF_BACKEND", "auto")
        mp.setattr(TEC, "_correct_reads_native", lambda *a: False)
        mp.setattr(TEC.read_error_correction, "wf_calls", 0)
        seq = _port_ec(reads_1p2mbp)
        seq_calls = TEC.read_error_correction.wf_calls
    return jax_ref, seq, seq_calls


@pytest.mark.parametrize("inflight,route", [
    pytest.param(1, "native", id="1"), pytest.param(7, "native", id="7"),
    pytest.param(None, "native", id="all"), pytest.param(1, "python", id="1-python"),
    pytest.param(7, "python", id="7-python"), pytest.param(None, "python", id="all-python"),
])
def test_lockstep_matches_sequential(reads_1p2mbp, ec_references, monkeypatch, count_plain, inflight,
                                     route):
    """The lockstep scheduler at EC_INFLIGHT 1, 7 and every read, with the
    DFS in C (``native``, the route when the native library is there) and
    in Python: each read's k_mer/m_pos and the stats vector equal the
    port's sequential loop's and the JAX package's Pallas-backend EC's,
    with one round per call at 1 and 16 rounds (the longest chain of
    calls of one read) with every read in flight."""
    (j_reads, j_stats), (s_reads, s_stats), seq_calls = ec_references
    monkeypatch.setattr(TW, "WF_BACKEND", "device")
    monkeypatch.setattr(TEC, "EC_INFLIGHT", inflight)
    monkeypatch.setattr(TEC.read_error_correction, "wf_calls", 0)
    monkeypatch.setattr(WE.wf_ed_core_rounds, "rounds", 0)
    reads, stats = _port_ec(reads_1p2mbp, route)
    calls, rounds = TEC.read_error_correction.wf_calls, WE.wf_ed_core_rounds.rounds

    assert len(reads) == len(s_reads) == len(j_reads) > 0
    for (k, m), (ks, ms), (kj, mj) in zip(reads, s_reads, j_reads):
        assert np.array_equal(k, ks) and np.array_equal(m, ms)
        assert np.array_equal(k, kj) and np.array_equal(m, mj)
    assert np.array_equal(stats, s_stats) and np.array_equal(stats, j_stats)
    assert stats[2] + stats[7] > 0  # blocks were corrected
    assert calls == seq_calls == count_plain["items"] == 1159
    assert rounds == count_plain["launches"]
    assert rounds == {1: calls, None: 16}.get(inflight, rounds)
    assert 16 <= rounds <= calls
