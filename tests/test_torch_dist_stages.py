"""The port's process-sharded host stages (oatk_tpu_torch/dist/stages.py
and the branches of asm/{align,ec,scg}.py that reach it) against
oatk_tpu's, in one process: shard_ranges, merge_aln_flats and
sharded_pair_reduce array-equal to oatk_tpu.dist.stages; syncasm under
OATK_TPU_STAGE_SHARDS byte-identical (both GFAs, and the -v log) to the
unsharded port and to oatk_tpu under the same setting.  Also the
mesh's refusals, --cpu with --shards, and index/linkcov.py.  Every
comparison is exact."""
import numpy as np
import pytest

from genome_sim import random_genome, sample_reads, write_reads

K, S, C = 151, 13, 3


@pytest.mark.parametrize("n,k", [(0, 1), (1, 2), (7, 3), (100, 8), (5, 5), (3, 8), (1001, 7)])
def test_shard_ranges(n, k):
    from oatk_tpu.dist.stages import shard_ranges as J
    from oatk_tpu_torch.dist.stages import shard_ranges as T

    assert T(n, k) == J(n, k)
    assert T(n, k)[0][0] == 0 and T(n, k)[-1][1] == n


def _flat(rng, sid0, n_reads):
    """An alignment flat for reads sid0.. with 0-3 chains each."""
    n_ch = rng.integers(0, 4, n_reads)
    n_fr = rng.integers(1, 5, int(n_ch.sum()))
    return dict(
        sids=np.arange(sid0, sid0 + n_reads, dtype=np.int64),
        frag6=rng.integers(0, 1000, (int(n_fr.sum()), 6)).astype(np.int64),
        aln_cut=np.concatenate([[0], np.cumsum(n_fr)]).astype(np.int64),
        read_aln_off=np.concatenate([[0], np.cumsum(n_ch)]).astype(np.int64),
        max_score=rng.integers(0, 50, n_reads).astype(np.int64),
    )


def test_merge_aln_flats():
    from oatk_tpu.dist.stages import merge_aln_flats as J
    from oatk_tpu_torch.dist.stages import merge_aln_flats as T

    rng = np.random.default_rng(5)
    parts = [_flat(rng, 0, 7), None, _flat(rng, 7, 0), _flat(rng, 7, 12), _flat(rng, 19, 3)]
    for ps in (parts, [], [None]):
        a, b = J(ps), T(ps)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


def _stream(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "empty":
        return np.zeros(0, np.uint64)
    if kind == "top-bit":
        # full 64-bit keys: about half have the top bit set, so a signed
        # compare would put them in the wrong range
        keys = rng.integers(0, np.iinfo(np.uint64).max, 20_000, dtype=np.uint64, endpoint=True)
        return np.concatenate([keys, keys[:3000]])
    # few distinct keys, so the stride sample's splitters are keys that
    # repeat: every copy of a splitter must land in one shard
    v0 = rng.integers(0, 40, 30_000).astype(np.uint64)
    v1 = rng.integers(0, 3, 30_000).astype(np.uint64)
    return (v0 << np.uint64(32)) | v1


@pytest.mark.parametrize("kind", ["duplicates", "top-bit", "empty"])
@pytest.mark.parametrize("n_shards", [2, 5, 8])
def test_sharded_pair_reduce(n_shards, kind):
    from oatk_tpu.dist.stages import sharded_pair_reduce as J
    from oatk_tpu_torch.dist.stages import sharded_pair_reduce as T

    packed = _stream(kind)
    pj, cj = J(packed.copy(), n_shards)
    pt, ct = T(packed.copy(), n_shards)
    assert pt.dtype == pj.dtype == np.uint64 and ct.dtype == cj.dtype
    assert np.array_equal(pt, pj) and np.array_equal(ct, cj)
    u, c = np.unique(packed, return_counts=True)
    assert np.array_equal(pt, u) and np.array_equal(ct, c)
    assert T(packed.copy(), 1) is None and T(packed.copy()) is None


@pytest.fixture(scope="module")
def stage_set(tmp_path_factory):
    """The data set of tests/test_sharded_db.py's GFA test: a(7 kbp) +
    r(2.2 kbp) + b(6 kbp) + r at 14x of 2.2 kbp reads.  (The stage set
    of tests/test_sharding.py cleans down to an empty graph at c=3, so
    no read aligns there.)"""
    rng = np.random.default_rng(23)
    a, r, b = random_genome(rng, 7000), random_genome(rng, 2200), random_genome(rng, 6000)
    fa = tmp_path_factory.mktemp("stages") / "r.fa"
    write_reads(str(fa), sample_reads(rng, a + r + b + r, coverage=14, read_len=2200,
                                      err_rate=0.002))
    return str(fa)


def _port_syncasm(fa, out, capsys, verbose=1):
    from oatk_tpu_torch.asm.pipeline import syncasm

    capsys.readouterr()
    syncasm([fa], k=K, s=S, min_k_cov=C, do_ec=True, do_unzip=3, out=out, device="cpu",
            verbose=verbose)
    return capsys.readouterr().err


def _log(err: str) -> list[str]:
    """The -v log without its clock readings."""
    return [ln for ln in err.splitlines() if " time " not in ln and "time:" not in ln]


@pytest.fixture(scope="module")
def unsharded(stage_set, tmp_path_factory):
    """The port's unsharded run: (output prefix, -v log)."""
    import contextlib
    import io
    import os

    from oatk_tpu_torch.asm.pipeline import syncasm

    assert "OATK_TPU_STAGE_SHARDS" not in os.environ
    out = str(tmp_path_factory.mktemp("plain") / "plain")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        syncasm([stage_set], k=K, s=S, min_k_cov=C, do_ec=True, do_unzip=3, out=out,
                device="cpu", verbose=1)
    return out, err.getvalue()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n", [2, 5])
def test_stage_shards_gfa(stage_set, unsharded, tmp_path, monkeypatch, capsys, n):
    """Alignment and EC split into n read blocks and merged: both GFAs
    byte-identical to the unsharded port and to oatk_tpu under the same
    setting, the -v log equal to the unsharded one (one alignment line
    per call), and both stages really partitioned."""
    import oatk_tpu.asm.pipeline as J
    from oatk_tpu_torch.asm import ec as TE
    from oatk_tpu_torch.dist import stages as TS

    monkeypatch.setenv("OATK_TPU_STAGE_SHARDS", str(n))
    aln_calls, ec_ranges = [], []
    real_aln, real_ec = TS.sharded_read_alignment, TE._correct_reads_native
    monkeypatch.setattr(TS, "sharded_read_alignment",
                        lambda *a, **k: aln_calls.append(k["n_shards"]) or real_aln(*a, **k))
    monkeypatch.setattr(TE, "_correct_reads_native",
                        lambda *a: ec_ranges.append(a[4]) or real_ec(*a))
    oj, ot = str(tmp_path / "jax"), str(tmp_path / "torch")
    J.syncasm([stage_set], k=K, s=S, min_k_cov=C, do_ec=True, do_unzip=3, out=oj)
    err = _port_syncasm(stage_set, ot, capsys)
    assert aln_calls and set(aln_calls) == {n}
    assert len(ec_ranges) == 1 and len(ec_ranges[0]) == n
    plain, plain_err = unsharded
    for suf in (".utg.gfa", ".utg.final.gfa"):
        a, b, c = _read(plain + suf), _read(ot + suf), _read(oj + suf)
        assert a.count(b"\nS\t") >= 1
        assert b == a, suf
        assert b == c, suf
    assert _log(err) == _log(plain_err)
    assert err.count("[M::scg_read_alignment]") == len(aln_calls)


def test_stage_shards_device_ec_stays_whole(stage_set, unsharded, tmp_path, monkeypatch, capsys):
    """Under OATK_TPU_WF_BACKEND=device EC runs whole, in one lockstep
    pass over every read (the C driver's, as the native library is
    there); alignment still splits; the GFAs equal the unsharded default
    run's."""
    from oatk_tpu_torch.asm import ec as TE
    from oatk_tpu_torch.kernels import wavefront as TW

    monkeypatch.setenv("OATK_TPU_STAGE_SHARDS", "2")
    monkeypatch.setattr(TW, "WF_BACKEND", "device")
    passes = []
    real = TE._correct_reads_lockstep
    monkeypatch.setattr(TE, "_correct_reads_lockstep",
                        lambda reads, *a: passes.append(len(reads)) or real(reads, *a))
    real_c = TE._correct_reads_lockstep_native
    monkeypatch.setattr(TE, "_correct_reads_lockstep_native",
                        lambda rd, *a: passes.append(len(rd.reads)) or real_c(rd, *a))
    out = str(tmp_path / "dev")
    _port_syncasm(stage_set, out, capsys, verbose=0)
    plain, _ = unsharded
    n_reads = sum(1 for ln in open(stage_set) if ln.startswith(">"))
    assert passes == [n_reads]
    for suf in (".utg.gfa", ".utg.final.gfa"):
        assert _read(out + suf) == _read(plain + suf), suf


def test_make_mesh_refuses():
    """A CUDA mesh larger than the visible cards raises, as oatk_tpu's
    make_mesh does for its devices; CPU meshes are logical shards."""
    import torch

    from oatk_tpu_torch.dist import make_mesh
    from oatk_tpu_torch.dist.sharding import Mesh

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA device"):
        make_mesh(n_cards + 2, "cuda")
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")
    m = make_mesh(5, "cpu")
    assert m.size == 5 and m.local_shards() == [0, 1, 2, 3, 4] and m.ranks is None
    assert all(d.type == "cpu" for d in m.devices)
    assert Mesh(["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2


def test_cpu_flag_ignores_shards(stage_set, unsharded, tmp_path, capsys):
    """--cpu (host oracle extraction) logs that it ignores --shards and
    writes the GFAs of the unsharded run (the oracle selects the same
    syncmers as the device path)."""
    from oatk_tpu_torch.cli.syncasm import main

    out = str(tmp_path / "b")
    assert main([stage_set, "-k", str(K), "-s", str(S), "-c", str(C), "--cpu", "--device", "cpu",
                 "--shards", "2", "-o", out]) == 0
    assert "[M::syncasm] --cpu disables the device mesh; ignoring --shards" in capsys.readouterr().err
    plain, _ = unsharded
    for suf in (".utg.gfa", ".utg.final.gfa"):
        assert _read(out + suf) == _read(plain + suf)


def test_linkcov(tmp_path):
    """index/linkcov.py against oatk_tpu's on one read set (each package
    on its own host oracle's ReadDB and SyncmerDB)."""
    from oatk_tpu.asm.reads import extract_all_syncmers as j_extract
    from oatk_tpu.index.linkcov import syncmer_link_coverage_analysis as j_link
    from oatk_tpu.index.syncmer_db import collect_syncmer_db as j_collect
    from oatk_tpu.io.fastx import read_fastx as j_read
    from oatk_tpu_torch.asm.reads import extract_all_syncmers as t_extract
    from oatk_tpu_torch.index.linkcov import syncmer_link_coverage_analysis as t_link
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db as t_collect
    from oatk_tpu_torch.io.fastx import read_fastx as t_read

    rng = np.random.default_rng(8)
    g = random_genome(rng, 2500)
    fa = tmp_path / "r.fa"
    write_reads(str(fa), sample_reads(rng, g, coverage=15, read_len=900, err_rate=0.002))
    jdb = j_extract(j_read([str(fa)]), 51, 11, use_device=False)
    tdb = t_extract(t_read([str(fa)]), 51, 11, use_device=False)
    jres = j_link(jdb, j_collect(jdb), 2, 5, 30, 0.0)
    tres = t_link(tdb, t_collect(tdb), 2, 5, 30, 0.0)
    assert tres[0] == jres[0] and tres[0] > 0
    for a, b in zip(jres[1:], tres[1:]):
        assert np.array_equal(a, b)
