"""Fused loader of oatk_tpu_torch (asm/reads.py:load_and_extract, device
"cpu") against the JAX package's loader with Pallas extraction and
device counting (impl="pallas", device_count=True -- what
OATK_TPU_IMPL=pallas OATK_TPU_COUNT=device selects): every per-read
array and the SyncmerDB after collect_syncmer_db must be equal."""
import gzip

import numpy as np
import pytest

from genome_sim import random_genome, sample_reads

W, S = 51, 11


def _write_fa(path, reads, prefix="r"):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">{prefix}{i} extra comment\n{r}\n")


@pytest.fixture
def reads():
    rng = np.random.default_rng(20260817)
    g = random_genome(rng, 6000)
    rd = sample_reads(rng, g, coverage=6, read_len=900, err_rate=0.01)
    # N-bearing reads: single Ns and a short N run
    for i, ps in ((0, (50, 51)), (3, (400,)), (7, tuple(range(200, 206)))):
        r = list(rd[i])
        for p in ps:
            r[p] = "N"
        rd[i] = "".join(r)
    return rd


def _jax_db(paths):
    from oatk_tpu.asm.reads import load_and_extract
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    db = load_and_extract(paths, W, S, impl="pallas", device_count=True)
    assert db is not None
    return db, collect_syncmer_db(db)


def _torch_db(paths):
    from oatk_tpu_torch.asm.reads import load_and_extract
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db

    db = load_and_extract(paths, W, S, device="cpu")
    assert db is not None and db._devcount is not None
    return db, collect_syncmer_db(db)


def _assert_same(j, t):
    (db1, scm1), (db2, scm2) = j, t
    for f in ("h", "s", "cov", "mp_flat", "mp_off"):
        assert np.array_equal(getattr(scm1, f), getattr(scm2, f)), f
    assert db1.n == db2.n > 0
    for a, b in zip(db1.reads, db2.reads):
        assert a.sid == b.sid and a.name == b.name and a.hoco_l == b.hoco_l
        for f in ("hoco_code", "ho_rl", "is_n", "m_pos", "s_mer", "k_mer"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, (a.sid, f)
            assert np.array_equal(x, y), (a.sid, f)
    for f in ("hoco_off", "rl_ovf_pos", "rl_ovf_len"):
        assert np.array_equal(getattr(db1, f), getattr(db2, f)), f
    # the whole-run flats leave unwritten gaps between segments: compare
    # every read's window (the addressing contract), not the gaps
    for i, r in enumerate(db2.reads):
        o0 = int(db2.hoco_off[i])
        for f in ("hoco_flat", "rl_flat"):
            w1 = getattr(db1, f)[o0 : o0 + r.hoco_l]
            assert np.array_equal(w1, getattr(db2, f)[o0 : o0 + r.hoco_l]), (i, f)
    dp1, dp2 = db1._dev_pairs, db2._dev_pairs
    assert dp1[0] == dp2[0]
    assert np.array_equal(dp1[1], dp2[1]) and np.array_equal(dp1[2], dp2[2])


@pytest.fixture
def both_segs(monkeypatch):
    """Shrink the segment size of BOTH loaders (multi-segment split)."""
    from oatk_tpu.asm import reads as JR
    from oatk_tpu_torch.asm import reads as TR

    def set_(n):
        monkeypatch.setattr(JR, "_SEG_BYTES", n)
        monkeypatch.setattr(TR, "_SEG_BYTES", n)

    return set_


def test_multi_segment_with_ns(tmp_path, reads, both_segs):
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    both_segs(4096)
    t = _torch_db([str(fa)])
    assert any(r.is_n.any() for r in t[0].reads)
    _assert_same(_jax_db([str(fa)]), t)


def test_multi_file_fastq_gz(tmp_path, reads, both_segs):
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads[:20]):
            f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")
    fgz = tmp_path / "r2.fa.gz"
    with gzip.open(fgz, "wt") as f:
        for i, r in enumerate(reads[20:40]):
            f.write(f">g{i}\n{r}\n")
    fa = tmp_path / "r3.fa"
    _write_fa(str(fa), reads[40:], prefix="h")
    paths = [str(fq), str(fgz), str(fa)]
    both_segs(2048)
    t = _torch_db(paths)
    assert [r.sid for r in t[0].reads] == list(range(len(reads)))
    _assert_same(_jax_db(paths), t)


def test_single_segment(tmp_path, reads):
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    _assert_same(_jax_db([str(fa)]), _torch_db([str(fa)]))


def test_overflow_regrow(tmp_path, monkeypatch):
    """A clamped first capacity forces the regrow loop; the result must
    still equal the JAX loader's."""
    from oatk_tpu_torch.asm import reads as TR

    rng = np.random.default_rng(7)
    g = random_genome(rng, 3000)
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), sample_reads(rng, g, coverage=3, read_len=600))
    ref = _jax_db([str(fa)])
    real = TR._round_up
    clamped = []

    def tiny(x, m):
        if m == 1024 and x > 512 and not clamped:
            clamped.append(x)
            return 64
        return real(x, m)

    monkeypatch.setattr(TR, "_round_up", tiny)
    t = _torch_db([str(fa)])
    monkeypatch.undo()
    assert clamped, "overflow path not exercised"
    _assert_same(ref, t)


def test_mixed_format_is_rejected(tmp_path, reads, both_segs):
    """A FASTA file with embedded FASTQ records: the optimistic split is
    discarded (its device lanes invalidated), the unsplit native parse
    rejects the buffer, and the port refuses instead of falling back."""
    from oatk_tpu_torch.asm import pipeline as TP
    from oatk_tpu_torch.asm.reads import load_and_extract

    mixed = tmp_path / "m.fa"
    with open(mixed, "w") as f:
        for i, r in enumerate(reads[:15]):
            f.write(f">r{i}\n{r}\n")
        for i, r in enumerate(reads[15:30]):
            f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")
    both_segs(2048)
    assert load_and_extract([str(mixed)], W, S, device="cpu") is None
    with pytest.raises(NotImplementedError):
        TP.load_reads([str(mixed)], W, S, device="cpu")


def test_unported_options_refuse(tmp_path, reads, monkeypatch):
    from oatk_tpu_torch.asm.reads import load_and_extract

    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads[:5])
    with pytest.raises(NotImplementedError):
        load_and_extract([str(fa)], W, S, max_data=1000, device="cpu")
    monkeypatch.setenv("OATK_TPU_DEVICE_HOCO", "1")
    with pytest.raises(NotImplementedError):
        load_and_extract([str(fa)], W, S, device="cpu")
