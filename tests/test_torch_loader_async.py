"""The key route of oatk_tpu_torch's pipelined loader (asm/reads.py:
load_and_extract with device counting) uploads units of whole parse
segments, appends per length bucket of a unit and reads the appends'
n_sel back once per file, as the JAX package's loader reads its chunks'
(oatk_tpu/asm/reads.py:787-895): on the CPU, against oatk_tpu with its
Pallas extraction in interpret mode, on the same seeded reads (k=51,
s=11, segments and units shrunk so that units of several segments run).

- (a) forced overflow: the extraction capacity pinned at its floor of
  1024 lanes (``_sel_divisor`` patched to a huge divisor in both
  packages) overflows several appends; after the one drain each regrows
  once (lanes invalidated, its rows packed again from the whole-file
  codes and appended at a new offset), and the SyncmerDB arrays and
  per-read views equal the JAX package's exactly, and the unpatched
  run's.  The appends that overflow are counted from the unpatched run's
  n_sel (the JAX loader regrows more: its compaction can report an
  overflow that is not one).
- (b) a mixed FASTA/FASTQ file: units of the optimistic split are
  queued, the split is discarded (lanes invalidated, the pending n_sel
  tensors never touched) and the Python reader takes over; the ReadDB
  equals the JAX package's ``load_reads``.
- (b') a FASTA file whose sequence line starts with '@': the guard
  discards the optimistic split and the verified split parses natively;
  one record per read remains.
- (c) on the key route the only use of an append's n_sel tensor is the
  one ``torch.cat`` per file, whose result is read once: one host read
  per file and none per unit (``load_counters``), the finalize's sorts
  queued once, after the last file, and none of them reading the host.
- ``cuda``-marked: the pinned upload ring on the card with more units
  than slots gives the CPU run's bytes, with and without regrows
  (skipped without a card).
"""
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from genome_sim import random_genome, sample_reads

W, S = 51, 11
HOST_READS = {"__int__", "__bool__", "__float__", "__index__", "item", "tolist", "cpu", "numpy",
              "nonzero", "to"}


def _write_fa(path, reads, prefix="r"):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">{prefix}{i} c\n{r}\n")


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(20261017)
    g = random_genome(rng, 20000)
    rd = sample_reads(rng, g, coverage=10, read_len=2000, err_rate=0.005)
    r = list(rd[2])
    r[100:104] = "NNNN"
    rd[2] = "".join(r)
    return rd


@pytest.fixture
def segs(monkeypatch):
    """Shrink the segment size of both loaders, and the port's units to
    about two segments (the reads' hoco is about half their bases)."""
    from oatk_tpu.asm import reads as JR
    from oatk_tpu_torch.asm import reads as TR

    def set_(n):
        monkeypatch.setattr(JR, "_SEG_BYTES", n)
        monkeypatch.setattr(TR, "_SEG_BYTES", n)
        monkeypatch.setattr(TR, "_UNIT_POSITIONS", n)

    return set_


class _Watch(TorchFunctionMode):
    """Logs every torch function called with a watched tensor (an n_sel
    tensor the device count handed back) among its arguments, and every
    host read of a tensor that a ``torch.cat`` of watched tensors made
    (or of a result derived from one)."""

    def __init__(self):
        super().__init__()
        self.watched, self.derived, self.log = {}, {}, []

    def add(self, t):
        self.watched[id(t)] = t

    def _hits(self, args, kwargs):
        flat = []
        for a in list(args) + list((kwargs or {}).values()):
            flat.extend(a if isinstance(a, (list, tuple)) else [a])
        ids = [id(a) for a in flat if isinstance(a, torch.Tensor)]
        return sum(i in self.watched for i in ids), any(i in self.derived for i in ids)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        n, derived = self._hits(args, kwargs)
        name = getattr(func, "__name__", str(func))
        if n:
            self.log.append((name, n))
        if derived:
            self.log.append((name, "cat"))
        if (n and name == "cat") or (derived and isinstance(out, torch.Tensor)):
            self.derived[id(out)] = out
        return out


@pytest.fixture
def watch(monkeypatch):
    """A _Watch over the n_sel tensor of every append to DevCountState
    (``_commit``, which ``append_rows`` and ``append`` share)."""
    from oatk_tpu_torch.index.devcount import DevCountState

    w = _Watch()
    real = DevCountState._commit

    def commit(self, *a):
        off, n_sel = real(self, *a)
        w.add(n_sel)
        return off, n_sel

    monkeypatch.setattr(DevCountState, "_commit", commit)
    return w


def _jax_db(paths):
    from oatk_tpu.asm.reads import load_and_extract
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    db = load_and_extract(paths, W, S, impl="pallas", device_count=True)
    assert db is not None
    return db, collect_syncmer_db(db)


def _torch_db(paths, device="cpu"):
    from oatk_tpu_torch.asm.reads import load_and_extract
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db

    db = load_and_extract(paths, W, S, device=device)
    assert db is not None and db._devcount is not None
    return db, collect_syncmer_db(db)


def _assert_same(j, t):
    """SyncmerDB arrays, per-read views (values and dtypes) and the
    device arc pairs equal."""
    (db1, scm1), (db2, scm2) = j, t
    for f in ("h", "s", "cov", "mp_flat", "mp_off"):
        assert np.array_equal(getattr(scm1, f), getattr(scm2, f)), f
    assert db1.n == db2.n > 0
    for a, b in zip(db1.reads, db2.reads):
        assert a.sid == b.sid and a.name == b.name and a.hoco_l == b.hoco_l
        for f in ("hoco_code", "ho_rl", "is_n", "m_pos", "s_mer", "k_mer"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (a.sid, f)
    dp1, dp2 = getattr(db1, "_dev_pairs", None), getattr(db2, "_dev_pairs", None)
    assert (dp1 is None) == (dp2 is None)
    if dp1 is not None:
        assert np.array_equal(dp1[1], dp2[1]) and np.array_equal(dp1[2], dp2[2])


def test_forced_overflow_regrows_after_the_drain(tmp_path, reads, segs, monkeypatch, watch):
    """(a) Several appends overflow their 1024 lanes; each regrows once
    after the one drain, and the result equals the JAX loader's (patched
    the same way) and the port's own unpatched run."""
    from oatk_tpu.asm import reads as JR
    from oatk_tpu_torch.asm import reads as TR

    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    segs(48 << 10)
    with watch:
        plain = _torch_db([str(fa)])
    assert plain[0].load_counters["regrows"] == 0
    first = [int(t[0]) for t in watch.watched.values()]  # each append's exact n_sel
    n_chunks, n_over = len(first), sum(n > 1024 for n in first)
    assert n_chunks == plain[0]._devcount_stats.n_append and n_over >= 2
    pc = plain[0].load_counters
    assert pc["appends"] == n_chunks >= pc["units"] >= 2 and pc["host_rows"] == 0
    assert pc["device_rows"] == len(reads)
    watch.watched.clear()
    watch.log.clear()

    huge = lambda w, s: 1 << 40  # noqa: E731  (capacity = its floor, 1024 lanes)
    monkeypatch.setattr(JR, "_sel_divisor", huge)
    monkeypatch.setattr(TR, "_sel_divisor", huge)
    ref = _jax_db([str(fa)])
    with watch:
        t = _torch_db([str(fa)])
    c = t[0].load_counters
    assert c["regrows"] == n_over
    assert c["files"] == 1 and c["chunk_reads"] == 0 and c["nsel_reads"] == 1 + n_over
    assert c["appends"] == n_chunks + n_over and c["units"] == pc["units"]
    assert 0 < c["host_rows"] <= len(reads)  # the overflowed appends' rows, packed again
    st = t[0]._devcount_stats
    assert st.n_append == n_chunks + n_over and st.n_invalidate == n_over
    # the chunks' first tensors go into the one cat; each regrow reads its own
    assert watch.log.count(("cat", n_chunks)) == 1
    assert [e for e in watch.log if e[1] != "cat" and e[0] != "cat"] == [("__getitem__", 1)] * n_over
    assert {"extract", "finalize_dispatch", "nsel_drain"} <= set(t[0].load_timings)
    _assert_same(ref, t)
    _assert_same(plain, t)


def test_mixed_format_discards_pending_chunks(tmp_path, reads, segs, monkeypatch, watch):
    """(b) The optimistic split of a FASTA file with embedded FASTQ
    records queues the pure segments' chunks; the guard discards them
    (lanes invalidated, the pending n_sel tensors untouched), the
    native parse rejects the buffer and the Python reader runs.  The
    ReadDB equals the JAX package's load_reads."""
    from oatk_tpu.asm.pipeline import load_reads as j_load_reads
    from oatk_tpu_torch.asm import pipeline as TP
    from oatk_tpu_torch.index.devcount import DevCountState

    mixed = tmp_path / "m.fa"
    with open(mixed, "w") as f:
        for i, r in enumerate(reads[:60]):
            f.write(f">r{i}\n{r}\n")
        for i, r in enumerate(reads[60:75]):
            f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")
        for i, r in enumerate(reads[75:]):
            f.write(f">t{i}\n{r}\n")
    segs(16 << 10)
    inval = []
    real_inv = DevCountState.invalidate

    def invalidate(self, off, n):
        inval.append((off, n, self.n_fill))
        return real_inv(self, off, n)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DevCountState, "invalidate", invalidate)
        with watch:
            db = TP.load_reads([str(mixed)], W, S, device="cpu")
    assert len(watch.watched) >= 2  # appends were pending when the attempt was discarded
    assert inval and inval[0][0] == 0 and inval[0][1] == inval[0][2]  # every lane of the attempt
    assert watch.log == []  # no pending n_sel was read, or even concatenated
    assert getattr(db, "_devcount", None) is None  # the Python reader counted on the host
    monkeypatch.setenv("OATK_TPU_IMPL", "pallas")  # the JAX package's card route, interpreted
    monkeypatch.setenv("OATK_TPU_COUNT", "device")
    j = j_load_reads([str(mixed)], W, S)
    assert db.n == j.n > 0
    for a, b in zip(j.reads, db.reads):
        assert a.sid == b.sid and a.name == b.name and a.hoco_l == b.hoco_l
        for f in ("hoco_code", "ho_rl", "is_n", "m_pos", "s_mer", "k_mer"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (a.sid, f)


def test_mixed_format_retry_keeps_one_record_per_read(tmp_path, reads, segs, monkeypatch):
    """(b') A FASTA file with a sequence line that starts with '@': the
    guard drops the optimistic split (its lanes invalidated) and the
    verified split parses natively.  The reads' records are made after
    the segment loop, so exactly one per read remains, and the N
    positions of the dropped attempt do not reach the record table:
    every field equals the JAX loader's."""
    from oatk_tpu_torch import native

    fa = tmp_path / "at.fa"
    with open(fa, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r[:500]}\n@{r[500:]}\n" if i == 40 else f">r{i}\n{r}\n")
    segs(16 << 10)
    hits = []
    real = native.find_pattern2
    monkeypatch.setattr(native, "find_pattern2", lambda *a: hits.append(real(*a)) or hits[-1])
    t = _torch_db([str(fa)])
    assert hits and hits[0] >= 0  # the guard fired
    assert [r.sid for r in t[0].reads] == list(range(len(reads)))
    assert len(t[0].table.isn_pos) == 5  # read 2's NNNN and read 40's '@'
    assert [int(r.is_n.sum()) for r in t[0].reads[:3]] == [0, 0, 4] and t[0].reads[40].is_n.sum() == 1
    _assert_same(_jax_db([str(fa)]), t)


@pytest.mark.parametrize("n_files", [1, 2])
def test_one_nsel_read_per_file(tmp_path, reads, segs, monkeypatch, watch, n_files):
    """(c) Each append's n_sel tensor is used once, in its file's one
    ``torch.cat``, whose result the host reads once; the finalize's
    sorts are queued once, after the last file's chunks, before the
    drain.  Equal to the JAX loader."""
    from oatk_tpu_torch.index.devcount import DevCountState

    paths = []
    cut = np.linspace(0, len(reads), n_files + 1).astype(int)
    for i in range(n_files):
        p = tmp_path / f"r{i}.fa"
        _write_fa(str(p), reads[cut[i]:cut[i + 1]], prefix=f"f{i}_")
        paths.append(str(p))
    segs(16 << 10)
    order = []
    real_sf = DevCountState.start_finalize
    monkeypatch.setattr(DevCountState, "start_finalize",
                        lambda self: order.append(("finalize", len(watch.log))) or real_sf(self))
    with watch:
        t = _torch_db(paths)
    c = t[0].load_counters
    n_chunks = t[0]._devcount_stats.n_append
    assert n_chunks >= c["units"] >= 2 * n_files
    assert c == dict(files=n_files, nsel_reads=n_files, chunk_reads=0, regrows=0,
                     pinned_bytes=0, copy_uploads=0, units=c["units"], appends=n_chunks,
                     device_rows=len(reads), host_rows=0)
    cats = [e for e in watch.log if e[0] == "cat" and e[1] != "cat"]
    assert len(cats) == n_files and sum(n for _, n in cats) == n_chunks
    reads_of_cat = [e[0] for e in watch.log if e[1] == "cat" and e[0] in HOST_READS]
    assert reads_of_cat == ["cpu", "tolist"] * n_files
    assert [e for e in watch.log if e not in cats and e[1] != "cat"] == []
    # the sorts were queued once, before the last file's drain
    assert len(order) == 2 and order[0][1] == len(watch.log) - 3  # then build's own call
    _assert_same(_jax_db(paths), t)


def test_finalize_sorted_reads_nothing():
    """The finalize's queued part makes no host read: no conversion, no
    copy to the host and no boolean-mask indexing (each waits for the
    device); its compaction equals the one-piece finalize."""
    from oatk_tpu_torch.index import devcount as DC

    rng = np.random.default_rng(5)
    n = 4000
    h = rng.integers(0, 300, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    low = (rng.permutation(n).astype(np.uint64) // np.uint64(40) << np.uint64(32)) \
        | (np.arange(n, dtype=np.uint64) << np.uint64(1))
    sm = (h >> np.uint64(7)) ^ np.uint64(rng.random() < 2)  # a few mismatching payloads
    sm[::97] += np.uint64(1)
    bv = (rng.random(n) < 0.2).astype(np.int32)
    st = DC.DevCountState.from_numpy(h, low, sm, rng.integers(0, 1 << 20, n), bv)
    seen = []

    class Log(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", str(func))
            if name == "__getitem__" and isinstance(args[1], torch.Tensor) and args[1].dtype == torch.bool:
                name = "boolean mask"
            seen.append(name)
            return func(*args, **(kwargs or {}))

    with Log():
        part = DC.finalize_sorted(*st.bufs)
    assert seen and not set(seen) & (HOST_READS | {"boolean mask"}), sorted(set(seen))
    for a, b in zip(DC.finalize_compact(part), DC.finalize(*st.bufs)):
        assert torch.equal(a, b)
    assert int(DC.finalize(*st.bufs)[9][2]) > 0  # collisions counted


def test_uploads_on_cpu_use_the_blob_in_place():
    """On the CPU the upload ring neither pins nor copies a lone array,
    and lays a list of arrays end to end."""
    from oatk_tpu_torch.asm.reads import Uploads

    up = Uploads("cpu")
    blob, sids = np.arange(64, dtype=np.uint8), np.arange(3, dtype=np.int64)
    b, s = up.put(blob, sids)
    up.done()
    assert b.data_ptr() == blob.ctypes.data and s.data_ptr() == sids.ctypes.data
    assert up.uploads == 0 and up.pinned_bytes == 0
    (cat,) = up.put([blob[:5], blob[7:9]])
    assert cat.tolist() == [0, 1, 2, 3, 4, 7, 8]


# --- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("regrow", [False, True])
def test_cuda_pinned_ring_reuses_slots(tmp_path, reads, monkeypatch, regrow):
    """More units than pinned slots: every slot staged several uploads,
    the pinned memory stays at the slot count times the largest upload,
    and the bytes equal the CPU run's; with the first capacity clamped to
    64 lanes, every append regrows after the drain, on the card as on
    the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from oatk_tpu_torch.asm import reads as TR

    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    monkeypatch.setattr(TR, "_SEG_BYTES", 16 << 10)  # the card's machine has no JAX package
    monkeypatch.setattr(TR, "_UNIT_POSITIONS", 8 << 10)
    monkeypatch.setattr(TR, "_UPLOAD_SLOTS", 2)
    if regrow:
        monkeypatch.setattr(TR, "_capacity", lambda B, Lp, w, s: 64)
    sizes = []
    real_put = TR.Uploads.put
    monkeypatch.setattr(TR.Uploads, "put", lambda self, *fields: sizes.append(sum(
        TR._round_up(sum(a.nbytes for a in (f if isinstance(f, list) else [f])), 16)
        for f in fields)) or real_put(self, *fields))
    cpu = _torch_db([str(fa)])
    for _ in range(3):  # a reuse race shows only now and then
        sizes.clear()
        card = _torch_db([str(fa)], device="cuda")
        c = card[0].load_counters
        assert c["units"] >= 3 * 2 and c["nsel_reads"] == 1 + c["regrows"]
        assert c["copy_uploads"] == c["units"] + c["regrows"] == len(sizes)
        assert (c["regrows"] == c["appends"] // 2 > 0) == regrow
        assert c["host_rows"] == (len(reads) if regrow else 0)
        assert max(sizes) <= c["pinned_bytes"] <= 2 * max(sizes)
        _assert_same(cpu, card)
