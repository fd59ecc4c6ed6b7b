"""Loaders of oatk_tpu_torch (asm/reads.py, device "cpu") against the
JAX package's with Pallas extraction in interpret mode: the fused loader
with device counting (impl="pallas", device_count=True -- what
OATK_TPU_IMPL=pallas OATK_TPU_COUNT=device selects) and with host
counting, the -D capped flow, the Python reader fallback and the
device-hoco route.  Every per-read array (values and dtypes) and the
SyncmerDB after collect_syncmer_db must be equal; the Python reader's
routes are held against the JAX host oracle."""
import gzip
import os

import numpy as np
import pytest

from genome_sim import random_genome, sample_reads
from oatk_tpu_torch.asm.reads import READ_FIELDS

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


def _jax_db(paths, max_data=0, device_count=True):
    from oatk_tpu.asm.reads import load_and_extract
    from oatk_tpu.index.syncmer_db import collect_syncmer_db

    db = load_and_extract(paths, W, S, max_data, impl="pallas", device_count=device_count)
    assert db is not None
    return db, collect_syncmer_db(db)


def _torch_db(paths, max_data=0, device_count=True):
    from oatk_tpu_torch.asm.reads import load_and_extract
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db

    db = load_and_extract(paths, W, S, max_data, device="cpu", device_count=device_count)
    assert db is not None
    assert (getattr(db, "_devcount", None) is not None) == (device_count and not max_data)
    return db, collect_syncmer_db(db)


def _oracle(paths, max_data=0, collect=False):
    """The JAX package's host oracle over its Python reader (with
    ``collect``, after collect_syncmer_db's hash -> id rewrite)."""
    from oatk_tpu.asm.reads import extract_all_syncmers
    from oatk_tpu.index.syncmer_db import collect_syncmer_db
    from oatk_tpu.io.fastx import read_fastx

    db = extract_all_syncmers(read_fastx(paths, max_data), W, S, use_device=False)
    if collect:
        collect_syncmer_db(db)
    return db


def _assert_values(db, ref):
    """Per-read values equal (the oracle stores ho_rl as uint32)."""
    assert db.n == ref.n > 0
    for a, b in zip(db.reads, ref.reads):
        assert a.sid == b.sid and a.name == b.name and a.hoco_l == b.hoco_l
        for f in ("hoco_code", "ho_rl", "is_n", "m_pos", "s_mer", "k_mer"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (a.sid, f)


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
    dp1, dp2 = getattr(db1, "_dev_pairs", None), getattr(db2, "_dev_pairs", None)
    assert (dp1 is None) == (dp2 is None)
    if dp1 is not None:
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


@pytest.mark.parametrize("regrow", [False, True])
@pytest.mark.parametrize("n_files", [1, 2, 3])
def test_units_span_segments(tmp_path, reads, both_segs, monkeypatch, n_files, regrow):
    """The key route uploads units of several parse segments and lays out
    their rows on the device; its ReadDB and SyncmerDB equal the JAX
    loader's over 1-3 files, with the port's first capacity clamped to 64
    lanes (every append regrows from the whole-file codes) or not."""
    from oatk_tpu_torch.asm import reads as TR

    paths = []
    cut = np.linspace(0, len(reads), n_files + 1).astype(int)
    for i in range(n_files):
        p = tmp_path / f"r{i}.fa"
        _write_fa(str(p), reads[cut[i]:cut[i + 1]], prefix=f"f{i}_")
        paths.append(str(p))
    both_segs(2048)
    monkeypatch.setattr(TR, "_UNIT_POSITIONS", 2500)  # two or three segments a unit
    if regrow:
        monkeypatch.setattr(TR, "_capacity", lambda B, Lp, w, s: 64)
    t = _torch_db(paths)
    c = t[0].load_counters
    n_seg = sum(max(1, os.path.getsize(p) // 2048) for p in paths)
    assert n_files < c["units"] < n_seg and c["device_rows"] == len(reads)
    assert c["regrows"] == (c["appends"] // 2 if regrow else 0)
    assert c["host_rows"] == (len(reads) if regrow else 0)
    assert c["appends"] == t[0]._devcount_stats.n_append >= c["units"]
    assert c["nsel_reads"] == n_files + c["regrows"] and c["chunk_reads"] == 0
    _assert_same(_jax_db(paths), t)


@pytest.mark.parametrize("w", [51, 1001])
def test_stream_pack_matches_numpy(w):
    """The workers' native stream pack (asm/stream_pack.py) against numpy:
    each read's 2-bit bytes from its 16-aligned offset on, zeros past its
    last base and 16 spare ones, its length bucket as _bucket_len of
    max(hl, w+4) at and around every bucket edge, empty reads, and each N
    as (read, position) by a search of the read offsets."""
    from oatk_tpu_torch.asm.reads import _bucket_len
    from oatk_tpu_torch.asm.stream_pack import pack_stream
    from oatk_tpu_torch.kernels.oracle import pack_hoco

    rng = np.random.default_rng(w)
    edges = [0, 1, 2, 3, 4, 63, 64, 65, 511, 512, 513, 1023, 1024, 1025, 2047, 2048, 2049, 4095,
             4096, 4097, 6143, 6144, 6145, 20000, w + 3, w + 4, w + 5]
    lens = np.array(edges + list(rng.integers(0, 9000, 40)) + [0, 0, 7], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    codes = rng.integers(0, 4, int(offs[-1])).astype(np.uint8)
    isn = np.unique(np.concatenate([offs[:-1][lens > 0], offs[1:][lens > 0] - 1,
                                    rng.integers(0, int(offs[-1]), 50)]))
    sg = pack_stream(offs, codes, isn, w)
    blocks = -(-lens // 64)
    assert np.array_equal(sg.row_off, 16 * np.concatenate([[0], np.cumsum(blocks)[:-1]]))
    assert len(sg.stream) == 16 * (int(blocks.sum()) + 1) and not sg.stream[-16:].any()
    assert np.array_equal(sg.hl, lens) and sg.hl.dtype == sg.lp.dtype == np.int32
    assert sg.lp.tolist() == [_bucket_len(max(int(n), w + 4)) for n in lens]
    for i, n in enumerate(lens):
        row = sg.stream[sg.row_off[i]:sg.row_off[i] + 16 * blocks[i]]
        want = np.zeros(16 * blocks[i], np.uint8)
        want[:(n + 3) // 4] = pack_hoco(codes[offs[i]:offs[i + 1]])
        assert np.array_equal(row, want), i
    i = np.searchsorted(offs, isn, side="right") - 1
    assert np.array_equal(sg.n_rows, (i << 32) | (isn - offs[i]))


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


def test_mixed_format_falls_back(tmp_path, reads, both_segs):
    """A FASTA file with embedded FASTQ records: the optimistic split is
    discarded (its device lanes invalidated), the unsplit native parse
    rejects the buffer, load_and_extract returns None and load_reads
    takes the Python reader (host hoco, 2-bit blob, the selection on the
    device, host counting).  Held against the JAX host oracle."""
    from oatk_tpu_torch.asm import pipeline as TP
    from oatk_tpu_torch.asm.reads import load_and_extract
    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select

    mixed = tmp_path / "m.fa"
    with open(mixed, "w") as f:
        for i, r in enumerate(reads[:15]):
            f.write(f">r{i}\n{r}\n")
        for i, r in enumerate(reads[15:30]):
            f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")
    both_segs(2048)
    assert load_and_extract([str(mixed)], W, S, device="cpu") is None
    calls = []
    real = TP.extract_all_syncmers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "extract_all_syncmers", lambda *a, **k: calls.append(1) or real(*a, **k))
        n0 = syncmer_select.launches
        db = TP.load_reads([str(mixed)], W, S, device="cpu")
    assert calls and syncmer_select.launches == n0  # CPU tensors: the plain version
    _assert_values(db, _oracle([str(mixed)]))


@pytest.mark.parametrize("where", ["first-file", "second-file"])
def test_capped_loader(tmp_path, reads, capsys, where):
    """-D: the sequential flow keeps the reads up to and including the
    one whose raw bases reach the cap, counts on the host, drops the
    run-length overflow entries past the cap and reads no further file.
    Equal to the JAX capped loader (values and dtypes, flats, SyncmerDB)
    and to the JAX oracle over the capped Python reader."""
    f1, f2 = tmp_path / "a.fa", tmp_path / "b.fa"
    _write_fa(str(f1), reads[:25], prefix="a")
    _write_fa(str(f2), reads[25:], prefix="b")
    n1 = sum(len(r) for r in reads[:25])
    cap = n1 // 2 if where == "first-file" else n1 + sum(len(r) for r in reads[25:]) // 3
    paths = [str(f1), str(f2)]
    t = _torch_db(paths, max_data=cap)
    assert "data limit (%d) reached" % cap in capsys.readouterr().err
    assert 0 < t[0].n < len(reads)
    assert (t[0].n <= 25) == (where == "first-file")
    _assert_same(_jax_db(paths, max_data=cap), t)
    _assert_values(t[0], _oracle(paths, max_data=cap, collect=True))


def test_host_count_equals_device_count(tmp_path, reads, both_segs):
    """OATK_TPU_COUNT=host (each chunk's rows fetched, host sort) gives
    the ReadDB and SyncmerDB of device counting and of the JAX loader
    with device_count=False."""
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    both_segs(4096)
    host = _torch_db([str(fa)], device_count=False)
    _assert_same(_jax_db([str(fa)], device_count=False), host)
    dev = _torch_db([str(fa)])
    for f in ("h", "s", "cov", "mp_flat", "mp_off"):
        assert np.array_equal(getattr(host[1], f), getattr(dev[1], f)), f
    for a, b in zip(host[0].reads, dev[0].reads):
        for f in ("hoco_code", "ho_rl", "is_n", "m_pos", "s_mer", "k_mer"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (a.sid, f)


@pytest.mark.parametrize("value,device_count", [("host", False), ("device", True),
                                                ("auto", True), ("bogus", True)])
def test_count_knob(tmp_path, reads, monkeypatch, capsys, value, device_count):
    """load_reads reads OATK_TPU_COUNT: host counts on the host, device
    and auto on the device; any other value warns with the JAX package's
    message and runs as auto (device)."""
    from oatk_tpu_torch.asm import pipeline as TP

    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads[:10])
    monkeypatch.setenv("OATK_TPU_COUNT", value)
    db = TP.load_reads([str(fa)], W, S, device="cpu")
    assert (getattr(db, "_devcount", None) is not None) == device_count
    err = capsys.readouterr().err
    warned = "[W::syncasm] OATK_TPU_COUNT='bogus' not in {'auto','device','host'}; using 'auto'"
    assert (warned in err) == (value == "bogus")


@pytest.mark.parametrize("name", ["OATK_TPU_STAGE_SHARDS", "OATK_TPU_SHARDED_IMPL",
                                  "OATK_TPU_SHARD_CAP_SCALE", None])
def test_multi_device_settings_warn_once(tmp_path, reads, monkeypatch, capsys, name):
    """A multi-device setting that the port does not read
    (OATK_TPU_SHARDED_IMPL, OATK_TPU_SHARD_CAP_SCALE) warns once on
    stderr, with the reason; OATK_TPU_STAGE_SHARDS, which the port reads,
    does not warn.  The loaded ReadDB is the one of a run without it."""
    from oatk_tpu_torch.asm import pipeline as TP

    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads[:10])
    for n in ("OATK_TPU_STAGE_SHARDS", *TP.UNREAD_SETTINGS):
        monkeypatch.delenv(n, raising=False)
    plain = TP.load_reads([str(fa)], W, S, device="cpu")
    capsys.readouterr()
    monkeypatch.setattr(TP, "_multi_device_warned", False)
    if name is not None:
        monkeypatch.setenv(name, "2")
    dbs = [TP.load_reads([str(fa)], W, S, device="cpu") for _ in range(2)]
    err = capsys.readouterr().err
    unread = name in TP.UNREAD_SETTINGS
    assert err.count("oatk_tpu_torch does not read") == unread
    if unread:
        assert f"{name}: {TP.UNREAD_SETTINGS[name]}" in err
    else:
        assert not err
    for db in dbs:
        for a, b in zip(plain.reads, db.reads):
            assert np.array_equal(a.k_mer, b.k_mer) and np.array_equal(a.m_pos, b.m_pos)


def test_device_hoco_route(tmp_path, reads, monkeypatch):
    """OATK_TPU_DEVICE_HOCO=1: load_and_extract steps aside, and
    extract_all_syncmers uploads raw ASCII and runs the hoco phase on the
    device.  Syncmers and the fetched hoco arrays (values and dtypes)
    equal the JAX package's device-hoco route in interpret mode."""
    from oatk_tpu.asm.reads import extract_all_syncmers as j_extract
    from oatk_tpu.io.fastx import read_fastx as j_read

    from oatk_tpu_torch.asm import pipeline as TP
    from oatk_tpu_torch.asm.reads import load_and_extract

    rd = list(reads)
    for i, (p, ch) in enumerate(((50, "N"), (51, "n"), (300, "R"), (301, "y"))):
        r = list(rd[i % 3])
        r[p] = ch
        rd[i % 3] = "".join(r)
    rd[4] = rd[4].lower()
    fa = tmp_path / "dh.fa"
    _write_fa(str(fa), rd)
    monkeypatch.setenv("OATK_TPU_DEVICE_HOCO", "1")
    assert load_and_extract([str(fa)], W, S, device="cpu") is None
    t = TP.load_reads([str(fa)], W, S, device="cpu")
    j = j_extract(j_read([str(fa)]), W, S, impl="pallas")
    monkeypatch.delenv("OATK_TPU_DEVICE_HOCO")
    assert any(r.is_n.any() for r in t.reads)
    assert t.n == j.n
    for a, b in zip(j.reads, t.reads):
        assert a.sid == b.sid and a.name == b.name and a.hoco_l == b.hoco_l
        for f in ("hoco_code", "ho_rl", "is_n", "m_pos", "s_mer", "k_mer"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (a.sid, f)
    _assert_values(t, _oracle([str(fa)]))


def _record_paths(tmp_path, reads, both_segs, case):
    """The inputs of one case of test_loader_records_equal_jax_reads:
    (paths, max_data, device_count)."""
    fa = str(tmp_path / "r.fa")
    if case == "one-segment":
        _write_fa(fa, reads)
        return [fa], 0, True
    if case in ("segments-with-ns", "host-count"):
        _write_fa(fa, reads)
        both_segs(4096)
        return [fa], 0, case == "segments-with-ns"
    if case == "files-fastq-gz":
        fq, fgz = str(tmp_path / "r.fq"), str(tmp_path / "r2.fa.gz")
        with open(fq, "w") as f:
            for i, r in enumerate(reads[:20]):
                f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")
        with gzip.open(fgz, "wt") as f:
            for i, r in enumerate(reads[:10]):  # the N-bearing reads
                f.write(f">g{i}\n{r}\n")
        _write_fa(fa, reads[20:], prefix="h")
        both_segs(2048)
        return [fq, fgz, fa], 0, True
    assert case == "capped"
    f2 = str(tmp_path / "b.fa")
    _write_fa(fa, reads[:25], prefix="a")
    _write_fa(f2, reads[25:], prefix="b")
    n1 = sum(len(r) for r in reads[:25])
    return [fa, f2], n1 + sum(len(r) for r in reads[25:]) // 3, False


def _assert_records(j, t):
    """Every field of every read of the port's loader is what the JAX
    loader's ReadSyncmers holds: None where it holds None, else the same
    values, dtype and shape, and a view of another array exactly where
    the JAX read's is one."""
    assert len(j.reads) == len(t.reads) > 0
    for a, b in zip(j.reads, t.reads):
        assert (a.sid, a.name, a.hoco_l) == (b.sid, b.name, b.hoco_l)
        for f in READ_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if x is None or y is None:
                assert x is None and y is None, (a.sid, f)
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, (a.sid, f)
            assert np.array_equal(x, y), (a.sid, f)
            assert (x.base is None) == (y.base is None), (a.sid, f)


@pytest.mark.parametrize("case", ["one-segment", "segments-with-ns", "files-fastq-gz", "capped",
                                  "host-count"])
def test_loader_records_equal_jax_reads(tmp_path, reads, both_segs, case):
    """The native loader's records against the JAX loader's ReadSyncmers,
    right after the load (the key route's syncmer fields unset on both)
    and after collect_syncmer_db: every array made once, on its first
    access, and kept (the table's view counts); on the routes that count
    on the host every syncmer array is assigned, so none is made."""
    from oatk_tpu.asm.reads import load_and_extract as j_load
    from oatk_tpu.index.syncmer_db import collect_syncmer_db as j_collect
    from oatk_tpu_torch.asm.reads import load_and_extract
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db

    paths, max_data, device_count = _record_paths(tmp_path, reads, both_segs, case)
    j = j_load(paths, W, S, max_data, impl="pallas", device_count=device_count)
    t = load_and_extract(paths, W, S, max_data, device="cpu", device_count=device_count)
    assert t.table.views == dict.fromkeys(READ_FIELDS, 0)
    _assert_records(j, t)
    assert any(r.is_n.any() for r in t.reads)
    j_collect(j)
    collect_syncmer_db(t)
    _assert_records(j, t)
    made = t.n if device_count else 0
    assert t.table.views == dict(hoco_code=t.n, ho_rl=t.n, is_n=t.n, m_pos=made, s_mer=made,
                                 k_mer=made)


@pytest.mark.parametrize("field", READ_FIELDS)
def test_assigned_field_wins(tmp_path, reads, field):
    """A value assigned to a record's field is what the field reads from
    then on; for m_pos/s_mer/k_mer a later set of the table's syncmer
    flats overrides it, as the count's per-read restore did, and a value
    assigned after that set wins again.  Other reads and other fields
    keep their views."""
    from oatk_tpu_torch.asm.reads import load_and_extract
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db

    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    db = load_and_extract([str(fa)], W, S, device="cpu")
    r, other, t = db.reads[7], db.reads[8], db.table
    mine = np.arange(5, dtype=np.uint64)
    setattr(r, field, mine)
    assert getattr(r, field) is mine
    collect_syncmer_db(db)
    syncmer = field in ("m_pos", "s_mer", "k_mer")

    def window(rd, f):
        if f in ("m_pos", "s_mer", "k_mer"):
            return getattr(t, f)[t.moff[rd.sid] : t.moff[rd.sid + 1]]
        o0 = int(db.hoco_off[rd.sid])
        flat = db.hoco_flat if f == "hoco_code" else db.rl_flat
        return flat[o0 : o0 + rd.hoco_l] if f != "is_n" else None

    if syncmer:
        assert np.array_equal(getattr(r, field), window(r, field))
        setattr(r, field, mine)
        assert getattr(r, field) is mine
        flats = {f: getattr(t, f) for f in ("m_pos", "s_mer", "k_mer")}
        flats[field] = flats[field] + flats[field].dtype.type(2)
        t.set_syncmers(t.moff, flats["m_pos"], flats["s_mer"], flats["k_mer"])
        assert np.array_equal(getattr(r, field), window(r, field))
        setattr(r, field, mine)
    assert getattr(r, field) is mine
    for f in READ_FIELDS:
        if f != field and f != "is_n":
            assert np.array_equal(getattr(r, f), window(r, f)), f
        if f != "is_n":
            assert np.array_equal(getattr(other, f), window(other, f)), f
    assert r.is_n.sum() == 6 or field == "is_n"  # read 7's N run
    assert other.n == len(window(other, "m_pos"))


def test_syncasm_makes_no_is_n_view(tmp_path, reads):
    """A whole CPU syncasm (EC, 3 unzip rounds) reads no read's is_n and
    makes each other field for at most every read once; EC hands its
    merged flats to the record table (its second set).  Every read's
    syncmer arrays at the end, and the GFA bytes, equal the JAX
    package's syncasm."""
    from oatk_tpu.asm import pipeline as J
    from oatk_tpu_torch.asm.pipeline import syncasm

    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    kw = dict(k=W, s=S, min_k_cov=2, do_ec=True, do_unzip=3)
    oj, ot = str(tmp_path / "j"), str(tmp_path / "t")
    res = syncasm([str(fa)], out=ot, device="cpu", **kw)
    assert res.scg is not None
    t = res.read_db.table
    assert t.views["is_n"] == 0 and t.gen == 2
    assert all(v <= res.read_db.n for v in t.views.values()), t.views
    ref = J.syncasm([str(fa)], out=oj, **kw)
    assert ref.read_db.n == res.read_db.n
    for a, b in zip(ref.read_db.reads, res.read_db.reads):
        for f in ("m_pos", "s_mer", "k_mer"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (a.sid, f)
    for suf in (".utg.gfa", ".utg.final.gfa"):
        with open(oj + suf, "rb") as f1, open(ot + suf, "rb") as f2:
            assert f1.read() == f2.read(), suf
