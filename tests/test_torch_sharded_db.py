"""The port's multi-device syncmer collection (oatk_tpu_torch/dist/
sharded_db.py, dist/sharding.py) against oatk_tpu's on the virtual
8-device CPU mesh: load_and_extract_sharded + build on make_mesh(n,
"cpu") array-equal to oatk_tpu's on make_mesh(n) and to the port's
single-device DB; the hash owners and the unsigned 2-key sort against
numpy uint64; the hoco-row extraction against oatk_tpu's Pallas route
(interpret mode); K11 against oatk_tpu's sharded_extract_count_step;
``syncasm --shards n --device cpu`` through the port's CLI
byte-identical to oatk_tpu's ``syncasm(shards=n)``.  The ``cuda`` cases
run meshes on ``cuda:0`` and skip without a card.  Every comparison is
exact."""
import numpy as np
import pytest
import torch

from genome_sim import random_genome, sample_reads, write_reads

K, S, C = 151, 13, 3
MESHES = [1, 5, 8]


@pytest.fixture(scope="module")
def db_set(tmp_path_factory):
    """The data set of tests/test_sharded_db.py's DB test: a 20 kbp
    genome at 10x of 2.5 kbp reads."""
    rng = np.random.default_rng(42)
    g = random_genome(rng, 20000)
    fa = tmp_path_factory.mktemp("sdb") / "reads.fa"
    write_reads(str(fa), sample_reads(rng, g, coverage=10, read_len=2500, err_rate=0.001))
    return [str(fa)]


@pytest.fixture(scope="module")
def multi_set(tmp_path_factory):
    """tests/test_sharded_db.py's multi-file set (two genomes, two files;
    at 8 shards some hash ranges are nearly empty)."""
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("multi")
    fa1, fa2 = d / "a.fa", d / "b.fa"
    write_reads(str(fa1), sample_reads(rng, random_genome(rng, 9000), 8, 1800))
    write_reads(str(fa2), sample_reads(rng, random_genome(rng, 6000), 8, 1500))
    return [str(fa1), str(fa2)]


def _jax_sharded(files, n):
    from oatk_tpu.dist.sharded_db import load_and_extract_sharded
    from oatk_tpu.dist.sharding import make_mesh

    db, coll = load_and_extract_sharded(files, K, S, make_mesh(n))
    return db, coll.build(db)


def _port_single(files):
    from oatk_tpu_torch.asm.pipeline import load_reads
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db

    db = load_reads(files, K, S, device="cpu")
    return db, collect_syncmer_db(db)


@pytest.fixture(scope="module")
def jax_dbs(db_set, multi_set):
    """oatk_tpu's sharded DBs, computed once per mesh (JAX compiles its
    sharded step per mesh and row bucket)."""
    out = {n: _jax_sharded(db_set, n) for n in MESHES}
    out["multi"] = _jax_sharded(multi_set, 8)
    return out


def _same_db(a, b, tag):
    """ReadDB (per-read m_pos, s_mer, k_mer) and SyncmerDB (h, s, cov,
    position lists) equal."""
    (rda, sca), (rdb, scb) = a, b
    assert rda.n == rdb.n, tag
    for r1, r2 in zip(rda.reads, rdb.reads):
        for f in ("m_pos", "s_mer", "k_mer"):
            x, y = getattr(r1, f), getattr(r2, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (tag, r1.sid, f)
    assert sca.n == scb.n and sca.n > 0, tag
    for f in ("h", "s", "cov", "del_", "mp_flat", "mp_off"):
        x, y = getattr(sca, f), getattr(scb, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), (tag, f)


@pytest.mark.parametrize("n", MESHES)
def test_sharded_db(db_set, jax_dbs, n):
    from oatk_tpu_torch.dist.sharded_db import load_and_extract_sharded
    from oatk_tpu_torch.dist.sharding import make_mesh

    db, coll = load_and_extract_sharded(db_set, K, S, make_mesh(n, "cpu"))
    got = (db, coll.build(db))
    _same_db(got, jax_dbs[n], f"jax mesh {n}")
    _same_db(got, _port_single(db_set), "port single-device")
    assert len(coll.occ_per_shard) == n and sum(coll.occ_per_shard) == db.total_syncmers()
    assert (coll.exchange_bytes == 0) == (n == 1)


def test_sharded_multifile_and_empty_shards(multi_set, jax_dbs):
    from oatk_tpu_torch.dist.sharded_db import load_and_extract_sharded
    from oatk_tpu_torch.dist.sharding import make_mesh

    db, coll = load_and_extract_sharded(multi_set, K, S, make_mesh(8, "cpu"))
    got = (db, coll.build(db))
    _same_db(got, jax_dbs["multi"], "jax multi-file")
    _same_db(got, _port_single(multi_set), "port single-device")


def test_sharded_batches_and_python_reader(db_set):
    """Many small batches (each owner's buffer grows across them) and
    the Python reader's route (-D): the DB equals the single-device
    loader's on the same reads."""
    from oatk_tpu_torch.asm.pipeline import load_reads
    from oatk_tpu_torch.dist.sharded_db import load_and_extract_sharded
    from oatk_tpu_torch.dist.sharding import make_mesh
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db

    db, coll = load_and_extract_sharded(db_set, K, S, make_mesh(3, "cpu"), batch_bases=4_000)
    assert coll.n_steps > 10
    _same_db((db, coll.build(db)), _port_single(db_set), "small batches")
    db, coll = load_and_extract_sharded(db_set, K, S, make_mesh(3, "cpu"), max_data=30_000)
    ref = load_reads(db_set, K, S, 30_000, device="cpu")
    assert db.hoco_flat is None and 0 < db.n == ref.n < 100
    _same_db((db, coll.build(db)), (ref, collect_syncmer_db(ref)), "-D")


U64 = np.iinfo(np.uint64).max


@pytest.mark.parametrize("D", [1, 2, 5, 8])
def test_owner_and_sort_unsigned(D):
    """Owners (top bits, clamped) and the finalize sort on keys with the
    top bit set, against numpy uint64."""
    from oatk_tpu_torch._u64 import from_numpy_u64, to_numpy_u64
    from oatk_tpu_torch.dist.sharded_db import _owner_bits, finalize_sort, owner_of

    rng = np.random.default_rng(D)
    h = rng.integers(0, U64, 5000, dtype=np.uint64, endpoint=True)
    h[:8] = [0, 1, 1 << 63, (1 << 63) - 1, U64, U64 - 1, 1 << 62, 3 << 62]
    h = np.concatenate([h, h[:500]])  # equal hashes: the low key decides
    lo = rng.integers(0, U64, len(h), dtype=np.uint64, endpoint=True)
    bits = _owner_bits(D)
    want = np.minimum(h >> np.uint64(64 - bits), np.uint64(D - 1)).astype(np.int64)
    got = owner_of(from_numpy_u64(h, "cpu"), D).numpy()
    assert np.array_equal(got, want)
    assert _owner_bits(1) == 1 and (D != 5 or set(want.tolist()) == {0, 1, 2, 3, 4})
    keys = torch.stack([from_numpy_u64(h, "cpu"), from_numpy_u64(lo, "cpu")], 1)
    sh, sl = finalize_sort(keys)
    order = np.lexsort((lo, h))
    assert np.array_equal(to_numpy_u64(sh), h[order]) and np.array_equal(to_numpy_u64(sl), lo[order])


def test_extract_hoco_rows_matches_jax():
    """The hoco-row entry (K1 on host-compressed codes) against oatk_tpu's
    extract_hoco_batch_pallas in interpret mode: the selected lanes and
    the exact count."""
    from oatk_tpu.kernels.syncmer import extract_hoco_batch_pallas
    from oatk_tpu_torch.kernels.syncmer import extract_hoco_rows

    rng = np.random.default_rng(3)
    w, s, B, L, mo = 51, 11, 6, 1024, 2048
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[1, 300:302] = 4
    codes[2, 700:] = 5
    codes[3, 40:] = 5
    codes[4, 500] = 4
    j = np.asarray(extract_hoco_batch_pallas(codes, w, s, mo, interpret=True)["packed"])
    t = extract_hoco_rows(torch.from_numpy(codes), w, s, mo).numpy()
    n = int(t[0, mo])
    assert 0 < n <= mo
    assert np.array_equal(t[:, :n], j[:, :n]) and not t[:, n:mo].any()


@pytest.fixture(scope="module")
def k11_rows():
    """tests/test_sharding.py's extract+count input: 16 ASCII rows of
    1024 (w=51, s=11)."""
    from conftest import random_read

    rng = np.random.default_rng(12345)
    B, L = 16, 1024
    seqs = [random_read(rng, L - 200)[: L - 8] for _ in range(B)]
    seq = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, sq in enumerate(seqs):
        b = np.frombuffer(sq.encode(), np.uint8)[:L]
        seq[i, : len(b)] = b
        lens[i] = len(b)
    return seq, lens


@pytest.mark.parametrize("D", [8, 5])
def test_k11_matches_jax(k11_rows, D):
    """sharded_extract_count_step against oatk_tpu's (at a bucket_cap at
    which JAX drops nothing) and against numpy's unique over the host
    oracle's hashes; n_dropped all zero."""
    import jax.numpy as jnp

    from oatk_tpu.dist.sharding import make_mesh as j_mesh
    from oatk_tpu.dist.sharding import sharded_extract_count_step as j_k11
    from oatk_tpu_torch.dist import make_mesh, sharded_extract_count_step
    from oatk_tpu_torch.kernels.oracle import syncmers_of_read_oracle

    seq, lens = k11_rows
    w, s = 51, 11
    B = 16 if D == 8 else 15
    got = sharded_extract_count_step(seq[:B], lens[:B], w, s, 64, make_mesh(D, "cpu"))
    if D == 8:
        want = j_k11(jnp.asarray(seq), jnp.asarray(lens), w, s, 2048, j_mesh(8), 1024)
        assert int(np.asarray(want[3]).sum()) == 0
        for a, b in zip(got, want):
            assert np.array_equal(a, np.asarray(b))
    n_distinct, hist, n_sel, n_dropped = got
    hs = np.concatenate([
        syncmers_of_read_oracle(seq[i, : lens[i]], w, s, i, "r").k_mer for i in range(B)])
    _, counts = np.unique(hs, return_counts=True)
    assert int(n_sel.sum()) == len(hs) and int(n_distinct.sum()) == len(counts)
    assert (hist == np.bincount(np.clip(counts, 0, 63), minlength=64)).all()
    assert not n_dropped.any() and n_dropped.shape == (D,)


@pytest.fixture(scope="module")
def gfa_set(tmp_path_factory):
    """tests/test_sharded_db.py's GFA set: a(7 kbp) + r(2.2 kbp) +
    b(6 kbp) + r at 14x of 2.2 kbp reads."""
    rng = np.random.default_rng(23)
    a, r, b = random_genome(rng, 7000), random_genome(rng, 2200), random_genome(rng, 6000)
    fa = tmp_path_factory.mktemp("gfa") / "reads.fa"
    write_reads(str(fa), sample_reads(rng, a + r + b + r, coverage=14, read_len=2200,
                                      err_rate=0.002))
    return str(fa)


@pytest.mark.parametrize("n", MESHES)
def test_cli_shards_gfa(gfa_set, tmp_path, capsys, n):
    """``syncasm --shards n --device cpu`` through the port's CLI: both
    GFAs byte-identical to oatk_tpu's syncasm(shards=n), and the sharded
    loader ran (the port's single-device loader did not)."""
    import oatk_tpu.asm.pipeline as J
    from oatk_tpu_torch.asm import pipeline as TP
    from oatk_tpu_torch.cli.syncasm import main

    oj, ot = str(tmp_path / "jax"), str(tmp_path / "torch")
    J.syncasm([gfa_set], k=K, s=S, min_k_cov=C, do_ec=True, do_unzip=3, out=oj, shards=n)
    called = []
    real = TP.load_reads
    TP.load_reads = lambda *a, **k: called.append(1) or real(*a, **k)
    try:
        assert main([gfa_set, "-k", str(K), "-s", str(S), "-c", str(C), "--shards", str(n),
                     "--device", "cpu", "-o", ot]) == 0
    finally:
        TP.load_reads = real
    assert not called
    for suf in (".utg.gfa", ".utg.final.gfa"):
        with open(oj + suf, "rb") as f:
            a = f.read()
        with open(ot + suf, "rb") as f:
            b = f.read()
        assert a.count(b"\nS\t") >= 1
        assert a == b, suf


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 5])
def test_cuda_mesh_on_one_card(db_set, n):
    """n shards on cuda:0 (an explicit mesh, as chip_smoke.py runs it):
    the DB equals the single-device card DB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the selection kernel has no CPU mode)")
    from oatk_tpu_torch.asm.pipeline import load_reads
    from oatk_tpu_torch.dist.sharded_db import load_and_extract_sharded
    from oatk_tpu_torch.dist.sharding import Mesh
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db

    db, coll = load_and_extract_sharded(db_set, K, S, Mesh(["cuda:0"] * n))
    ref = load_reads(db_set, K, S, device="cuda")
    _same_db((db, coll.build(db)), (ref, collect_syncmer_db(ref)), f"cuda:0 x {n}")


@pytest.mark.cuda
def test_cuda_shards1_gfa(gfa_set, tmp_path):
    """--shards 1 on the card: both GFAs equal the unsharded card run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the selection kernel has no CPU mode)")
    from oatk_tpu_torch.cli.syncasm import main

    common = [gfa_set, "-k", str(K), "-s", str(S), "-c", str(C), "--device", "cuda"]
    assert main([*common, "-o", str(tmp_path / "a")]) == 0
    assert main([*common, "--shards", "1", "-o", str(tmp_path / "b")]) == 0
    for suf in (".utg.gfa", ".utg.final.gfa"):
        with open(str(tmp_path / "a") + suf, "rb") as f:
            a = f.read()
        with open(str(tmp_path / "b") + suf, "rb") as f:
            assert f.read() == a and a.count(b"\nS\t") >= 1
