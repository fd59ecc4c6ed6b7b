"""Device counting finalize of oatk_tpu_torch (index/devcount.py) against
the JAX package's _make_finalize_jit on the SAME carry buffers (taken
from the JAX loader's state, or built synthetically), and the host
build that consumes it.  Tolerance: exact on the valid prefixes
([:n_tot], [:n_scm], [:n_ru], [:n_pu]) and the 5 scalars."""
import copy

import numpy as np
import pytest
import torch

from genome_sim import random_genome, sample_reads

W, S = 51, 11


def _write_fa(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i} c\n{r}\n")


@pytest.fixture
def fasta(tmp_path):
    rng = np.random.default_rng(20260819)
    g = random_genome(rng, 8000)
    reads = sample_reads(rng, g, coverage=7, read_len=1100, err_rate=0.01)
    fa = tmp_path / "r.fa"
    _write_fa(str(fa), reads)
    return str(fa)


def _jax_loaded(fa, monkeypatch, seg_bytes=4096):
    """The JAX loader's read DB with device counting (its DevCountState
    still holds the carry buffers)."""
    from oatk_tpu.asm import reads as JR

    monkeypatch.setattr(JR, "_SEG_BYTES", seg_bytes)
    db = JR.load_and_extract([fa], W, S, impl="pallas", device_count=True)
    assert db is not None and db._devcount is not None
    return db


def _bufs_np(state):
    return tuple(np.asarray(b) for b in state._bufs)


def _u(a):
    """Compare 8-byte lanes as uint64 bits, narrower ones as int64."""
    a = np.asarray(a)
    return a.view(np.uint64) if a.dtype.itemsize == 8 else a.astype(np.int64)


def _assert_finalize_equal(bufs):
    from oatk_tpu.index.devcount import _make_finalize_jit
    from oatk_tpu_torch.index.devcount import DevCountState, final_to_numpy, finalize

    ref = [np.asarray(x) for x in _make_finalize_jit()(*bufs)]
    st = DevCountState.from_numpy(*bufs)
    got = final_to_numpy(finalize(*st._bufs))
    (gid, m32, rs_sid, rs_pos, hh, hs, h1, l1, s1, sc, pk, pc) = ref
    n_tot, n_scm, n_susp, n_pu, n_ru = (int(x) for x in sc)
    assert np.array_equal(_u(got[9]), _u(sc))
    # the port hands host code the JAX path's dtypes
    assert got[0].dtype == np.int32 and got[1].dtype == np.uint32
    assert all(got[i].dtype == np.uint64 for i in (4, 5, 6, 7, 8, 10))
    for i, n in ((0, n_tot), (1, n_tot), (2, n_ru), (3, n_ru), (4, n_scm),
                 (5, n_scm), (6, n_tot), (7, n_tot), (8, n_tot), (10, n_pu), (11, n_pu)):
        assert len(got[i]) == n, i
        assert np.array_equal(_u(got[i]), _u(ref[i][:n])), i
    return n_tot, n_scm, n_susp, n_pu, n_ru


def test_finalize_on_loader_buffers(fasta, monkeypatch):
    """Real carry buffers: every chunk's padding lanes are invalid."""
    db = _jax_loaded(fasta, monkeypatch)
    bufs = _bufs_np(db._devcount)
    assert (bufs[4] != 0).any()  # invalid lanes present
    n_tot, n_scm, n_susp, n_pu, _ = _assert_finalize_equal(bufs)
    assert n_tot > 0 and n_scm > 0 and n_susp == 0 and n_pu > 0


def test_finalize_with_invalidated_chunk(fasta, monkeypatch):
    """A chunk's lanes invalidated after appending (a discarded attempt)
    must drop out of both finalizes alike."""
    db = _jax_loaded(fasta, monkeypatch)
    bh, bl, bs, bm, bv = _bufs_np(db._devcount)
    bv = bv.copy()
    valid = np.flatnonzero(bv == 0)
    bv[valid[: len(valid) // 3]] = 1
    n_tot, *_ = _assert_finalize_equal((bh, bl, bs, bm, bv))
    assert n_tot == len(valid) - len(valid) // 3


def test_forced_collision_takes_host_fallback(fasta, monkeypatch):
    """Give two distinct k-mers the same hash: n_susp > 0 in both
    finalizes, and the port's build resolves it on host exactly as the
    JAX package's build does."""
    from oatk_tpu.index.syncmer_db import collect_syncmer_db as jax_collect
    from oatk_tpu_torch.index.devcount import DevCountState
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db as torch_collect

    db_j = _jax_loaded(fasta, monkeypatch)
    state, db_j._devcount = db_j._devcount, None
    db_t = copy.deepcopy(db_j)
    db_j._devcount = state
    bh, bl, bs, bm, bv = (b.copy() for b in _bufs_np(db_j._devcount))
    valid = np.flatnonzero(bv == 0)
    # pick two lanes whose smers differ and merge their hashes
    a = valid[0]
    b = next(i for i in valid[1:] if bs[i] != bs[a] and bh[i] != bh[a])
    bh[bh == bh[b]] = bh[a]
    _, _, n_susp, _, _ = _assert_finalize_equal((bh, bl, bs, bm, bv))
    assert n_susp > 0

    import jax.numpy as jnp

    db_j._devcount._bufs = tuple(jnp.asarray(x) for x in (bh, bl, bs, bm, bv))
    db_j._devcount._final = None
    db_j._devcount._prefetch = None
    st = DevCountState.from_numpy(bh, bl, bs, bm, bv)
    st.n_occ = db_j._devcount.n_occ
    db_t._devcount = st
    scm_j, scm_t = jax_collect(db_j), torch_collect(db_t)
    for f in ("h", "s", "cov", "mp_flat", "mp_off"):
        assert np.array_equal(getattr(scm_j, f), getattr(scm_t, f)), f
    for r1, r2 in zip(db_j.reads, db_t.reads):
        assert np.array_equal(r1.k_mer, r2.k_mer)
        assert np.array_equal(r1.m_pos, r2.m_pos)
        assert np.array_equal(r1.s_mer, r2.s_mer)


def _synthetic_bufs(rng, n_reads=40, per_read=30, n_kinds=25):
    """Hand-made carry buffers: hashes with the top bit set, duplicate
    adjacent pairs across reads, self-complementary pairs (one syncmer
    followed by itself on the other strand), invalid lanes mixed in."""
    kinds_h = rng.integers(0, 2**64 - 1, n_kinds, dtype=np.uint64, endpoint=True)
    kinds_h[::2] |= np.uint64(1 << 63)
    kinds_s = rng.integers(0, 2**62, n_kinds, dtype=np.uint64)
    H, L_, Sm, M, V = [], [], [], [], []
    for sid in range(n_reads):
        ks = rng.integers(0, n_kinds, per_read)
        zs = rng.integers(0, 2, per_read)
        if sid % 5 == 0:  # self-complementary pair: k, then k on the other strand
            ks[3] = ks[2]
            zs[3] = 1 - zs[2]
        if sid % 7 == 1:  # a pair duplicated from read 1
            ks[:6] = [1, 2, 3, 1, 2, 3]
        for idx in range(per_read):
            H.append(kinds_h[ks[idx]])
            L_.append((sid << 32) | (idx << 1) | int(zs[idx]))
            Sm.append(kinds_s[ks[idx]])
            M.append((idx * 17) << 1 | int(zs[idx]))
            V.append(0)
    n = len(H)
    junk = rng.integers(0, 2**64 - 1, n // 4, dtype=np.uint64, endpoint=True)
    bh = np.concatenate([np.asarray(H, np.uint64), junk])
    bl = np.concatenate([np.asarray(L_, np.uint64), junk[::-1]])
    bs = np.concatenate([np.asarray(Sm, np.uint64), junk])
    bm = np.concatenate([np.asarray(M, np.uint32), junk.astype(np.uint32)])
    bv = np.concatenate([np.asarray(V, np.int32), np.ones(len(junk), np.int32)])
    perm = rng.permutation(len(bh))  # append order must not matter
    return bh[perm], bl[perm], bs[perm], bm[perm], bv[perm]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_finalize_synthetic_duplicate_and_self_complementary_pairs(seed):
    bufs = _synthetic_bufs(np.random.default_rng(seed))
    n_tot, n_scm, n_susp, n_pu, n_ru = _assert_finalize_equal(bufs)
    assert n_ru == 40 and n_susp == 0
    assert n_pu < 40 * 29  # duplicates collapsed into counts


def test_finalize_empty():
    """No valid lane at all."""
    from oatk_tpu_torch.index.devcount import DevCountState, final_to_numpy, finalize

    z = np.zeros(8, np.uint64)
    st = DevCountState.from_numpy(z, z, z, z.astype(np.uint32), np.ones(8, np.int32))
    got = final_to_numpy(finalize(*st._bufs))
    assert list(got[9]) == [0, 0, 0, 0, 0]
    assert all(len(x) == 0 for i, x in enumerate(got) if i != 9)


def test_from_numpy_keeps_bit_patterns():
    from oatk_tpu_torch._u64 import to_numpy_u64
    from oatk_tpu_torch.index.devcount import DevCountState

    rng = np.random.default_rng(1)
    h = rng.integers(0, 2**64 - 1, 100, dtype=np.uint64, endpoint=True)
    st = DevCountState.from_numpy(h, h, h, h.astype(np.uint32), np.zeros(100, np.int32))
    assert np.array_equal(to_numpy_u64(st._bufs[0]), h)
    assert st._bufs[0].dtype == torch.int64 and st.n_occ == 100
