"""Device extraction chain of oatk_tpu_torch (kernels/syncmer.py:
extract_hoco_fused) against the JAX package's extract_hoco_fused_pallas
(Pallas in interpret mode) on the same seeded blobs.  Tolerance: exact
-- the packed rows below n_sel and the count slot must be equal."""
import numpy as np
import pytest
import torch

from oatk_tpu.kernels.oracle import pack_hoco
from oatk_tpu_torch.asm.reads import chunk_blob


def _blob(rng, B, Lp, w, n_pos=(), n_cap=0, dense=False):
    """packed | hoco_l (i32) | N positions (i32, padded with B*Lp)."""
    if dense:
        # a short repeating motif with random breaks: near every
        # position closes or opens a syncmer
        codes = np.tile(rng.integers(0, 4, 7).astype(np.uint8), Lp // 7 + 1)[:Lp]
        codes = np.stack([np.roll(codes, 3 * b) for b in range(B)])
        codes[rng.random((B, Lp)) < 0.2] = rng.integers(0, 4)
    else:
        codes = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    blob, packed, hl, _ = chunk_blob(B, Lp, sorted(n_pos), n_cap)
    hl[:] = rng.integers(w + 4, Lp + 1, B)
    hl[0] = Lp
    packed[:] = np.stack([pack_hoco(codes[b]) for b in range(B)])
    return blob


def _jax_packed(blob, B, Lp, n_cap, w, s, max_out):
    import jax.numpy as jnp

    from oatk_tpu.kernels.syncmer import extract_hoco_fused_pallas

    out = extract_hoco_fused_pallas(
        jnp.asarray(blob), B, Lp, n_cap, w, s, max_out, interpret=True
    )
    return np.asarray(out["packed"])


def _torch_packed(blob, B, Lp, n_cap, w, s, max_out):
    from oatk_tpu_torch.kernels.syncmer import extract_hoco_fused

    return extract_hoco_fused(torch.from_numpy(blob), B, Lp, n_cap, w, s, max_out).numpy()


def _assert_same(a, b, max_out):
    n = int(a[0, max_out])
    assert int(b[0, max_out]) == n
    m = min(n, max_out)
    assert np.array_equal(a[:, :m], b[:, :m])
    return n


@pytest.mark.parametrize(
    "B,Lp,w,s",
    [(5, 1024, 51, 11), (4, 2048, 15, 5), (3, 2048, 151, 13), (3, 4096, 1001, 31)],
)
def test_fused_matches_jax_n_free(B, Lp, w, s):
    rng = np.random.default_rng(B * Lp + w)
    blob = _blob(rng, B, Lp, w)
    a = _jax_packed(blob, B, Lp, 0, w, s, 4096)
    b = _torch_packed(blob, B, Lp, 0, w, s, 4096)
    assert _assert_same(a, b, 4096) > 0


@pytest.mark.parametrize("w,s", [(51, 11), (151, 13)])
def test_fused_matches_jax_with_ns(w, s):
    rng = np.random.default_rng(77 + w)
    B, Lp = 6, 2048
    n_pos = rng.choice(B * Lp, 40, replace=False).tolist() + [5, Lp + 1000]
    n_pos = sorted(set(n_pos))
    blob = _blob(rng, B, Lp, w, n_pos=n_pos, n_cap=1024)
    a = _jax_packed(blob, B, Lp, 1024, w, s, 4096)
    b = _torch_packed(blob, B, Lp, 1024, w, s, 4096)
    assert _assert_same(a, b, 4096) > 0


def test_dense_stream_overflowing_twice_converges(monkeypatch):
    """A selection stream far denser than the capacity estimate: the
    port's loader loop (asm/reads.py:extract_chunk) must regrow until the
    result is exact, here after TWO overflows, and then equal the JAX
    chain run through its own overflow retry."""
    from oatk_tpu_torch.asm import reads as R
    from oatk_tpu_torch.kernels import syncmer as K

    rng = np.random.default_rng(2)
    B, Lp, w, s = 4, 2048, 15, 5
    blob = _blob(rng, B, Lp, w, dense=True)

    # JAX: its own retry loop on the reported count (loader semantics)
    max_out = 64
    while True:
        a = _jax_packed(blob, B, Lp, 0, w, s, max_out)
        if int(a[0, max_out]) <= max_out:
            break
        max_out = -(-(int(a[0, max_out]) + 1024) // 1024) * 1024

    calls = []
    real = K.extract_hoco_fused

    def counting(*args):
        calls.append(args[-1])
        return real(*args)

    real_round_up = R._round_up
    clamps = []

    def clamped_round_up(x, m):
        if not clamps:  # first regrow stays too small: a second overflow
            clamps.append(x)
            return 128
        return real_round_up(x, m)

    monkeypatch.setattr(K, "extract_hoco_fused", counting)
    monkeypatch.setattr(R, "_round_up", clamped_round_up)
    packed, n_sel, mo = R.extract_chunk(blob, B, Lp, 0, w, s, 64, "cpu")
    assert calls[:2] == [64, 128] and len(calls) == 3  # overflowed twice
    assert n_sel > 128 and n_sel <= mo
    b = packed.numpy()
    assert int(b[0, mo]) == n_sel == int(a[0, max_out])
    assert np.array_equal(a[:, :n_sel], b[:, :n_sel])


def test_overflowing_result_reports_exact_count():
    rng = np.random.default_rng(4)
    B, Lp, w, s = 2, 1024, 15, 5
    blob = _blob(rng, B, Lp, w, dense=True)
    full = _torch_packed(blob, B, Lp, 0, w, s, 4096)
    n = int(full[0, 4096])
    cut = _torch_packed(blob, B, Lp, 0, w, s, 64)
    assert n > 64 and int(cut[0, 64]) == n  # exact, not inflated
    assert np.array_equal(cut[:, :64], full[:, :64])


def test_murmur_rows_match_host_oracle():
    """MurmurHash64A on int64 bit patterns equals the numpy uint64 one
    (kernels/hashes.py) for every tail length."""
    from oatk_tpu.kernels.hashes import murmur64_blocks_np
    from oatk_tpu_torch._u64 import to_numpy_u64
    from oatk_tpu_torch.kernels.syncmer_details import murmur64_rows

    rng = np.random.default_rng(11)
    for n_bytes in (1, 7, 8, 9, 63, 251):
        nblk = -(-n_bytes // 8)
        raw = rng.integers(0, 256, (50, nblk * 8)).astype(np.uint8)
        raw[:, n_bytes:] = 0
        blocks = raw.view(np.uint64)
        got = to_numpy_u64(murmur64_rows(torch.from_numpy(raw.view(np.int64)), n_bytes))
        assert np.array_equal(got, murmur64_blocks_np(blocks, n_bytes))


def _ascii_rows(rng, B, L):
    """Random ASCII reads: homopolymer runs of upper- and lowercase
    bases, N/n, other IUPAC letters and stray bytes; one empty row, one
    full row, garbage bytes past every row's length."""
    alphabet = np.frombuffer(b"ACGTACGTACGTacgtNnRYKMSWBDHVryU-*", np.uint8)
    seq = alphabet[rng.integers(0, len(alphabet), (B, L))]
    run = rng.random((B, L)) < 0.5  # homopolymers: repeat the previous byte
    for j in range(1, L):
        seq[:, j] = np.where(run[:, j], seq[:, j - 1], seq[:, j])
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0], lens[1] = 0, L
    for b in range(B):
        seq[b, lens[b]:] = rng.integers(0, 256, L - lens[b])
    return seq, lens


@pytest.mark.parametrize("B,L", [(6, 512), (3, 2048)])
def test_hoco_phase_matches_jax(B, L):
    """hoco_phase against the JAX package's _hoco_phase, exactly, for
    every returned array (values and dtypes)."""
    import jax.numpy as jnp

    from oatk_tpu.kernels.syncmer import _hoco_phase
    from oatk_tpu_torch.kernels.syncmer import hoco_phase

    seq, lens = _ascii_rows(np.random.default_rng(B * L), B, L)
    ref = {k: np.asarray(v) for k, v in _hoco_phase(jnp.asarray(seq), jnp.asarray(lens)).items()}
    got = {k: v.numpy() for k, v in hoco_phase(torch.from_numpy(seq), torch.from_numpy(lens)).items()}
    assert set(got) == set(ref)
    assert ref["is_n"].any() and (ref["ho_rl"] > 0).any()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("w,s", [(51, 11), (151, 13)])
def test_extract_ascii_matches_jax(w, s):
    """extract_syncmers_ascii (hoco phase, selection, details) against
    the JAX package's extract_syncmers_batch_pallas in interpret mode:
    the packed rows below n_sel, the count slot and the hoco arrays."""
    import jax.numpy as jnp

    from oatk_tpu.kernels.syncmer import extract_syncmers_batch_pallas
    from oatk_tpu_torch.kernels.syncmer import extract_syncmers_ascii

    seq, lens = _ascii_rows(np.random.default_rng(w), 4, 2048)
    seq[2, :] = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(1).integers(0, 4, 2048)]
    lens[2] = 2048  # an N-free row with many syncmers
    max_out = 1024
    ref = extract_syncmers_batch_pallas(jnp.asarray(seq), jnp.asarray(lens), w, s, max_out,
                                        interpret=True, return_hoco=True)
    got = extract_syncmers_ascii(torch.from_numpy(seq), torch.from_numpy(lens), w, s, max_out,
                                 return_hoco=True)
    assert _assert_same(np.asarray(ref["packed"]), got["packed"].numpy(), max_out) > 0
    for k in ("hoco_c", "hoco_l", "ho_rl", "is_n"):
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
