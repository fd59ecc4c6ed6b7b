"""Closed-syncmer selection in oatk_tpu_torch: the plain PyTorch version
(what the wrapper runs for a CPU tensor) against the JAX package's
Pallas kernel run in interpret mode, on the same seeded inputs.
Tolerance: exact (integer selection codes).

The CUDA kernel itself runs only on a card: the ``cuda``-marked test
compares it with the plain version there and skips elsewhere."""
import numpy as np
import pytest
import torch

from oatk_tpu_torch.kernels import syncmer_select as SS

# the main-path shapes, plus q = w-s+1 = 2 (empty q-2 window) at both
# ends of the s range
CASES = [(15, 5), (51, 11), (91, 13), (151, 13), (1001, 31), (12, 11), (32, 31)]


def _codes(rng, B, L, w, n_rate=None, short_row=True):
    """[B, 1+L+w+2] uint8: bases, Ns (default ~0.3 per w-window),
    ragged read ends (pad 5), pad columns; row 1 shorter than w+4 when
    requested."""
    if n_rate is None:
        n_rate = 0.3 / w
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < n_rate] = 4
    hl = rng.integers(max(1, L // 3), L + 1, B)
    hl[0] = L
    if short_row and B > 1:
        hl[1] = min(L, w + 3)
    for b in range(B):
        codes[b, hl[b]:] = 5
    return np.pad(codes, ((0, 0), (1, w + 2)), constant_values=5)


def _pallas(cp, w, s):
    import jax.numpy as jnp

    from oatk_tpu.kernels.syncmer_pallas import syncmer_select_pallas

    return np.asarray(syncmer_select_pallas(jnp.asarray(cp), w, s, interpret=True))


@pytest.mark.parametrize("w,s", CASES)
def test_plain_matches_pallas(w, s):
    rng = np.random.default_rng(1000 + w)
    cp = _codes(rng, 6, max(700, 3 * w), w)
    ref = _pallas(cp, w, s)
    got = SS.syncmer_select_plain(torch.from_numpy(cp), w, s).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    assert (ref != 0).any()


@pytest.mark.parametrize("w,s", CASES[:3])
def test_plain_matches_pallas_int32_input_dense_ns(w, s):
    """int32 codes (the Pallas kernel's other input type) with Ns dense
    enough that most windows are cut."""
    rng = np.random.default_rng(2000 + w)
    cp = _codes(rng, 4, 1500, w, n_rate=0.02).astype(np.int32)
    ref = _pallas(cp, w, s)
    got = SS.syncmer_select_plain(torch.from_numpy(cp), w, s).numpy()
    assert np.array_equal(got, ref)


def test_plain_matches_pallas_multi_tile_k1001():
    """B=8 rows of 16384 positions at k=1001/s=31: several Pallas tiles
    per row, so tile halos are crossed."""
    rng = np.random.default_rng(16384)
    cp = _codes(rng, 8, 16384, 1001, n_rate=2e-4)
    ref = _pallas(cp, 1001, 31)
    got = SS.syncmer_select_plain(torch.from_numpy(cp), 1001, 31).numpy()
    assert np.array_equal(got, ref)
    assert (ref != 0).sum() > 50


def test_wrapper_takes_plain_only_on_cpu():
    rng = np.random.default_rng(9)
    cp = torch.from_numpy(_codes(rng, 3, 600, 51))
    before = SS.syncmer_select.launches
    assert torch.equal(SS.syncmer_select(cp, 51, 11), SS.syncmer_select_plain(cp, 51, 11))
    assert SS.syncmer_select.launches == before  # no kernel launched
    # a non-CPU, non-CUDA tensor is refused, never computed by the plain path
    with pytest.raises(ValueError):
        SS.syncmer_select(cp.to("meta"), 51, 11)


def test_argument_checks():
    cp = torch.full((2, 60), 5, dtype=torch.uint8)
    with pytest.raises(ValueError):
        SS.syncmer_select(cp, 51, 32)  # s > 31
    with pytest.raises(ValueError):
        SS.syncmer_select(cp, 101, 11)  # row shorter than w+3
    with pytest.raises(ValueError):
        SS.syncmer_select(cp[0], 15, 5)  # not [B, Lp]


@pytest.mark.cuda
@pytest.mark.parametrize("w,s", CASES)
def test_cuda_kernel_matches_plain(w, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(3000 + w)
    cp = torch.from_numpy(_codes(rng, 8, 9000, w)).cuda()
    before = SS.syncmer_select.launches
    got = SS.syncmer_select(cp, w, s)
    torch.cuda.synchronize()
    assert SS.syncmer_select.launches == before + 1
    assert torch.equal(got, SS.syncmer_select_plain(cp, w, s))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(1, 1), (3, 31), (5, 2047), (2, 2049), (7, 4097)])
@pytest.mark.parametrize("w,s", [(51, 11), (1001, 31)])
def test_cuda_kernel_ragged_shapes(B, L, w, s):
    """Rows shorter than one tile, one position past a tile, a single
    position: the kernel masks its own ragged edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(B * L + w)
    cp = torch.from_numpy(_codes(rng, B, L, w, short_row=False)).cuda()
    got = SS.syncmer_select(cp, w, s)
    torch.cuda.synchronize()
    assert got.shape == (B, L)
    assert torch.equal(got, SS.syncmer_select_plain(cp, w, s))
