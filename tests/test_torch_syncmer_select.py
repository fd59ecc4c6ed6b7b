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
# k above the shared-memory limit of a tile-plus-halo design (w >= 5,965)
LARGE = [(6001, 31), (9001, 31), (20001, 31)]


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
@pytest.mark.parametrize("w,s", CASES + LARGE)
def test_cuda_kernel_matches_plain(w, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(3000 + w)
    cp = torch.from_numpy(_codes(rng, 8, max(9000, 6 * w), w)).cuda()
    before = SS.syncmer_select.launches
    got = SS.syncmer_select(cp, w, s)
    torch.cuda.synchronize()
    assert SS.syncmer_select.launches == before + 1
    ref = SS.syncmer_select_plain(cp, w, s)
    assert (ref != 0).sum() > 20  # rows long enough to select at every k
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(1, 1), (3, 31), (5, 2047), (2, 2049), (7, 4097)])
@pytest.mark.parametrize("w,s", [(51, 11), (1001, 31), (20001, 31)])
def test_cuda_kernel_ragged_shapes(B, L, w, s):
    """Rows shorter than one tile, one position past a tile, a single
    position: the kernel masks its own ragged edges.  Where w is past
    every such length, the rows are 4w longer, so that they select."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if w > 4097:
        L += 4 * w
    rng = np.random.default_rng(B * L + w)
    cp = torch.from_numpy(_codes(rng, B, L, w, short_row=False)).cuda()
    got = SS.syncmer_select(cp, w, s)
    torch.cuda.synchronize()
    ref = SS.syncmer_select_plain(cp, w, s)
    assert got.shape == (B, L)
    if w > 4097:
        assert (ref != 0).sum() >= 3
    assert torch.equal(got, ref)


def test_plain_matches_pallas_large_k():
    """k=6001/s=31, B=2: above the old kernel's shared-memory limit; the
    Pallas kernel (interpret mode) and the plain version agree."""
    rng = np.random.default_rng(6001)
    cp = _codes(rng, 2, 2 * 6001 + 900, 6001, n_rate=2e-5)
    ref = _pallas(cp, 6001, 31)
    got = SS.syncmer_select_plain(torch.from_numpy(cp), 6001, 31).numpy()
    assert np.array_equal(got, ref)
    assert (ref != 0).any()


# --- a CPU model of the CUDA kernel's decomposition -----------------------
# Test code only: it computes the selection codes the way
# csrc/syncmer_select.cu does (tiles, runs of R columns, in-run prefix and
# suffix minima, a doubling table over run minima queried at two lengths,
# head and tail windows, in-run last invalid columns plus an exclusive
# prefix max over runs), so that the kernel's index arithmetic is checked
# here against the plain version.

_SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _hash_np(k, mask):
    u = np.uint64
    k = (~k + (k << u(21))) & mask
    k = k ^ (k >> u(24))
    k = (k + (k << u(3)) + (k << u(8))) & mask
    k = k ^ (k >> u(14))
    k = (k + (k << u(2)) + (k << u(4))) & mask
    k = k ^ (k >> u(28))
    return (k + (k << u(31))) & mask


def _model_tile(row, Lp, L, w, s, tile, R, t0):
    """Selection codes of one tile (outputs t0 .. t0+tile-1) of one row."""
    q = w - s + 1
    W2 = q - 2
    NH, NT, E = tile + 4, tile + 2, tile + w + 4
    nr, nhead = -(-E // R), -(-NH // R)
    n = nr * R
    mask = np.uint64((1 << (2 * s)) - 1)
    cols = t0 + np.arange(n + s - 1)
    c = np.where(cols < Lp, row[np.minimum(cols, Lp - 1)], 5).astype(np.int64)
    inv = c >= 4
    cc = np.where(inv, 0, c).astype(np.uint64)
    F = np.zeros(n, np.uint64)
    Rv = np.zeros(n, np.uint64)
    for j in range(s):
        F |= cc[j:j + n] << np.uint64(2 * (s - 1 - j))
        Rv |= (np.uint64(3) - cc[j:j + n]) << np.uint64(2 * j)
    ci = np.concatenate([[0], np.cumsum(inv)])
    bad = (ci[s:s + n] - ci[:n] > 0) | (F == Rv)
    M = np.where(bad, _SENT, _hash_np(np.minimum(F, Rv), mask))
    Mr = M.reshape(nr, R)
    runmin = Mr.min(1)
    P = np.minimum.accumulate(Mr, axis=1).ravel()
    headS = np.empty(NH, np.uint64)
    for a in range(nhead):  # head runs: S seeded with the run's columns past the head
        e0, hi = a * R, min(a * R + R, NH)
        beyond = M[hi:e0 + R].min() if hi < e0 + R else _SENT
        headS[e0:hi] = np.minimum(np.minimum.accumulate(M[e0:hi][::-1])[::-1], beyond)
    headM, tailM, tailP = M[:NH], M[q - 1:q - 1 + NT], P[q - 1:q - 1 + NT]
    last = np.maximum.accumulate(np.where(inv[:n], np.arange(n), -1).reshape(nr, R), axis=1)
    tailLB = last.ravel()[w:w + tile]
    excl = np.concatenate([[-1], np.maximum.accumulate(last[:, -1])[:-1]])
    D0 = (W2 - 1) // R if W2 >= 1 else 0
    dm = W2 - 1 - D0 * R if W2 >= 1 else 0
    levels = [np.concatenate([runmin, np.full(nr, _SENT)])]
    while 2 ** len(levels) <= max(D0, 1):
        t, span = levels[-1], 2 ** (len(levels) - 1)
        levels.append(np.minimum(t, np.concatenate([t[span:], np.full(span, _SENT)])))
    ah = np.arange(nhead)
    mids = []
    for ln in (D0 - 1, D0):
        if ln >= 1:
            k = ln.bit_length() - 1
            mids.append(np.minimum(levels[k][ah + 1], levels[k][ah + 1 + ln - 2 ** k]))
        else:
            mids.append(np.full(nhead, _SENT))
    mid0, mid1 = mids

    p = np.arange(min(tile, L - t0))
    Mm1, Mp, M2, La = headM[p], headM[p + 1], headM[p + 2], tailM[p + 1]
    if W2 >= 1:
        a, r = (p + 2) // R, (p + 2) % R
        C1 = np.minimum(np.minimum(headS[p + 2], np.where(r + dm >= R, mid1[a], mid0[a])), tailP[p])
        a3, r3 = np.where(r == R - 1, a + 1, a), np.where(r == R - 1, 0, r + 1)
        C3 = np.minimum(np.minimum(headS[p + 3], np.where(r3 + dm >= R, mid1[a3], mid0[a3])), tailP[p + 1])
    else:
        C1 = C3 = np.full(len(p), _SENT)
    Bq1 = np.minimum(Mp, C1) if q >= 2 else np.full(len(p), _SENT)
    D = np.minimum(M2, C3) if q >= 2 else np.full(len(p), _SENT)
    noN = np.maximum(excl[(p + w) // R], tailLB[p]) < p + 1
    code_pw = row[t0 + p + w + 1]
    open_ = (Mp != _SENT) & (Mp <= D) & noN & (code_pw != 4)
    case2 = (La <= Mm1) & (La <= Bq1)
    case3 = ~case2 & (Mm1 <= Bq1) & (Mm1 != _SENT) & ((La < Bq1) | ((Mp == La) & (Mp <= C1)))
    close_ = (La != _SENT) & noN & (case2 | case3)
    return np.where(open_ != close_, np.where(open_, 1, 2), 0).astype(np.int32)


def _model(cp, w, s, tile, R, ref=None, max_tiles=None):
    """The model's codes [B, L]; with ``ref`` and ``max_tiles``, only the
    tiles that hold a selection of ``ref``, the first and the last tile
    and a few others are computed (elsewhere ``ref`` is copied)."""
    W2 = w - s - 1
    assert W2 < 1 or 1 <= R <= W2, "the run decomposition is exact only for R <= W2"
    B, Lp = cp.shape
    L = Lp - w - 3
    out = np.zeros((B, L), np.int32) if ref is None else ref.copy()
    starts = list(range(0, L, tile))
    for b in range(B):
        t0s = starts
        if max_tiles is not None and len(starts) > max_tiles:
            hit = sorted(set((np.flatnonzero(ref[b]) // tile * tile).tolist()))
            rest = np.random.default_rng(b).choice(starts, max_tiles, replace=False)
            t0s = sorted(set(hit + [0, starts[-1]] + rest.tolist()))
        for t0 in t0s:
            out[b, t0:t0 + tile] = _model_tile(cp[b], Lp, L, w, s, tile, R, t0)
    return out


def _other_r(R, w, s):
    """A second run length for the model: W2 itself (runs as long as
    the window) where that differs, else a shorter or longer one."""
    W2 = w - s - 1
    if W2 < 1:
        return R + 3
    return W2 if W2 != R else max(1, R // 2)


@pytest.mark.parametrize("which_r", ["wrapper", "other"])
@pytest.mark.parametrize("tile", [64, 2816])  # 2816: the card's tile at k=1001
@pytest.mark.parametrize("w,s", CASES + LARGE)
def test_model_of_kernel_matches_plain(w, s, tile, which_r):
    """The kernel's decomposition, modelled on the CPU, equals the plain
    version exactly: rows shorter than w+4, rows that end inside a tile,
    a last tile past L, head and tail windows that overlap (w < tile)."""
    R = SS.run_length(tile, w, s)
    if which_r == "other":
        R = _other_r(R, w, s)
    rng = np.random.default_rng(4000 + w + tile)
    q = w - s + 1
    L = w + 6 * q + 2 * tile + 37 if w > tile else 2 * tile + 37 + 3 * w
    cp = _codes(rng, 2 if w > 5000 else 3, L, w)
    ref = SS.syncmer_select_plain(torch.from_numpy(cp), w, s).numpy()
    got = _model(cp, w, s, tile, R, ref=ref, max_tiles=40) if w > 5000 else _model(cp, w, s, tile, R)
    assert np.array_equal(got, ref)
    assert (ref != 0).any()


@pytest.mark.parametrize("w,s", [(15, 5), (51, 11), (1001, 31), (32, 31)])
def test_model_of_kernel_dense_ns(w, s):
    """Ns dense enough to cut most windows."""
    rng = np.random.default_rng(5000 + w)
    cp = _codes(rng, 4, 3 * w + 300, w, n_rate=0.3 / s)
    ref = SS.syncmer_select_plain(torch.from_numpy(cp), w, s).numpy()
    for tile in (64, 512):
        R = SS.run_length(tile, w, s)
        for r in (R, _other_r(R, w, s)):
            assert np.array_equal(_model(cp, w, s, tile, r), ref), (tile, r)


@pytest.mark.parametrize("R", [1, 7, 12, 87, 255, 256, 300, 4000])
def test_run_index_advance(R):
    """The rules loop advances x = p+2 and p+w to their run and offset by
    THREADS positions without division, as the kernel does."""
    T = SS.THREADS
    Qs, Rs = T // R, T % R
    for w in (1, 15, 1001, 20001):
        for tid in (0, 1, 37, T - 1):
            a, r = (tid + 2) // R, (tid + 2) % R
            al, rl = (tid + w) // R, (tid + w) % R
            for p in range(tid, 5000, T):
                assert (a, r) == divmod(p + 2, R) and (al, rl) == divmod(p + w, R)
                a, r = a + Qs, r + Rs
                if r >= R:
                    a, r = a + 1, r - R
                al, rl = al + Qs, rl + Rs
                if rl >= R:
                    al, rl = al + 1, rl - R


@pytest.mark.parametrize("w,s", CASES + LARGE)
def test_run_table_is_bounded(w, s):
    """The wrapper's run length keeps the run table near THREADS entries
    (the shared memory does not grow with w) and R <= W2."""
    for tile in (64, 2048, 2816, 4096):
        R = SS.run_length(tile, w, s)
        nr = -(-(tile + w + 4) // R)
        W2 = w - s - 1
        assert R >= 1 and (W2 < 1 or R <= W2)
        assert nr <= SS.THREADS or R == W2
