"""The extraction chain around the selection kernel in oatk_tpu_torch
(kernels/syncmer_details.py): the blob decode (K3d) and the ordered
compaction with the per-selected details (K4).

- The plain versions, chained with the selection kernel's plain version,
  against the JAX package's extract_hoco_fused_pallas (Pallas in
  interpret mode) on the same seeded blobs.  Tolerance: exact, over the
  whole packed array; the JAX program leaves the payload and hash of its
  lanes past n_sel unmasked, so those lanes are zeroed on its side first.
- A numpy model of csrc/syncmer_details.cu's index arithmetic (the
  decode's words across row ends, tile counts, the chunked exclusive
  scan, the in-warp ballot ranks, the per-lane Murmur blocks read as
  aligned words from both ends of the window, the warp's strides of 32
  blocks) against the plain version.
- The wrappers' contract, and ``cuda``-marked cases that hold the kernels
  against the plain versions on a card (skipped without one)."""
import numpy as np
import pytest
import torch

from oatk_tpu_torch.asm.reads import chunk_blob
from oatk_tpu_torch.kernels.oracle import pack_hoco
from oatk_tpu_torch.kernels import syncmer_details as SD
from oatk_tpu_torch.kernels.syncmer_select import syncmer_select_plain

# the main-path shapes, and w of every residue mod 4 (the CLI takes any
# k), with and without a Murmur tail block (n_bytes & 7)
CASES = [(15, 5), (51, 11), (151, 13), (1001, 31), (16, 5), (50, 11), (33, 7), (64, 13)]
LARGE = [(6001, 31), (20001, 31)]  # more than 32 Murmur blocks per window


def _blob(rng, B, Lp, w, n_rate=0.0, dense=False, n_cap=None):
    """packed | hoco lengths (i32) | N positions (i32, padded with the
    sentinel B*Lp): random or near-periodic codes, ragged read ends, Ns
    at n_rate (some past a read's end)."""
    if dense:
        codes = np.tile(rng.integers(0, 4, 7).astype(np.uint8), Lp // 7 + 1)[:Lp]
        codes = np.stack([np.roll(codes, 3 * b) for b in range(B)])
        codes[rng.random((B, Lp)) < 0.2] = rng.integers(0, 4)
    else:
        codes = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    hl = rng.integers(min(w + 4, Lp), Lp + 1, B)
    hl[0] = Lp
    blob, packed, hl_v, n_cap = chunk_blob(B, Lp, np.flatnonzero(rng.random(B * Lp) < n_rate), n_cap)
    hl_v[:] = hl
    packed[:] = np.stack([pack_hoco(codes[b]) for b in range(B)])
    return blob, n_cap


def _plain_chain(blob, B, Lp, n_cap, w, s, max_out):
    cp = SD.decode_blob_plain(torch.from_numpy(blob), B, Lp, n_cap, w)
    sel = syncmer_select_plain(cp, w, s)
    return cp, sel, SD.selected_details_plain(cp, sel, w, s, max_out)


def _jax_packed(blob, B, Lp, n_cap, w, s, max_out):
    import jax.numpy as jnp

    from oatk_tpu.kernels.syncmer import extract_hoco_fused_pallas

    out = extract_hoco_fused_pallas(jnp.asarray(blob), B, Lp, n_cap, w, s, max_out, interpret=True)
    ref = np.asarray(out["packed"]).copy()
    n = min(int(ref[0, max_out]), max_out)
    ref[1:, n:max_out] = 0  # the JAX program's invalid lanes keep their payload and hash
    return ref


@pytest.mark.parametrize("w,s", CASES)
@pytest.mark.parametrize("kind", ["n_free", "n_dense"])
def test_plain_chain_matches_jax(w, s, kind):
    rng = np.random.default_rng(100 * w + s + (kind == "n_dense"))
    B, Lp = 4, 2048 if w < 1000 else 4096
    blob, n_cap = _blob(rng, B, Lp, w, n_rate=0.0 if kind == "n_free" else 1.0 / w)
    assert (n_cap == 0) == (kind == "n_free")
    max_out = 2048
    ref = _jax_packed(blob, B, Lp, n_cap, w, s, max_out)
    got = _plain_chain(blob, B, Lp, n_cap, w, s, max_out)[2].numpy()
    assert 0 < int(got[0, max_out]) <= max_out
    assert np.array_equal(got, ref)


def test_plain_chain_overflow_matches_jax():
    """n_sel above max_out: the first max_out lanes are the first max_out
    selections of the exact run, the slot holds the exact n_sel."""
    rng = np.random.default_rng(4)
    B, Lp, w, s = 2, 1024, 15, 5
    blob, n_cap = _blob(rng, B, Lp, w, dense=True, n_rate=0.002)
    full = _jax_packed(blob, B, Lp, n_cap, w, s, 4096)
    n = int(full[0, 4096])
    assert n > 64
    got = _plain_chain(blob, B, Lp, n_cap, w, s, 64)[2].numpy()
    assert int(got[0, 64]) == n
    assert np.array_equal(got[:, :64], full[:, :64])
    assert not got[1:, 64].any()


def test_decode_plain_marks_ns_past_read_ends():
    """Every N position below B*Lp becomes 4, past a read's end too; the
    sentinel is dropped; column 0 and the pad columns hold 5."""
    rng = np.random.default_rng(8)
    B, Lp, w = 3, 512, 21
    blob, n_cap = _blob(rng, B, Lp, w, n_rate=0.01)
    cp = SD.decode_blob_plain(torch.from_numpy(blob), B, Lp, n_cap, w).numpy()
    hl = blob[B * Lp // 4: B * Lp // 4 + 4 * B].view(np.int32)
    n_pos = blob[B * Lp // 4 + 4 * B:].view(np.int32)
    assert cp.shape == (B, 1 + Lp + w + 2)
    assert (cp[:, 0] == 5).all() and (cp[:, 1 + Lp:] == 5).all()
    is_n = np.zeros(B * Lp, bool)
    is_n[n_pos[n_pos < B * Lp]] = True
    is_n = is_n.reshape(B, Lp)
    past = np.arange(Lp)[None, :] >= hl[:, None]
    body = cp[:, 1:1 + Lp]
    assert (body[is_n] == 4).all() and (body[past & ~is_n] == 5).all()
    assert (body[~past & ~is_n] < 4).all() and (is_n & past).any()


# --- a CPU model of the CUDA kernels' index arithmetic ---------------------
# Test code only: it computes the packed result the way
# csrc/syncmer_details.cu does, so that the kernels' tiles, scan, ranks and
# Murmur blocks are checked here against the plain version.

_THREADS, _ROUNDS = 256, 16
_TILE = _THREADS * _ROUNDS
_SCAN_THREADS, _SCAN_ITEMS = 1024, 8
_M = np.uint64(0xC6A4A7935BD1E995)
_U32 = np.uint64(0xFFFFFFFF)


def _model_decode(blob, B, Lp, n_cap, w, per=16):
    """blob_decode_kernel (row b0 writes the 16-byte chunks of the flat
    output that start in it; a chunk's bytes may run into the next rows),
    then blob_n_scatter_kernel."""
    Wd = 1 + Lp + w + 2
    total = B * Wd
    hl = blob[B * Lp // 4: B * Lp // 4 + 4 * B].view(np.int32)
    out = np.full(-(-total // per) * per, 255, np.uint8)
    written = np.zeros(len(out), np.int64)
    for b0 in range(B):
        r0 = b0 * Wd
        for f0 in range(-(-r0 // per) * per, r0 + Wd, per):
            b, c = b0, f0 - r0
            h = min(hl[b], Lp)
            for t in range(min(per, total - f0)):
                if c == Wd:
                    b, c = b + 1, 0
                    h = min(hl[b], Lp)
                p = c - 1
                v = 5
                if 0 <= p < h:
                    v = (blob[b * (Lp // 4) + (p >> 2)] >> (6 - 2 * (p & 3))) & 3
                out[f0 + t] = v
                written[f0 + t] += 1
                c += 1
    assert (written[:total] == 1).all()  # every byte once
    out = out[:total].reshape(B, Wd)
    for v in blob[B * Lp // 4 + 4 * B: B * Lp // 4 + 4 * B + 4 * n_cap].view(np.int32):
        if 0 <= v < B * Lp:
            out[v // Lp, 1 + v % Lp] = 4
    return out


@pytest.mark.parametrize("B,Lp,w", [(1, 16, 15), (3, 64, 18), (5, 48, 33), (2, 32, 20), (8, 4, 1)])
def test_model_of_decode_matches_plain(B, Lp, w):
    """Row widths 1+Lp+w+2 of every residue mod 4, and one below 16, so
    that a thread's bytes cross one or two row ends at every offset."""
    blob, n_cap = _blob(np.random.default_rng(B * Lp + w), B, Lp, min(w, Lp - 4), n_rate=0.05)
    ref = SD.decode_blob_plain(torch.from_numpy(blob), B, Lp, n_cap, w).numpy()
    assert np.array_equal(_model_decode(blob, B, Lp, n_cap, w), ref)


def _model_scan(cnt):
    """sel_scan_kernel: chunks of 1024 threads x 8 items, a warp scan of the
    threads' sums, a scan of the warps' sums, and the carry."""
    out = np.empty_like(cnt)
    carry = 0
    span = _SCAN_THREADS * _SCAN_ITEMS
    for base in range(0, len(cnt), span):
        v = np.zeros(span, np.int64)
        part = cnt[base:base + span]
        v[:len(part)] = part
        v = v.reshape(_SCAN_THREADS, _SCAN_ITEMS)
        local = v.sum(1)
        lw = local.reshape(32, 32)  # [warp, lane]
        incl = np.cumsum(lw, axis=1)
        wtot = incl[:, 31]
        wex = np.cumsum(wtot) - wtot
        run = (carry + wex[:, None] + incl - lw).reshape(-1)
        ex = run[:, None] + np.cumsum(v, axis=1) - v
        out[base:base + span] = ex.reshape(-1)[:len(part)]
        carry += int(wtot.sum())
    return out, carry


def _model_compact(sel_flat, max_out):
    """sel_count_kernel, sel_scan_kernel, sel_compact_kernel: rows 0 and 1 of the
    result below max_out, and the count slot."""
    n = len(sel_flat)
    n_tiles = -(-n // _TILE)
    pad = np.zeros(n_tiles * _TILE, np.int64)
    pad[:n] = sel_flat
    # sel_count_kernel: thread t of tile b reads entries b*TILE + r*THREADS + t
    cnt = (pad.reshape(n_tiles, _ROUNDS, _THREADS) != 0).sum((1, 2)).astype(np.int64)
    off, total = _model_scan(cnt)
    # sel_compact_kernel: warp wid of tile b owns entries b*TILE + wid*512 +
    # r*32 + lane, in that order
    nz = pad.reshape(n_tiles, _THREADS // 32, _ROUNDS, 32) != 0
    wcnt = nz.sum((2, 3))
    at_warp = off[:, None] + np.cumsum(wcnt, axis=1) - wcnt
    rcnt = nz.sum(3)
    at_round = at_warp[:, :, None] + np.cumsum(rcnt, axis=2) - rcnt
    below = np.cumsum(nz, axis=3) - nz  # popc(ballot & lanes below)
    j = (at_round[..., None] + below).reshape(-1)
    flat = np.arange(n_tiles * _TILE)
    keep = nz.reshape(-1) & (j < max_out)
    out = np.zeros((3, max_out + 1), np.int64)
    out[0, j[keep]] = flat[keep]
    out[1, j[keep]] = pad[keep]
    out[0, max_out] = total
    return out


def _load_codes32(mem, begin, w, lo):
    """load_codes32: the 32 codes at window offsets lo .. lo+31 as eight
    words, from the aligned words that overlap the window (each must lie
    inside the allocation), funnel-shifted to the start."""
    begin = begin.astype(np.int64)
    at = begin + lo
    a0 = at & ~np.int64(3)
    sh = ((at & 3) * 8).astype(np.uint64)
    wd = []
    for m in range(9):
        a = a0 + 4 * m
        ok = (a + 4 > begin) & (a < begin + w)
        assert ((a[ok] >= 0) & (a[ok] + 4 <= len(mem))).all(), "word outside the allocation"
        i = np.where(ok, a, 0)
        word = sum(mem[i + t].astype(np.uint64) << np.uint64(8 * t) for t in range(4))
        wd.append(np.where(ok, word, np.uint64(0)))
    return [((wd[j + 1] << np.uint64(32) | wd[j]) >> sh) & _U32 for j in range(8)]


def _valid_mask(nv):
    if nv >= 32:
        return np.uint64(0xFFFFFFFFFFFFFFFF)
    if nv <= 0:
        return np.uint64(0)
    full, part = nv >> 2, nv & 3
    m = (1 << (8 * full)) - 1
    if part:
        m |= ((0xFF << (8 - 2 * part)) & 0xFF) << (8 * full)
    return np.uint64(m)


def _window_block(mem, begin, w, i, rc):
    """window_block: Murmur block i of each window, forward or (where rc)
    of its reverse complement."""
    xf = _load_codes32(mem, begin, w, 32 * i)
    xr = _load_codes32(mem, begin, w, w - 32 * (i + 1))
    fwd = np.zeros(len(begin), np.uint64)
    rev = np.zeros(len(begin), np.uint64)
    for j in range(8):
        bf = (((xf[j] & np.uint64(0x03030303)) * np.uint64(0x40100401)) & _U32) >> np.uint64(24)
        br = ((((xr[7 - j] & np.uint64(0x03030303)) * np.uint64(0x01041040)) & _U32)
              >> np.uint64(24)) ^ np.uint64(0xFF)
        fwd |= bf << np.uint64(8 * j)
        rev |= br << np.uint64(8 * j)
    return np.where(rc, rev, fwd) & _valid_mask(w - 32 * i)


def _model_details(cp, out, L, w, s, max_out):
    """sel_details_kernel on the compacted rows: the s-mer payload by an OR
    over s lanes, Murmur over the lanes' blocks in strides of 32, tails
    zeroed."""
    B, Wd = cp.shape
    mem = np.zeros(-(-cp.size // 512) * 512, np.uint8)  # the allocation's 512 B granules
    mem[:cp.size] = cp.reshape(-1)
    mem[cp.size:] = np.random.default_rng(0).integers(0, 256, len(mem) - cp.size)  # slack
    q = w - s + 1
    n_eff = min(int(out[0, max_out]), max_out)
    flat, oc = out[0, :n_eff], out[1, :n_eff]
    b = flat // L
    begin = b * Wd + 1 + (flat - b * L)
    u = np.uint64
    f = np.zeros(n_eff, u)
    r = np.zeros(n_eff, u)
    for lane in range(s):
        c = (mem[begin + np.where(oc == 1, 0, q - 1) + lane] & 3).astype(u)
        f |= c << u(2 * (s - 1 - lane))
        r |= (u(3) - c) << u(2 * lane)
    z = f > r
    payload = (np.minimum(f, r) << u(1)) | z.astype(u)
    payload = np.where(oc == 2, payload ^ u(1), payload)

    n_bytes = (w - 1) // 4 + 1
    n_full, nblk = n_bytes >> 3, -(-n_bytes // 8)
    h = np.full(n_eff, u(1234) ^ (u(n_bytes) * _M), u)
    for g in range(0, nblk, 32):
        lanes = [g + lane for lane in range(32) if g + lane < nblk]
        v = [_window_block(mem, begin, w, i, z) for i in lanes]
        k = [(x * _M) for x in v]
        k = [(x ^ (x >> u(47))) * _M for x in k]
        for j, i in enumerate(lanes):
            h = (h ^ (k[j] if i < n_full else v[j])) * _M
    h ^= h >> u(47)
    h *= _M
    h ^= h >> u(47)

    res = np.zeros((3, max_out + 1), np.int64)
    res[0, :n_eff] = (flat << 1) | z
    res[1, :n_eff] = payload.view(np.int64)
    res[2, :n_eff] = h.view(np.int64)
    res[0, max_out] = out[0, max_out]
    return res


def _model(cp, sel, w, s, max_out):
    B, L = sel.shape
    with np.errstate(over="ignore"):
        return _model_details(cp, _model_compact(sel.reshape(-1), max_out), L, w, s, max_out)


def _inputs(w, s, seed, B=3, n_rate=None):
    rng = np.random.default_rng(seed)
    Lp = max(1024, -(-(4 * w + 600) // 16) * 16)
    blob, n_cap = _blob(rng, B, Lp, w, n_rate=0.3 / w if n_rate is None else n_rate)
    cp = SD.decode_blob_plain(torch.from_numpy(blob), B, Lp, n_cap, w)
    return cp, syncmer_select_plain(cp, w, s)


@pytest.mark.parametrize("w,s", CASES + LARGE)
def test_model_of_kernels_matches_plain(w, s):
    cp, sel = _inputs(w, s, 7000 + w)
    n = int((sel != 0).sum())
    assert n > 0
    for max_out in (n + 37, max(1, n // 2)):  # room to spare, and an overflow
        ref = SD.selected_details_plain(cp, sel, w, s, max_out).numpy()
        got = _model(cp.numpy(), sel.numpy(), w, s, max_out)
        assert np.array_equal(got, ref), max_out


@pytest.mark.parametrize("w,s", [(15, 5), (51, 11), (33, 7)])
def test_model_of_kernels_dense_selections(w, s):
    """Near-periodic codes: most positions select, so tiles, warps and
    rounds hold many ranks each."""
    rng = np.random.default_rng(w)
    B, Lp = 4, 8192
    blob, n_cap = _blob(rng, B, Lp, w, dense=True, n_rate=1e-3)
    cp = SD.decode_blob_plain(torch.from_numpy(blob), B, Lp, n_cap, w)
    sel = syncmer_select_plain(cp, w, s)
    n = int((sel != 0).sum())
    assert n > B * Lp // 50
    for max_out in (n, n - 1, 4097):
        ref = SD.selected_details_plain(cp, sel, w, s, max_out).numpy()
        assert np.array_equal(_model(cp.numpy(), sel.numpy(), w, s, max_out), ref), max_out


def test_model_scan_crosses_chunks():
    """More tile counts than one pass of the scan block takes (8,192):
    the carry joins the chunks."""
    cnt = np.random.default_rng(5).integers(0, 4097, 20_000).astype(np.int64)
    got, total = _model_scan(cnt)
    assert np.array_equal(got, np.cumsum(cnt) - cnt) and total == cnt.sum()


@pytest.mark.parametrize("w,s", CASES + LARGE)
def test_selected_windows_hold_bases_only(w, s):
    """The details read a window's codes straight from codes_padded (& 3):
    the selection kernel selects only windows whose w codes are all
    below 4, with Ns dense enough to cut many windows."""
    cp, sel = _inputs(w, s, 9000 + w, n_rate=1.0 / w)
    B, L = sel.shape
    b, p = np.nonzero(sel.numpy())
    assert len(b) > 0
    c = cp.numpy()
    worst = max(int(c[bi, 1 + pi:1 + pi + w].max()) for bi, pi in zip(b, p))
    assert worst < 4
    assert (c[:, 1:1 + L] == 4).sum() > B * L * 0.5 / w  # the Ns are there


# --- the wrappers' contract ---------------------------------------------------

def test_wrappers_take_plain_only_on_cpu():
    cp, sel = _inputs(51, 11, 11)
    before = (SD.decode_blob.launches, SD.selected_details.launches)
    got = SD.selected_details(cp, sel, 51, 11, 512)
    assert torch.equal(got, SD.selected_details_plain(cp, sel, 51, 11, 512))
    rng = np.random.default_rng(12)
    blob, n_cap = _blob(rng, 2, 1024, 51, n_rate=0.01)
    bt = torch.from_numpy(blob)
    assert torch.equal(SD.decode_blob(bt, 2, 1024, n_cap, 51), SD.decode_blob_plain(bt, 2, 1024, n_cap, 51))
    assert (SD.decode_blob.launches, SD.selected_details.launches) == before  # nothing launched
    with pytest.raises(ValueError):  # neither CPU nor CUDA: refused, never computed
        SD.selected_details(cp.to("meta"), sel.to("meta"), 51, 11, 512)
    with pytest.raises(ValueError):
        SD.decode_blob(bt.to("meta"), 2, 1024, n_cap, 51)


def test_wrapper_argument_checks():
    cp, sel = _inputs(51, 11, 13)
    B, L = sel.shape
    with pytest.raises(TypeError):
        SD.selected_details(cp.to(torch.int32), sel, 51, 11, 64)  # codes not uint8
    with pytest.raises(TypeError):
        SD.selected_details(cp, sel.long(), 51, 11, 64)  # sel not int32
    with pytest.raises(ValueError):
        SD.selected_details(cp[:, 1:], sel, 51, 11, 64)  # not [B, 1+L+w+2]
    with pytest.raises(ValueError):
        SD.selected_details(cp, sel, 51, 32, 64)  # s > 31
    with pytest.raises(ValueError):
        SD.selected_details(cp[0], sel, 51, 11, 64)  # not 2-D
    wide = torch.zeros((B, 2 * cp.shape[1]), dtype=torch.uint8)
    with pytest.raises(ValueError):
        SD.selected_details(wide[:, ::2], sel, 51, 11, 64)  # strided
    with pytest.raises(ValueError):
        SD.selected_details(cp, sel, 51, 11, -1)
    blob = torch.zeros(2 * 1024 // 4 + 8, dtype=torch.uint8)
    with pytest.raises(TypeError):
        SD.decode_blob(blob.to(torch.int32), 2, 1024, 0, 51)
    with pytest.raises(ValueError):
        SD.decode_blob(blob, 2, 1020, 0, 51)  # B*Lp/4 packed bytes not a multiple of 4
    with pytest.raises(ValueError):
        SD.decode_blob(blob, 2, 1024, 4, 51)  # shorter than its N slots
    with pytest.raises(ValueError):
        SD.decode_blob(torch.zeros(2 * blob.numel(), dtype=torch.uint8)[::2], 2, 1024, 0, 51)  # strided


# --- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("n_rate", [0.0, 1e-3, 0.05])
@pytest.mark.parametrize("B,Lp,w", [(1, 16, 15), (3, 1024, 51), (64, 2048, 1001), (5, 4112, 20001)])
def test_cuda_decode_matches_plain(B, Lp, w, n_rate):
    _card()
    blob, n_cap = _blob(np.random.default_rng(B * Lp + w), B, Lp, w, n_rate=n_rate)
    bt = torch.from_numpy(blob).cuda()
    before = SD.decode_blob.launches
    got = SD.decode_blob(bt, B, Lp, n_cap, w)
    torch.cuda.synchronize()
    assert SD.decode_blob.launches == before + (2 if n_cap else 1)
    assert torch.equal(got, SD.decode_blob_plain(bt, B, Lp, n_cap, w))


@pytest.mark.cuda
@pytest.mark.parametrize("w,s", CASES + LARGE)
def test_cuda_details_match_plain(w, s):
    _card()
    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select

    cp, _ = _inputs(w, s, 12000 + w, B=32 if w > 5000 else 8)
    cp = cp.cuda()
    sel = syncmer_select(cp, w, s)
    n = int((sel != 0).sum())
    assert n > 20
    for max_out in (n + 1000, n, n // 3, 0):
        before = SD.selected_details.launches
        got = SD.selected_details(cp, sel, w, s, max_out)
        torch.cuda.synchronize()
        assert SD.selected_details.launches == before + SD.DETAILS_LAUNCHES
        assert torch.equal(got, SD.selected_details_plain(cp, sel, w, s, max_out)), max_out


@pytest.mark.cuda
def test_cuda_chain_matches_cpu():
    """extract_hoco_fused on the card (K3d, K1, K4) equals its run on the
    CPU (the plain versions), with Ns and an overflow."""
    _card()
    from oatk_tpu_torch.kernels.syncmer import extract_hoco_fused

    B, Lp, w, s = 64, 4096, 1001, 31
    blob, n_cap = _blob(np.random.default_rng(77), B, Lp, w, n_rate=1e-3)
    for max_out in (8192, 64):
        cpu = extract_hoco_fused(torch.from_numpy(blob), B, Lp, n_cap, w, s, max_out)
        card = extract_hoco_fused(torch.from_numpy(blob).cuda(), B, Lp, n_cap, w, s, max_out)
        assert int(cpu[0, max_out]) > 64
        assert torch.equal(card.cpu(), cpu)
