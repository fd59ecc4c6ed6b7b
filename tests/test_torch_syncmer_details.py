"""The extraction chain around the selection kernel in oatk_tpu_torch
(kernels/syncmer_details.py): the blob decode (K3d) and the ordered
compaction with the per-selected details (K4).

- The plain versions, chained with the selection kernel's plain version,
  against the JAX package's extract_hoco_fused_pallas (Pallas in
  interpret mode) on the same seeded blobs.  Tolerance: exact, over the
  whole packed array; the JAX program leaves the payload and hash of its
  lanes past n_sel unmasked, so those lanes are zeroed on its side first.
- A numpy model of csrc/syncmer_details.cu's index arithmetic (the
  decode's two aligned word loads and byte masks across row ends; K4's
  row-aligned tiles, in-warp ballot ranks, the decoupled look-back with
  its row prefix run with the tiles' steps in a shuffled order, the
  per-lane Murmur blocks read as aligned words from both ends of the
  window, the warp's strides of 32 blocks, and the lanes K4 writes on
  the packed and the key route, those past n_sel included) against the
  plain versions.
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
# Test code only: it computes what csrc/syncmer_details.cu computes the way
# the kernels do (the decode's word loads and byte masks across row ends;
# K4's row-aligned tiles, ballot ranks, decoupled look-back with its row
# prefix, the per-lane Murmur blocks and the lanes it writes on both
# routes), so that the kernels' arithmetic is checked here against the
# plain versions.

_THREADS, _ROUNDS = 256, 8
_WARPS = _THREADS // 32
_TILE = _WARPS * 32 * 4 * _ROUNDS  # 8192 sel entries per tile
_M = np.uint64(0xC6A4A7935BD1E995)
_U32 = np.uint64(0xFFFFFFFF)
_W32, _W64 = 0xFFFFFFFF, (1 << 64) - 1
_AGG_SHIFT = 47
_INCL_MASK = (1 << _AGG_SHIFT) - 1
_FLAG_AGG, _FLAG_INCL = 1 << 62, 2 << 62


def _spread4(bb):
    return ((bb >> 6) | (bb << 4) | (bb << 14) | (bb << 24)) & 0x03030303


def _byte_mask(nib):
    return (((nib * 0x00204081) & 0x01010101) * 0xFF) & _W32


def _word(blob, a):
    assert a % 4 == 0 and 0 <= a and a + 4 <= len(blob), "word outside the blob"
    return int.from_bytes(blob[a:a + 4].tobytes(), "little")


def _decode_segment(src, at0, h, c0, t0, t1, word):
    """decode_segment: bytes t0 <= t < t1 of a chunk are columns c0 + t - t0
    of a row whose bases start at byte at0 of src; the bases from two
    aligned words, byte-swapped and shifted."""
    p0 = c0 - 1 - t0
    lo, hi = max(t0, -p0), min(t1, h - p0)
    z = 0
    if lo < hi:
        at = at0 + ((p0 + lo) >> 2)
        a0 = at & ~3
        x = (int.from_bytes(_word(src, a0).to_bytes(4, "little"), "big") << 32) | int.from_bytes(
            _word(src, a0 + 4).to_bytes(4, "little"), "big")
        u0 = 4 * (at - a0) + ((p0 + lo) & 3)
        z = (((x << (2 * u0)) & _W64) >> (2 * lo)) >> 32
    seg = ((1 << t1) - 1) & ~((1 << t0) - 1)
    bas = ((1 << hi) - 1) & ~((1 << lo) - 1) if lo < hi else 0
    for k in range(4):
        codes = _spread4((z >> (24 - 8 * k)) & 0xFF)
        mb = _byte_mask((bas >> (4 * k)) & 0xF)
        ms = _byte_mask((seg >> (4 * k)) & 0xF)
        word[k] = (word[k] & ~ms & _W32) | (ms & ((codes & mb) | (0x05050505 & ~mb & _W32)))


def _model_gather(src, row_start, hl, buckets, n32, n64, w, per=16):
    """blob_decode_kernel (per bucket, row b0 writes the 16-byte chunks of
    the bucket's flat output that start in it, one segment per row a chunk
    touches), then blob_n_scatter_kernel; outputs laid out as
    syncmer_details.rows_layout says.  Returns each bucket's [B, Wd]."""
    offs, size = SD.rows_layout(buckets, w)
    out = np.full(size, 255, np.uint8)
    written = np.zeros(size, np.int64)
    for (row0, B, Lp), o in zip(buckets, offs):
        Wd = 1 + Lp + w + 2
        total = B * Wd
        for b0 in range(B):
            r0 = b0 * Wd
            for f0 in range(-(-r0 // per) * per, r0 + Wd, per):
                nb = min(per, total - f0)
                word = [0, 0, 0, 0]
                b, c, t = b0, f0 - r0, 0
                while t < nb:
                    ln = min(nb - t, Wd - c)
                    r = row0 + b
                    _decode_segment(src, int(row_start(r, Lp)), min(int(hl[r]), Lp), c, t, t + ln, word)
                    t, b, c = t + ln, b + 1, 0
                for t in range(nb):
                    out[o + f0 + t] = (word[t >> 2] >> (8 * (t & 3))) & 0xFF
                    written[o + f0 + t] += 1
        assert (written[o:o + total] == 1).all()  # every byte once
    for v in (n32 if n32 is not None else n64):
        if v < 0:
            continue
        r, p = (v // buckets[0][2], v % buckets[0][2]) if n32 is not None else (v >> 32, v & 0xFFFFFFFF)
        for (row0, B, Lp), o in zip(buckets, offs):
            if row0 <= r < row0 + B:
                if p < Lp:
                    out[o + (r - row0) * (1 + Lp + w + 2) + 1 + p] = 4
                break
    return [out[o:o + B * (1 + Lp + w + 2)].reshape(B, -1) for o, (_r, B, Lp) in zip(offs, buckets)]


def _model_decode(blob, B, Lp, n_cap, w):
    """The kernels on the packed route's blob: row r at r*Lp/4, one bucket."""
    hl = blob[B * Lp // 4: B * Lp // 4 + 4 * B].view(np.int32)
    n32 = blob[B * Lp // 4 + 4 * B: B * Lp // 4 + 4 * B + 4 * n_cap].view(np.int32)
    return _model_gather(blob, lambda r, lp: r * (lp // 4), hl, [(0, B, Lp)], n32, None, w)[0]


@pytest.mark.parametrize("B,Lp,w", [(1, 16, 15), (3, 64, 18), (5, 48, 33), (2, 32, 20), (8, 4, 1)])
def test_model_of_decode_matches_plain(B, Lp, w):
    """Row widths 1+Lp+w+2 of every residue mod 4, and one below 16, so
    that a thread's bytes cross one or two row ends at every offset."""
    blob, n_cap = _blob(np.random.default_rng(B * Lp + w), B, Lp, min(w, Lp - 4), n_rate=0.05)
    ref = SD.decode_blob_plain(torch.from_numpy(blob), B, Lp, n_cap, w).numpy()
    assert np.array_equal(_model_decode(blob, B, Lp, n_cap, w), ref)


def _unit(rng, lens, w, n_at=(), tail=16):
    """A unit as the loader's key route lays it out (asm/reads.py:
    _pack_stream): random reads of hoco lengths ``lens`` parsed into one
    segment with Ns at the (read, position) pairs ``n_at``, packed into the
    stream, rows ordered by length bucket.  Returns (stream, row_off, hl,
    buckets, n_rows, codes per read, N positions per read)."""
    from oatk_tpu_torch.asm.reads import _pack_stream

    codes = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    isn = np.array(sorted(int(offs[i]) + p for i, p in n_at), np.int64)
    res = (None, None, offs, np.concatenate(codes + [np.zeros(0, np.uint8)]), None, isn)
    sg = _pack_stream(res, w)
    assert len(sg.stream) == 16 * (sum(-(-n // 64) for n in lens) + 1)
    assert not sg.stream[len(sg.stream) - tail:].any() and (sg.row_off % 16 == 0).all()
    order = np.argsort(sg.lp, kind="stable")
    inv = np.empty(len(lens), np.int64)
    inv[order] = np.arange(len(lens))
    n_rows = (inv[sg.n_rows >> 32] << 32) | (sg.n_rows & 0xFFFFFFFF)
    lp = sg.lp[order]
    edges = np.flatnonzero(np.diff(lp)) + 1
    buckets = [(int(a), int(b - a), int(lp[a])) for a, b in zip(np.append(0, edges), np.append(edges, len(lens)))]
    per_read_n = [[p for i2, p in n_at if i2 == i] for i in range(len(lens))]
    return (sg.stream, sg.row_off[order], sg.hl[order], buckets, n_rows,
            [codes[i] for i in order], [per_read_n[i] for i in order])


# hoco lengths across the bucket edges (512, 1024, 2048, 4096, 6144), one
# of exactly its Lp, reads shorter than w+4, an empty read
UNIT_LENS = [513, 512, 3, 0, 1024, 1025, 54, 4096, 4097, 6144, 2047, 2049, 700, 55]


@pytest.mark.parametrize("w", [51, 15])
@pytest.mark.parametrize("lens", [UNIT_LENS, [77], [4096]])
def test_decode_rows_plain_matches_blob(w, lens):
    """The row gather's plain version equals decode_blob_plain on the same
    reads laid out as each bucket's padded blob: Ns at a read's first and
    last base, lengths across bucket edges, a read of exactly Lp, reads
    shorter than w+4, a unit of one read."""
    rng = np.random.default_rng(len(lens) * 100 + w)
    n_at = [(i, p) for i, n in enumerate(lens) if n for p in sorted({0, n - 1, n // 3})]
    stream, row_off, hl, buckets, n_rows, codes, n_pos = _unit(rng, lens, w, n_at)
    got = SD.decode_rows_plain(torch.from_numpy(stream), torch.from_numpy(row_off),
                               torch.from_numpy(hl), buckets, torch.from_numpy(n_rows), w)
    assert len(got) == len(buckets) == len({b[2] for b in buckets})
    for (row0, B, Lp), cp in zip(buckets, got):
        blob, packed, hl_v, n_cap = chunk_blob(
            B, Lp, np.array([b * Lp + p for b in range(B) for p in n_pos[row0 + b]], np.int64))
        for b in range(B):
            c = codes[row0 + b]
            packed[b, :(len(c) + 3) // 4] = pack_hoco(c)
            hl_v[b] = len(c)
        want = SD.decode_blob_plain(torch.from_numpy(blob), B, Lp, n_cap, w)
        assert torch.equal(cp, want), (row0, B, Lp)
        body = cp[:, 1:1 + Lp].numpy()
        for b in range(B):
            assert (body[b, n_pos[row0 + b]] == 4).all()


@pytest.mark.parametrize("w", [51, 15, 1001])
def test_model_of_decode_rows_matches_plain(w):
    """The kernels' index arithmetic on the loader's stream: rows at their
    16-aligned offsets, several buckets in one launch, N entries of every
    bucket; every word they load lies inside the stream."""
    rng = np.random.default_rng(w)
    lens = [int(n) for n in rng.integers(0, 700, 9)] + [3, 64, 65, 512, 513]
    n_at = [(i, int(p)) for i, n in enumerate(lens) if n > 3 for p in rng.integers(0, n, 2)]
    stream, row_off, hl, buckets, n_rows, _c, _n = _unit(rng, lens, w, n_at)
    stream = stream.copy()
    want = SD.decode_rows_plain(torch.from_numpy(stream), torch.from_numpy(row_off),
                                torch.from_numpy(hl), buckets, torch.from_numpy(n_rows), w)
    got = _model_gather(stream, lambda r, lp: row_off[r], hl, buckets, None, n_rows, w)
    for g, ww in zip(got, want):
        assert np.array_equal(g, ww.numpy())


def test_decode_rows_wrapper():
    """On the CPU the row gather takes the plain version and launches
    nothing; its checks refuse bad tables."""
    rng = np.random.default_rng(3)
    stream, row_off, hl, buckets, n_rows, _c, _n = _unit(rng, [600, 1500, 90], 51, [(1, 7)])
    args = [torch.from_numpy(a) for a in (stream, row_off, hl)]
    nr = torch.from_numpy(n_rows)
    before = SD.decode_rows.launches
    got = SD.decode_rows(*args, buckets, nr, 51)
    want = SD.decode_rows_plain(*args, buckets, nr, 51)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and SD.decode_rows.launches == before
    offs, size = SD.rows_layout(buckets, 51)
    assert offs[0] == 0 and all(o % 16 == 0 for o in offs) and size >= sum(c.numel() for c in got)
    with pytest.raises(TypeError):
        SD.decode_rows(args[0].int(), *args[1:], buckets, nr, 51)  # stream not uint8
    with pytest.raises(TypeError):
        SD.decode_rows(args[0], args[1].int(), args[2], buckets, nr, 51)  # row_off not int64
    with pytest.raises(TypeError):
        SD.decode_rows(*args, buckets, nr.int(), 51)  # N entries not int64
    with pytest.raises(ValueError):
        SD.decode_rows(args[0], args[1][:2], args[2], buckets, nr, 51)  # tables of two lengths
    with pytest.raises(ValueError):
        SD.decode_rows(*args, [(2, 2, 512)], nr, 51)  # rows past the table
    with pytest.raises(ValueError):
        SD.decode_rows(*args, [(0, 1, 514)], nr, 51)  # Lp not a multiple of 4
    with pytest.raises(ValueError):  # neither CPU nor CUDA: refused, never computed
        SD.decode_rows(*(a.to("meta") for a in args), buckets, nr.to("meta"), 51)


def _tile_ranks(codes):
    """The block-local rank of each nonzero of a tile (warp wid owns codes
    1024 wid + 128 r + 4 lane + c): the warps before, the rounds before,
    the round's warp scan of the lanes' counts (inclusive, less the
    lane's own), and the lane's own codes before c."""
    nz = codes.reshape(_WARPS, _ROUNDS, 32, 4) != 0
    per_warp = nz.sum((1, 2, 3))
    per_round = nz.sum((2, 3))
    at = (np.cumsum(per_warp) - per_warp)[:, None] + np.cumsum(per_round, 1) - per_round
    lane_cnt = nz.sum(3)
    below = np.cumsum(lane_cnt, 2) - lane_cnt
    own = np.cumsum(nz, 3) - nz
    rank = at[:, :, None, None] + below[:, :, :, None] + own
    return nz.reshape(-1), rank.reshape(-1), int(nz.sum())


def _look_back(status, t, row_first):
    """look_back: windows of 32 status words, nearest first; yields while a
    word it needs is not yet published (the warp reads the window again),
    returns (g, r)."""
    g = r = 0
    done = False
    hi = t - 1
    span = 32
    while not done or hi >= row_first:
        js = [hi - q for q in range(span)]
        words = [status[j] if j >= 0 and (not done or j >= row_first) else _FLAG_INCL for j in js]
        if any(wd >> 62 == 0 for wd in words):
            yield
            continue
        aggs = [(wd >> _AGG_SHIFT) & 0x7FFF for wd in words]
        if not done:
            incl = [q for q in range(span) if words[q] >> 62 == 2]
            f = incl[0] if incl else span
            g += sum(aggs[:f]) + (words[f] & _INCL_MASK if incl else 0)
            done = bool(incl)
        r += sum(a for j, a in zip(js, aggs) if j >= row_first)
        hi -= span
    return g, r


def _model_tiles(sel, rng, tile=_TILE):
    """sel_tiles_kernel's compaction: tiles that never straddle a row, taken
    in ticket order, each publishing its aggregate, looking back and
    publishing its inclusive prefix, their steps interleaved at random.
    Returns (j, b, p, code, idx) of every selection and n_sel."""
    B, L = sel.shape
    tpr = -(-L // tile)
    n_tiles = B * tpr
    status = [0] * n_tiles
    found = []

    def run(t):
        b = t // tpr
        row_first = b * tpr
        p_lo = (t - row_first) * tile
        codes = np.zeros(tile, np.int64)
        part = sel[b, p_lo:min(L, p_lo + tile)]
        codes[:len(part)] = part
        nz, rank, agg = _tile_ranks(codes) if tile == _TILE else _flat_ranks(codes)
        g = r = 0
        if t > 0:
            status[t] = _FLAG_AGG | (agg << _AGG_SHIFT)
            yield
            g, r = yield from _look_back(status, t, row_first)
        status[t] = _FLAG_INCL | (agg << _AGG_SHIFT) | (g + agg)
        k = np.flatnonzero(nz)
        assert (k < 1 << 14).all()  # the shared list's 16-bit entries: column << 2 | code
        found.append((g + rank[k], np.full(len(k), b), p_lo + k, codes[k], r + rank[k]))

    live, started = {}, 0
    while started < n_tiles or live:
        if started < n_tiles and (not live or rng.random() < 0.3):
            live[started] = run(started)  # the next ticket
            started += 1
            continue
        t = int(rng.choice(list(live)))
        try:
            next(live[t])
        except StopIteration:
            del live[t]
    n_sel = status[-1] & _INCL_MASK if n_tiles else 0
    cols = [np.concatenate(c) for c in zip(*found)]
    order = np.argsort(cols[0])
    assert np.array_equal(cols[0][order], np.arange(n_sel))  # every selection one lane
    return [c[order] for c in cols], n_sel


def _flat_ranks(codes):
    """Ranks of a tile of another size (the look-back tests): ascending."""
    nz = codes != 0
    return nz, np.cumsum(nz) - nz, int(nz.sum())


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


def _model_details(cp, b, p, oc, w, s):
    """window_details of each selected window (row b, column p, code oc):
    the s-mer payload by an OR over s lanes, Murmur over the lanes' blocks
    in strides of 32.  Returns (z, payload, hash) as uint64 arrays."""
    B, Wd = cp.shape
    mem = np.zeros(-(-cp.size // 512) * 512, np.uint8)  # the allocation's 512 B granules
    mem[:cp.size] = cp.reshape(-1)
    mem[cp.size:] = np.random.default_rng(0).integers(0, 256, len(mem) - cp.size)  # slack
    q = w - s + 1
    begin = b * Wd + 1 + p
    u = np.uint64
    f = np.zeros(len(b), u)
    r = np.zeros(len(b), u)
    for lane in range(s):
        c = (mem[begin + np.where(oc == 1, 0, q - 1) + lane] & 3).astype(u)
        f |= c << u(2 * (s - 1 - lane))
        r |= (u(3) - c) << u(2 * lane)
    z = f > r
    payload = (np.minimum(f, r) << u(1)) | z.astype(u)
    payload = np.where(oc == 2, payload ^ u(1), payload)

    n_bytes = (w - 1) // 4 + 1
    n_full, nblk = n_bytes >> 3, -(-n_bytes // 8)
    h = np.full(len(b), u(1234) ^ (u(n_bytes) * _M), u)
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
    return z.astype(u), payload, h


def _model_lanes(cp, sel, w, s, max_out, seed):
    """The selections (tiles, look-back) and their details below max_out,
    the tail blocks' lanes from n = min(n_sel, max_out) to max_out (each
    lane written once); returns (selections, details, n_sel, n)."""
    (j, b, p, oc, idx), n_sel = _model_tiles(sel, np.random.default_rng(seed))
    n = min(n_sel, max_out)
    nt = _THREADS
    z_count = min(max(-(-max_out // (8 * nt)), 1), 264)  # tail blocks
    tail = np.concatenate([np.arange(n + zb * nt + t, max_out, z_count * nt)
                           for zb in range(z_count) for t in range(nt)] + [np.zeros(0, int)])
    assert np.array_equal(np.sort(tail), np.arange(n, max_out))
    sl = slice(0, n)
    with np.errstate(over="ignore"):
        det = _model_details(cp, b[sl], p[sl], oc[sl], w, s)
    return (b[sl], p[sl], idx[sl]), det, n_sel, n


def _model(cp, sel, w, s, max_out, seed=0):
    """The packed result as K4 writes it."""
    B, L = sel.shape
    (b, p, _idx), (z, payload, h), n_sel, n = _model_lanes(cp, sel, w, s, max_out, seed)
    res = np.zeros((3, max_out + 1), np.int64)
    res[0, :n] = ((b * L + p) << 1) | z.astype(np.int64)
    res[1, :n] = payload.view(np.int64)
    res[2, :n] = h.view(np.int64)
    res[0, max_out] = n_sel
    return res


def _model_keys(cp, sel, w, s, max_out, sids, seed=0):
    """The five key lanes as K4's key epilogue writes them, and n_sel."""
    u = np.uint64
    (b, p, idx), (z, payload, h), n_sel, n = _model_lanes(cp, sel, w, s, max_out, seed)
    sids = sids.astype(u)
    bh = np.zeros(max_out, u)
    bl = np.zeros(max_out, u)
    bs = np.zeros(max_out, u)
    bm = np.zeros(max_out, np.int64)
    bv = np.ones(max_out, np.int32)
    bh[:n], bs[:n] = h, payload
    bl[:n] = (sids[np.minimum(b, len(sids) - 1)] << u(32)) | (idx.astype(u) << u(1)) | z
    bm[:n] = (p << 1) | z.astype(np.int64)
    bv[:n] = 0
    bl[n:] = (sids[0] << u(32)) | (np.arange(max_out - n, dtype=u) << u(1))
    return (bh.view(np.int64), bl.view(np.int64), bs.view(np.int64), bm, bv), n_sel


def _inputs(w, s, seed, B=3, n_rate=None, Lp=None, dense=False):
    rng = np.random.default_rng(seed)
    Lp = Lp or max(1024, -(-(4 * w + 600) // 16) * 16)
    blob, n_cap = _blob(rng, B, Lp, w, n_rate=0.3 / w if n_rate is None else n_rate, dense=dense)
    cp = SD.decode_blob_plain(torch.from_numpy(blob), B, Lp, n_cap, w)
    return cp, syncmer_select_plain(cp, w, s)


@pytest.mark.parametrize("w,s", CASES + LARGE)
def test_model_of_kernels_matches_plain(w, s):
    cp, sel = _inputs(w, s, 7000 + w)
    n = int((sel != 0).sum())
    assert n > 0
    for max_out in (n + 37, max(1, n // 2)):  # room to spare, and an overflow
        ref = SD.selected_details_plain(cp, sel, w, s, max_out).numpy()
        got = _model(cp.numpy(), sel.numpy(), w, s, max_out, seed=max_out)
        assert np.array_equal(got, ref), max_out


@pytest.mark.parametrize("w,s", [(15, 5), (51, 11), (33, 7)])
def test_model_of_kernels_dense_selections(w, s):
    """Near-periodic codes: most positions select, so tiles, warps and
    rounds hold many ranks each; rows of 5.25 tiles (L not a multiple of
    the tile), so every row's look-back crosses several tiles."""
    cp, sel = _inputs(w, s, w, B=3, n_rate=1e-3, Lp=21 * _TILE // 4, dense=True)
    B, L = sel.shape
    n = int((sel != 0).sum())
    assert n > B * L // 50 and L % _TILE
    for max_out in (n, n - 1, 4097):
        ref = SD.selected_details_plain(cp, sel, w, s, max_out).numpy()
        assert np.array_equal(_model(cp.numpy(), sel.numpy(), w, s, max_out, seed=max_out), ref), max_out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_look_back_in_any_order(seed):
    """The look-back over tiles of 64 codes whose steps interleave at
    random: every selection gets its lane in ascending flat order and its
    rank within its row, with rows of many tiles (some with none
    selected) and windows of 32 status words that mix aggregates and
    inclusive prefixes."""
    rng = np.random.default_rng(seed)
    B, L = 5, 64 * 70 + 17
    sel = np.where(rng.random((B, L)) < 0.05, rng.integers(1, 3, (B, L)), 0)
    sel[2] = 0  # a row with no selection
    sel[3, : 64 * 40] = 0  # a row whose first 40 tiles select nothing
    (j, b, p, oc, idx), n_sel = _model_tiles(sel, rng, tile=64)
    fb, fp = np.nonzero(sel)
    assert n_sel == len(fb)
    assert np.array_equal(b, fb) and np.array_equal(p, fp) and np.array_equal(oc, sel[fb, fp])
    first = np.searchsorted(fb, fb)
    assert np.array_equal(idx, np.arange(len(fb)) - first)


def _model_tail_blocks(status, n_tiles, max_out, Z, rng, late, nt=8):
    """sel_tiles_kernel's tail blocks once every tile has published, their
    steps interleaved at random and block ``late`` started after all the
    others have finished: each reads n_sel from the last tile's word,
    writes its lanes from min(n_sel, max_out) on (``nt`` threads a block)
    and zeroes its share of the other status words; the last to finish
    zeroes the last tile's word and the counters.  Returns the n_sel each
    block read, how often each lane was written, the counters."""
    ctr = [n_tiles + Z, n_tiles, 0]
    read = [None] * Z
    writes = np.zeros(max_out, np.int64)

    def run(z):
        n_sel = status[n_tiles - 1] & _INCL_MASK if n_tiles else 0
        read[z] = n_sel
        yield
        n_eff = min(n_sel, max_out)
        for j in range(n_eff + z * nt, max_out, Z * nt):
            for t in range(nt):
                if j + t < max_out:
                    writes[j + t] += 1
        yield
        for i in range(z * nt, n_tiles - 1, Z * nt):
            for t in range(nt):
                if i + t < n_tiles - 1:
                    status[i + t] = 0
        yield
        ctr[2] += 1
        if ctr[2] == Z:
            if n_tiles:
                status[n_tiles - 1] = 0
            ctr[:] = [0, 0, 0]

    live = {z: run(z) for z in range(Z) if z != late}
    while live:
        z = int(rng.choice(list(live)))
        try:
            next(live[z])
        except StopIteration:
            del live[z]
    for _ in run(late):
        pass
    return read, writes, ctr


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_tiles,n_sel,max_out", [(1, 5, 40), (3, 70, 75), (40, 300, 1000),
                                                    (9, 600, 500), (0, 0, 64)])
def test_model_tail_blocks_read_n_sel_whatever_their_order(seed, n_tiles, n_sel, max_out):
    """Every tail block reads the exact n_sel, even one that starts after
    the others have zeroed their status words; the lanes from
    min(n_sel, max_out) to max_out are written once and no selected lane
    at all; the status words and counters end zero for the next call."""
    rng = np.random.default_rng(seed)
    Z = min(max(-(-max_out // (8 * 8)), 1), 264)
    status = [_FLAG_INCL | int(rng.integers(0, 1 << 20)) for _ in range(n_tiles)]
    if n_tiles:
        status[-1] = _FLAG_INCL | (7 << _AGG_SHIFT) | n_sel
    for late in {0, Z - 1, int(rng.integers(0, Z))}:
        st = list(status)
        read, writes, ctr = _model_tail_blocks(st, n_tiles, max_out, Z, rng, late)
        n = min(n_sel, max_out)
        assert read == [n_sel] * Z, late
        assert (writes[:n] == 0).all() and (writes[n:] == 1).all(), late
        assert st == [0] * n_tiles and ctr == [0, 0, 0], late


@pytest.mark.parametrize("w,s", [(15, 5), (51, 11), (1001, 31)])
def test_model_of_key_lanes_matches_plain(w, s):
    """The key epilogue: every lane of the five buffers, those past n
    included, equals the plain key route's, with room to spare and with
    an overflow."""
    cp, sel = _inputs(w, s, 8000 + w, B=4)
    B = sel.shape[0]
    n = int((sel != 0).sum())
    sids = np.array([7, 3, 11, 5], np.int64)[:B] + (1 << 30)
    for max_out in (n + 45, max(1, n // 3)):
        got, n_sel = _model_keys(cp.numpy(), sel.numpy(), w, s, max_out, sids, seed=max_out)
        bufs = _key_bufs(max_out + 10)
        ref_n = SD.selected_keys_plain(cp, sel, w, s, max_out, torch.from_numpy(sids), bufs, 10)
        assert n_sel == int(ref_n[0]) == n
        for g, r in zip(got, bufs):
            assert np.array_equal(g, r[10:].numpy()), max_out


def _key_bufs(n, device="cpu"):
    """Five key buffers filled with a marker, as a lane nobody wrote."""
    return tuple(torch.full((n,), 99, dtype=dt, device=device) for dt in (torch.int64,) * 4 + (torch.int32,))


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
@pytest.mark.parametrize("w", [51, 1001])
@pytest.mark.parametrize("lens", [UNIT_LENS, [77], [12001, 9000, 15000, 33]])
def test_cuda_decode_rows_matches_plain(w, lens):
    """The row gather on the card equals its plain version on the loader's
    streams, Ns included, with units of odd sizes; a launch of more
    buckets than one launch takes cuts them into launches."""
    _card()
    rng = np.random.default_rng(len(lens) + w)
    n_at = [(i, int(p)) for i, n in enumerate(lens) if n for p in {0, n - 1, n // 2}]
    for n_at_ in (n_at, []):
        stream, row_off, hl, buckets, n_rows, _c, _n = _unit(rng, lens, w, n_at_)
        args = [torch.from_numpy(a).cuda() for a in (stream, row_off, hl, n_rows)]
        before = SD.decode_rows.launches
        got = SD.decode_rows(*args[:3], buckets, args[3], w)
        torch.cuda.synchronize()
        assert SD.decode_rows.launches == before + (2 if n_at_ else 1)
        want = SD.decode_rows_plain(*args[:3], buckets, args[3], w)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    many = [(r, 1, 512) for r in range(36)]  # 36 buckets: two launches
    hl = torch.full((36,), 500, dtype=torch.int32, device="cuda")
    ro = torch.arange(36, device="cuda") * 128
    st = torch.from_numpy(np.random.default_rng(1).integers(0, 256, 36 * 128 + 16).astype(np.uint8)).cuda()
    nr = torch.tensor([(1 << 32) | 5, (33 << 32) | 499], device="cuda")
    got = SD.decode_rows(st, ro, hl, many, nr, 15)
    want = SD.decode_rows_plain(st, ro, hl, many, nr, 15)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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
@pytest.mark.parametrize("w,s,B,Lp,spare", [(15, 5, 200, 16384, 64), (1001, 31, 300, 15360, 4096)])
def test_cuda_every_selected_lane_stays_valid(w, s, B, Lp, spare):
    """K4 on the key route, launch after launch on one stream (the status
    words and counters reused): many tail blocks over few tiles, so a tail
    block often starts after the others have finished.  Every launch
    marks exactly n_sel lanes valid, and its lanes equal the first
    launch's."""
    _card()
    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select

    blob, n_cap = _blob(np.random.default_rng(B), B, Lp, w)
    cp = SD.decode_blob_plain(torch.from_numpy(blob), B, Lp, n_cap, w).cuda()
    sel = syncmer_select(cp, w, s)
    n = int((sel != 0).sum())
    max_out = n + spare
    sids = torch.arange(B, dtype=torch.int64, device="cuda")

    def bufs():
        return [torch.full((max_out,), -1, dtype=torch.int64, device="cuda") for _ in range(4)] + [
            torch.ones(max_out, dtype=torch.int32, device="cuda")]

    first = bufs()
    assert int(SD.selected_keys(cp, sel, w, s, max_out, sids, first, 0)[0]) == n
    keys = bufs()
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(2000):
        n_d = SD.selected_keys(cp, sel, w, s, max_out, sids, keys, 0)
        bad += ((keys[4] == 0).sum() != n_d[0]).to(torch.int64)
    assert int(bad) == 0
    assert all(torch.equal(a, b) for a, b in zip(keys, first))


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
