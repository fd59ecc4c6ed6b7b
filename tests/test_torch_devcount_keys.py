"""The key route of oatk_tpu_torch: K4 writing the device count's five key
lanes itself (kernels/syncmer_details.py:selected_keys,
kernels/syncmer.py:extract_hoco_fused_keys, DevCountState.append as the
loader queues it through asm/reads.py:Uploads, and the loader's regrow
after the drain, asm/reads.py:_grow_if_overflow).

- The plain key route against the JAX package's per-chunk key decode
  (oatk_tpu/index/devcount.py keys_jit + write_jit, on the CPU with the
  Pallas chain in interpret mode) on the same seeded blobs: exact on every
  valid lane and on the invalid flag of every lane (the JAX program's
  invalid lanes keep the payload and hash it left there).
- The key route against index/devcount.py:chunk_keys of the packed
  route: exact on every lane, those past n_sel included, and nothing
  written outside the chunk's lanes.
- An overflow regrown after the drain (lanes invalidated, the chunk
  appended again at a new offset) and an invalidated chunk: the finalize
  equals the one over buffers that the packed route plus chunk_keys
  fills, exactly.
- ``cuda``-marked cases that hold the kernel against the plain version on
  a card (skipped without one)."""
import numpy as np
import pytest
import torch

from oatk_tpu_torch.asm import reads as R
from oatk_tpu_torch.asm.reads import chunk_blob
from oatk_tpu_torch.index import devcount as DC
from oatk_tpu_torch.kernels import syncmer_details as SD
from oatk_tpu_torch.kernels.oracle import pack_hoco
from oatk_tpu_torch.kernels.syncmer import extract_hoco_fused, extract_hoco_fused_keys
from oatk_tpu_torch.kernels.syncmer_select import syncmer_select_plain

DTYPES = (torch.int64,) * 4 + (torch.int32,)


def _blob(rng, B, Lp, w, n_rate=0.0, dense=False):
    """A loader blob: random or near-periodic codes, ragged read ends, Ns
    at n_rate; the last row empty, as the loader's padded rows are."""
    if dense:
        codes = np.tile(rng.integers(0, 4, 7).astype(np.uint8), Lp // 7 + 1)[:Lp]
        codes = np.stack([np.roll(codes, 3 * b) for b in range(B)])
        codes[rng.random((B, Lp)) < 0.2] = rng.integers(0, 4)
    else:
        codes = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    hl = rng.integers(min(w + 4, Lp), Lp + 1, B)
    hl[0] = Lp
    hl[-1] = 0
    blob, packed, hl_v, n_cap = chunk_blob(B, Lp, np.flatnonzero(rng.random(B * Lp) < n_rate))
    hl_v[:] = hl
    packed[:] = np.stack([pack_hoco(codes[b]) for b in range(B)])
    return blob, n_cap


def _bufs(n, fill=99, device="cpu"):
    return tuple(torch.full((n,), fill, dtype=dt, device=device) for dt in DTYPES)


@pytest.mark.parametrize("w,s", [(15, 5), (51, 11), (151, 13)])
def test_keys_plain_match_jax(w, s):
    import jax.numpy as jnp

    from oatk_tpu.index.devcount import _make_keys_jit, _make_write_jit
    from oatk_tpu.kernels.syncmer import extract_hoco_fused_pallas

    rng = np.random.default_rng(300 + w)
    B, Lp, off, room = 5, 2048, 37, 2048
    blob, n_cap = _blob(rng, B, Lp, w, n_rate=1.0 / w)
    sids = np.array([4, 9, 2, 30, 17], np.int64) + 1000
    # the JAX decode with room to spare (its compaction reports an
    # overflow's count inflated and fills its lanes otherwise: the exact
    # route's first max_out lanes are compared with its first max_out)
    packed = extract_hoco_fused_pallas(jnp.asarray(blob), B, Lp, n_cap, w, s, room,
                                       interpret=True)["packed"]
    nsel_j, *keys = _make_keys_jit()(packed, jnp.asarray(sids), Lp=Lp, out_cap=room)
    zero = [jnp.zeros(room, jnp.uint64) for _ in range(3)] + [jnp.zeros(room, jnp.uint32),
                                                              jnp.ones(room, jnp.int32)]
    ref = [np.asarray(x) for x in _make_write_jit()(*zero, *keys, np.int32(0))]
    n_ref = int(nsel_j[0])
    assert 1 < n_ref < room
    for max_out in (room, n_ref // 2):  # room to spare, and an overflow
        bufs = _bufs(off + max_out + 5)
        n_sel = extract_hoco_fused_keys(torch.from_numpy(blob), B, Lp, n_cap, w, s, max_out,
                                        torch.from_numpy(sids), bufs, off)
        assert int(n_sel[0]) == n_ref
        n = min(n_ref, max_out)
        lanes = slice(off, off + max_out)
        flags = bufs[4][lanes].numpy()
        assert np.array_equal(flags, ref[4][:max_out] if max_out == room else
                              (np.arange(max_out) >= n).astype(np.int32))  # every lane's flag
        for got, want in zip(bufs[:4], ref[:4]):  # hash, low, smer, m32 of the valid lanes
            assert np.array_equal(got[lanes].numpy()[:n].view(np.uint64), want[:n].astype(np.uint64))


@pytest.mark.parametrize("max_out", [4096, 100, 0])
def test_keys_match_chunk_keys(max_out):
    """Every lane of the chunk, those past n_sel included, equals
    chunk_keys of the packed route; the lanes around it are untouched."""
    rng = np.random.default_rng(max_out)
    B, Lp, w, s, off = 4, 4096, 51, 11, 123
    blob, n_cap = _blob(rng, B, Lp, w, n_rate=0.01)
    sids = torch.tensor([8, 1, 5, 3], dtype=torch.int64)
    bufs = _bufs(off + max_out + 77)
    n_sel = extract_hoco_fused_keys(torch.from_numpy(blob), B, Lp, n_cap, w, s, max_out, sids,
                                    bufs, off)
    packed = extract_hoco_fused(torch.from_numpy(blob), B, Lp, n_cap, w, s, max_out)
    assert int(n_sel[0]) == int(packed[0, max_out]) > 100
    for buf, want in zip(bufs, DC.chunk_keys(packed, sids, Lp)):
        assert torch.equal(buf[off:off + max_out], want.to(buf.dtype))
        assert (buf[:off] == 99).all() and (buf[off + max_out:] == 99).all()


def _state_by_packed_route(chunks, w, s):
    """Count buffers filled as the loader filled them before the key route:
    the packed result of each chunk (regrown in place) decoded by
    chunk_keys, one chunk after another.  Returns the state and each
    chunk's (offset, lanes)."""
    lanes, spans, n_occ = [], [], 0
    for blob, B, Lp, n_cap, max_out, sids in chunks:
        packed, n_sel, max_out = R.extract_chunk(blob, B, Lp, n_cap, w, s, max_out, "cpu")
        lanes.append(DC.chunk_keys(packed, torch.from_numpy(sids), Lp))
        spans.append((sum(n for _, n in spans), max_out))
        n_occ += n_sel
    cols = [torch.cat(c).numpy() for c in zip(*lanes)]
    st = DC.DevCountState.from_numpy(*(c.view(np.uint64) for c in cols[:3]), *cols[3:])
    assert st.n_occ == n_occ
    return st, spans


class _LoggedState(DC.DevCountState):
    """A DevCountState that logs each append's (offset, lanes)."""

    def __init__(self, device):
        super().__init__(device)
        self.log = []

    def append(self, *a):
        off, n_sel = super().append(*a)
        self.log.append((off, a[6]))
        return off, n_sel


def _state_by_key_route(chunks, w, s, device="cpu"):
    """The loader's key route: every chunk queued (upload, extraction,
    append) with no read, then one read of every n_sel and the regrow of
    the chunks that overflowed.  Returns the state, each chunk's final
    (offset, lanes) and the loader's counters."""
    st, up, pending = _LoggedState(device), R.Uploads(device), []
    for blob, B, Lp, n_cap, max_out, sids in chunks:
        blob_d, sids_d = up.put(blob, sids)
        off, n_d = st.append(blob_d, B, Lp, n_cap, w, s, max_out, sids_d)
        up.done()
        pending.append(R._Pending(lambda b=blob, c=n_cap: (b, c), B, Lp, max_out, off, sids, n_d))
    counters = dict(regrows=0, nsel_reads=1, host_rows=0)
    spans = list(st.log)
    for i, (pend, n_sel) in enumerate(zip(pending, torch.cat([p.n_sel for p in pending]).cpu().tolist())):
        n_log = len(st.log)
        st.n_occ += R._grow_if_overflow(st, up, pend, n_sel, w, s, counters)
        if len(st.log) > n_log:  # regrown: its last append holds its lanes
            spans[i] = st.log[-1]
    return st, spans, counters


def _chunks(seed, w):
    rng = np.random.default_rng(seed)
    out, sid = [], 0
    for B, Lp, max_out, dense in ((4, 2048, 2048, False), (3, 1024, 64, True), (6, 4096, 4096, False)):
        blob, n_cap = _blob(rng, B, Lp, w, n_rate=0.002, dense=dense)
        out.append((blob, B, Lp, n_cap, max_out, np.arange(sid, sid + B - 1, dtype=np.int64)))
        sid += B - 1
    return out


def test_overflow_retry_rewrites_the_same_lanes(monkeypatch):
    """A chunk that overflows twice (the first regrow clamped too small)
    has its lanes invalidated and is appended again at the end of the
    buffers each time, after the one drain; its last lanes equal the
    packed route's decode lane for lane, every other chunk's lanes stay
    where they were queued, and the finalize equals the packed route's."""
    w, s = 15, 5
    chunks = _chunks(5, w)
    ref, ref_spans = _state_by_packed_route(chunks, w, s)
    calls, clamps = [], []
    real_round_up = R._round_up

    def clamped(x, m):
        if not clamps:
            clamps.append(x)
            return 128
        return real_round_up(x, m)

    import oatk_tpu_torch.kernels.syncmer as K

    real_keys = K.extract_hoco_fused_keys

    def counting(*a):
        calls.append(a[6])
        return real_keys(*a)

    monkeypatch.setattr(R, "_round_up", clamped)
    monkeypatch.setattr(K, "extract_hoco_fused_keys", counting)
    st, spans, counters = _state_by_key_route(chunks, w, s)
    # three chunks queued, then the second regrown twice (64 -> 128 -> room)
    assert calls[:3] == [2048, 64, 4096] and calls[3] == 128 and calls[4] > 128 and len(calls) == 5
    assert counters == dict(regrows=2, nsel_reads=3, host_rows=3)  # its 3 rows laid out once
    assert st.n_append == 5 and st.n_invalidate == 2 and st.n_occ == ref.n_occ
    assert [n for _, n in spans] == [n for _, n in ref_spans]
    assert spans[1][0] == 2048 + 64 + 4096 + 128  # behind both abandoned attempts
    inv = st.bufs[4]
    assert (inv[2048:2048 + 64] == 1).all() and (inv[6208:6208 + 128] == 1).all()
    for (o, n), (ro, rn) in zip(spans, ref_spans):
        for a, b in zip(st.bufs, ref.bufs):
            assert torch.equal(a[o:o + n], b[ro:ro + rn])
    for a, b in zip(DC.finalize(*(b[:st.n_fill] for b in st.bufs)),
                    DC.finalize(*(b[:ref.n_fill] for b in ref.bufs))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("drop", [None, 1])
def test_finalize_equals_packed_route(drop):
    """The finalize over the key route's buffers equals the one over the
    packed route's, with and without a chunk invalidated afterwards (a
    discarded parse attempt)."""
    w, s = 51, 11
    chunks = _chunks(9, w)
    (a, spans_a), (b, spans_b, _c) = _state_by_packed_route(chunks, w, s), _state_by_key_route(chunks, w, s)
    assert [n for _, n in spans_a] == [n for _, n in spans_b]
    states = [a, b]
    if drop is not None:
        for st, spans in zip(states, (spans_a, spans_b)):
            st.invalidate(*spans[drop])
    finals = [DC.finalize(*(b[:st.n_fill] for b in st.bufs)) for st in states]
    assert int(finals[0][9][0]) > 0
    for a, b in zip(*finals):
        assert torch.equal(a, b)


def test_key_route_argument_checks():
    blob, n_cap = _blob(np.random.default_rng(3), 2, 1024, 51)
    cp = SD.decode_blob_plain(torch.from_numpy(blob), 2, 1024, n_cap, 51)
    sel = syncmer_select_plain(cp, 51, 11)
    sids = torch.tensor([0, 1])
    with pytest.raises(ValueError):
        SD.selected_keys(cp, sel, 51, 11, 64, sids, _bufs(32), 0)  # lanes past the buffers
    with pytest.raises(ValueError):
        SD.selected_keys(cp, sel, 51, 11, 64, sids.int(), _bufs(64), 0)  # sids not int64
    with pytest.raises(ValueError):
        SD.selected_keys(cp, sel, 51, 11, 64, sids[:0], _bufs(64), 0)  # no sids
    with pytest.raises(ValueError):
        SD.selected_keys(cp, sel, 51, 11, 64, sids, _bufs(64)[:4], 0)  # four buffers
    with pytest.raises(ValueError):
        SD.selected_keys(cp, sel, 51, 11, 64, sids, _bufs(64)[::-1], 0)  # wrong types
    with pytest.raises(ValueError):  # neither CPU nor CUDA: refused, never computed
        SD.selected_keys(cp.to("meta"), sel.to("meta"), 51, 11, 64, sids.to("meta"),
                         _bufs(64, device="meta"), 0)
    before = SD.selected_keys.launches
    SD.selected_keys(cp, sel, 51, 11, 64, sids, _bufs(64), 0)
    assert SD.selected_keys.launches == before  # the plain version launches nothing


# --- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("w,s,B,Lp", [(15, 5, 8, 4096), (51, 11, 16, 8192), (1001, 31, 64, 16384),
                                      (20001, 31, 8, 81920), (51, 11, 5, 21501)])
def test_cuda_keys_match_plain(w, s, B, Lp):
    """Every lane of the five buffers and n_sel, with room to spare, at
    n_sel, an overflow and max_out 0; rows of odd length (not a multiple
    of the tile or of 4) included."""
    _card()
    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select

    rng = np.random.default_rng(B * Lp + w)
    Lb = -(-Lp // 16) * 16
    blob, n_cap = _blob(rng, B, Lb, w, n_rate=0.3 / w, dense=w < 100)
    cp = SD.decode_blob(torch.from_numpy(blob).cuda(), B, Lb, n_cap, w)
    cp = cp[:, :1 + Lp + w + 2].contiguous() if Lp != Lb else cp
    sel = syncmer_select(cp, w, s)
    n = int((sel != 0).sum())
    assert n > 3
    sids = torch.arange(B, dtype=torch.int64, device="cuda") * 7 + 3
    for max_out in (n + 1000, n, n // 3, 0):
        off = 11
        got, want = _bufs(off + max_out + 9, device="cuda"), _bufs(off + max_out + 9, device="cuda")
        before = SD.selected_keys.launches
        n_got = SD.selected_keys(cp, sel, w, s, max_out, sids, got, off)
        torch.cuda.synchronize()
        assert SD.selected_keys.launches == before + SD.DETAILS_LAUNCHES
        n_want = SD.selected_keys_plain(cp, sel, w, s, max_out, sids, want, off)
        assert int(n_got[0]) == int(n_want[0]) == n
        for a, b in zip(got, want):
            assert torch.equal(a, b), max_out


@pytest.mark.cuda
def test_cuda_extract_chunk_key_route():
    """The loader's key route on the card (pinned uploads on the copy
    stream, an overflow regrown) equals its run on the CPU, buffer for
    buffer."""
    _card()
    w, s = 15, 5
    chunks = _chunks(21, w)
    cpu, spans, cc = _state_by_key_route(chunks, w, s)
    card, card_spans, kc = _state_by_key_route(chunks, w, s, device="cuda")
    assert cc["regrows"] > 0 and kc == cc
    assert card_spans == spans and card.n_fill == cpu.n_fill and card.n_occ == cpu.n_occ
    for a, b in zip(card.bufs, cpu.bufs):
        assert torch.equal(a[:card.n_fill].cpu(), b[:cpu.n_fill])
