"""Read database and syncmer extraction (PyTorch port of
``oatk_tpu/asm/reads.py``).

``ReadDB`` and the host helpers (segment parse + pack, sparse N
positions, row bucketing) are carried unchanged.  Every device route
selects through the closed-syncmer kernel (:mod:`..kernels.syncmer_select`):

- :func:`load_and_extract`, the fused native-parse loader.  Uncapped,
  worker threads parse and 2-bit pack the segments ahead of the main
  thread.  On the key route (device counting) each segment's reads are
  one stream (:func:`_pack_stream`); the main thread uploads runs of
  whole segments as one unit, K3d lays out the rows of every length
  bucket on the card (:func:`oatk_tpu_torch.kernels.syncmer_details.
  decode_rows`) and K1 -> K4 write the keys into the device count
  buffers (:func:`oatk_tpu_torch.kernels.syncmer.select_keys`).  With
  ``device_count=False`` each segment's chunks are padded blobs
  (:func:`_pack_chunks`) whose selected rows come back to the host for
  the host sort (:func:`oatk_tpu_torch.kernels.syncmer.extract_hoco_fused`).
  Under ``-D`` (``max_data``) one sequential flow parses each whole
  file, caps it and counts on the host.
- :func:`extract_all_syncmers`, the Python reader's route (host hoco +
  2-bit pack into the loader's blob layout, or raw ASCII with the hoco
  phase on the device under ``OATK_TPU_DEVICE_HOCO``), host counting;
  with ``use_device=False`` the sequential host oracle (``--cpu``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import partial

import numpy as np

from ..io.fastx import SeqRecord
from ..kernels.oracle import ReadSyncmers, hoco_compress_np, pack_hoco, syncmers_of_read_oracle
from ..utils import log_info
from ..utils.trace import add, once, record, span


@dataclass
class ReadDB:
    """All reads with hoco sequences and per-read syncmer lists."""

    k: int  # k-mer size (hoco bases); reference's 'w'
    s: int  # s-mer size
    # ReadSyncmers, or on the native loader's routes LoadedRead records
    # whose arrays resolve from ``table``
    reads: list = field(default_factory=list)
    stats: dict = field(default_factory=dict)
    version: int = 0  # bumped whenever read arrays mutate (EC)
    # whole-run hoco streams in sid order (set by the native loader;
    # per-read hoco_code/ho_rl are views into these).  Consumers
    # (consensus _Flats) reuse them instead of re-concatenating ~100 MB
    # of per-read arrays.  Immutable: EC splices only syncmer arrays.
    hoco_flat: np.ndarray | None = None  # uint8 codes
    rl_flat: np.ndarray | None = None  # uint8 run length - 1, saturated 255
    hoco_off: np.ndarray | None = None  # int64 [n+1] read offsets
    # exact run-length-1 values for saturated rl_flat entries, sorted by
    # global stream position (the reference's ho_l_rl overflow list)
    rl_ovf_pos: np.ndarray | None = None  # int64 global hoco positions
    rl_ovf_len: np.ndarray | None = None  # int64 exact run-length-1
    table: ReadTable | None = None  # the native loader's records' arrays

    @property
    def n(self) -> int:
        return len(self.reads)

    def total_syncmers(self) -> int:
        return sum(len(r.m_pos) for r in self.reads)


READ_FIELDS = ("hoco_code", "ho_rl", "is_n", "m_pos", "s_mer", "k_mer")


class ReadTable:
    """The whole-run arrays that one run's :class:`LoadedRead` records
    resolve their array fields from, indexed by sid.  The loader sets the
    hoco flats, ``hoco_off`` and the sorted N positions in the same
    coordinates (``isn_pos``) once its reads are assembled; the device
    count sets the syncmer flats and their per-read offsets ``moff``
    (:meth:`set_syncmers`).  ``views`` counts the views made from it, by
    field, over the run."""

    __slots__ = ("hoco_flat", "rl_flat", "hoco_off", "isn_pos",
                 "moff", "m_pos", "s_mer", "k_mer", "gen", "views")

    def __init__(self):
        self.hoco_flat = self.rl_flat = self.hoco_off = self.isn_pos = None
        self.moff = self.m_pos = self.s_mer = self.k_mer = None
        self.gen = 0  # syncmer sets so far
        self.views = dict.fromkeys(READ_FIELDS, 0)

    def set_syncmers(self, moff, m_pos, s_mer, k_mer) -> None:
        """Read i's m_pos/s_mer/k_mer become slices [moff[i], moff[i+1])
        of these flats, over any value a record held or was assigned
        before."""
        self.moff, self.m_pos, self.s_mer, self.k_mer = moff, m_pos, s_mer, k_mer
        self.gen += 1


def _hoco_field(name, make):
    """The LoadedRead hoco field ``name``: the value assigned, else
    ``make(table, read)``, made on first access and kept."""
    slot = "_" + name

    def get(self):
        try:
            return getattr(self, slot)
        except AttributeError:
            v = make(self._t, self)
            setattr(self, slot, v)
            self._t.views[name] += 1
            return v

    def set_(self, v):
        setattr(self, slot, v)

    return property(get, set_)


def _hoco_window(flat):
    def make(t, r):
        o0 = int(t.hoco_off[r.sid])
        return getattr(t, flat)[o0 : o0 + r.hoco_l]
    return make


def _is_n_window(t, r):
    """A read's dense N flags from the table's sparse N positions (the
    shared all-False view for an N-free read)."""
    o0 = int(t.hoco_off[r.sid])
    lo, hi = np.searchsorted(t.isn_pos, (o0, o0 + r.hoco_l))
    if hi == lo:
        return _false_view(r.hoco_l)
    v = np.zeros(r.hoco_l, bool)
    v[t.isn_pos[lo:hi] - o0] = True
    return v


def _syncmer_field(name):
    """The LoadedRead syncmer field ``name``: None before the table's
    first :meth:`ReadTable.set_syncmers`; then the value assigned since
    the latest set, else the read's slice of the table's flat, made on
    first access and kept.  The slot holds (table generation, value), so
    a set outdates every value held before it without a loop over the
    reads."""
    slot = "_" + name

    def get(self):
        t = self._t
        try:
            gen, v = getattr(self, slot)
            if gen == t.gen:
                return v
        except AttributeError:
            pass
        if not t.gen:
            return None
        v = getattr(t, name)[t.moff[self.sid] : t.moff[self.sid + 1]]
        setattr(self, slot, (t.gen, v))
        t.views[name] += 1
        return v

    def set_(self, v):
        setattr(self, slot, (self._t.gen, v))

    return property(get, set_)


class LoadedRead:
    """One read of the native loader: the fields and meanings of
    :class:`~oatk_tpu_torch.kernels.oracle.ReadSyncmers`, holding only its
    sid, name and hoco length and its run's :class:`ReadTable`.  Each
    array field is a view into the table's whole-run arrays, made on first
    access; a value assigned to a field is kept and read from then on (a
    syncmer field's until the table's next set)."""

    __slots__ = ("sid", "name", "hoco_l", "_t") + tuple("_" + f for f in READ_FIELDS)

    def __init__(self, sid: int, name: str, hoco_l: int, table: ReadTable):
        self.sid = sid
        self.name = name
        self.hoco_l = hoco_l
        self._t = table

    hoco_code = _hoco_field("hoco_code", _hoco_window("hoco_flat"))
    ho_rl = _hoco_field("ho_rl", _hoco_window("rl_flat"))
    is_n = _hoco_field("is_n", _is_n_window)
    m_pos = _syncmer_field("m_pos")
    s_mer = _syncmer_field("s_mer")
    k_mer = _syncmer_field("k_mer")

    @property
    def n(self) -> int:
        return len(self.m_pos)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _device_hoco_on() -> bool:
    """OATK_TPU_DEVICE_HOCO: the hoco phase runs on the device from raw
    ASCII (the Python reader's route)."""
    return os.environ.get("OATK_TPU_DEVICE_HOCO", "0") not in ("", "0")


# bytes per pipeline segment of the fused loader (tests shrink this to
# force multi-segment splits on small inputs)
_SEG_BYTES = 4 << 20


def _sel_divisor(w: int, s: int) -> int:
    """Positions-per-selected-syncmer estimate for the device capacity.

    Expected closed-syncmer density is ~2/(w-s+2); at production k
    (w>=500) observed density is ~half that, so a (w-s)/2 divisor still
    leaves ~2x headroom.  Small k keeps the conservative (w-s)/3."""
    return max(4, (w - s) // 2 if w >= 500 else (w - s) // 3)


def _capacity(B: int, Lp: int, w: int, s: int) -> int:
    """Starting extraction capacity (max_out) of a chunk of B x Lp
    positions."""
    return _round_up(max(1024, int(B * Lp / _sel_divisor(w, s))), 1024)


def _bucket_len(L: int) -> int:
    """Padded row length for a read: powers of two up to 4096, then
    multiples of 2048 (padding waste is uploaded and scanned, so the
    grid stays fine; the row length must stay a multiple of 512)."""
    if L <= 512:
        return 512
    if L <= 4096:
        return 1 << int(np.ceil(np.log2(L)))
    return _round_up(L, 2048)


def _pad_rows(n: int, bsz: int) -> int:
    """Pad a chunk's row count to a multiple of 64 (capped at the full
    chunk size)."""
    return min(max(64, _round_up(n, 64)), bsz)


def _chunks_of(lengths, w: int, s: int, batch_bases: int):
    """(chunk read indices, B, Lp, max_out) over reads bucketed by padded
    length, each bucket cut into chunks of about ``batch_bases``."""
    buckets: dict[int, list[int]] = {}
    for i, n in enumerate(lengths):
        buckets.setdefault(_bucket_len(max(int(n), w + 4)), []).append(i)
    for Lp, idxs in sorted(buckets.items()):
        bsz = max(1, batch_bases // Lp)
        for start in range(0, len(idxs), bsz):
            chunk = idxs[start : start + bsz]
            B = _pad_rows(len(chunk), bsz)
            yield chunk, B, Lp, _capacity(B, Lp, w, s)


_false_buf = np.zeros(1 << 14, bool)


def _false_view(n: int) -> np.ndarray:
    """Read-only all-False view for N-free reads (Ns are rare; one
    shared buffer replaces a per-read dense flag array)."""
    global _false_buf
    if n > len(_false_buf):
        _false_buf = np.zeros(max(n, 2 * len(_false_buf)), bool)
    return _false_buf[:n]


def _read_isn_views(isn_pos: np.ndarray, offs: np.ndarray, n_reads: int):
    """Per-read is_n bool arrays from the sparse ambiguous-position
    list (positions in the same coordinates as ``offs``)."""
    lo = np.searchsorted(isn_pos, offs[:n_reads])
    hi = np.searchsorted(isn_pos, offs[1 : n_reads + 1])
    out = [None] * n_reads
    for ri in range(n_reads):
        l0 = int(offs[ri + 1]) - int(offs[ri])
        if hi[ri] > lo[ri]:
            d = np.zeros(l0, bool)
            d[isn_pos[lo[ri] : hi[ri]] - int(offs[ri])] = True
            out[ri] = d
        else:
            out[ri] = _false_view(l0)
    return out


def _unpack_packed(pk: np.ndarray, n_sel: int, Lp: int):
    """Decode the extraction's [3, >=n_sel] int64 result: row0 =
    flat_idx<<1|z, row1 = smer payload, row2 = bitcast Murmur hash."""
    flat = pk[0, :n_sel]
    sel_z = (flat & 1).astype(np.int32)
    fi = flat >> 1
    sel_b = (fi // Lp).astype(np.int32)
    sel_p = (fi % Lp).astype(np.int32)
    sel_smer = pk[1, :n_sel].astype(np.uint64)
    sel_kh = pk[2, :n_sel].view(np.uint64) if pk.shape[0] > 2 else None
    return sel_b, sel_p, sel_z, sel_smer, sel_kh


def _host_rows(packed, n_sel: int, B: int, Lp: int):
    """Fetch one chunk's n_sel selected rows for host counting: returns
    (row cuts [B+1], m_pos uint32, s_mer uint64, k_mer uint64), the
    per-read fields being [cuts[b], cuts[b+1]) slices."""
    pk = packed[:, :n_sel].cpu().numpy()
    sel_b, sel_p, sel_z, sel_smer, sel_kh = _unpack_packed(pk, n_sel, Lp)
    cuts = np.searchsorted(sel_b, np.arange(B + 1))
    mpos = (sel_p.astype(np.uint32) << 1) | sel_z.astype(np.uint32)
    return cuts, mpos, sel_smer, sel_kh.copy()


def _set_rows(reads: list, chunk, rows, keep: int) -> None:
    """Give the reads of one chunk their syncmer arrays (reads at or
    past ``keep``, the -D cap, are skipped)."""
    cuts, mpos, smer, kmer = rows
    for bi, ri in enumerate(chunk):
        if ri >= keep:
            continue
        lo, hi = cuts[bi], cuts[bi + 1]
        r = reads[ri]
        r.m_pos, r.s_mer, r.k_mer = mpos[lo:hi], smer[lo:hi], kmer[lo:hi]


def _pack_chunks(res, n_reads: int, w: int, s: int, batch_bases: int):
    """2-bit pack the first ``n_reads`` reads of a parse result into
    upload blobs: [(chunk_read_idxs, B, Lp, max_out, n_cap, blob)]."""
    from .. import native

    offs, codes, isn_idx = res[2], res[3], res[5]
    chunks = []
    for chunk, B, Lp, max_out in _chunks_of(np.diff(offs[: n_reads + 1]), w, s, batch_bases):
        st = offs[chunk]
        en = offs[np.asarray(chunk) + 1]
        # sparse ambiguous positions straight from the parser (parse-local
        # coordinates, same as offs)
        n_pos = _chunk_n_positions(isn_idx, st, en, Lp)
        # one blob = one upload; the packed grid / lengths / N
        # positions are written straight into their blob slices
        blob, packed, hl, n_cap = chunk_blob(B, Lp, n_pos)
        native.pack_rows_gather(codes, st, en, Lp // 4, out=packed)
        hl[: len(chunk)] = (en - st).astype(np.int32)
        chunks.append((chunk, B, Lp, max_out, n_cap, blob))
    return chunks


def chunk_blob(B: int, Lp: int, n_pos, n_cap: int | None = None):
    """One chunk's zeroed upload blob [packed B x Lp/4 | hoco lengths
    i32[B] | N positions i32[n_cap]] with the N positions ``n_pos``
    (row-local slots bi*Lp + p, ascending) written in and the unused N
    slots holding the drop sentinel B*Lp.  ``n_cap`` defaults to the
    loader's: 0 without Ns, else len(n_pos) rounded up to a multiple of
    1024.  Returns (blob, packed view [B, Lp/4], hoco-length view i32[B],
    n_cap)."""
    if n_cap is None:
        n_cap = 0 if not len(n_pos) else _round_up(max(64, len(n_pos)), 1024)
    pk_b = B * (Lp // 4)
    blob = np.zeros(pk_b + 4 * B + 4 * n_cap, np.uint8)
    n_arr = blob[pk_b + 4 * B :].view(np.int32)
    n_arr[:] = B * Lp
    n_arr[: len(n_pos)] = n_pos
    return blob, blob[:pk_b].reshape(B, Lp // 4), blob[pk_b : pk_b + 4 * B].view(np.int32), n_cap


def _parse_pack_segment(
    data: bytes, c0: int, c1: int, w: int, s: int, batch_bases: int, out3=None,
    tacc: list | None = None, stream: bool = False,
):
    """Worker: native parse+hoco of one byte range [c0, c1), then the
    2-bit pack of its reads: with ``stream`` (the key route) one
    contiguous stream (:func:`_pack_stream`), else every chunk's upload
    blob (:func:`_pack_chunks`).  Runs off the main thread (the C parse
    and pack release the GIL) so segment i+1 parses while segment i
    uploads/computes on the device.  The range is parsed in place -- no
    segment slice copy -- and with ``out3`` straight into the caller's
    whole-file arrays (no per-segment allocation either).  Returns
    (parse_result, stream or [(chunk_read_idxs, B, Lp, max_out, n_cap,
    blob)]) or None.  ``tacc`` collects (parse_s, pack_s) per segment
    (each worker's wall; the caller books their sums)."""
    import time as _time

    from .. import native

    _t0 = _time.perf_counter()
    res = native.parse_fastx_hoco(data, c0, c1, out=out3)
    _t_parse = _time.perf_counter() - _t0
    if res is None:
        return None
    packed = _pack_stream(res, w) if stream else _pack_chunks(res, len(res[0]), w, s, batch_bases)
    if tacc is not None:
        tacc.append((_t_parse, _time.perf_counter() - _t0 - _t_parse))
    return res, packed


def _pack_stream(res, w: int):
    """A parse result's reads as the key route's 2-bit stream, row table
    and N entries (:func:`.stream_pack.pack_stream`, one native call)."""
    from .stream_pack import pack_stream

    return pack_stream(res[2], res[3], res[5], w)


def _chunk_n_positions(isn_idx, st, en, Lp):
    """Row-local device slots (bi*Lp + local) of N bases for a chunk,
    given the sorted whole-stream N-index array and per-row [st, en)
    code ranges.  Touches only rows that actually contain Ns."""
    lo = np.searchsorted(isn_idx, st)
    hi = np.searchsorted(isn_idx, en)
    if not len(isn_idx) or not (hi > lo).any():
        return np.empty(0, np.int64)
    parts = [
        bi * Lp + (isn_idx[l:h] - s0)
        for bi, (l, h, s0) in enumerate(zip(lo, hi, st))
        if h > l
    ]
    return np.concatenate(parts)


def extract_chunk(blob: np.ndarray, B, Lp, n_cap, w, s, max_out, device):
    """Upload one chunk's blob and extract its syncmers, reading n_sel
    back and regrowing the capacity in a loop until it holds every
    selected position: the packed route (host counting, the Python
    reader).  Returns (packed [3, max_out+1] on ``device``, n_sel,
    max_out)."""
    import torch

    from ..kernels.syncmer import extract_hoco_fused

    blob_d = torch.from_numpy(blob).to(device)
    while True:
        packed = extract_hoco_fused(blob_d, B, Lp, n_cap, w, s, max_out)
        n_sel = int(packed[0, max_out])
        if n_sel <= max_out:
            return packed, n_sel, max_out
        max_out = _round_up(n_sel + 1024, 1024)


# pinned staging slots of the key route's uploads (tests shrink this to
# reuse each slot several times on a small input)
_UPLOAD_SLOTS = 4

# hoco positions a unit of the key route gathers before its upload (the
# parse segments that reach it, whole; tests shrink this)
_UNIT_POSITIONS = 32 << 20


class Uploads:
    """Host-to-device copies of the key route's units (a stream and its
    tables) and regrown chunks (blob and read ids), queued without
    waiting for the card.

    On a CUDA device each upload is staged in one of ``_UPLOAD_SLOTS``
    pinned host buffers, sized to the largest upload seen, so the pinned
    memory is bounded whatever the input's size.  The slot's copy to the
    card runs with ``non_blocking=True`` on a dedicated copy stream into
    memory allocated on that stream; an event recorded there makes the
    compute stream wait before the decode, and ``record_stream`` keeps
    the caching allocator from handing the device buffer out again before
    the compute stream's queued kernels have read it.  :meth:`done`
    records an event on the compute stream behind the upload's kernels;
    before the host rewrites a slot it waits on the event of the slot's
    previous upload -- the loop's only host wait -- so the host runs at
    most ``_UPLOAD_SLOTS`` uploads ahead of the card and at most that
    many device buffers are in flight.

    Staging copies the workers' numpy arrays into the slot on the main
    thread, so no pinned memory is held per segment.

    On the CPU the arrays are used in place (a list of arrays is
    concatenated): no pinning, no streams.  A failure to pin or to make
    the stream raises."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.uploads = 0  # copies issued on the copy stream
        self.pinned_bytes = 0  # pinned staging bytes held
        if self.cuda:
            self.copy = torch.cuda.Stream(self.device)
            self.compute = torch.cuda.current_stream(self.device)
            self.slots = [None] * _UPLOAD_SLOTS
            self.freed = [None] * _UPLOAD_SLOTS  # compute-stream events
            self.next = 0
            self.size = 0
            self._slot = 0

    def put(self, *fields):
        """Each field -- a numpy array, or a list of arrays of one dtype laid
        end to end -- as a 1-D tensor of its dtype on the device, ordered
        before the compute stream's next kernels; on a card each starts
        16-byte aligned in one buffer.  The host's wait for the slot, its
        copy into it and the copy queued on the copy stream are the spans
        ``upload_wait``, ``upload_stage`` and ``upload_copy``."""
        import torch

        parts = [f if isinstance(f, list) else [f] for f in fields]
        if not self.cuda:
            return tuple(torch.from_numpy(p[0] if len(p) == 1 else np.concatenate(p)) for p in parts)
        offs, total = [], 0
        for p in parts:
            offs.append(total)
            total += _round_up(sum(a.nbytes for a in p), 16)
        i = self.next
        self.next = (i + 1) % len(self.slots)
        with span("upload_wait"):
            if self.freed[i] is not None:
                self.freed[i].synchronize()
        with span("upload_stage"):
            slot = self.slots[i]
            if slot is None or slot.numel() < total:
                self.size = max(self.size, total)
                slot = torch.empty(self.size, dtype=torch.uint8, pin_memory=True)
                if not slot.is_pinned():
                    raise RuntimeError(f"could not pin {self.size} B of host memory for uploads")
                self.slots[i] = slot
                self.pinned_bytes = sum(t.numel() for t in self.slots if t is not None)
            host = slot.numpy()
            for p, o in zip(parts, offs):  # one copy call per field
                n = sum(a.nbytes for a in p)
                np.concatenate([a.reshape(-1).view(np.uint8) for a in p], out=host[o : o + n])
        with span("upload_copy"):
            with torch.cuda.stream(self.copy):
                dev = torch.empty(total, dtype=torch.uint8, device=self.device)
                dev.copy_(slot[:total], non_blocking=True)
                ev = self.copy.record_event()
            self.compute.wait_event(ev)
            dev.record_stream(self.compute)
        self.uploads += 1
        self._slot = i
        return tuple(
            dev[o : o + sum(a.nbytes for a in p)].view(torch.from_numpy(p[0][:0]).dtype)
            for p, o in zip(parts, offs))

    def done(self):
        """Mark the end of the kernels that read the last upload."""
        if self.cuda:
            self.freed[self._slot] = self.compute.record_event()


@dataclass
class _Pending:
    """One key-route append, kept for the drain: its rows (B of them,
    padded to Lp, read ids ``sids``), its lanes [off, off+max_out), its
    n_sel tensor, and ``make_blob`` to lay the rows out again as the
    packed route's blob, (blob, n_cap), should they overflow."""

    make_blob: object
    B: int
    Lp: int
    max_out: int
    off: int
    sids: np.ndarray
    n_sel: object


def _grow_if_overflow(devcount, uploads, pend: _Pending, n_sel: int, w: int, s: int,
                      counters) -> int:
    """Regrow one append after the drain, as the reference's
    ``_grow_if_overflow`` (``oatk_tpu/asm/reads.py:445``): while its
    exact n_sel exceeds its capacity, invalidate its lanes and append its
    rows again, packed on the host into a blob (``pend.make_blob``), at a
    new offset with ``max_out = n_sel + 1024`` rounded up (the finalize's
    global sort makes the append order irrelevant).  Returns n_sel."""
    max_out, off, blob = pend.max_out, pend.off, None
    while n_sel > max_out:
        devcount.invalidate(off, max_out)
        max_out = _round_up(n_sel + 1024, 1024)
        if blob is None:
            blob, n_cap = pend.make_blob()
            counters["host_rows"] += pend.B
        blob_d, sids_d = uploads.put(blob, pend.sids)
        off, n_d = devcount.append(blob_d, pend.B, pend.Lp, n_cap, w, s, max_out, sids_d)
        uploads.done()
        n_sel = int(n_d[0])
        counters["regrows"] += 1
        counters["nsel_reads"] += 1
    return n_sel


def _rows_blob(codes: np.ndarray, st: np.ndarray, hl: np.ndarray, n_rows: np.ndarray,
               row0: int, Lp: int):
    """The packed route's blob of rows row0 .. row0+len(st)-1 of a unit,
    packed again from the whole-file codes (reads at ``st``, ``hl`` long;
    the unit's N entries ``r<<32 | p``): (blob, n_cap)."""
    from .. import native

    B = len(st)
    r, p = n_rows >> 32, n_rows & 0xFFFFFFFF
    hit = (r >= row0) & (r < row0 + B)
    blob, packed, hl_v, n_cap = chunk_blob(B, Lp, (r[hit] - row0) * Lp + p[hit])
    native.pack_rows_gather(codes, st, st + hl, Lp // 4, out=packed)
    hl_v[:] = hl
    return blob, n_cap


def extract_all_syncmers(
    records: list[SeqRecord],
    w: int,
    s: int,
    use_device: bool = True,
    batch_bases: int = 32 << 20,
    device="cuda",
) -> ReadDB:
    """Syncmer extraction for reads from the Python reader, counted on
    the host.

    On ``device`` (the JAX package's ``impl="pallas"`` route): host hoco
    (``hoco_compress_np``), 2-bit pack into the loader's blob layout,
    :func:`extract_chunk`, then the per-read split of the fetched rows;
    under OATK_TPU_DEVICE_HOCO the hoco phase runs on the device from raw
    ASCII instead.  ``use_device=False`` runs the sequential host oracle
    per read (``--cpu``)."""
    db = ReadDB(k=w, s=s)
    db.reads = [None] * len(records)  # type: ignore

    if not use_device:
        for i, rec in enumerate(records):
            db.reads[i] = syncmers_of_read_oracle(rec.seq, w, s, rec.sid, rec.name)
        return db
    if _device_hoco_on():
        return _extract_device_hoco(db, records, w, s, batch_bases, device)

    # host-side homopolymer compression (needed for consensus/EC anyway);
    # the device consumes 2-bit packed hoco codes + sparse N positions
    hoco = [hoco_compress_np(rec.seq) for rec in records]
    for i, (rec, (code, ho_rl, is_n)) in enumerate(zip(records, hoco)):
        db.reads[i] = ReadSyncmers(
            sid=rec.sid, name=rec.name, hoco_l=len(code), hoco_code=code, ho_rl=ho_rl,
            is_n=is_n, m_pos=None, s_mer=None, k_mer=None,
        )
    up = 0
    for chunk, B, Lp, max_out in _chunks_of([len(h[0]) for h in hoco], w, s, batch_bases):
        n_pos = np.concatenate(
            [bi * Lp + np.flatnonzero(hoco[ri][2]) for bi, ri in enumerate(chunk)]
        )
        blob, packed, hl, n_cap = chunk_blob(B, Lp, n_pos)
        for bi, ri in enumerate(chunk):
            code = hoco[ri][0]
            packed[bi, : (len(code) + 3) // 4] = pack_hoco(code)
            hl[bi] = len(code)
        pk, n_sel, _mo = extract_chunk(blob, B, Lp, n_cap, w, s, max_out, device)
        _set_rows(db.reads, chunk, _host_rows(pk, n_sel, B, Lp), len(records))
        up += blob.nbytes
    db.upload_bytes = up
    return db


def _extract_device_hoco(db, records, w, s, batch_bases, device):
    """OATK_TPU_DEVICE_HOCO=1 route: upload RAW ASCII reads (1 B/base,
    bucketed by raw length) and run homopolymer compression on the
    device (:func:`oatk_tpu_torch.kernels.syncmer.extract_syncmers_ascii`),
    fetching the hoco arrays back for the host-side DB.  The host skips
    its hoco+pack pass; the upload carries 4x the bytes of the 2-bit
    blob and the read-back ~6 B per base more."""
    import torch

    from ..kernels.syncmer import extract_syncmers_ascii

    up = 0
    for chunk, B, Lp, max_out in _chunks_of([len(r.seq) for r in records], w, s, batch_bases):
        seq = np.zeros((B, Lp), dtype=np.uint8)
        lens = np.zeros(B, dtype=np.int32)
        for bi, ri in enumerate(chunk):
            sq = records[ri].seq
            seq[bi, : len(sq)] = sq
            lens[bi] = len(sq)
        seq_d = torch.from_numpy(seq).to(device)
        lens_d = torch.from_numpy(lens).to(device)
        up += seq.nbytes + lens.nbytes
        while True:
            out = extract_syncmers_ascii(seq_d, lens_d, w, s, max_out, return_hoco=True)
            n_sel = int(out["packed"][0, max_out])
            if n_sel <= max_out:
                break
            # capacity overflow (pathological density): regrow and redo
            max_out = _round_up(n_sel + 1024, 1024)
        hc, hl, rl, isn = (out[k].cpu().numpy() for k in ("hoco_c", "hoco_l", "ho_rl", "is_n"))
        for bi, ri in enumerate(chunk):
            n_h = int(hl[bi])
            db.reads[ri] = ReadSyncmers(
                sid=records[ri].sid,
                name=records[ri].name,
                hoco_l=n_h,
                hoco_code=hc[bi, :n_h].copy(),
                ho_rl=rl[bi, :n_h].astype(np.uint32),
                is_n=isn[bi, :n_h].copy(),
                m_pos=None,
                s_mer=None,
                k_mer=None,
            )
        _set_rows(db.reads, chunk, _host_rows(out["packed"], n_sel, B, Lp), len(records))
    db.upload_bytes = up
    return db


def load_and_extract(
    paths: list[str],
    w: int,
    s: int,
    max_data: int = 0,
    batch_bases: int = 32 << 20,
    device="cuda",
    device_count: bool = True,
) -> ReadDB | None:
    """Fused native load + device extraction.

    Uncapped, each file splits at record boundaries into ~``_SEG_BYTES``
    segments; worker threads parse and pack them while the main thread
    extracts the segments before them on ``device``.  With
    ``device_count`` (the key route) the keys go to a
    :class:`~oatk_tpu_torch.index.devcount.DevCountState`, which the
    returned ReadDB carries as ``_devcount`` for ``collect_syncmer_db``,
    and the main thread only queues work, as the reference's loader does
    (``oatk_tpu/asm/reads.py:787-895``): per unit of whole segments
    (about ``_UNIT_POSITIONS`` hoco positions; the last unit of a file
    may be smaller) one upload of their streams and row table
    (:class:`Uploads`), one K3d over every length bucket, and per bucket
    K1 -> K4 and the append, with no host read in the segment loop; after
    it the finalize's sorts
    (:meth:`~oatk_tpu_torch.index.devcount.DevCountState.start_finalize`),
    the host assembly of the reads, then ONE read of every append's n_sel
    and the regrow of any that overflowed (:func:`_grow_if_overflow`,
    its rows packed again from the whole-file codes).  Otherwise each
    chunk's selected rows are fetched and ``collect_syncmer_db`` sorts on
    the host.

    ``max_data`` (-D) runs the sequential flow: a whole-file parse, the
    reads up to and including the one whose raw bases reach the cap,
    host counting, and no further files once the cap is reached.

    Returns None when the native parser rejects the input (for example a
    FASTA file with embedded FASTQ records) and under
    OATK_TPU_DEVICE_HOCO; the caller then takes the Python reader.

    The main thread's phases are spans of the port's recorder
    (:mod:`oatk_tpu_torch.utils.trace`), ``load.<phase>`` under
    ``syncasm``: ``setup``, ``read_bytes``, ``cuts``, ``submit`` (the
    segments handed to the parse workers), ``parse_wait`` (blocked on
    them), ``extract`` (the queueing time on the key route, of which,
    on a card, ``extract.upload_wait`` waits for a staging slot,
    ``extract.upload_stage`` copies into one and ``extract.upload_copy``
    queues its copy to the card, and ``extract.append`` queues the
    extraction chain and the count's appends), ``finalize_dispatch``,
    ``assemble_total``, ``nsel_drain`` and ``flats`` (the whole-run hoco
    arrays); the workers' summed ``parse_work``/``pack_work`` are worker
    keys.  The ReadDB carries them as ``load_timings`` by their last name
    (seconds; the same under any caller), and ``load_counters``: ``files``
    (pipelined files), ``nsel_reads`` (host reads of n_sel: one per file
    on the key route, plus one per regrow), ``chunk_reads`` (chunks whose
    n_sel was read inside the segment loop: 0 on the key route),
    ``regrows``, ``pinned_bytes`` (the upload ring's staging memory),
    ``copy_uploads`` (copies on the copy stream: units and regrows, on a
    card), ``units`` (units queued), ``appends`` (K1/K4 appends to the
    count, regrows included), ``device_rows`` (rows K3d laid out from a
    unit's stream) and ``host_rows`` (rows packed on the host into padded
    blobs: every row on the packed route, a regrow's rows on the key
    route)."""
    import torch

    from .. import native

    if _device_hoco_on():
        return None
    if not native.available():
        raise RuntimeError("the native host library (oatk_tpu_torch/native/*.c) failed to build")
    _touch_cuda(torch.device(device))
    with record() as tm:
        db = _load_files(paths, w, s, max_data, batch_bases, device, device_count)
    if db is not None:
        db.load_timings = {}
        for k_, v in tm.items():
            names = k_.split(".")
            if "once" not in names:
                db.load_timings[names[-1]] = db.load_timings.get(names[-1], 0.0) + v
    return db


_cuda_used: set = set()


def _touch_cuda(device) -> None:
    """The process's first use of a CUDA device (the runtime's set-up and
    the device's context), as the span ``once.cuda``."""
    import torch

    if device.type != "cuda" or device.index in _cuda_used:
        return
    with once("cuda"):
        torch.cuda.synchronize(device)
    _cuda_used.add(device.index)


def _load_files(paths, w, s, max_data, batch_bases, device, device_count):
    """:func:`load_and_extract` in its recording: the ReadDB, or None
    where the native parser rejects a file."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from .. import native
    from ..index.devcount import DevCountState
    from ..io.fastx import read_source_bytes
    from ..kernels.syncmer_details import decode_rows

    with span("setup"):
        devcount = DevCountState(device) if device_count and not max_data else None
        uploads = Uploads(device) if devcount is not None else None
    counters = dict(files=0, nsel_reads=0, chunk_reads=0, regrows=0, pinned_bytes=0,
                    copy_uploads=0, units=0, appends=0, device_rows=0, host_rows=0)
    table = ReadTable()
    db = ReadDB(k=w, s=s, table=table)
    total_raw = 0
    up = 0
    sid0 = 0
    code_parts: list[np.ndarray] = []
    rl_parts: list[np.ndarray] = []
    off_parts: list[np.ndarray] = []
    ovf_pos_parts: list[np.ndarray] = []
    ovf_len_parts: list[np.ndarray] = []
    isn_parts: list[np.ndarray] = []
    off_base = 0

    def extract_rows(chunks):
        """Extract one parse unit's chunks on the packed route; returns
        the host rows per chunk."""
        nonlocal up
        rows = []
        for chunk, B, Lp, max_out, n_cap, blob in chunks:
            packed, n_sel, max_out = extract_chunk(blob, B, Lp, n_cap, w, s, max_out, device)
            up += blob.nbytes
            counters["chunk_reads"] += 1
            counters["nsel_reads"] += 1
            counters["host_rows"] += len(chunk)
            rows.append((chunk, _host_rows(packed, n_sel, B, Lp)))
        return rows

    def queue_unit(segs, codes, pending):
        """Queue one unit on the key route: ``segs`` are consecutive parse
        segments, each (its SegStream, its first read id, its reads'
        offsets in ``codes``, the whole-file hoco array).  One upload of
        their streams and the row table, ordered by length bucket (stably,
        so read ids ascend within a bucket); one K3d over every bucket; per
        bucket K1, K4 and the count's append, a :class:`_Pending` each."""
        nonlocal up
        n = [len(sg.hl) for sg, _sid, _offs in segs]
        R = sum(n)
        if R == 0:
            return
        sbase = np.cumsum([0] + [len(sg.stream) for sg, _sid, _offs in segs[:-1]])
        rbase = np.cumsum([0] + n[:-1])
        lp = np.concatenate([sg.lp for sg, _sid, _offs in segs])
        order = np.argsort(lp, kind="stable")
        row_off = np.concatenate([sg.row_off + b for (sg, _s, _o), b in zip(segs, sbase)])[order]
        hl = np.concatenate([sg.hl for sg, _sid, _offs in segs])[order]
        sids = np.concatenate([np.arange(sid, sid + k, dtype=np.int64)
                               for (_sg, sid, _o), k in zip(segs, n)])[order]
        st = np.concatenate([offs[:-1] for _sg, _sid, offs in segs])[order]
        n_rows = np.concatenate([sg.n_rows + (b << 32) for (sg, _s, _o), b in zip(segs, rbase)])
        if len(n_rows):  # read index -> its row in the bucket order
            inv = np.empty(R, np.int64)
            inv[order] = np.arange(R)
            n_rows = (inv[n_rows >> 32] << 32) | (n_rows & 0xFFFFFFFF)
        lp = lp[order]
        edges = np.flatnonzero(np.diff(lp)) + 1
        buckets = [(int(r0), int(r1 - r0), int(lp[r0]))
                   for r0, r1 in zip(np.append(0, edges), np.append(edges, R))]
        fields = ([sg.stream for sg, _sid, _offs in segs], row_off, sids, hl, n_rows)
        stream_d, row_off_d, sids_d, hl_d, n_rows_d = uploads.put(*fields)
        with span("append"):
            cps = decode_rows(stream_d, row_off_d, hl_d, buckets, n_rows_d, w)
            for (r0, B, Lp), cp in zip(buckets, cps):
                max_out = _capacity(B, Lp, w, s)
                off, n_sel = devcount.append_rows(cp, w, s, max_out, sids_d[r0 : r0 + B])
                pending.append(_Pending(
                    partial(_rows_blob, codes, st[r0 : r0 + B], hl[r0 : r0 + B], n_rows, r0, Lp),
                    B, Lp, max_out, off, sids[r0 : r0 + B], n_sel))
        uploads.done()
        counters["units"] += 1
        counters["device_rows"] += R
        up += sum(a.nbytes for f in fields for a in (f if isinstance(f, list) else [f]))

    def assemble(res, sid_base, keep, rows, base):
        """LoadedRead records for the first ``keep`` reads of one parse
        result, whose hoco windows start at ``base`` of the whole-run
        flats; the result's N positions go to the table in the same
        coordinates.  The packed route assigns each chunk's syncmer
        arrays here; under device counting they resolve once the count
        sets them (DevCountState.build)."""
        names, offs, isn_pos = res[0], res[2], res[5]
        hl = np.diff(offs[: keep + 1]).tolist()
        reads = [LoadedRead(sid, nm, n, table)
                 for sid, nm, n in zip(range(sid_base, sid_base + keep), names, hl)]
        if len(isn_pos):
            isn_parts.append(isn_pos[isn_pos < offs[keep]] + base)
        for chunk, r in rows:
            _set_rows(reads, chunk, r, keep)
        return reads

    if devcount is not None:
        # pre-size the count buffers across all inputs (expected key lanes
        # ~ padded-hoco/sel_divisor, ~0.8 x raw bytes / divisor); sizes of
        # pipes/URLs are unknown and the buffers grow for them instead
        tot = 0
        for p in paths:
            try:
                sz = os.path.getsize(p)
            except (OSError, ValueError):
                sz = 0
            tot += int(0.8 * sz / _sel_divisor(w, s)) + (sz // _SEG_BYTES + 2) * 1024
        devcount.cap_hint = tot

    for i_path, path in enumerate(paths):
        with span("read_bytes"):
            data = read_source_bytes(path)

        if max_data:
            # ---- sequential flow (-D cap honored mid-file) ----
            with span("parse"):
                res = native.parse_fastx_hoco_mt(data)
            if res is None:
                return None
            with span("extract"):
                names, rawlen, offs, codes, rl = res[:5]
                # the read whose raw bases reach the cap is kept
                keep = int(np.searchsorted(np.cumsum(rawlen), max_data - total_raw) + 1)
                keep = min(keep, len(names))
                total_raw += int(rawlen[:keep].sum())
                rows = extract_rows(_pack_chunks(res, keep, w, s, batch_bases))
            with span("assemble_total"):
                db.reads.extend(assemble(res, sid0, keep, rows, off_base))
                h_end = int(offs[keep])
                code_parts.append(codes[:h_end])
                rl_parts.append(rl[:h_end])
                off_parts.append(offs[:keep] + off_base)
                if len(res[6]):
                    sel = res[6] < h_end  # entries of reads beyond the -D cap drop
                    ovf_pos_parts.append(res[6][sel] + off_base)
                    ovf_len_parts.append(res[7][sel])
                off_base += h_end
                sid0 += keep
            if total_raw >= max_data:
                # message as reference syncmer.c:473,539
                log_info(
                    f"data limit ({max_data}) reached. Discard the remaining sequences...",
                    func="sr_read",
                )
                break
            continue

        # ---- pipelined flow ----
        # fixed ~4 MB segments regardless of file size
        n_seg = max(1, len(data) // _SEG_BYTES)
        guard_pool = ThreadPoolExecutor(1)  # mixed-format guard scan
        # whole-file hoco arrays: each segment parses DIRECTLY into its
        # own byte-range region (hoco length never exceeds raw bytes, so
        # regions are disjoint); hoco_off points at each read's true
        # position, leaving a gap after every segment where its hoco
        # shrank -- consumers always address one read's window
        codes_full = np.empty(len(data), np.uint8)
        rl_full = np.empty(len(data), np.uint8)
        failed = False
        seg_results: list = []
        pending: list = []  # key route: the chunks queued, for the drain
        counters["files"] += 1
        try:
            for attempt in (0, 1):
                with span("cuts"):
                    guard_fut = None
                    cuts = None
                    if n_seg > 1:
                        if attempt == 0 and data[:1] == b">":
                            # optimistic: split on '\n>' now; the mixed-format
                            # guard scan runs concurrently on a worker thread
                            cuts = native.fasta_record_cuts(data, n_seg)
                            if cuts is not None:
                                guard_fut = guard_pool.submit(
                                    native.find_pattern2, data, b"\n@"
                                )
                        else:
                            cuts = native.segment_record_cuts(data, n_seg)
                    bounds = (
                        [(0, len(data))] if cuts is None else list(zip(cuts[:-1], cuts[1:]))
                    )
                seg_results = []
                pending = []
                unit: list = []  # key route: segments not yet queued
                unit_pos = 0
                failed = False
                # key lanes appended during a discarded attempt must be
                # masked out of the device count buffers
                att_fill = devcount.n_fill if devcount is not None else 0
                seg_sid = sid0
                n_parse = max(1, min(native.n_threads_default(), 8, len(bounds)))
                seg_tms: list = []  # (parse_s, pack_s) per segment, worker-side
                with ThreadPoolExecutor(n_parse) as ex:
                    with span("submit"):
                        futs = [
                            ex.submit(
                                _parse_pack_segment, data, c0, c1, w, s, batch_bases,
                                (codes_full[c0:c1], rl_full[c0:c1]), seg_tms, devcount is not None,
                            )
                            for c0, c1 in bounds
                        ]
                    for (c0, _c1), fut in zip(bounds, futs):
                        # consume in order; extract as ready
                        with span("parse_wait"):
                            pr = fut.result()
                        if pr is None:
                            failed = True
                            continue
                        res, packed = pr
                        rows = []
                        if devcount is None:
                            with span("extract"):
                                rows = extract_rows(packed)
                        elif not failed:
                            # whole segments gather into a unit of about
                            # _UNIT_POSITIONS hoco positions
                            unit.append((packed, seg_sid, res[2] + c0))
                            unit_pos += int(res[2][-1])
                            if unit_pos >= _UNIT_POSITIONS:
                                with span("extract"):
                                    queue_unit(unit, codes_full, pending)
                                unit, unit_pos = [], 0
                        seg_sid += len(res[0])
                        seg_results.append((res, c0, rows))
                    if unit and not failed:
                        with span("extract"):
                            queue_unit(unit, codes_full, pending)
                if guard_fut is not None and guard_fut.result() >= 0:
                    # rare mixed-format file: the optimistic '\n>' split
                    # was unsafe; drop this attempt (its pending n_sel
                    # tensors unread) and redo verified
                    if devcount is not None and devcount.n_fill > att_fill:
                        devcount.invalidate(att_fill, devcount.n_fill - att_fill)
                    continue
                break
        finally:
            guard_pool.shutdown(wait=True)
        if seg_tms:
            add("parse_work", sum(p for p, _ in seg_tms))
            add("pack_work", sum(q for _, q in seg_tms))
        if failed:
            return None
        if pending and i_path == len(paths) - 1:
            # optimistic, as the reference (oatk_tpu/asm/reads.py:849-856):
            # the sorts queue behind the chunks while the host assembles
            # (a regrow drops them and build queues them again; a later
            # file's appends would too, so only the last file queues them)
            with span("finalize_dispatch"):
                devcount.start_finalize()
        with span("assemble_total"):
            for res, vbase, rows in seg_results:
                names, rawlen, offs = res[0], res[1], res[2]
                keep = len(names)
                # the segment's reads live from vbase on in the whole-file
                # arrays (parse wrote in place)
                db.reads.extend(assemble(res, sid0, keep, rows, off_base + vbase))
                total_raw += int(rawlen.sum())
                off_parts.append(offs[:keep] + (off_base + vbase))
                if len(res[6]):
                    # run-length overflow entries: segment-local -> global
                    ovf_pos_parts.append(res[6] + (off_base + vbase))
                    ovf_len_parts.append(res[7])
                sid0 += keep
            off_base += len(data)
            code_parts.append(codes_full)
            rl_parts.append(rl_full)
        if pending:
            # ONE read of every chunk's n_sel, after the assembly; then
            # the rare overflowed chunks regrow
            with span("nsel_drain"):
                n_sels = torch.cat([p.n_sel for p in pending]).cpu().tolist()
                counters["nsel_reads"] += 1
                for pend, n_sel in zip(pending, n_sels):
                    devcount.n_occ += _grow_if_overflow(
                        devcount, uploads, pend, n_sel, w, s, counters)
    with span("flats"):
        if code_parts:
            db.hoco_flat = (
                code_parts[0] if len(code_parts) == 1 else np.concatenate(code_parts)
            )
            db.rl_flat = rl_parts[0] if len(rl_parts) == 1 else np.concatenate(rl_parts)
            z = np.zeros(0, np.int64)
            db.rl_ovf_pos = np.concatenate(ovf_pos_parts) if ovf_pos_parts else z
            db.rl_ovf_len = np.concatenate(ovf_len_parts) if ovf_len_parts else z
            db.hoco_off = np.concatenate(
                off_parts + [np.asarray([off_base], np.int64)]
            ).astype(np.int64, copy=False)
            table.hoco_flat, table.rl_flat, table.hoco_off = db.hoco_flat, db.rl_flat, db.hoco_off
            table.isn_pos = np.concatenate(isn_parts) if isn_parts else z
    if devcount is not None and devcount.n_fill > 0:
        db._devcount = devcount  # consumed by collect_syncmer_db
    db.upload_bytes = up
    if uploads is not None:
        counters.update(pinned_bytes=uploads.pinned_bytes, copy_uploads=uploads.uploads,
                        appends=devcount.n_append)
    db.load_counters = counters
    return db
