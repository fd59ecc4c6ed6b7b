"""Consensus caller: syncmer/unitig sequences and GFA emission.

scg_consensus / scg_syncmer_consensus / scg_unitig_consensus /
calc_syncmer_overlap analogues (reference syncasm.c:465-1046).

Per-syncmer bases come from any un-corrected supporting read; in DNA
mode homopolymer run lengths are the rounded mean across supporting
reads.  Adjacent-syncmer overlap distance is the mode of per-read
distances.  Ties in the mode are broken deterministically (count desc,
distance asc); the reference's tie order follows its hash-table layout
and is unspecified.
"""
from __future__ import annotations

import numpy as np

from ..index.syncmer_db import MAX_RD_SCM, SyncmerDB
from ..utils.trace import span
from .reads import ReadDB
from .scg import Scg

_NT = np.frombuffer(b"ACGT", np.uint8)
MAX_RD_LEN = 0x7FFFFFFF


def _resolve_rl_m1(read_db: ReadDB, sid: int, p: int, rl: np.ndarray) -> np.ndarray:
    """Exact run-length-1 values for a window of saturated u8 entries
    (255 => look up the ReadDB overflow list at global stream positions)."""
    op = getattr(read_db, "rl_ovf_pos", None)
    ol = getattr(read_db, "rl_ovf_len", None)
    if op is None or len(op) == 0 or read_db.hoco_off is None:
        return rl
    base = int(read_db.hoco_off[sid]) + p
    sat = np.flatnonzero(rl == 255)
    gpos = base + sat
    j = np.searchsorted(op, gpos)
    ok = (j < len(op)) & (op[np.minimum(j, len(op) - 1)] == gpos)
    rl = rl.copy()
    rl[sat[ok]] = ol[j[ok]]
    return rl


def _hoco_flats(read_db: ReadDB):
    """(hoff, code_flat, rl_flat, rl_ovf_pos, rl_ovf_len): hoco streams
    are immutable per ReadDB (EC splices only the syncmer arrays), so
    this caches forever.  rl_flat is u8 run-length-1 saturated at 255
    (reference sr_t layout); the sorted overflow pair holds exact values
    for saturated positions."""
    cached = getattr(read_db, "_hoco_fcache", None)
    if cached is not None:
        return cached
    reads = read_db.reads
    n = len(reads)
    z64 = np.zeros(0, np.int64)
    if (
        getattr(read_db, "hoco_flat", None) is not None
        and read_db.hoco_off is not None
        and len(read_db.hoco_off) == n + 1
    ):
        # the native loader already holds the whole-run hoco streams
        # (per-read arrays are views into them): zero-copy reuse
        op = read_db.rl_ovf_pos if read_db.rl_ovf_pos is not None else z64
        ol = read_db.rl_ovf_len if read_db.rl_ovf_len is not None else z64
        hf = (read_db.hoco_off[:n], read_db.hoco_flat, read_db.rl_flat, op, ol)
    else:
        hl = np.fromiter((r.hoco_l for r in reads), np.int64, count=n)
        hoff = np.zeros(n, np.int64)
        if n > 1:
            np.cumsum(hl[:-1], out=hoff[1:])
        code = (
            np.concatenate([r.hoco_code for r in reads]).astype(np.uint8, copy=False)
            if n else np.zeros(0, np.uint8)
        )
        rl_exact = (
            np.concatenate([r.ho_rl for r in reads]) if n else np.zeros(0, np.uint32)
        )
        if rl_exact.dtype == np.uint8:
            # already the saturated layout (views of a loader stream)
            rl, op, ol = rl_exact, z64, z64
        else:
            # exact run-1 values from the oracle/jnp paths: saturate and
            # record the (rare) overflow entries
            big = np.flatnonzero(rl_exact >= 255)
            rl = np.minimum(rl_exact, 255).astype(np.uint8)
            op = big.astype(np.int64)
            ol = rl_exact[big].astype(np.int64)
        hf = (hoff, code, rl, op, ol)
    read_db._hoco_fcache = hf
    return hf


class _ReadFlats:
    """Flat concatenations of the per-read syncmer arrays, cached per
    ReadDB version (EC bumps it).  Shared by consensus, alignment,
    error correction and the stat pass."""

    __slots__ = ("mc", "moff", "kflat", "mflat", "sids", "_sflat")

    def __init__(self, read_db: ReadDB):
        reads = read_db.reads
        n = len(reads)
        self.mc = np.fromiter((len(r.m_pos) for r in reads), np.int64, count=n)
        self.sids = np.fromiter((r.sid for r in reads), np.int64, count=n)
        self.moff = np.zeros(n, np.int64)
        if n > 1:
            np.cumsum(self.mc[:-1], out=self.moff[1:])
        self.kflat = (
            np.concatenate([r.k_mer for r in reads]).astype(np.uint64, copy=False)
            if n else np.zeros(0, np.uint64)
        )
        self.mflat = (
            np.concatenate([r.m_pos for r in reads]).astype(np.uint32, copy=False)
            if n else np.zeros(0, np.uint32)
        )
        self._sflat = None

    def smer(self, reads):
        """Flat s_mer stream (only the stat pass wants it; lazy)."""
        if self._sflat is None:
            self._sflat = (
                np.concatenate([r.s_mer for r in reads])
                if len(reads) else np.zeros(0, np.uint64)
            )
        return self._sflat


def read_flats(read_db: ReadDB) -> _ReadFlats:
    key = getattr(read_db, "version", 0)
    cached = getattr(read_db, "_rflats_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    rf = _ReadFlats(read_db)
    read_db._rflats_cache = (key, rf)
    return rf


def set_read_flats(read_db: ReadDB, mc, kflat, mflat, sflat, sids) -> _ReadFlats:
    """Register flats a mutator already holds (DB id rewrite, native EC)
    under the CURRENT read_db.version, skipping the per-read rebuild."""
    rf = _ReadFlats.__new__(_ReadFlats)
    rf.mc = mc
    rf.moff = np.zeros(len(mc), np.int64)
    if len(mc) > 1:
        np.cumsum(mc[:-1], out=rf.moff[1:])
    rf.kflat = kflat
    rf.mflat = mflat
    rf.sids = sids
    rf._sflat = sflat
    read_db._rflats_cache = (getattr(read_db, "version", 0), rf)
    return rf


class _Flats:
    """Flat views for the native (C) consensus loops: the cached
    read-level flats plus the syncmer occurrence flats.  None when the
    native library is unavailable (pure-Python loops used instead)."""

    def __init__(self, read_db: ReadDB, scm_db: SyncmerDB):
        rf = read_flats(read_db)
        self.moff = rf.moff
        self.kflat = rf.kflat
        self.mflat = rf.mflat
        (self.hoff, self.code_flat, self.rl_flat,
         ovf_pos, ovf_len) = _hoco_flats(read_db)
        self.rl_ovf = (ovf_pos, ovf_len)
        # syncmer occurrence lists flattened (for whole-unitig C emission);
        # the DB keeps its flat backing array, so reuse it when present
        ns = scm_db.n
        if getattr(scm_db, "mp_flat", None) is not None:
            self.mp_flat = scm_db.mp_flat.astype(np.uint64, copy=False)
            self.mp_off = scm_db.mp_off.astype(np.int64, copy=False)
        elif ns:
            self.mp_off = np.zeros(ns + 1, np.int64)
            np.cumsum(
                np.fromiter((len(a) for a in scm_db.m_pos), np.int64, count=ns),
                out=self.mp_off[1:],
            )
            self.mp_flat = np.concatenate(scm_db.m_pos).astype(np.uint64, copy=False)
        else:
            self.mp_off = np.zeros(1, np.int64)
            self.mp_flat = np.zeros(0, np.uint64)

    @staticmethod
    def build(read_db: ReadDB, scm_db: SyncmerDB):
        """Cached per (read_db, scm_db) contents: EC rewrites reads and
        occurrence lists mid-pipeline, so invalidate on the version
        counters those mutators bump.  Component flats have their own
        caches, so a rebuild only re-links them."""
        from .. import native

        if not native.available():
            return None
        key = (getattr(read_db, "version", 0), getattr(scm_db, "version", 0))
        cached = getattr(read_db, "_flats_cache", None)
        # hold the scm_db reference in the cache and compare identity --
        # a bare id() key could false-hit after the old DB is collected
        # and a new one reuses its address
        if cached is not None and cached[0] == key and cached[2] is scm_db:
            return cached[1]
        flats = _Flats(read_db, scm_db)
        read_db._flats_cache = (key, flats, scm_db)
        return flats


def calc_syncmer_overlap(
    read_db: ReadDB, scm_db: SyncmerDB, m1: int, rc1: int, m2: int, rc2: int,
    flats: _Flats | None = None,
) -> int:
    """Mode of per-read adjacent distances between syncmers m1 -> m2."""
    if flats is not None:
        from .. import native

        return native.scm_overlap_mode(
            scm_db.m_pos[m1], scm_db.m_pos[m2], rc1, rc2,
            flats.kflat, flats.mflat, flats.moff,
        )
    counts: dict[int, int] = {}
    pos1 = scm_db.m_pos[m1]
    pos2 = scm_db.m_pos[m2]
    reads = read_db.reads
    r1_all = (pos1 >> np.uint64(32)).astype(np.int64).tolist()
    i1_all = (((pos1 >> np.uint64(1)).astype(np.int64)) & MAX_RD_SCM).tolist()
    c1_all = (pos1.astype(np.int64) & 1).tolist()
    r2_all = (pos2 >> np.uint64(32)).astype(np.int64).tolist()
    i2_all = (((pos2 >> np.uint64(1)).astype(np.int64)) & MAX_RD_SCM).tolist()
    c2_all = (pos2.astype(np.int64) & 1).tolist()
    p2 = 0
    n2 = len(pos2)
    for r1, i1, c1 in zip(r1_all, i1_all, c1_all):
        rd1 = reads[r1]
        if int(rd1.k_mer[i1]) & 1:
            continue  # error-corrected
        l1 = int(rd1.m_pos[i1]) >> 1
        while p2 < n2 and r2_all[p2] < r1:
            p2 += 1
        for j in range(p2, n2):
            r2 = r2_all[j]
            if r2 != r1:
                break
            i2 = i2_all[j]
            rd2 = reads[r2]
            if int(rd2.k_mer[i2]) & 1:
                continue
            l2 = int(rd2.m_pos[i2]) >> 1
            c2 = c2_all[j]
            if i1 == i2 + 1 and c1 != rc1 and c2 != rc2:
                d = l1 - l2
                counts[d] = counts.get(d, 0) + 1
            elif i1 + 1 == i2 and c1 == rc1 and c2 == rc2:
                d = l2 - l1
                counts[d] = counts.get(d, 0) + 1
    if not counts:
        return 0
    return max(counts.items(), key=lambda kv: (kv[1], -kv[0]))[0]


def _lround(x: float) -> int:
    return int(np.floor(x + 0.5)) if x >= 0 else -int(np.floor(-x + 0.5))


def _device_consensus_on() -> bool:
    """OATK_TPU_DEVICE_CONSENSUS routes the run-length consensus math
    through the device reduction.  Resolved at the scg_consensus stage
    entry (which disables the batched native emitter so the flag is
    authoritative); the per-syncmer calls only re-read it on the
    non-batched path, where Python loop costs dominate."""
    import os

    return bool(os.environ.get("OATK_TPU_DEVICE_CONSENSUS"))


def _runlen_reps_device(rl_stack: np.ndarray, m_seq: int, device) -> np.ndarray:
    """Run-length consensus repeats on ``device``: 1 + lround(mean) over
    the per-read run-length rows (reference syncasm.c:994 lround
    semantics).  One upload and one read-back per call.

    Bit-exact by construction: the cross-read sum is an int64 sum (order
    independent), and the single rounding division is elementwise in
    float64, as on the host."""
    import torch

    rl = torch.from_numpy(np.ascontiguousarray(rl_stack[:m_seq], np.int64)).to(device)
    tot = rl.sum(0).to(torch.float64)
    reps = 1 + torch.floor(tot / rl.shape[0] + 0.5).to(torch.int64)
    _runlen_reps_device.calls += 1
    return reps.cpu().numpy()


_runlen_reps_device.calls = 0


def syncmer_consensus(
    read_db: ReadDB, scm_db: SyncmerDB, s: int, rev: int, beg: int, out: list, hoco_seq: bool,
    flats: _Flats | None = None, device="cpu",
) -> int:
    """Append the consensus of syncmer ``s`` starting at offset ``beg``
    (may be negative -> 'N' fill) to ``out``; returns emitted length.
    Under OATK_TPU_DEVICE_CONSENSUS the run-length reduction runs on
    ``device``."""
    w = read_db.k
    assert beg < w
    bl = 0
    if beg < 0:
        out.append(b"N" * (-beg))
        bl = -beg
        beg = 0
    l = w - beg
    bl += l

    dev_rl = not hoco_seq and _device_consensus_on()
    if dev_rl:
        flats = None  # run-length reduction on device via the Python gather
    if flats is not None:
        from .. import native

        base = np.empty(l, np.uint8)
        totrl = None if hoco_seq else np.zeros(l, np.int64)
        m_seq = native.scm_consensus_fill(
            scm_db.m_pos[s], rev, beg, l,
            flats.kflat, flats.mflat, flats.moff,
            flats.code_flat, flats.rl_flat, flats.hoff,
            not hoco_seq, base, totrl,
            rl_ovf=flats.rl_ovf,
        )
        if m_seq == 0:
            out.append(b"N" * l)
            return bl
        if hoco_seq:
            out.append(_NT[base].tobytes())
            return bl
        reps = 1 + np.floor(totrl / m_seq + 0.5).astype(np.int64)
        out.append(_NT[np.repeat(base, reps)].tobytes())
        return bl + int(reps.sum()) - l

    m_pos = scm_db.m_pos[s]
    # bulk-decode occurrence fields once (tolist converts in C; the
    # per-element int(np.uint64) pattern dominated profiles otherwise)
    sids = (m_pos >> np.uint64(32)).astype(np.int64).tolist()
    idxs = (((m_pos >> np.uint64(1)).astype(np.int64)) & MAX_RD_SCM).tolist()

    base_seq = None
    tot_rl = None
    m_seq = 0
    dev_rows: list | None = [] if dev_rl else None
    reads = read_db.reads
    for sid, idx in zip(sids, idxs):
        rd = reads[sid]
        if int(rd.k_mer[idx]) & 1:
            continue
        p = int(rd.m_pos[idx])
        r = (p & 1) ^ rev
        p >>= 1
        if not r:
            p += beg
        if base_seq is None:
            win = rd.hoco_code[p : p + l].astype(np.int64)
            if r:
                win = (3 - win)[::-1]
            base_seq = win
            if hoco_seq:
                break
            tot_rl = np.zeros(l, np.int64)
        rl = rd.ho_rl[p : p + l].astype(np.int64)  # stores run-1
        if rd.ho_rl.dtype == np.uint8 and np.any(rl == 255):
            rl = _resolve_rl_m1(read_db, sid, p, rl)
        if r:
            rl = rl[::-1]
        if dev_rows is not None:
            dev_rows.append(rl)
        else:
            tot_rl += rl
        m_seq += 1
    if base_seq is None:
        out.append(b"N" * l)
        return bl

    if hoco_seq:
        out.append(_NT[base_seq].tobytes())
        return bl
    chunks = []
    bl_extra = 0
    # vectorized 1 + lround(t/m_seq): run-length totals are non-negative,
    # so lround == floor(x + 0.5) (C lround half-away-from-zero)
    if dev_rows is not None:
        reps = _runlen_reps_device(np.stack(dev_rows), m_seq, device)
    else:
        reps = 1 + np.floor(tot_rl / m_seq + 0.5).astype(np.int64)
    bl_extra = int(reps.sum()) - l
    out.append(_NT[np.repeat(base_seq, reps)].tobytes())
    return bl + bl_extra


def unitig_consensus(
    read_db: ReadDB, scm_db: SyncmerDB, v: np.ndarray, out: list, hoco_seq: bool,
    flats: _Flats | None = None, device="cpu",
) -> int:
    """Stitch syncmer consensi along a unitig by overlap offsets."""
    n = len(v)
    if n == 0:
        return 0
    w = read_db.k
    if flats is not None and (hoco_seq or not _device_consensus_on()):
        # native whole-unitig emitter, unless the device run-length
        # opt-in is on (its math lives in syncmer_consensus below)
        from .. import native

        vv = np.ascontiguousarray(v, np.uint64)
        cap = max(4096, 4 * n * w)
        while True:
            buf = np.empty(cap, np.uint8)
            ret = native.utg_consensus_emit(
                vv, w, hoco_seq, flats.mp_flat, flats.mp_off,
                flats.kflat, flats.mflat, flats.moff,
                flats.code_flat, flats.rl_flat, flats.hoff, buf,
                rl_ovf=flats.rl_ovf,
            )
            if ret >= 0:
                out.append(buf[:ret].tobytes())
                return int(ret)
            cap *= 4  # pathological run-length expansion; regrow
    pos = np.zeros(n, np.int64)
    for i in range(1, n):
        pos[i] = pos[i - 1] + calc_syncmer_overlap(
            read_db, scm_db, int(v[i - 1]) >> 1, int(v[i - 1]) & 1, int(v[i]) >> 1, int(v[i]) & 1,
            flats,
        )
    beg_pos = end_pos = 0
    l = 0
    i = 0
    while i < n:
        while i + 1 < n and pos[i + 1] <= end_pos:
            i += 1
        beg_pos = int(pos[i])
        l += syncmer_consensus(
            read_db, scm_db, int(v[i]) >> 1, int(v[i]) & 1, end_pos - beg_pos, out, hoco_seq,
            flats, device,
        )
        end_pos = beg_pos + w
        i += 1
    return l


def ensure_vtx_seq(utg):
    """Decode cached raw consensus emissions into vtx_seq strings.

    The batched scg_consensus path skips eager decoding (the scg0 call
    would decode tens of thousands of single-syncmer strings); only the
    EC Python fallback actually walks vtx_seq, and calls this first."""
    lz = getattr(utg, "_seq_lazy", None)
    if lz is not None:
        code_flat, lsrc, lrev, w = lz
        if len(lsrc) != utg.n_vtx:
            return  # stale cache (graph mutated since the consensus pass)
        for i in range(utg.n_vtx):
            if utg.vtx_del[i] or utg.vtx_seq[i] is not None:
                continue
            st = int(lsrc[i])
            if st < 0:
                utg.vtx_seq[i] = "N" * w
            elif lrev[i]:
                utg.vtx_seq[i] = (
                    _NT[3 - code_flat[st : st + w][::-1]].tobytes().decode()
                )
            else:
                utg.vtx_seq[i] = _NT[code_flat[st : st + w]].tobytes().decode()
        return
    buf = getattr(utg, "_seq_buf", None)
    cuts = getattr(utg, "_seq_cuts", None)
    if buf is None or cuts is None or len(cuts) != utg.n_vtx + 1:
        return  # stale cache (graph mutated since the consensus pass)
    for i in range(utg.n_vtx):
        if not utg.vtx_del[i] and utg.vtx_seq[i] is None:
            utg.vtx_seq[i] = buf[int(cuts[i]) : int(cuts[i + 1])].tobytes().decode()


def _utg_avg_cov(scg: Scg, i: int) -> float:
    """IQR-trimmed mean coverage over (preferably single-copy) syncmers."""
    utg = scg.utg
    if utg.vtx_del[i]:
        return 0.0
    s = (np.asarray(utg.vtx_a[i], np.uint64) >> np.uint64(1)).astype(np.int64)
    nocc = scg.idx.start[s + 1] - scg.idx.start[s]
    cov = scg.scm_db.cov[s].astype(np.float64)
    sel = cov[(nocc == 1) & (cov > 0)]
    if len(sel) == 0:
        sel = cov
    return average_iqr(sel)


def average_iqr(vals: np.ndarray) -> float:
    """Mean over [Q1-1.5*IQR, Q3+1.5*IQR] with C-quantile interpolation."""
    n = len(vals)
    if n == 0:
        return 0.0
    v = np.sort(vals.astype(float))
    q1 = _quantile_sorted(v, 0.25)
    q3 = _quantile_sorted(v, 0.75)
    iqr = q3 - q1
    lo, hi = q1 - 1.5 * iqr, q3 + 1.5 * iqr
    sel = v[(v >= lo) & (v <= hi)]
    return float(sel.mean()) if len(sel) else 0.0


def _quantile_sorted(a: np.ndarray, q: float) -> float:
    n = len(a)
    if n == 1:
        return float(a[0])
    x = q * (n - 1)
    i = _lround(np.floor(x))
    frac = x - np.floor(x)
    if i == n - 1:
        return float(a[i])
    return float(a[i] + (a[i + 1] - a[i]) * frac)


def scg_consensus(
    read_db: ReadDB, scg: Scg, hoco_seq: bool, save_seq: bool, fo=None, device="cpu"
):
    """Compute unitig consensus sequences, lengths, coverages and arc
    overlap lengths; optionally emit GFA.

    With the native library, all vertices (and all arcs) are processed
    in single batched C calls -- per-call ctypes dispatch dominated
    large unfiltered graphs otherwise.  Under OATK_TPU_DEVICE_CONSENSUS
    the run-length reduction of every syncmer runs on ``device``."""
    with span("flats"):
        utg = scg.utg
        scm_db = scg.scm_db
        w = read_db.k
        utg.clean_consensus()
        flats = _Flats.build(read_db, scm_db)
        if fo:
            fo.write("H\tVN:Z:1.0\n")

    n_vtx = utg.n_vtx
    batched = flats is not None and n_vtx > 0
    if batched and not hoco_seq and _device_consensus_on():
        # the opt-in device run-length path lives in syncmer_consensus;
        # the batched native emitter would bypass it entirely, so the
        # flag forces the per-unitig route
        batched = False
    if batched:
        from .. import native

        with span("va_flat"):
            vf = getattr(utg, "_va_flat", None)
            vo = getattr(utg, "_va_off", None)
            if vf is not None and vo is not None and len(vo) == n_vtx + 1:
                va_flat, va_off = vf, vo
            else:
                va_flat = (
                    np.concatenate(
                        [np.asarray(utg.vtx_a[i], np.uint64) for i in range(n_vtx)]
                    )
                    if n_vtx else np.zeros(0, np.uint64)
                )
                va_off = np.zeros(n_vtx + 1, np.int64)
                np.cumsum(
                    np.fromiter(
                        (len(utg.vtx_a[i]) for i in range(n_vtx)), np.int64, count=n_vtx
                    ),
                    out=va_off[1:],
                )
        with span("emit_batch"):
            live = (~np.asarray(utg.vtx_del[:n_vtx], bool)).astype(np.uint8)
            va_len = np.diff(va_off)
            # Lazy hoco consensus (the EC-graph call): every vertex is one
            # syncmer and no read has an EC flag yet, so each vertex's hoco
            # consensus is exactly the first occurrence's window in the hoco
            # stream (scm_consensus_fill semantics with all occurrences
            # un-corrected).  Record (stream offset, rev) per vertex instead
            # of materializing the ~100 MB ASCII buffer; native EC and
            # ensure_vtx_seq decode on demand.
            lazy = (
                hoco_seq
                and save_seq
                and fo is None
                and bool(np.all(va_len == 1))
                and not bool((flats.kflat & np.uint64(1)).any())
            )
            if lazy:
                hoco_total = len(flats.code_flat)
                s_ids = (va_flat >> np.uint64(1)).astype(np.int64)
                vrev = (va_flat & np.uint64(1)).astype(np.uint32)
                mo0 = flats.mp_off[s_ids]
                has = flats.mp_off[s_ids + 1] > mo0
                lsrc = np.full(n_vtx, -1, np.int64)
                lrev = np.zeros(n_vtx, np.uint8)
                if np.any(has):
                    e0 = flats.mp_flat[mo0[has]]
                    sid = (e0 >> np.uint64(32)).astype(np.int64)
                    idx = ((e0 >> np.uint64(1)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
                    praw = flats.mflat[flats.moff[sid] + idx]
                    r = ((praw & np.uint32(1)).astype(np.uint32) ^ vrev[has]).astype(np.uint8)
                    st = flats.hoff[sid] + (praw >> np.uint32(1)).astype(np.int64)
                    if bool(np.all((st >= 0) & (st + w <= hoco_total))):
                        lsrc[has] = st
                        lrev[has] = r
                    else:
                        lazy = False  # corrupt-entry guard: materialize instead
            if not lazy:
                # window-sum bound covers hoco emission; dna run-length
                # expansion beyond the 2x margin regrows
                cap = max(4096, 2 * int(va_off[-1]) * w)
                while True:
                    buf = np.empty(cap, np.uint8)
                    cuts = np.empty(n_vtx + 1, np.int64)
                    ret = native.utg_consensus_emit_batch(
                        va_flat, va_off, live, w, hoco_seq,
                        flats.mp_flat, flats.mp_off, flats.kflat, flats.mflat,
                        flats.moff, flats.code_flat, flats.rl_flat, flats.hoff,
                        buf, cuts,
                        rl_ovf=flats.rl_ovf,
                    )
                    if ret >= 0:
                        break
                    if ret == -2:
                        raise MemoryError("utg_consensus_emit_batch allocation failure")
                    cap *= 4
        with span("lens_covs"):
            if save_seq:
                if lazy:
                    utg._seq_buf = None
                    utg._seq_cuts = None
                    utg._seq_lazy = (flats.code_flat, lsrc, lrev, w)
                else:
                    # raw emission buffer for native EC; vtx_seq strings are
                    # NOT decoded here -- the EC Python fallback decodes on
                    # demand via ensure_vtx_seq (the scg0 call would
                    # otherwise decode tens of thousands of single-syncmer
                    # strings for nothing)
                    utg._seq_buf = buf[: int(ret)].copy()
                    utg._seq_cuts = cuts.copy()
                    utg._seq_lazy = None
            # per-vertex lengths/coverages vectorized; fresh coverages for
            # single-syncmer vertices collapse to that syncmer's own count
            # (_utg_avg_cov of one value is the value, whichever sel branch)
            live_b = live.view(bool)
            lens_all = np.full(n_vtx, w, np.int64) if lazy else np.diff(cuts)
            if lazy:
                # EC-graph call: nothing downstream reads scg0's vtx_cov
                # (native/python EC consume seqs, lens and arcs; the graph
                # is dropped after EC), so skip the cov recomputation; the
                # emitted length of a single-syncmer hoco window is w
                if bool(np.all(live_b)):
                    utg.vtx_len[:n_vtx] = [w] * n_vtx
                else:
                    old_len = np.fromiter(
                        (utg.vtx_len[i] for i in range(n_vtx)), np.int64, count=n_vtx
                    )
                    utg.vtx_len[:n_vtx] = np.where(live_b, w, old_len).tolist()
                cov_f = None
            else:
                cov_f = np.fromiter(
                    (utg.vtx_cov[i] for i in range(n_vtx)), np.float64, count=n_vtx
                )
                need = live_b & (cov_f == 0)
                single = need & (va_len == 1)
                if np.any(single):
                    s1 = (va_flat[va_off[:-1][single]] >> np.uint64(1)).astype(np.int64)
                    cov_f[single] = scm_db.cov[s1]
                for i in np.flatnonzero(need & (va_len != 1)).tolist():
                    cov_f[i] = _utg_avg_cov(scg, i)
                old_len = np.fromiter(
                    (utg.vtx_len[i] for i in range(n_vtx)), np.int64, count=n_vtx
                )
                new_len = np.where(live_b, lens_all, old_len)
                old_cov = np.fromiter(
                    (utg.vtx_cov[i] for i in range(n_vtx)), np.int64, count=n_vtx
                )
                new_cov = np.where(live_b, cov_f.astype(np.int64), old_cov)
                utg.vtx_len[:n_vtx] = new_len.tolist()
                utg.vtx_cov[:n_vtx] = new_cov.tolist()
        with span("emit_gfa"):
            if fo is not None:
                for i in np.flatnonzero(live_b).tolist():
                    l = int(lens_all[i])
                    cov = float(cov_f[i])
                    seq = buf[cuts[i] : cuts[i + 1]].tobytes().decode()
                    fo.write(
                        f"S\tu{i}\t{seq}\tLN:i:{l}\tKC:i:{int(l * cov)}\tSC:f:{cov:.3f}\n"
                    )
    else:
        with span("emit_gfa"):
            for i in range(n_vtx):
                if utg.vtx_del[i]:
                    continue
                chunks: list[bytes] = []
                l = unitig_consensus(read_db, scm_db, utg.vtx_a[i], chunks, hoco_seq, flats, device)
                seq = b"".join(chunks).decode()
                assert len(seq) == l
                cov = utg.vtx_cov[i] if utg.vtx_cov[i] else _utg_avg_cov(scg, i)
                utg.vtx_cov[i] = int(cov)
                utg.vtx_len[i] = l
                if save_seq:
                    utg.vtx_seq[i] = seq
                if fo:
                    fo.write(
                        f"S\tu{i}\t{seq}\tLN:i:{l}\tKC:i:{int(l * cov)}\tSC:f:{float(cov):.3f}\n"
                    )

    with span("emit_gfa"):
        utg._flush_pending()
    n_arc = len(utg.av)
    als_batch = None
    with span("arc_batch"):
        if batched and n_arc:
            vtx_len_arr = np.asarray(utg.vtx_len[:n_vtx], np.int64)
            als_batch = np.full(n_arc, -1, np.int64)
            scratch_cap = max(4096, 4 * w * 64)
            while True:
                ret = native.arc_overlap_batch(
                    np.ascontiguousarray(utg.av, np.uint64),
                    np.ascontiguousarray(utg.aw, np.uint64),
                    np.ascontiguousarray(utg.aln, np.int64),
                    np.ascontiguousarray(utg.adel, np.uint8),
                    np.ascontiguousarray(utg.acomp, np.uint8),
                    va_flat, va_off, vtx_len_arr, w, hoco_seq,
                    flats.mp_flat, flats.mp_off, flats.kflat, flats.mflat,
                    flats.moff, flats.code_flat, flats.rl_flat, flats.hoff,
                    scratch_cap, als_batch,
                    rl_ovf=flats.rl_ovf,
                )
                if ret >= 0:
                    break
                if ret == -2:
                    raise MemoryError("arc_overlap_batch worker allocation failure")
                scratch_cap *= 4

    with span("arcs"):
        if als_batch is not None and fo is None and n_arc:
            # no GFA emission: the batched overlaps scatter straight into
            # als (arc + complement), no per-arc Python walk
            from ..graph.asmg import _match_complements

            part = getattr(utg, "_arc_partner", None)
            if part is None or len(part) != n_arc:
                part = _match_complements(utg.av, utg.aw)
            if part is not None:
                sel = np.flatnonzero(~utg.adel & ~utg.acomp)
                vals = als_batch[sel]
                utg.als[sel] = vals
                p = part[sel]
                ok = p >= 0
                utg.als[p[ok]] = vals[ok]
                return
        for ai in range(n_arc):
            if utg.adel[ai] or utg.acomp[ai]:
                continue
            v, t = int(utg.av[ai]), int(utg.aw[ai])
            if als_batch is not None:
                l = int(als_batch[ai])
            else:
                ln = int(utg.aln[ai])
                if ln > 0:
                    a = utg.vtx_a[v >> 1]
                    sub = a[:ln] if (v & 1) else a[len(a) - ln :]
                    chunks = []
                    l = unitig_consensus(read_db, scm_db, sub, chunks, hoco_seq, flats, device)
                else:
                    a = utg.vtx_a[v >> 1]
                    z = v & 1
                    vv = int(a[0] if z else a[-1]) ^ z
                    a2 = utg.vtx_a[t >> 1]
                    z2 = t & 1
                    tt = int(a2[-1] if z2 else a2[0]) ^ z2
                    l = calc_syncmer_overlap(read_db, scm_db, vv >> 1, vv & 1, tt >> 1, tt & 1, flats)
                    if l < w:
                        chunks = []
                        l = syncmer_consensus(
                            read_db, scm_db, vv >> 1, vv & 1, l, chunks, hoco_seq, flats, device
                        )
                    else:
                        l = 0
                l = min(l, utg.vtx_len[v >> 1], utg.vtx_len[t >> 1])
            utg.als[ai] = l
            ci = utg.comp_arc_idx(ai)
            if ci is not None:
                utg.als[ci] = l
            if fo:
                cov = int(utg.acov[ai])
                fo.write(f"L\tu{v>>1}\t{'+-'[v&1]}\tu{t>>1}\t{'+-'[t&1]}\t{l}M\tEC:i:{cov}\n")
                fo.write(f"L\tu{t>>1}\t{'-+'[t&1]}\tu{v>>1}\t{'-+'[v&1]}\t{l}M\tEC:i:{cov}\n")
