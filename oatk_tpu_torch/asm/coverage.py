"""Unitig & arc coverage estimation from read alignments.

scg_ra_utg_coverage / scg_ra_arc_coverage / scg_refine_arc_coverage /
scg_update_utg_cov analogues (reference syncasm.c:630-692,
1643-2261): three-round unitig coverage (unique-pileup IQR mean -> EM
over multi-alignment LCS blocks -> syncmer-count redistribution) and
arc coverage from uniquely-anchored consecutive fragment support with
parallel-link refinement.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils import log_info, log_warn
from .align import ReadAln
from .consensus import average_iqr, _lround
from .reads import ReadDB
from .scg import Scg

EM_MAX_ITER = 1000
DBL_EPSILON = 2.220446049250313e-16


def _em_host_run(avg, u_flat, bid, nm_b, nlen, n_vtx: int) -> int:
    """Coverage EM (round 2) on the host, updating ``avg`` in place;
    returns the number of iterations.  np.bincount accumulates in the
    reference's sequential order, so this loop is the byte-parity
    default."""
    nb_total = len(nm_b)
    it = 0
    while it < EM_MAX_ITER:
        it += 1
        if nb_total:
            au = avg[u_flat]
            tot_b = np.bincount(bid, weights=au, minlength=nb_total)
            tb = tot_b[bid]
            ok = tb != 0.0
            w = np.zeros(len(u_flat))
            w[ok] = au[ok] / tb[ok] * nm_b[bid[ok]]
            covs = np.bincount(u_flat, weights=w, minlength=n_vtx)
        else:
            covs = np.zeros(n_vtx)
        diff = 0.0
        for i in range(n_vtx):
            c = covs[i] / nlen[i]
            diff += abs(c - avg[i])
            avg[i] = c
        if diff < DBL_EPSILON:
            break
    return it


def _em_device_run(avg, u_flat, bid, nm_b, nlen, n_vtx: int, device):
    """Coverage EM (round 2) on ``device`` (port of the JAX package's
    ``lax.while_loop`` over segment sums): float64 ``index_add_`` segment
    sums, the same stopping rule (``it < EM_MAX_ITER and diff >=
    DBL_EPSILON``) tested before every iteration, one read-back of
    ``diff`` per iteration.  Returns (coverage vector as numpy, number of
    iterations).

    Opt-in via OATK_TPU_DEVICE_EM: CUDA's float64 ``index_add_`` sums
    with atomics, in no fixed order, so the result can differ from the
    host loop's sequential order in the last bits."""
    import torch

    f64 = torch.float64
    avg_t = torch.as_tensor(avg, dtype=f64).to(device)
    u = torch.as_tensor(u_flat, dtype=torch.int64).to(device)
    b = torch.as_tensor(bid, dtype=torch.int64).to(device)
    nmb = torch.as_tensor(nm_b, dtype=f64).to(device)[b]
    nl = torch.as_tensor(nlen, dtype=f64).to(device)
    nb = len(nm_b)
    it, diff = 0, float("inf")
    while it < EM_MAX_ITER and diff >= DBL_EPSILON:
        au = avg_t[u]
        tb = torch.zeros(nb, dtype=f64, device=avg_t.device).index_add_(0, b, au)[b]
        nz = tb != 0.0
        w = torch.where(nz, au / torch.where(nz, tb, 1.0) * nmb, 0.0)
        new = torch.zeros(n_vtx, dtype=f64, device=avg_t.device).index_add_(0, u, w) / nl
        diff = float((new - avg_t).abs().sum())
        avg_t = new
        it += 1
    _em_device_run.calls += 1
    return avg_t.cpu().numpy(), it


_em_device_run.calls = 0
_device_em_warned = False


def _warn_device_em_once():
    """OATK_TPU_DEVICE_EM is EXPERIMENTAL and outside the byte-parity
    contract: no device reduction can reproduce the reference's
    sequential float accumulation (reference syncasm.c:1643-2261) by
    construction -- float addition is non-associative and the device
    sums in its own order, so coverage values (and thus SC/KC tags) may
    differ in the last bits on some inputs.  The parity-tested host loop
    is the default."""
    global _device_em_warned
    if not _device_em_warned:
        _device_em_warned = True
        log_warn(
            "OATK_TPU_DEVICE_EM is experimental: device float reduction "
            "order is not guaranteed to reproduce the reference "
            "byte-for-byte",
            func="scg_ra_utg_coverage",
        )


def scg_update_utg_cov(scg: Scg):
    from .consensus import _utg_avg_cov

    for i in range(scg.utg.n_vtx):
        scg.utg.vtx_cov[i] = int(_utg_avg_cov(scg, i))


# ---------------- LCS alignment blocks ----------------

def _find_lcs(s_scm: np.ndarray, u_scm: np.ndarray, offset: int) -> list[tuple[int, int]]:
    """Longest-common-subsequence match blocks between the read syncmer
    ids and a unitig syncmer list; returns [(start_in_read, length)]."""
    from .. import native

    if native.available():
        blocks = native.find_lcs_native(
            np.ascontiguousarray(s_scm, np.int64),
            np.ascontiguousarray(u_scm, np.int64),
            offset,
        )
        if blocks is not None:
            return [(int(b), int(n)) for b, n in blocks]
    s_ids = s_scm
    u_ids = u_scm
    s_n, u_n = len(s_ids), len(u_ids)
    blocks: list[tuple[int, int]] = []
    start = 0
    s_end, u_end = s_n - 1, u_n - 1
    while start < s_n and start < u_n and s_ids[start] == u_ids[start]:
        start += 1
    while start <= s_end and start <= u_end and s_ids[s_end] == u_ids[u_end]:
        s_end -= 1
        u_end -= 1
    if start > 0:
        blocks.append((offset, start))
    sa = s_ids[start : s_end + 1]
    ua = u_ids[start : u_end + 1]
    sn, un = len(sa), len(ua)
    if sn and un:
        L = np.zeros((sn + 1, un + 1), np.int32)
        eq = sa[:, None] == ua[None, :]
        for i in range(1, sn + 1):
            for j in range(1, un + 1):
                if eq[i - 1, j - 1]:
                    L[i, j] = L[i - 1, j - 1] + 1
                else:
                    L[i, j] = max(L[i - 1, j], L[i, j - 1])
        # backtrace
        bt: list[tuple[int, int]] = []
        i, j = sn, un
        while i > 0 and j > 0:
            if sa[i - 1] == ua[j - 1]:
                bt.append((i - 1 + offset + start, 1))
                i -= 1
                j -= 1
            elif L[i, j - 1] > L[i - 1, j]:
                j -= 1
            else:
                i -= 1
        blocks.extend(reversed(bt))
    if start + (s_end - start + 1) < s_n:
        blocks.append((offset + s_end + 1, s_n - s_end - 1))
    # merge adjacent
    merged: list[tuple[int, int]] = []
    for b, n in blocks:
        if merged and merged[-1][0] + merged[-1][1] == b:
            merged[-1] = (merged[-1][0], merged[-1][1] + n)
        else:
            merged.append((b, n))
    return merged


def _make_ma_blocks(scg: Scg, read, alns: list[ReadAln]):
    """Multi-alignment blocks for one read: (n_match[], uids[b][a])."""
    g = scg.utg
    scm = (read.k_mer >> np.uint64(1)).astype(np.int64)
    n = len(alns)
    lcs_blocks: list[list[tuple[int, int]]] = []
    for ra in alns:
        blk: list[tuple[int, int]] = []
        for frg in ra.frags:
            uid = frg.uid >> 1
            ua = g.vtx_a[uid]
            sub = ua[frg.u_beg : frg.u_end + 1]
            u_scm = ((sub >> np.uint64(1)).astype(np.int64))[::-1] if frg.uid & 1 else (
                sub >> np.uint64(1)
            ).astype(np.int64)
            blk.extend(_find_lcs(scm[frg.s_beg : frg.s_end + 1], np.asarray(u_scm), frg.s_beg))
        lcs_blocks.append(blk)

    n_match: list[int] = []
    u_match: list[list[int]] = []
    lcsb = [0] * n
    frgs = [0] * n
    begs = [0] * n
    lens = [0] * n
    uids = [0] * n

    def shift(i) -> bool:
        if lcsb[i] >= len(lcs_blocks[i]):
            return False
        begs[i], lens[i] = lcs_blocks[i][lcsb[i]]
        while alns[i].frags[frgs[i]].s_end < begs[i]:
            frgs[i] += 1
        uids[i] = alns[i].frags[frgs[i]].uid >> 1
        return True

    for i in range(n):
        if not lcs_blocks[i] or not shift(i):
            return n_match, u_match
    while True:
        s_beg = max(begs)
        m_ext = min(lens[i] - s_beg + begs[i] for i in range(n))
        if m_ext > 0:
            n_match.append(m_ext)
            u_match.append(list(uids))
            done = False
            for i in range(n):
                ext = lens[i] - s_beg + begs[i]
                if ext == m_ext:
                    lcsb[i] += 1
                    if not shift(i):
                        done = True
                        break
                else:
                    begs[i] = s_beg + m_ext
                    lens[i] = ext - m_ext
            if done:
                break
        else:
            i = int(np.argmin(begs))
            lcsb[i] += 1
            if not shift(i):
                break
    return n_match, u_match


def scg_ra_utg_coverage(
    scg: Scg, read_db: ReadDB, ra_db: list[ReadAln], verbose: int = 0, device="cpu"
):
    """Unitig coverage from the read alignments; the EM round runs on
    ``device`` under OATK_TPU_DEVICE_EM."""
    if not ra_db:
        log_warn("no read alignment, unitig coverage estimation skipped")
        return
    g = scg.utg
    n_vtx = g.n_vtx

    from .. import native

    use_native = native.available()
    flat = getattr(ra_db, "flat", None)
    # the native aligner's flat arrays are usable iff ra_db is exactly
    # the alignment set they describe (one ReadAln per chain)
    use_flat = use_native and flat is not None and (
        getattr(ra_db, "_lazy", False)
        or len(flat["aln_cut"]) - 1 == list.__len__(ra_db)
    )
    if use_native:
        va_flat = np.concatenate(
            [g.vtx_a[i] if g.vtx_a[i] is not None else np.zeros(0, np.uint64)
             for i in range(n_vtx)]
        ).astype(np.uint64, copy=False)
        va_off = np.zeros(n_vtx + 1, np.int64)
        np.cumsum(
            np.fromiter(
                (len(g.vtx_a[i]) if g.vtx_a[i] is not None else 0 for i in range(n_vtx)),
                np.int64, count=n_vtx,
            ),
            out=va_off[1:],
        )

    # round 1: uniquely-mapped pileup, per-syncmer, IQR mean of covered
    avg = np.zeros(n_vtx)
    if use_flat:
        # an alignment is uniquely mapped iff its read has exactly one
        # chain (s = 1/n_a + max_score has zero fractional part only for
        # n_a == 1); accumulate interval pileups with a difference array
        frag6 = flat["frag6"]
        aln_cut = flat["aln_cut"]
        read_aln_off = flat["read_aln_off"]
        n_a_r = np.diff(read_aln_off)
        aln_na = np.repeat(n_a_r, n_a_r)
        frag_aln = np.repeat(
            np.arange(len(aln_cut) - 1, dtype=np.int64), np.diff(aln_cut)
        )
        fsel = frag6[aln_na[frag_aln] == 1]
        dif = np.zeros(int(va_off[-1]) + 1)
        base = va_off[fsel[:, 0] >> 1]
        np.add.at(dif, base + fsel[:, 1], 1.0)
        np.add.at(dif, base + fsel[:, 2] + 1, -1.0)
        pile_flat = np.cumsum(dif[:-1])
        for i in range(n_vtx):
            seg = pile_flat[va_off[i] : va_off[i + 1]]
            avg[i] = max(1.0, average_iqr(seg[seg > 0]))
    else:
        pile = [
            np.zeros(len(g.vtx_a[i]) if g.vtx_a[i] is not None else 0)
            for i in range(n_vtx)
        ]
        for ra in ra_db:
            if ra.s - int(ra.s) > DBL_EPSILON:
                continue  # not uniquely mapped
            for frg in ra.frags:
                pile[frg.uid >> 1][frg.u_beg : frg.u_end + 1] += 1.0
        for i in range(n_vtx):
            sel = pile[i][pile[i] > 0]
            avg[i] = max(1.0, average_iqr(sel))

    if not use_flat:
        # group alignments by read
        by_read: dict[int, list[ReadAln]] = {}
        for ra in ra_db:
            by_read.setdefault(ra.sid, []).append(ra)

    if use_flat:
        # feed the flat arrays straight into the threaded batch: block
        # order is sids order skipping unmapped (empty spans), identical
        # to the by_read dict order the non-flat branches use
        sids_f = flat["sids"]
        from .consensus import _Flats

        flats_c = _Flats.build(read_db, scg.scm_db)
        s_idx = np.asarray(sids_f, np.int64)
        if flats_c is not None and len(s_idx):
            # one gather from the cached whole-run k_mer flat instead of
            # a per-read slice loop
            moff_all = np.append(flats_c.moff, len(flats_c.kflat))
            st = moff_all[s_idx]
            ln = moff_all[s_idx + 1] - st
            scm_off = np.zeros(len(s_idx) + 1, np.int64)
            np.cumsum(ln, out=scm_off[1:])
            gidx = (
                np.arange(int(scm_off[-1]), dtype=np.int64)
                - np.repeat(scm_off[:-1], ln)
                + np.repeat(st, ln)
            )
            scm_flat = (flats_c.kflat[gidx] >> np.uint64(1)).astype(np.int64)
        else:
            scm_l = [
                np.ascontiguousarray(read_db.reads[int(s)].k_mer >> np.uint64(1), np.int64)
                for s in sids_f
            ]
            scm_off = np.zeros(len(sids_f) + 1, np.int64)
            np.cumsum(
                np.fromiter((len(a) for a in scm_l), np.int64, count=len(scm_l)),
                out=scm_off[1:],
            )
            scm_flat = np.concatenate(scm_l) if scm_l else np.zeros(0, np.int64)
        nm_all, u_flat, read_cut = native.ma_blocks_batch_native(
            scm_flat, scm_off, flat["frag6"], flat["aln_cut"],
            flat["read_aln_off"], va_flat, va_off,
        )
        nb_total = len(nm_all)
        nm_b = nm_all.astype(np.float64)
        n_aln_b = np.repeat(np.diff(flat["read_aln_off"]), np.diff(read_cut))
        bid = np.repeat(np.arange(nb_total, dtype=np.int64), n_aln_b)
    elif use_native:
        # ONE threaded native call for all reads (ma_blocks_batch):
        # concatenated per-read syncmer ids, global frag rows, global
        # alignment cuts, per-read alignment spans.  Output flat arrays
        # feed the EM directly -- block order is reads in dict order,
        # blocks in order, uid members left-to-right, exactly the order
        # the per-read path produced.
        scm_l: list[np.ndarray] = []
        scm_off = [0]
        rows = []
        aln_cut = [0]
        read_aln_off = [0]
        for sid, alns in by_read.items():
            km = read_db.reads[sid].k_mer
            scm_l.append(np.ascontiguousarray(km >> np.uint64(1), np.int64))
            scm_off.append(scm_off[-1] + len(km))
            for ra in alns:
                for f in ra.frags:
                    rows.append((f.uid, f.u_beg, f.u_end, f.s_beg, f.s_end, 0))
                aln_cut.append(len(rows))
            read_aln_off.append(len(aln_cut) - 1)
        scm_flat = np.concatenate(scm_l) if scm_l else np.zeros(0, np.int64)
        frag6 = np.asarray(rows, np.int64).reshape(len(rows), 6)
        nm_all, u_flat, read_cut = native.ma_blocks_batch_native(
            scm_flat, np.asarray(scm_off, np.int64), frag6,
            np.asarray(aln_cut, np.int64), np.asarray(read_aln_off, np.int64),
            va_flat, va_off,
        )
        nb_total = len(nm_all)
        nm_b = nm_all.astype(np.float64)
        n_aln_b = np.repeat(np.diff(read_aln_off), np.diff(read_cut))
        bid = np.repeat(np.arange(nb_total, dtype=np.int64), n_aln_b)
    else:
        mas = [
            _make_ma_blocks(scg, read_db.reads[sid], alns)
            for sid, alns in by_read.items()
        ]
        # flatten blocks once: EM accumulation order is preserved (reads
        # in dict order, blocks in order, members left-to-right), and
        # bincount accumulates sequentially in that same flat order, so
        # the float rounding matches the reference's per-block loops
        nm_flat_l, u_flat_l, bid_l = [], [], []
        nb_total = 0
        for n_match, u_match in mas:
            for nm, us in zip(n_match, u_match):
                usl = [int(u) for u in us] if not isinstance(us, np.ndarray) else us
                nm_flat_l.append(int(nm))
                u_flat_l.extend(int(u) for u in usl)
                bid_l.extend([nb_total] * len(usl))
                nb_total += 1
        nm_b = np.asarray(nm_flat_l, np.float64)
        u_flat = np.asarray(u_flat_l, np.int64)
        bid = np.asarray(bid_l, np.int64)
    nlen_arr = np.fromiter(
        (max(1, len(g.vtx_a[i]) if g.vtx_a[i] is not None else 1) for i in range(n_vtx)),
        np.float64, count=n_vtx,
    )

    # round 2: EM over multi-alignment blocks
    if nb_total and os.environ.get("OATK_TPU_DEVICE_EM"):
        _warn_device_em_once()
        avg[:] = _em_device_run(avg, u_flat, bid, nm_b, nlen_arr, n_vtx, device)[0]
    else:
        _em_host_run(avg, u_flat, bid, nm_b, nlen_arr, n_vtx)

    # round 3: redistribute syncmer counts weighted by utg coverage
    # (vectorized: every (unitig, position) holds exactly one syncmer, so
    # the per-syncmer scatter has no collisions).  Float-order invariant:
    # the reference C sums each syncmer's occurrence weights SEQUENTIALLY
    # (syncasm.c:2031-2033) and bincount accumulates sequentially too;
    # np.sum would NOT match for >=8 elements (numpy unrolls into 8-way
    # accumulators) -- do not "simplify" back to per-slice np.sum
    idx = scg.idx
    vlen = np.fromiter(
        (len(g.vtx_a[i]) if g.vtx_a[i] is not None else 0 for i in range(n_vtx)),
        np.int64, count=n_vtx,
    )
    voff = np.zeros(n_vtx + 1, np.int64)
    np.cumsum(vlen, out=voff[1:])
    cflat = np.zeros(int(voff[-1]))
    if len(idx.scm):
        scm_all = idx.scm.astype(np.int64)
        uid_all = idx.uid.astype(np.int64)
        pos_all = idx.pos.astype(np.int64)
        au = avg[uid_all]
        tot_s = np.bincount(scm_all, weights=au, minlength=scg.scm_db.n)
        ts = tot_s[scm_all]
        ok = ts >= DBL_EPSILON
        cov_s = scg.scm_db.cov.astype(np.float64)[scm_all]
        val = np.zeros(len(scm_all))
        val[ok] = au[ok] / ts[ok] * cov_s[ok]
        cflat[voff[uid_all[ok]] + pos_all[ok]] = val[ok]
    for i in range(n_vtx):
        avg[i] = max(1.0, average_iqr(cflat[voff[i] : voff[i + 1]]))
        g.vtx_cov[i] = int(avg[i])


def scg_ra_arc_coverage(
    scg: Scg, read_db: ReadDB, ra_db: list[ReadAln], refine: bool, verbose: int = 0
):
    g = scg.utg
    g._flush_pending()
    idx = scg.idx
    flat = getattr(ra_db, "flat", None)
    tbl = None
    if flat is not None and "max_score" in flat and (
        getattr(ra_db, "_lazy", False)
        or len(flat["aln_cut"]) - 1 == list.__len__(ra_db)
    ):
        from .align import chain_tables

        tbl = chain_tables(g, idx, flat)
    if tbl is not None:
        # vectorized pair accumulation; l/c contributions interleaved in
        # pair order so per-link float-addition order matches the
        # object loop's dict updates bit-exactly
        t, pc = tbl["t"], tbl["pair_chain"]
        uniq, score = tbl["uniq"], tbl["score"]
        sel = np.flatnonzero(uniq[t] & uniq[t + 1])
        ids = np.empty(2 * len(sel), np.int64)
        ids[0::2] = tbl["l"][sel]
        ids[1::2] = tbl["c"][sel]
        wts = np.empty(2 * len(sel))
        wts[0::2] = score[pc[sel]]
        wts[1::2] = score[pc[sel]]
        aid_all = (g.alink.astype(np.int64) << 1) | g.acomp.astype(np.int64)
        nbin = int(max(aid_all.max() + 1 if len(aid_all) else 1,
                       ids.max() + 1 if len(ids) else 1, 1))
        dup = np.bincount(ids, weights=wts, minlength=nbin)
        live = ~g.adel
        # unassigned link ids (UINT64_MAX) turn negative under the i64
        # cast; the dict path scored them 0.0
        aid_live = aid_all[live]
        vals = np.where(
            (aid_live >= 0) & (aid_live < nbin), dup[np.clip(aid_live, 0, nbin - 1)], 0.0
        )
        g.acov[live] = vals.astype(g.acov.dtype)
    else:
        dup_s: dict[int, float] = {}
        for ra in ra_db:
            if ra.n < 2:
                continue
            score = ra.s - int(ra.s)
            if score < DBL_EPSILON:
                score = 1.0
            if score < 0.99:
                uniq = []
                for frg in ra.frags:
                    a = g.vtx_a[frg.uid >> 1]
                    u = False
                    for t in range(frg.u_beg, frg.u_end + 1):
                        if idx.n_occ(int(a[t]) >> 1) == 1:
                            u = True
                            break
                    uniq.append(u)
            else:
                uniq = [True] * ra.n
            for j in range(1, ra.n):
                ai = g.arc_idx(ra.frags[j - 1].uid, ra.frags[j].uid)
                if ai is None:
                    continue
                l0 = g.arc_id(ai)
                c0 = g.comp_arc_id(ai)
                if uniq[j - 1] and uniq[j]:
                    dup_s[l0] = dup_s.get(l0, 0.0) + score
                    dup_s[c0] = dup_s.get(c0, 0.0) + score
        for i in range(len(g.av)):
            if g.adel[i]:
                continue
            g.acov[i] = int(dup_s.get(g.arc_id(i), 0.0))
    if refine:
        scg_refine_arc_coverage(scg, verbose)
    else:
        g.arc_fix_cov()


def scg_refine_arc_coverage(scg: Scg, verbose: int = 0):
    """Redistribute arc coverage over parallel links sharing the same
    end-syncmer pair (including within-unitig occurrences)."""
    g = scg.utg
    g._flush_pending()
    link_pairs: dict[int, list[tuple[int, int]]] = {}
    h_arc: dict[tuple[int, int], int] = {}
    for i in range(len(g.av)):
        if g.adel[i] or g.acomp[i]:
            continue
        v = g.arc_head_e(i)
        w = g.arc_tail_e(i)
        if v > w:
            v, w = w ^ 1, v ^ 1
        ld = int(g.alink[i])
        key = (v, w)
        if key not in h_arc:
            h_arc[key] = ld
        ld0 = h_arc[key]
        link_pairs.setdefault(ld0, []).append(
            (int(g.alink[i]), (g.vtx_cov[int(g.av[i]) >> 1] + g.vtx_cov[int(g.aw[i]) >> 1]) // 2)
        )
    for i in range(g.n_vtx):
        a = g.vtx_a[i]
        if a is None:
            continue
        for j in range(1, len(a)):
            v, w = int(a[j - 1]), int(a[j])
            if v > w:
                v, w = w ^ 1, v ^ 1
            key = (v, w)
            if key not in h_arc:
                continue
            link_pairs[h_arc[key]].append((-1, g.vtx_cov[i]))
    for i in range(len(g.av)):
        if g.adel[i] or g.acomp[i]:
            continue
        v = g.arc_head_e(i)
        w = g.arc_tail_e(i)
        if v > w:
            v, w = w ^ 1, v ^ 1
        ld = h_arc[(v, w)]
        pair = link_pairs[ld]
        if len(pair) == 1:
            continue
        c = sum(p[1] for p in pair)
        mine = next((p[1] for p in pair if p[0] == int(g.alink[i])), None)
        if c == 0 or mine is None:
            continue
        newc = _lround(float(g.acov[i]) / c * mine)
        g.acov[i] = newc
        ci = g.comp_arc_idx(i, live_only=True)
        if ci is not None:
            g.acov[ci] = newc
    g.arc_fix_cov()
