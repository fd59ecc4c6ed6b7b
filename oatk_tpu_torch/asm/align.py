"""Read -> syncmer-graph alignment (HOT LOOP 4).

Anchor collection, per-unitig co-linear fragment construction, exact
-overlap chaining across graph arcs and multi-optimal backtrace,
following reference alignment.c:159-691.  Anchors for a whole
read batch come from the inverted syncmer index; the per-read chaining
is a host loop (fragment counts per read are tiny).

Score = matches - gaps; a read alignment is kept when it covers >= 90%
of the read's syncmers; the stored score encodes mapping uniqueness as
1/n_alignments + max_score.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import log_info
from .reads import ReadDB
from .scg import Scg

MATCH_SCORE = 1
GAP_PENALTY = 1
MIN_A_FRAC = 0.9


@dataclass
class RaFrag:
    uid: int  # utg id << 1 | strand
    u_beg: int
    u_end: int  # inclusive
    s_beg: int
    s_end: int  # inclusive


@dataclass
class ReadAln:
    sid: int
    frags: list[RaFrag]
    s: float = 0.0

    @property
    def n(self) -> int:
        return len(self.frags)


class RaDB(list):
    """Alignment list that optionally carries the native batch's flat
    arrays (set by scg_read_alignment's native path), letting coverage
    estimation skip rebuilding per-frag rows in Python.

    flat keys: sids (aligned-read sid order), frag6 [N,6] i64 rows
    (uid, u_beg, u_end, s_beg, s_end, s_cnt) in emission order,
    aln_cut (global frag offsets per alignment), read_aln_off
    (alignment offsets per sid, zero-span for unmapped reads),
    max_score (per sid, int64).

    The native path leaves the list EMPTY (lazy): the per-chain
    ReadAln/RaFrag objects -- tens of thousands of tiny dataclasses --
    are only materialized if something actually iterates/indexes the
    list.  All pipeline consumers work off ``flat`` directly, so in the
    common run nothing ever does."""

    flat: dict | None = None

    def __init__(self):
        super().__init__()
        self.flat = None
        self._lazy = False

    def _materialize(self):
        if not self._lazy:
            return
        self._lazy = False
        f = self.flat
        of5 = f["frag6"][:, :5].tolist()  # bulk C conversion to py ints
        chain_cut = f["aln_cut"]
        read_cut = f["read_aln_off"]
        sids = f["sids"]
        ms = f["max_score"]
        for gi in range(len(sids)):
            c0, c1 = int(read_cut[gi]), int(read_cut[gi + 1])
            n_a = c1 - c0
            if n_a == 0:
                continue
            sid = int(sids[gi])
            s = 1.0 / n_a + int(ms[gi])
            for c in range(c0, c1):
                f0, f1 = int(chain_cut[c]), int(chain_cut[c + 1])
                frags = [RaFrag(*of5[t]) for t in range(f0, f1)]
                list.append(self, ReadAln(sid, frags, s))

    def __len__(self):
        self._materialize()
        return list.__len__(self)

    def __iter__(self):
        self._materialize()
        return list.__iter__(self)

    def __getitem__(self, i):
        self._materialize()
        return list.__getitem__(self, i)

    def __bool__(self):
        if self._lazy:
            return int(self.flat["read_aln_off"][-1]) > 0
        return list.__len__(self) > 0

    def __contains__(self, item):
        self._materialize()
        return list.__contains__(self, item)

    def append(self, item):
        self._materialize()
        list.append(self, item)

    def extend(self, items):
        self._materialize()
        list.extend(self, items)

    def insert(self, i, item):
        self._materialize()
        list.insert(self, i, item)


def _align_one(
    read, scg: Scg, min_score_needed: int, ulen: np.ndarray | None = None
) -> tuple[list[list], int]:
    """Returns (list of optimal fragment chains, max_score); each chain is
    a list of fragment dicts."""
    g = scg.utg
    idx = scg.idx
    n_scm = read.n
    # ---- anchors (vectorized per-read index expansion) ----
    s_arr = (read.k_mer >> np.uint64(1)).astype(np.int64)
    lo = idx.start[s_arr]
    cnt = idx.start[s_arr + 1] - lo
    tot = int(cnt.sum())
    if tot == 0:
        return [], 0
    j_rep = np.repeat(np.arange(n_scm, dtype=np.int64), cnt)
    off0 = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    o_idx = np.repeat(lo - off0, cnt) + np.arange(tot, dtype=np.int64)
    u = idx.uid[o_idx]
    p = idx.pos[o_idx]
    rj = (read.m_pos.astype(np.int64) & 1)[j_rep]
    t_rev = idx.rev[o_idx] ^ rj
    if ulen is None:
        ulen = np.fromiter(
            (len(a) for a in g.vtx_a), np.int64, count=g.n_vtx
        )
    uid_all = (u << 1) | t_rev
    upos_all = np.where(t_rev == 1, ulen[u] - p - 1, p)

    order = np.lexsort((upos_all, j_rep, uid_all))
    uid_a = uid_all[order].tolist()
    upos_a = upos_all[order].tolist()
    spos_a = j_rep[order].tolist()
    m = len(uid_a)
    nxt = [-1] * m
    used = [False] * m

    # ---- per-unitig next-pointer linking ----
    frags: list[dict] = []
    j = 0
    while j < m:
        u = uid_a[j]
        p = j
        while p < m and uid_a[p] == u:
            p += 1
        # group starts by distinct s_pos
        pos_v = [j]
        for t in range(j + 1, p):
            if spos_a[t] != spos_a[pos_v[-1]]:
                pos_v.append(t)
        pos_v.append(p)
        for k in range(len(pos_v) - 2):
            s1, t1 = pos_v[k], pos_v[k + 1]
            s2 = t1
            while s1 < pos_v[k + 1]:
                while s2 < pos_v[k + 2] and upos_a[s2] <= upos_a[s1]:
                    s2 += 1
                if s2 < pos_v[k + 2] and upos_a[s2] > upos_a[s1]:
                    nxt[s1] = s2
                    used[s2] = True
                s1 += 1
        # walk chains from unmarked starting points
        for k in range(j, p):
            if used[k]:
                continue
            s_cnt = 1
            u_gap = s_gap = 0
            t = k
            while nxt[t] >= 0:
                n2 = nxt[t]
                u_gap += abs(int(upos_a[n2]) - int(upos_a[t])) - 1
                s_gap += abs(int(spos_a[n2]) - int(spos_a[t])) - 1
                s_cnt += 1
                t = n2
            if s_cnt == 1:
                continue  # singleton; handled below
            gap = max(u_gap, s_gap, 0)
            score = s_cnt * MATCH_SCORE - gap * GAP_PENALTY
            if score >= 0:
                frags.append(
                    dict(
                        uid=int(u),
                        u_beg=int(upos_a[k]),
                        u_end=int(upos_a[t]),
                        s_beg=int(spos_a[k]),
                        s_end=int(spos_a[t]),
                        s_cnt=s_cnt,
                        score0=score,
                        score=score,
                        prev=[],
                        chained=np.zeros(0, bool),
                    )
                )
                used[k] = True
                # mark chain members
                t = k
                while nxt[t] >= 0:
                    t = nxt[t]
                    used[t] = True
        # singletons: anchors never linked nor consumed
        for k in range(j, p):
            if not used[k] and nxt[k] < 0:
                frags.append(
                    dict(
                        uid=int(u),
                        u_beg=int(upos_a[k]),
                        u_end=int(upos_a[k]),
                        s_beg=int(spos_a[k]),
                        s_end=int(spos_a[k]),
                        s_cnt=1,
                        score0=1,
                        score=1,
                        prev=[],
                    )
                )
        j = p

    if not frags:
        return [], 0

    frags.sort(key=lambda f: (f["s_beg"], f["s_end"]))

    # ---- chaining across graph arcs (exact overlap, no clipping) ----
    mf = len(frags)
    for a in range(mf):
        f = frags[a]
        p = f["s_end"]
        if len(g.vtx_a[f["uid"] >> 1]) - f["u_end"] - 1 > 0:
            continue  # source must reach unitig end
        score = f["score"]
        for b in range(a + 1, mf):
            f1 = frags[b]
            if f1["u_beg"] > 0:
                continue  # target must start at unitig begin
            ai = g.arc_idx(f["uid"], f1["uid"], live_only=True)
            if ai is None:
                continue
            u_ovl = min(int(g.aln[ai]), p + 1)
            p1 = f1["s_beg"]
            if p1 > p + 1:
                break
            if p1 + u_ovl != p + 1:
                continue
            score1 = score + f1["score0"] - u_ovl * MATCH_SCORE
            if score1 <= score or score1 < f1["score"] or (
                score1 == f1["score"] and not f1["prev"]
            ):
                continue
            if score1 > f1["score"]:
                f1["score"] = score1
                f1["prev"] = []
            f1["prev"].append(a)

    max_score = max(f["score"] for f in frags)
    if max_score < min_score_needed:
        return [], max_score

    # ---- multi-optimal backtrace ----
    chains: list[list[int]] = []

    def backtrace(node: int, acc: list[int]):
        acc.append(node)
        if not frags[node]["prev"]:
            chains.append(list(reversed(acc)))
        else:
            for pv in frags[node]["prev"]:
                backtrace(pv, acc)
                acc.pop()

    for a in range(mf):
        if frags[a]["score"] == max_score:
            acc: list[int] = []
            backtrace(a, acc)

    out = []
    for ch in chains:
        cov = sum(frags[t]["s_cnt"] for t in ch)
        if cov / n_scm < MIN_A_FRAC:
            continue
        out.append([frags[t] for t in ch])
    return out, max_score


def _batch_anchors(
    read_db: ReadDB, scg: Scg, sids: np.ndarray, ulen: np.ndarray,
    ns: np.ndarray | None = None,
):
    """Anchor arrays for the gated reads, concatenated and sorted per
    read by (uid, spos, upos) -- the exact order _align_one works in.
    Fully vectorized: one index expansion + one lexsort over every
    gated read's occurrences."""
    idx = scg.idx
    G = len(sids)
    reads = read_db.reads
    if ns is None:
        ns = np.fromiter((len(reads[s].m_pos) for s in sids), np.int64, count=G)
    total = int(ns.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, np.zeros(G + 1, np.int64)
    from .consensus import _Flats

    flats = _Flats.build(read_db, scg.scm_db)
    if flats is not None:
        # gather from the cached whole-run flats instead of per-read
        # concatenation (sids is almost always every mappable read)
        moff_all = np.append(flats.moff, len(flats.kflat))
        s_idx = np.asarray(sids, np.int64)
        st = moff_all[s_idx]
        goff = np.zeros(G + 1, np.int64)
        np.cumsum(ns, out=goff[1:])
        gidx = (
            np.arange(total, dtype=np.int64)
            - np.repeat(goff[:-1], ns)
            + np.repeat(st, ns)
        )
        kflat = flats.kflat[gidx]
        mlow = flats.mflat[gidx].astype(np.int64) & 1
    else:
        kflat = np.concatenate([reads[s].k_mer for s in sids])
        mlow = np.concatenate([reads[s].m_pos for s in sids]).astype(np.int64) & 1
    base = np.zeros(G + 1, np.int64)
    np.cumsum(ns, out=base[1:])
    rid_e = np.repeat(np.arange(G, dtype=np.int64), ns)
    j_e = np.arange(total, dtype=np.int64) - base[rid_e]

    s_arr = (kflat >> np.uint64(1)).astype(np.int64)
    lo = idx.start[s_arr]
    cnt = idx.start[s_arr + 1] - lo
    tot = int(cnt.sum())
    if tot == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, np.zeros(G + 1, np.int64)
    off0 = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    o_idx = np.repeat(lo - off0, cnt) + np.arange(tot, dtype=np.int64)
    u = idx.uid[o_idx]
    p = idx.pos[o_idx]
    rj = np.repeat(mlow, cnt)
    t_rev = idx.rev[o_idx] ^ rj
    uid = (u << 1) | t_rev
    upos = np.where(t_rev == 1, ulen[u] - p - 1, p)
    spos = np.repeat(j_e, cnt)
    rid = np.repeat(rid_e, cnt)

    # single-key sort: pack (rid, uid, spos, upos) into one u64 when the
    # ranges fit (organelle-scale inputs always do) so the native
    # threaded radix argsort replaces the 4-key lexsort
    from .. import native

    order = None
    b_p = int(upos.max()).bit_length()
    b_s = int(spos.max()).bit_length()
    b_i = int(uid.max()).bit_length()
    b_r = int(rid.max()).bit_length()
    if native.available() and b_p + b_s + b_i + b_r <= 64:
        key = (
            (rid.astype(np.uint64) << np.uint64(b_p + b_s + b_i))
            | (uid.astype(np.uint64) << np.uint64(b_p + b_s))
            | (spos.astype(np.uint64) << np.uint64(b_p))
            | upos.astype(np.uint64)
        )
        order = native.argsort_u64(key)
    if order is None:
        order = np.lexsort((upos, spos, uid, rid))
    uid, upos, spos, rid = uid[order], upos[order], spos[order], rid[order]
    aoff = np.searchsorted(rid, np.arange(G + 1, dtype=np.int64)).astype(np.int64)
    return (
        np.ascontiguousarray(uid, np.int64),
        np.ascontiguousarray(upos, np.int64),
        np.ascontiguousarray(spos, np.int64),
        aoff,
    )


def _arc_table(g):
    """(sorted keys v<<32|w, aln values) for live arcs; duplicates keep
    the lowest storage index, matching asmg.arc_idx's scan order."""
    g._flush_pending()
    live = np.flatnonzero(~g.adel)
    keys = (g.av[live].astype(np.uint64) << np.uint64(32)) | g.aw[live].astype(np.uint64)
    uk, first = np.unique(keys, return_index=True)
    return np.ascontiguousarray(uk), np.ascontiguousarray(g.aln[live[first]].astype(np.int64))


def chain_tables(g, idx, flat):
    """Vectorized per-chain tables for the native aligner's flat arrays,
    shared by multiplex (unzip.py) and arc-coverage (coverage.py) so
    neither needs the per-ReadAln object loops.

    Returns None when any consecutive-fragment arc is missing from
    storage (callers fall back to the object path), else a dict with:

    - t:        [P] frag index of each pair's first fragment (pairs are
                consecutive fragments within one chain, in array order)
    - pair_chain: [P] chain index of each pair
    - l, c:     [P] arc_id / comp_arc_id of the pair's arc (asmg.arc_idx
                semantics: first storage match in scan order, deleted
                arcs included)
    - uniq:     [F] per-fragment flag, True when the fragment covers a
                syncmer with a single occurrence in the graph OR its
                chain is uniquely scored (score >= 0.99), matching the
                object loops' conditional uniq computation
    - score:    [C] per-chain score (1.0 for single-chain reads, else
                1/n_chains; the object code's frac(ra.s)-with-epsilon)
    - nfr:      [C] fragments per chain
    """
    frag6 = flat["frag6"]
    cc = np.asarray(flat["aln_cut"], np.int64)
    rc = np.asarray(flat["read_aln_off"], np.int64)
    F = frag6.shape[0]
    n_chain = len(cc) - 1
    nfr = np.diff(cc)
    n_a = np.diff(rc)
    n_a_chain = np.repeat(n_a, n_a)
    # reproduce the object loop's score = frac(1/n_a + max_score)
    # BIT-exactly: the addition rounds, so frac(s) differs from a bare
    # 1/n_a in the last ulp whenever 1/n_a is not dyadic -- and these
    # scores feed float accumulations compared against the C reference
    ms_chain = np.repeat(flat["max_score"].astype(np.float64), n_a)
    s_val = 1.0 / np.maximum(n_a_chain, 1) + ms_chain
    score = s_val - np.floor(s_val)
    score[score < 2.220446049250313e-16] = 1.0

    # per-fragment uniq: prefix sums of the unique-syncmer mask over the
    # flat vertex syncmer arrays
    va_len = np.fromiter(
        (len(a) if a is not None else 0 for a in g.vtx_a), np.int64, count=g.n_vtx
    )
    va_off = np.zeros(g.n_vtx + 1, np.int64)
    np.cumsum(va_len, out=va_off[1:])
    va_flat = (
        np.concatenate([a for a in g.vtx_a if a is not None and len(a)])
        if int(va_off[-1])
        else np.zeros(0, np.uint64)
    )
    s_all = (va_flat >> np.uint64(1)).astype(np.int64)
    uq_mask = (idx.start[s_all + 1] - idx.start[s_all]) == 1
    csum = np.zeros(len(va_flat) + 1, np.int64)
    np.cumsum(uq_mask, out=csum[1:])
    uidv = frag6[:, 0].astype(np.int64)
    base = va_off[uidv >> 1]
    uniq = (csum[base + frag6[:, 2].astype(np.int64) + 1]
            - csum[base + frag6[:, 1].astype(np.int64)]) > 0
    frag_chain = np.repeat(np.arange(n_chain, dtype=np.int64), nfr)
    uniq |= score[frag_chain] >= 0.99

    # consecutive-fragment pairs (chains are contiguous in frag order)
    is_last = np.zeros(F, bool)
    is_last[cc[1:][nfr > 0] - 1] = True
    t = np.flatnonzero(~is_last)
    pair_chain = frag_chain[t]

    # arc lookup over ALL storage arcs: stable-sorted (v<<32|w) keys,
    # first storage index per key == asmg.arc_idx's scan result
    g._flush_pending()
    if len(g.av):
        key = (g.av.astype(np.uint64) << np.uint64(32)) | g.aw.astype(np.uint64)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        fm = np.ones(len(ks), bool)
        fm[1:] = ks[1:] != ks[:-1]
        uk, ui = ks[fm], order[fm]
    else:
        uk = np.zeros(0, np.uint64)
        ui = np.zeros(0, np.int64)
    v = uidv[t]
    w = uidv[t + 1]
    qk = (v.astype(np.uint64) << np.uint64(32)) | w.astype(np.uint64)
    pos = np.minimum(np.searchsorted(uk, qk), max(len(uk) - 1, 0))
    if len(uk) == 0 or not np.all(uk[pos] == qk):
        return None
    ai = ui[pos]
    from ..graph.asmg import UINT64_MAX

    if np.any(g.alink[ai] == np.uint64(UINT64_MAX)):
        # unassigned link ids (arcs added after the last finalize):
        # the object loops handle them via big-int dict keys; bincount
        # cannot, so fall back
        return None
    l_id = (g.alink[ai].astype(np.int64) << 1) | g.acomp[ai].astype(np.int64)
    c_id = l_id ^ ((g.av[ai].astype(np.int64) ^ 1) != g.aw[ai].astype(np.int64))
    return dict(
        t=t, pair_chain=pair_chain, l=l_id, c=c_id,
        uniq=uniq, score=score, nfr=nfr,
    )


def scg_read_alignment(
    read_db: ReadDB, scg: Scg, for_unzip: bool = False, old_ra_db: list | None = None,
    shard: tuple[int, int] | None = None,
) -> list[ReadAln]:
    """Align all (gated) reads; returns alignment records sorted by read.

    shard=(rank, n): align only the rank-th contiguous block of gated
    reads (data parallelism over processes, reference
    alignment.c:636-676); the caller merges the flat results in rank
    order (:mod:`oatk_tpu_torch.dist.stages`).  Reads are mutually
    independent, so the merged result is bit-identical to an unsharded
    run.  With no shard given, a process group of more than one rank or
    OATK_TPU_STAGE_SHARDS > 1 routes the call through that module."""
    if scg.utg.vtx_n1() == 0:
        return []
    if shard is None:
        import os as _os

        from ..dist import comm

        _k = int(_os.environ.get("OATK_TPU_STAGE_SHARDS", "0"))
        if comm.process_count() > 1 or _k > 1:
            from ..dist.stages import sharded_read_alignment

            return sharded_read_alignment(read_db, scg, for_unzip, old_ra_db, n_shards=_k)
    n_reads = read_db.n
    from .. import native

    # per-read syncmer counts, cached per ReadDB version (EC bumps it)
    from .consensus import read_flats

    mc = read_flats(read_db).mc

    old_ra = np.ones(n_reads, np.int64)  # score_threshold<<1 | do_align
    if for_unzip and old_ra_db:
        old_flat = getattr(old_ra_db, "flat", None)
        if old_flat is not None and "max_score" in old_flat:
            # vectorized gate: a read realigns iff some chain spans >2
            # fragments; its threshold is the previous max_score (the
            # object loop's int(ra.s) adjustment always lands there:
            # s = 1/n_a + max_score with 0 < 1/n_a <= 1)
            old_ra[:] = 0
            sids_o = old_flat["sids"]
            n_a_o = np.diff(old_flat["read_aln_off"])
            nfr = np.diff(old_flat["aln_cut"])
            has3 = np.zeros(len(sids_o), bool)
            aln_read = np.repeat(np.arange(len(sids_o), dtype=np.int64), n_a_o)
            has3[aln_read[nfr > 2]] = True
            ms_o = old_flat["max_score"].astype(np.int64)
            old_ra[sids_o[has3]] = (ms_o[has3] << 1) | 1
        else:
            old_ra[:] = 0
            for ra in old_ra_db:
                if ra.n > 2 and (old_ra[ra.sid] & 1) == 0:
                    intpart = int(ra.s)
                    if ra.s - intpart < 1e-9:
                        intpart -= 1
                    old_ra[ra.sid] = intpart << 1 | 1

    ra_db: RaDB = RaDB()
    n_mapped = n_unique = 0
    g = scg.utg
    ulen = np.fromiter((len(a) for a in g.vtx_a), np.int64, count=g.n_vtx)
    n_mappable = int((mc > 0).sum())

    sids_arr = np.flatnonzero((mc > 0) & ((old_ra & 1) == 1))
    if shard is not None:
        r, npr = shard
        lo = (len(sids_arr) * r) // npr
        hi = (len(sids_arr) * (r + 1)) // npr
        sids_arr = sids_arr[lo:hi]
    if native.available() and len(sids_arr):
        n_scm = mc[sids_arr]
        uid, upos, spos, aoff = _batch_anchors(read_db, scg, sids_arr, ulen, n_scm)
        min_sc = (old_ra[sids_arr] >> 1).astype(np.int64)
        arc_key, arc_aln = _arc_table(g)
        res = native.align_batch(uid, upos, spos, aoff, n_scm, min_sc, ulen, arc_key, arc_aln)
        out_frag, chain_cut, read_cut, max_score = res
        ra_db.flat = dict(
            sids=sids_arr,
            frag6=out_frag,
            aln_cut=chain_cut,
            read_aln_off=read_cut,
            max_score=max_score,
        )
        ra_db._lazy = True
        n_a_read = np.diff(read_cut)
        n_mapped = int((n_a_read > 0).sum())
        n_unique = int((n_a_read == 1).sum())
    else:
        sids = sids_arr.tolist()
        for sid in sids:
            r = read_db.reads[sid]
            chains, max_score = _align_one(r, scg, int(old_ra[r.sid]) >> 1, ulen)
            n_a = len(chains)
            if n_a == 0:
                continue
            n_mapped += 1
            if n_a == 1:
                n_unique += 1
            for ch in chains:
                frags = [
                    RaFrag(f["uid"], f["u_beg"], f["u_end"], f["s_beg"], f["s_end"]) for f in ch
                ]
                ra_db.append(ReadAln(r.sid, frags, 1.0 / n_a + max_score))
    if shard is None:
        log_info(
            f"{n_mappable} mappable reads, {n_mapped} mapped ({n_unique} unique mapping)",
            func="scg_read_alignment",
        )
    return ra_db
