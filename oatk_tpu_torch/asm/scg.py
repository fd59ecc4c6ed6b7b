"""Syncmer graph: one vertex per syncmer, arcs from read adjacency.

make_syncmer_graph / scg_scm_utg_index / scg_arc_coverage analogues
(reference syncasm.c:116-368).  Arc counting is a vectorized
sort-reduce over all consecutive syncmer pairs across reads.
"""
from __future__ import annotations

import os as _os
from dataclasses import dataclass, field

import numpy as np

from ..graph.asmg import Asmg
from ..graph.unitig import unitigging
from ..index.syncmer_db import SyncmerDB
from ..utils import log_info
from ..utils.trace import span
from .reads import ReadDB


@dataclass
class ScgIndex:
    """Inverted index syncmer -> (unitig, pos, rev) occurrences, sorted by
    (scm, rev, uid, pos) like the reference 128-bit keys."""

    scm: np.ndarray
    rev: np.ndarray
    uid: np.ndarray
    pos: np.ndarray
    start: np.ndarray  # [n_scm+1] offsets

    def occ(self, s: int):
        lo, hi = self.start[s], self.start[s + 1]
        return slice(lo, hi)

    def n_occ(self, s: int) -> int:
        return int(self.start[s + 1] - self.start[s])


@dataclass
class Scg:
    scm_db: SyncmerDB
    utg: Asmg
    idx: ScgIndex | None = None

    def rebuild_index(self):
        self.idx = build_scm_utg_index(self.utg, self.scm_db.n)

    def is_empty(self) -> bool:
        return not np.any(~self.scm_db.del_)


def build_scm_utg_index(utg: Asmg, n_scm: int) -> ScgIndex:
    vdel = np.asarray(utg.vtx_del, bool)
    live = np.flatnonzero(~vdel)
    vf = getattr(utg, "_va_flat", None)
    vo = getattr(utg, "_va_off", None)
    if vf is not None and vo is not None and len(vo) == utg.n_vtx + 1:
        lens_all = np.diff(vo)
        if len(live) == utg.n_vtx:
            lens, cat = lens_all, vf
        else:
            lens = lens_all[live]
            cat = vf[np.repeat(~vdel, lens_all)]
        have = len(cat) > 0
    else:
        arrs = [utg.vtx_a[i] for i in live]
        have = bool(arrs)
        if have:
            lens = np.fromiter(map(len, arrs), np.int64, count=len(arrs))
            cat = np.concatenate(arrs)
    if have:
        scm = (cat >> np.uint64(1)).astype(np.int64)
        rev = (cat & np.uint64(1)).astype(np.int64)
        uid = np.repeat(live.astype(np.int64), lens)
        starts = np.concatenate([[0], np.cumsum(lens[:-1])]) if len(lens) else np.zeros(0, np.int64)
        pos = np.arange(len(cat), dtype=np.int64) - np.repeat(starts, lens)
        # concatenation order is already (uid, pos)-sorted, so a stable
        # sort on (scm, rev) -- which is exactly the packed uint64
        # syncmer entry `cat` -- reproduces the 4-key lexsort
        from .. import native

        order = native.argsort_u64(cat)
        if order is None:
            order = np.lexsort((rev, scm))
        scm, rev, uid, pos = scm[order], rev[order], uid[order], pos[order]
    else:
        scm = rev = uid = pos = np.zeros(0, np.int64)
    start = np.searchsorted(scm, np.arange(n_scm + 1))
    return ScgIndex(scm, rev, uid, pos, start)


def _read_adjacent_pairs(read_db: ReadDB):
    """All canonical consecutive-syncmer pairs (v0,v1) across reads,
    vectorized over the flat syncmer stream (a pair is valid unless its
    first member is the last syncmer of its read)."""
    from .consensus import read_flats

    rf = read_flats(read_db)
    kflat, mflat = rf.kflat, rf.mflat
    m = len(kflat)
    if m < 2:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    v = (kflat >> np.uint64(1)) << np.uint64(1) | (
        mflat.astype(np.uint64) & np.uint64(1)
    )
    ok = np.ones(m - 1, bool)
    last_of_read = np.cumsum(rf.mc[rf.mc > 0])[:-1] - 1
    ok[last_of_read] = False
    v0 = v[:-1][ok]
    v1 = v[1:][ok]
    if not len(v0):
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    flip = v0 > v1
    cv0 = np.where(flip, v1 ^ np.uint64(1), v0)
    cv1 = np.where(flip, v0 ^ np.uint64(1), v1)
    return cv0, cv1


def make_syncmer_graph(
    read_db: ReadDB, scm_db: SyncmerDB, min_k_cov: int, min_a_cov_f: float
) -> Scg:
    with span("vtx"):
        g = Asmg()
        # filter by kmer coverage (persistently marks scm_db.del_)
        scm_db.del_ |= scm_db.cov < np.uint32(min_k_cov)
        n = scm_db.n
        # bulk vertex creation (one per syncmer; a 40k-call add_vtx loop
        # dominated profiles on high-error inputs)
        ids2 = (np.arange(n, dtype=np.uint64) << np.uint64(1)).reshape(n, 1)
        from ..graph.asmg import LazyRows

        g.vtx_a = LazyRows(ids2)
        g._va_flat = ids2.reshape(n)  # read-only consumers; no copy
        g._va_off = np.arange(n + 1, dtype=np.int64)
        g.vtx_seq = [None] * n
        g.vtx_len = np.zeros(n, np.int64)
        g.vtx_cov = scm_db.cov.astype(np.int64)
        g.vtx_del = np.asarray(scm_db.del_).copy()
        g.vtx_circ = np.zeros(n, bool)

    with span("pairs"):
        # device-counted pairs: the devcount finalize already sort-reduced
        # every adjacent canonical pair on device (index/devcount.py); valid
        # while the reads are unspliced (EC bumps read_db.version)
        dp = getattr(read_db, "_dev_pairs", None)
        if dp is not None and dp[0] == getattr(read_db, "version", 0):
            pk_unique, counts = dp[1], dp[2]
            uv0 = (pk_unique >> np.uint64(32)).astype(np.int64)
            uv1 = (pk_unique & np.uint64(0xFFFFFFFF)).astype(np.int64)
            # hi=2^31 is safe because devcount packs v = gid<<1|rev with
            # int32 gid (see devcount.py finalize INVARIANT comment); the
            # host-sort branch below instead widens hi for >=2^32 ids
            hi, n_pairs = (1 << 31), len(uv0)
        else:
            if dp is not None:
                read_db._dev_pairs = None  # stale (EC spliced reads): free
            pk_unique = None
            cv0, cv1 = _read_adjacent_pairs(read_db)
            n_pairs = len(cv0)
    with span("arcs"):
        if pk_unique is None and n_pairs:
            hi = max(int(cv0.max()), int(cv1.max()))
            if hi < (1 << 32):
                # post-collection vertex ids are small: one packed-u64 sort
                # replaces the two-key lexsort over all adjacent pairs; in
                # multi-process runs the sort-reduce is range-sharded
                # across ranks (dist/stages.py, bit-identical merge)
                from .. import native
                from ..dist.stages import sharded_pair_reduce

                packed = np.ascontiguousarray((cv0 << np.uint64(32)) | cv1)
                res = sharded_pair_reduce(packed)
                if res is not None:
                    pk_unique, counts = res
                    uv0 = (pk_unique >> np.uint64(32)).astype(np.int64)
                    uv1 = (pk_unique & np.uint64(0xFFFFFFFF)).astype(np.int64)
                    k0 = None
                else:
                    if not native.sort_u64(packed):
                        packed.sort(kind="stable")
                    k0 = packed >> np.uint64(32)
                    k1 = packed & np.uint64(0xFFFFFFFF)
            else:
                order = np.lexsort((cv1, cv0))
                k0, k1 = cv0[order], cv1[order]
            if k0 is not None:
                new = np.concatenate([[True], (k0[1:] != k0[:-1]) | (k1[1:] != k1[:-1])])
                starts = np.flatnonzero(new)
                counts = np.diff(np.concatenate([starts, [len(k0)]]))
                uv0 = k0[starts].astype(np.int64)
                uv1 = k1[starts].astype(np.int64)
                if hi < (1 << 32):
                    pk_unique = packed[starts]
        if n_pairs:
            covs = scm_db.cov.astype(np.int64)
            mincov = np.minimum(covs[uv0 >> 1], covs[uv1 >> 1])
            dels = np.asarray(scm_db.del_)
            ok = (
                (counts >= min_a_cov_f * mincov)
                & ~dels[uv0 >> 1]
                & ~dels[uv1 >> 1]
            )
            if bool(ok.all()):
                # unfiltered graph (EC prelude: min_a_cov_f=0, no deletions):
                # keep views instead of fancy-index copies of ~10M-row arrays
                s0, s1, sc = uv0, uv1, counts
                ok = slice(None)
            else:
                s0, s1, sc = uv0[ok], uv1[ok], counts[ok]
            # (s1^1)==s0 iff (s0^1)==s1: one term decides palindromes
            has_comp = (s1 ^ 1) != s0
            # Duplicate-key scan: a pair key (s0,s1) and its complement key
            # (s1^1,s0^1) can BOTH occur as canonical pair keys (e.g. a
            # tandem-duplicated syncmer read from both strands: (a,a) and
            # (a^1,a^1)); each then generates the other as its complement
            # arc, and the reference's fix_symm / link-id semantics on
            # duplicate keys follow first-occurrence overwrite order, which
            # only the generic finalize path preserves.  Self-complementary
            # keys (s1 == s0^1) are palindromic single arcs, not duplicates.
            # One radix argsort of the combined fwd+comp keys yields both
            # the duplicate test (each half is internally unique, so a
            # cross-half duplicate = adjacent equal sorted keys) and every
            # arc's final position (inverse permutation) -- replacing the
            # binary-search dup probe + per-half argsort + two searchsorted
            # passes.
            nf = len(s0)
            dup_free = False
            native_arcs = None
            keys = order = csrc = None
            if hi < (1 << 32) and nf:
                from .. import native

                pk = pk_unique[ok]  # kept unique keys = s0<<32|s1, sorted
                nat = (
                    native.graph_build_arcs(pk, sc)
                    if _os.environ.get("OATK_TPU_GRAPH_NATIVE", "1") not in ("0", "")
                    else None
                )
                if nat is not None and len(nat) == 5:
                    # threaded C merge built the finalize-order arc table
                    # directly (native/graph_build.c); skip the Python
                    # argsort + scatters below
                    native_arcs = nat
                    dup_free = True
                elif nat is not None:
                    dup_free = False  # duplicate keys: generic path
                else:
                    comp_key = ((s1.astype(np.uint64) ^ np.uint64(1)) << np.uint64(32)) | (
                        s0.astype(np.uint64) ^ np.uint64(1)
                    )
                    csrc = np.flatnonzero(has_comp)  # fwd row of each comp arc
                    keys = np.concatenate([pk, comp_key[csrc]])
                    order = native.argsort_u64(keys)
                    if order is None:
                        order = np.argsort(keys, kind="stable")
                    ks = keys[order]
                    dup_free = not np.any(ks[1:] == ks[:-1])
            g._flush_pending()
            from ..graph.asmg import UINT64_MAX as _U64

            if dup_free and native_arcs is not None:
                av, aw, acov, acomp, partner = native_arcs
                total = len(av)
                g.av, g.aw, g.acov, g.acomp = av, aw, acov, acomp
                g.aln = np.zeros(total, np.int64)
                g.als = np.zeros(total, np.int64)
                g.adel = np.zeros(total, bool)
                g.alink = np.full(total, _U64, np.uint64)
                g._arc_partner = partner
                g._arcs_sorted = True
                g._arc_symm_clean = True
            elif dup_free:
                # Construct the arc arrays DIRECTLY in finalize's sorted
                # order: with all nf fwd + nc comp keys distinct, the merged
                # rank of every key is the inverse of `order`, the
                # complement partner of every arc is known, and the
                # post-fix_symm comp flags are fwd=False / comp=True /
                # palindrome=True.  finalize then skips its argsort + 8
                # permutation gathers and fix_symm's rewrites entirely --
                # each avoided fresh allocation also avoids a first-touch
                # page-fault cost.
                nc = len(csrc)
                total = nf + nc
                pos = np.empty(total, np.int64)
                pos[order] = np.arange(total, dtype=np.int64)
                posF = pos[:nf]
                posC = pos[nf:]
                av = np.empty(total, np.uint64)
                aw = np.empty(total, np.uint64)
                acov = np.empty(total, np.int64)
                acomp = np.zeros(total, bool)
                partner = np.empty(total, np.int64)
                av[posF] = s0.astype(np.uint64)
                aw[posF] = s1.astype(np.uint64)
                acov[posF] = sc
                pal = posF[~has_comp]
                acomp[pal] = True  # palindrome: single self-complement arc
                partner[pal] = pal
                av[posC] = (s1[csrc] ^ 1).astype(np.uint64)
                aw[posC] = (s0[csrc] ^ 1).astype(np.uint64)
                acov[posC] = sc[csrc]
                acomp[posC] = True
                pf = posF[csrc]
                partner[pf] = posC
                partner[posC] = pf
                g.av, g.aw, g.acov, g.acomp = av, aw, acov, acomp
                g.aln = np.zeros(total, np.int64)
                g.als = np.zeros(total, np.int64)
                g.adel = np.zeros(total, bool)
                g.alink = np.full(total, _U64, np.uint64)
                g._arc_partner = partner
                g._arcs_sorted = True
                g._arc_symm_clean = True
            else:
                # generic path (key overflow or duplicate keys): fwd +
                # complement interleaved in loop order; finalize does the
                # full sort / complement match / comp-flag reconciliation
                rows = 1 + has_comp.astype(np.int64)
                off = np.zeros(nf, np.int64)
                np.cumsum(rows[:-1], out=off[1:])
                total = int(rows.sum())
                av = np.empty(total, np.uint64)
                aw = np.empty(total, np.uint64)
                acov = np.empty(total, np.int64)
                acomp = np.zeros(total, bool)
                av[off] = s0.astype(np.uint64)
                aw[off] = s1.astype(np.uint64)
                acov[off] = sc
                co = off[has_comp] + 1
                av[co] = (s1[has_comp] ^ 1).astype(np.uint64)
                aw[co] = (s0[has_comp] ^ 1).astype(np.uint64)
                acov[co] = sc[has_comp]
                acomp[co] = True
                g.av = np.concatenate([g.av, av])
                g.aw = np.concatenate([g.aw, aw])
                g.aln = np.concatenate([g.aln, np.zeros(total, np.int64)])
                g.als = np.concatenate([g.als, np.zeros(total, np.int64)])
                g.acov = np.concatenate([g.acov, acov])
                g.adel = np.concatenate([g.adel, np.zeros(total, bool)])
                g.acomp = np.concatenate([g.acomp, acomp])
                g.alink = np.concatenate([g.alink, np.full(total, _U64, np.uint64)])
    vdel0 = np.asarray(g.vtx_del, bool)
    any_del = bool(vdel0.any())
    if any_del:
        vdel0 = vdel0.copy()  # finalize's cleanup resets vtx_del
    g.finalize(True)
    with span("index"):
        scg = Scg(scm_db=scm_db, utg=g)
        if _os.environ.get("OATK_TPU_GRAPH_NATIVE", "1") not in ("0", ""):
            # the bulk graph holds exactly one syncmer per vertex in id
            # order, so the inverted index is analytic: occurrence list =
            # live syncmers, uid = post-cleanup rank, rev = pos = 0 -- no
            # sort, no gathers (build_scm_utg_index reproduces exactly this
            # with a sort+gather; equivalence is locked by
            # tests/test_graph_build_native.py)
            keep = ~vdel0
            live = np.flatnonzero(keep).astype(np.int64)
            z = np.zeros(len(live), np.int64)
            start = np.zeros(scm_db.n + 1, np.int64)
            np.cumsum(keep, out=start[1:])
            uid = np.arange(len(live), dtype=np.int64) if any_del else live
            scg.idx = ScgIndex(live, z, uid, z, start)
        else:
            scg.rebuild_index()
    return scg


def process_mergeable_unitigs(scg: Scg):
    scg.utg = unitigging(scg.utg)
    scg.rebuild_index()


def scg_subgraph_stat(scg: Scg, fo):
    """Per-connected-component unitig/syncmer/arc counts
    (scg_subgraph_stat analogue, reference syncasm.c:423-463)."""
    from ..graph.traverse import subgraph as asmg_subgraph

    utg = scg.utg
    n_utg = utg.n_vtx
    visited = np.zeros(n_utg, bool)
    s = 0
    utg._flush_pending()
    for i in range(n_utg):
        if visited[i] or utg.vtx_del[i]:
            continue
        vtx = asmg_subgraph(utg, [i], 0, 0, modify_graph=False)
        flag = np.zeros(n_utg, bool)
        n_scm = 0
        for v in vtx:
            n_scm += len(utg.vtx_a[v])
            flag[v] = True
            visited[v] = True
        n_arc = sum(
            1
            for j in range(len(utg.av))
            if not utg.adel[j]
            and flag[int(utg.av[j]) >> 1]
            and flag[int(utg.aw[j]) >> 1]
        )
        print(f"[M::scg_subgraph_stat] syncmer graph stats for subgraph {s} - seeding u{vtx[0]}", file=fo)
        print(f"[M::scg_subgraph_stat] number unitigs  : {len(vtx)}", file=fo)
        print(f"[M::scg_subgraph_stat] number syncmers : {n_scm}", file=fo)
        print(f"[M::scg_subgraph_stat] number arcs     : {n_arc}", file=fo)
        s += 1


def scg_print_unitig_syncmer_list(scg: Scg, fo):
    """Dump per-unitig syncmer lists with coverages (debug aid)."""
    utg = scg.utg
    for i in range(utg.n_vtx):
        if utg.vtx_del[i]:
            continue
        items = " ".join(
            f"{int(x)>>1}{'+-'[int(x)&1]}[{int(scg.scm_db.cov[int(x)>>1])}]"
            for x in utg.vtx_a[i]
        )
        print(f"u{i} syncmer list: {items}", file=fo)


def scg_stat(scg: Scg, fo=None):
    utg = scg.utg
    n_utg = utg.vtx_n1()
    n_scm = sum(len(utg.vtx_a[i]) for i in range(utg.n_vtx) if not utg.vtx_del[i])
    utg._flush_pending()
    n_arc = int(np.count_nonzero(~utg.adel))
    if fo is not None:
        import sys

        p = fo if fo is not None else sys.stderr
        print(f"[M::scg_stat] number unitigs  : {n_utg}", file=p)
        print(f"[M::scg_stat] number syncmers : {n_scm}", file=p)
        print(f"[M::scg_stat] number arcs     : {n_arc}", file=p)
    return n_scm, n_utg, n_arc
