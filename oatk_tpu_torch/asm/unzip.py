"""Repeat resolution by read threading: multiplex / demultiplex.

scg_multiplex expands arcs supported by spanning read triplets into
compound vertices (dropping triplets dominated by min_d_f-fold stronger
ones); scg_demultiplex collapses every connected component back to
one-vertex-per-syncmer.  Port of reference syncasm.c:1090-1641.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..graph.asmg import Asmg, UINT64_MAX
from .align import ReadAln
from .scg import Scg, process_mergeable_unitigs

DBL_EPSILON = 2.220446049250313e-16


def scg_multiplex(
    scg: Scg, ra_db: list[ReadAln], max_n_scm: int, min_n_r: float, min_d_f: float
) -> int:
    g = scg.utg
    g._flush_pending()
    idx = scg.idx

    # spanning triplet scores keyed by (link_id_in, link_id_out)
    tri_s: dict[tuple[int, int], float] = {}
    flat = getattr(ra_db, "flat", None)
    tbl = None
    if flat is not None and "max_score" in flat and (
        getattr(ra_db, "_lazy", False)
        or len(flat["aln_cut"]) - 1 == list.__len__(ra_db)
    ):
        from .align import chain_tables

        tbl = chain_tables(g, idx, flat)
    if tbl is not None:
        # vectorized spanning-triplet accumulation: consecutive pair
        # (p, p+1) within one chain spans fragments (t, t+1, t+2); the
        # two key streams are interleaved exactly like the object
        # loop's l-then-c dict updates so per-key float-addition order
        # (and thus the bit-exact sums) is preserved
        t, pc = tbl["t"], tbl["pair_chain"]
        l_id, c_id = tbl["l"], tbl["c"]
        uniq, score = tbl["uniq"], tbl["score"]
        p = np.flatnonzero(pc[1:] == pc[:-1])  # pair p and p+1 same chain
        if len(p):
            ok = uniq[t[p]] & uniq[t[p] + 1] & uniq[t[p] + 2]
            p = p[ok]
        if len(p):
            keys = np.empty(2 * len(p), np.uint64)
            keys[0::2] = (l_id[p].astype(np.uint64) << np.uint64(32)) | l_id[
                p + 1
            ].astype(np.uint64)
            keys[1::2] = (c_id[p + 1].astype(np.uint64) << np.uint64(32)) | c_id[
                p
            ].astype(np.uint64)
            wts = np.empty(2 * len(p))
            wts[0::2] = score[pc[p]]
            wts[1::2] = score[pc[p]]
            uk, inv = np.unique(keys, return_inverse=True)
            tot = np.zeros(len(uk))
            np.add.at(tot, inv, wts)
            m32 = np.uint64(0xFFFFFFFF)
            for kk, vv in zip(uk, tot):
                tri_s[(int(kk >> np.uint64(32)), int(kk & m32))] = float(vv)
    else:
        for ra in ra_db:
            m = ra.n
            if m < 3:
                continue
            score = ra.s - int(ra.s)
            if score < DBL_EPSILON:
                score = 1.0
            if score < 0.99:
                uniq = []
                for frg in ra.frags:
                    a = g.vtx_a[frg.uid >> 1]
                    u = any(
                        idx.n_occ(int(a[t]) >> 1) == 1
                        for t in range(frg.u_beg, frg.u_end + 1)
                    )
                    uniq.append(u)
            else:
                uniq = [True] * m
            ai = g.arc_idx(ra.frags[0].uid, ra.frags[1].uid)
            l0, c0 = g.arc_id(ai), g.comp_arc_id(ai)
            for j in range(2, m):
                ai = g.arc_idx(ra.frags[j - 1].uid, ra.frags[j].uid)
                l1, c1 = g.arc_id(ai), g.comp_arc_id(ai)
                if uniq[j - 2] and uniq[j - 1] and uniq[j]:
                    tri_s[(l0, l1)] = tri_s.get((l0, l1), 0.0) + score
                    tri_s[(c1, c0)] = tri_s.get((c1, c0), 0.0) + score
                l0, c0 = l1, c1

    max_l_id = g.max_link_id()
    n_arc0 = len(g.av)
    n_vtx0 = g.n_vtx
    arc_next: dict[int, list[int]] = {}
    vtx_new: dict[int, int] = {}
    multi_vtx = np.zeros(n_vtx0, np.int8)
    updated = 0

    for i in range(n_vtx0):
        if g.vtx_del[i]:
            continue
        v1 = i << 1
        in_arcs = [j for j in g.arc_range(v1 ^ 1) if not g.adel[j]]
        out_arcs = [j for j in g.arc_range(v1) if not g.adel[j]]
        n_in1, n_out1 = len(in_arcs), len(out_arcs)
        if n_in1 == 0 and n_out1 == 0:
            multi_vtx[i] = 2
            continue
        if n_in1 == 0 or n_out1 == 0:
            continue
        l_in = [g.comp_arc_id(j) for j in in_arcs]
        l_out = [g.arc_id(j) for j in out_arcs]
        s_all = np.full((n_in1, n_out1), 0.001)
        for si in range(n_in1):
            for ti in range(n_out1):
                s_all[si, ti] = tri_s.get((l_in[si], l_out[ti]), 0.001)
        s_in = s_all.max(axis=1)
        s_out = s_all.max(axis=0)
        s_max = float(s_all.max())

        if (
            len(g.vtx_a[i]) > max_n_scm
            or g.arc_exists1(v1, v1)
            or s_max < min_n_r
        ):
            for si in range(n_in1):
                for ti in range(n_out1):
                    arc_next.setdefault(l_in[si], []).append(int(g.aw[out_arcs[ti]]))
                    arc_next.setdefault(l_out[ti] ^ 1, []).append(int(g.aw[in_arcs[si]]))
        else:
            for si in range(n_in1):
                for ti in range(n_out1):
                    if s_all[si, ti] / s_in[si] < min_d_f and s_all[si, ti] / s_out[ti] < min_d_f:
                        updated += 1
                        continue
                    arc_next.setdefault(l_in[si], []).append(int(g.aw[out_arcs[ti]]))
                    arc_next.setdefault(l_out[ti] ^ 1, []).append(int(g.aw[in_arcs[si]]))
            multi_vtx[i] = 1

    if updated == 0:
        return 0

    # expand supported arcs into compound vertices
    for i in range(n_arc0):
        if g.adel[i] or g.acomp[i]:
            continue
        if multi_vtx[int(g.av[i]) >> 1] != 1 and multi_vtx[int(g.aw[i]) >> 1] != 1:
            continue
        l0 = g.arc_id(i)
        sv: list[int] = []
        av, aw = int(g.av[i]), int(g.aw[i])
        a = g.vtx_a[av >> 1]
        if av & 1:
            sv.extend(int(x) ^ 1 for x in reversed(a))
        else:
            sv.extend(int(x) for x in a)
        if int(g.aln[i]):
            del sv[len(sv) - int(g.aln[i]) :]
        a = g.vtx_a[aw >> 1]
        if aw & 1:
            sv.extend(int(x) ^ 1 for x in reversed(a))
        else:
            sv.extend(int(x) for x in a)
        nv = g.add_vtx(a=np.array(sv, np.uint64))
        vtx_new[l0] = nv << 1
        vtx_new[l0 ^ 1] = nv << 1 | 1

    # new arcs between compounds (and plain endpoints)
    arc_seen: set[tuple[int, int]] = set()
    for i in range(n_arc0):
        if g.adel[i]:
            continue
        aw = int(g.aw[i])
        l0 = g.arc_id(i)
        c0 = int(g.acov[i])
        v = vtx_new.get(l0, UINT64_MAX)
        s = aw if v == UINT64_MAX else v
        for nxt in arc_next.get(l0, []):
            ai1 = g.arc_idx(aw, nxt)
            l1 = g.arc_id(ai1)
            c1 = int(g.acov[ai1])
            w = vtx_new.get(l1, UINT64_MAX)
            t = aw if w == UINT64_MAX else w
            if v != UINT64_MAX or w != UINT64_MAX:
                if (s, t) in arc_seen:
                    continue
                arc_seen.add((s, t))
                g.add_arc(
                    s, t, len(g.vtx_a[aw >> 1]), g.vtx_len[aw >> 1], UINT64_MAX, (c0 + c1) >> 1, 0
                )

    # delete expanded arcs
    for i in range(n_arc0):
        if g.adel[i]:
            continue
        if vtx_new.get(g.arc_id(i), UINT64_MAX) != UINT64_MAX:
            g.adel[i] = True

    # delete isolated originals
    for i in range(n_vtx0):
        if g.vtx_del[i] or multi_vtx[i] == 2:
            continue
        v1 = i << 1
        if g.arc_n1(v1 ^ 1) == 0 and g.arc_n1(v1) == 0:
            g.vtx_del[i] = True

    g.finalize(True)
    process_mergeable_unitigs(scg)
    return updated


def scg_demultiplex(scg: Scg):
    g = scg.utg
    g._flush_pending()
    n_dir = 2 * g.n_vtx
    flag = np.zeros(n_dir, bool)
    ng = Asmg()

    for i0 in range(n_dir):
        if flag[i0] or g.vtx_del[i0 >> 1]:
            continue
        # collect connected subgraph
        sub: list[int] = []
        q: deque = deque([i0, i0 ^ 1])
        while q:
            v = q.popleft()
            if flag[v]:
                continue
            if v & 1:
                sub.append(v >> 1)
            for j in g.arc_range(v):
                if g.adel[j]:
                    continue
                w = int(g.aw[j])
                if not flag[w]:
                    q.append(w)
                if not flag[w ^ 1]:
                    q.append(w ^ 1)
            flag[v] = True

        h_scm: dict[int, int] = {}
        arc_seen: set[tuple[int, int]] = set()
        for u in sub:
            a = g.vtx_a[u]
            prev = -1
            for k in range(len(a)):
                s = int(a[k]) >> 1
                if s not in h_scm:
                    h_scm[s] = ng.add_vtx(a=np.array([s << 1], np.uint64))
                cur = h_scm[s]
                if k > 0:
                    v = prev << 1 | (int(a[k - 1]) & 1)
                    w = cur << 1 | (int(a[k]) & 1)
                    if (v, w) not in arc_seen:
                        ng.add_arc2(v, w, 0, 0, 0, 0, 0)
                        arc_seen.add((v, w))
                        arc_seen.add((w ^ 1, v ^ 1))
                prev = cur
        # inter-unitig zero-overlap arcs
        m = len(sub) * 2
        for j in range(m):
            v = sub[j >> 1]
            a = g.vtx_a[v]
            pv = (int(a[0]) ^ 1) if (j & 1) else int(a[-1])
            pv = h_scm[pv >> 1] << 1 | (pv & 1)
            for k in range(m):
                w = sub[k >> 1]
                ai = g.arc_idx(v << 1 | (j & 1), w << 1 | (k & 1), live_only=True)
                if ai is None or int(g.aln[ai]) > 0:
                    continue
                a2 = g.vtx_a[w]
                nv = (int(a2[-1]) ^ 1) if (k & 1) else int(a2[0])
                nv = h_scm[nv >> 1] << 1 | (nv & 1)
                if (pv, nv) not in arc_seen:
                    ng.add_arc(pv, nv, 0, 0, 0, 0, 0)
                    arc_seen.add((pv, nv))

    ng.finalize(True)
    scg.utg = ng
    process_mergeable_unitigs(scg)
