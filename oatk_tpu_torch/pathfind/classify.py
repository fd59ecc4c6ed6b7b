"""Organelle classification: annotation scoring, coverage clustering,
seed selection and graph slimming (path.c:2712-4221 analogue).

``asg_annotation`` is the master: per-sequence and per-subgraph og
typing, 1-D DBSCAN coverage clustering, per-cluster classification with
the PLTD->MITO score-fold fixes, seed selection with size/coverage-fold
gates, and repeat-recall graph slimming emitting one component per
organelle subgraph.
"""
from __future__ import annotations

import sys
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..annot.db import ORDER_SID_OG, OG_MINI, OG_MITO, OG_PLTD, OG_TYPES, OG_UNCLASSIFIED, AnnotDB, is_rrn, is_trn
from ..graph.clean import drop_tip, pop_bubble, remove_weak_crosslink
from ..graph.traverse import subgraph as asmg_subgraph
from ..io.gfa import Asg
from ..utils import log_info

COMMON_MAX_PLTD_SIZE = 250000
COMMON_AVG_PLTD_SIZE = 160000
COMMON_MIN_PLTD_SIZE = 80000
PLTD_TO_MITO_FST = (3.0, 5.0)
COMMON_MAX_MITO_SIZE = 3000000
COMMON_MAX_MINICIRCLE_SIZE = 50000
DBSCAN_EPS = 0.25
CLUSTV_EPS = 0.50
LOG4_5 = 1.504077396776


@dataclass
class OgComponent:
    type: int
    score: float
    sscore: float
    len: int
    v: list[int]
    g: np.ndarray  # packed ((gid<<2|og)<<32)|score_u32, descending
    asmg: object | None  # Asmg copy restricted to the component

    @property
    def nv(self) -> int:
        return len(self.v)

    @property
    def ng(self) -> int:
        return len(self.g)


def _max2(a):
    imax = smax = 0
    max_a = smax_a = -np.inf
    for i in range(len(a)):
        if a[i] > max_a:
            smax, smax_a = imax, max_a
            imax, max_a = i, a[i]
        elif a[i] > smax_a:
            smax, smax_a = i, a[i]
    return imax, smax


def _annot_ok(db: AnnotDB, i: int, no_trn: int, no_rrn: int, max_eval: float) -> bool:
    return not (
        db.evalue[i] > max_eval
        or (no_trn and is_trn(db.gname[i]))
        or (no_rrn and is_rrn(db.gname[i]))
    )


def get_sequence_annot_score(
    db: AnnotDB, asg: Asg, no_trn: int, no_rrn: int, max_eval: float, n_core: int, verbose: int = 0
) -> np.ndarray | None:
    """Per-seg, per-og sum of best-hit scores of the top n_core genes."""
    if db.n == 0:
        return None
    if n_core == 0:
        n_core = 1 << 30
    m_gene = db.n_gene
    n_seg = asg.n_seg
    db.sort(ORDER_SID_OG)
    out = np.zeros((n_seg, 4))
    for i in range(n_seg):
        sl = db.query_sname(asg.segs[i].name)
        if sl.start == sl.stop:
            continue
        gene_score = np.zeros((4, m_gene))
        for j in range(sl.start, sl.stop):
            if not _annot_ok(db, j, no_trn, no_rrn, max_eval):
                continue
            og, gid = int(db.og_type[j]), int(db.gid[j])
            if gene_score[og, gid] < db.score[j]:
                gene_score[og, gid] = db.score[j]
        for og in range(4):
            top = np.sort(gene_score[og])[::-1][: min(n_core, m_gene)]
            out[i, og] = top.sum()
    return out


def _gene_list_for_segs(db: AnnotDB, asg: Asg, seg_ids, no_trn, no_rrn, max_eval) -> np.ndarray:
    """Best-hit gene list packed ((gid<<2|og)<<32)|score_u32, desc-sorted."""
    items = []
    for sid in seg_ids:
        sl = db.query_sname(asg.segs[sid].name)
        for j in range(sl.start, sl.stop):
            if not _annot_ok(db, j, no_trn, no_rrn, max_eval):
                continue
            items.append(
                ((int(db.gid[j]) << 2 | int(db.og_type[j])) << 32) | int(db.score[j])
            )
    if not items:
        return np.zeros(0, np.uint64)
    a = np.sort(np.array(items, np.uint64))[::-1]
    keep = np.concatenate([[True], (a[1:] >> np.uint64(32)) != (a[:-1] >> np.uint64(32))])
    return a[keep]


def annot_sequence_og_type(
    db: AnnotDB, asg: Asg, no_trn, no_rrn, max_eval, n_core, min_len, min_score, fix_og, verbose=0
) -> list[OgComponent]:
    """Classify each live segment independently; returns one entry per
    seg (UNCLASSIFIED placeholder where not classified)."""
    if db.n == 0:
        return []
    if n_core == 0:
        n_core = 1 << 30
    m_gene = db.n_gene
    db.sort(ORDER_SID_OG)
    out: list[OgComponent] = []
    for i in range(asg.n_seg):
        comp = OgComponent(OG_UNCLASSIFIED, 0.0, 0.0, 0, [], np.zeros(0, np.uint64), None)
        out.append(comp)
        if asg.asmg.vtx_del[i]:
            continue
        gene_score = np.zeros((4, m_gene))
        sl = db.query_sname(asg.segs[i].name)
        for j in range(sl.start, sl.stop):
            if not _annot_ok(db, j, no_trn, no_rrn, max_eval):
                continue
            og, gid = int(db.og_type[j]), int(db.gid[j])
            if gene_score[og, gid] < db.score[j]:
                gene_score[og, gid] = db.score[j]
        a_s = [
            float(np.sort(gene_score[og])[::-1][: min(n_core, m_gene)].sum()) for og in range(4)
        ]
        imax, smax = _max2(a_s)
        og_t = OG_UNCLASSIFIED
        if a_s[imax] >= min_score:
            og_t = OG_UNCLASSIFIED if a_s[imax] == a_s[smax] else imax
        if og_t != OG_UNCLASSIFIED:
            comp.type = og_t
            comp.score = a_s[imax]
            comp.sscore = a_s[smax]
            comp.len = asg.segs[i].len
            comp.v = [i]
            comp.g = _gene_list_for_segs(db, asg, [i], no_trn, no_rrn, max_eval)
        if verbose > 0:
            log_info(
                f"sequence {asg.segs[i].name}: size, {asg.segs[i].len}; mito score, "
                f"{a_s[OG_MITO]:.3f}; pltd score, {a_s[OG_PLTD]:.3f}; mini score, "
                f"{a_s[OG_MINI]:.3f}; classification, {og_t}",
                func="annot_sequence_og_type",
            )
    if fix_og:
        fix_og_misclassification(out, verbose)
    return out


def annot_subgraph_og_type(
    db: AnnotDB, asg: Asg, no_trn, no_rrn, max_eval, n_core, min_len, min_score, fix_og, verbose=0
) -> list[OgComponent]:
    """Classify each connected subgraph; returns classified components
    sorted by score descending."""
    if db.n == 0:
        return []
    if n_core == 0:
        n_core = 1 << 30
    m_gene = db.n_gene
    n_seg = asg.n_seg
    db.sort(ORDER_SID_OG)
    visited = np.zeros(n_seg, bool)
    out: list[OgComponent] = []
    for i in range(n_seg):
        if visited[i] or asg.asmg.vtx_del[i]:
            continue
        g = asg.asmg.copy()
        asmg_subgraph(g, [i], 0, 0, modify_graph=True)
        gene_score = np.zeros((4, m_gene))
        comp_v = []
        length = 0
        for j in range(n_seg):
            if g.vtx_del[j]:
                continue
            comp_v.append(j)
            length += g.vtx_len[j]
            visited[j] = True
            sl = db.query_sname(asg.segs[j].name)
            for k in range(sl.start, sl.stop):
                if not _annot_ok(db, k, no_trn, no_rrn, max_eval):
                    continue
                og, gid = int(db.og_type[k]), int(db.gid[k])
                if gene_score[og, gid] < db.score[k]:
                    gene_score[og, gid] = db.score[k]
        a_s = [
            float(np.sort(gene_score[og])[::-1][: min(n_core, m_gene)].sum()) for og in range(4)
        ]
        imax, smax = _max2(a_s)
        og_t = OG_UNCLASSIFIED
        if length >= min_len or a_s[imax] >= min_score:
            og_t = OG_UNCLASSIFIED if a_s[imax] == a_s[smax] else imax
        if og_t == OG_UNCLASSIFIED:
            continue
        out.append(
            OgComponent(
                og_t,
                a_s[imax],
                a_s[smax],
                length,
                comp_v,
                _gene_list_for_segs(db, asg, comp_v, no_trn, no_rrn, max_eval),
                g,
            )
        )
        if verbose > 0:
            log_info(
                f"subgraph seeding from {asg.segs[i].name}: segs, {len(comp_v)}; size, "
                f"{length}; mito score, {a_s[OG_MITO]:.3f}; pltd score, {a_s[OG_PLTD]:.3f}; "
                f"mini score, {a_s[OG_MINI]:.3f}; classification, {og_t}",
                func="annot_subgraph_og_type",
            )
    if fix_og:
        fix_og_misclassification(out, verbose)
    out.sort(key=lambda c: -c.score)
    return out


def fix_og_misclassification(components: list[OgComponent], verbose: int = 0):
    """Demote PLTD components whose annotation looks mito-contaminated
    (score-fold and size gates, reference path.c:2772-2872)."""
    n = len(components)
    gen_list: list[int] = []
    for i, comp in enumerate(components):
        for x in comp.g:
            x = int(x)
            gen_list.append((x & 0xFFFFFFFF00000000) | (((x & 0xFFFFFFFF) << 16) & 0xFFFF0000) | i)
    if not gen_list:
        return
    gen_list = sorted(gen_list, reverse=True)
    mito_gen = np.zeros(n, np.int64)
    pltd_gen = np.zeros(n, np.int64)
    m = len(gen_list)
    genid = gen_list[0] >> 32
    j = 0
    for i in range(m):
        if (gen_list[i] >> 32) != genid or i == m - 1:
            og = (gen_list[i] >> 32) & 0x3
            if og in (OG_MITO, OG_PLTD):
                if i == j or float((gen_list[j + 1] >> 16) & 0xFFFF) < float(
                    (gen_list[j] >> 16) & 0xFFFF
                ) * 0.8:
                    x = gen_list[j] & 0xFFFF
                    if og == OG_MITO:
                        mito_gen[x] += 1
                    else:
                        pltd_gen[x] += 1
            genid = gen_list[i] >> 32
            j = i

    p_b = p_b1 = -1
    p_s = p_s1 = 0.0
    for i, comp in enumerate(components):
        if comp.type != OG_PLTD:
            continue
        if comp.score > p_s and comp.len >= COMMON_MIN_PLTD_SIZE:
            if comp.len <= COMMON_MAX_PLTD_SIZE:
                p_b = i
                p_s = comp.score
            p_b1 = i
            p_s1 = comp.score
    if p_b == -1:
        p_b = p_b1
    if p_b == -1:
        return
    for i, comp in enumerate(components):
        if i == p_b or comp.type != OG_PLTD:
            continue
        if pltd_gen[i] > mito_gen[i] * PLTD_TO_MITO_FST[1]:
            continue
        if comp.score > comp.sscore * PLTD_TO_MITO_FST[1]:
            continue
        if comp.score < comp.sscore * PLTD_TO_MITO_FST[0] or (
            comp.len < COMMON_MIN_PLTD_SIZE or comp.len > COMMON_MAX_PLTD_SIZE
        ):
            comp.score, comp.sscore = comp.sscore, comp.score
            comp.type = OG_MITO if comp.score > 0.0 else OG_UNCLASSIFIED
            if verbose > 0:
                log_info(
                    "change subgraph organelle type annotation: PLTD -> "
                    f"{OG_TYPES[comp.type]}",
                    func="fix_og_misclassification",
                )


# ---------------- coverage clustering + seeds + slimming ----------------

def _dbscan_cluster(vals, eps: float, v_eps: float):
    """1-D chained clustering over sorted coverage values; returns
    cluster id per input index."""
    n = len(vals)
    order = np.argsort(vals, kind="stable")
    clust = np.zeros(n, np.int64)
    running = 0.0
    cnt = 0
    cid = 0
    for rank, i in enumerate(order):
        if rank == 0:
            running, cnt = vals[i], 1
        else:
            prev = vals[order[rank - 1]]
            if vals[i] <= prev * (1 + eps) and vals[i] <= running / cnt * (1 + v_eps):
                running += vals[i]
                cnt += 1
            else:
                cid += 1
                running, cnt = vals[i], 1
        clust[i] = cid
    return clust, cid + 1


def slim_graph(
    asg: Asg,
    sequence_og: list[OgComponent],
    component_g: OgComponent,
    gene_num: np.ndarray,  # [nv, 4]
    og_target: int,
    og_seeds: np.ndarray,  # [nv] of og type
    c_mean: float,
    max_r_len: int,
    components: list[OgComponent],
    verbose: int = 0,
):
    asmg = component_g.asmg.copy()
    n_vtx = asmg.n_vtx
    comp_v = component_g.v
    nv = len(comp_v)

    dels = np.zeros(n_vtx, bool)
    for i in range(nv):
        if og_seeds[i] != og_target:
            dels[comp_v[i]] = True

    # repeat recall: bring a repeat back when both directions connect to
    # kept sequence through all-repeat paths within max_r_len
    while True:
        dist = np.zeros(2 * n_vtx, np.int64)
        for i in range(nv):
            if dels[comp_v[i]]:
                continue
            max_r = min(asmg.vtx_len[comp_v[i]], max_r_len)
            for k in range(2):
                source = comp_v[i] << 1 | k
                flag = np.zeros(2 * n_vtx, bool)
                q = deque([(source, 0)])
                while q:
                    v, r = q.popleft()
                    flag[v] = True
                    dist[v] = source << 1 | 1
                    for j in asmg.arc_range(v):
                        if asmg.adel[j]:
                            continue
                        w = int(asmg.aw[j])
                        if (
                            not flag[w]
                            and r <= int(asmg.als[j]) + max_r
                            and asmg.vtx_len[w >> 1] <= max_r
                        ):
                            q.append((w, r + asmg.vtx_len[w >> 1] - int(asmg.als[j])))
        recall = 0
        for i in range(nv):
            v = comp_v[i]
            if dels[v] and asmg.vtx_len[v] <= max_r_len and dist[v << 1] and dist[v << 1 | 1]:
                dels[v] = False
                recall += 1
        if not recall:
            break

    for i in range(nv):
        if dels[comp_v[i]]:
            asmg.vtx_delete(comp_v[i], True)

    cleaned = 1
    while cleaned:
        cleaned = 0
        cleaned += pop_bubble(asmg, max_r_len, 0, False, True, False, verbose)
        cleaned += remove_weak_crosslink(asmg, 0.3, 10, False, verbose)
        cleaned += drop_tip(asmg, 0x7FFFFFFF, max_r_len, True, False, verbose)
    for i in range(nv):
        if asmg.vtx_del[comp_v[i]]:
            dels[comp_v[i]] = True

    m_size = sum(asmg.vtx_len[comp_v[i]] for i in range(nv) if not asmg.vtx_del[comp_v[i]]) * 0.1

    visited = np.zeros(n_vtx, bool)
    for i in range(nv):
        v = comp_v[i]
        if visited[v] or asmg.vtx_del[v]:
            continue
        g = asmg.copy()
        asmg_subgraph(g, [v], 0, 0, modify_graph=True)
        comp_s = []
        length = gen = 0
        for j in range(nv):
            w = comp_v[j]
            if g.vtx_del[w]:
                continue
            comp_s.append(w)
            length += g.vtx_len[w]
            gen += int(gene_num[j, og_target])
            visited[w] = True
        if length < m_size or gen == 0:
            continue

        # adjust repeat coverage pulled up by deleted neighbors
        for j in range(nv):
            w = comp_v[j]
            if (
                g.vtx_del[w]
                or og_seeds[j] == og_target
                or g.vtx_len[w] >= max_r_len
                or g.vtx_cov[w] < c_mean * 3.5
            ):
                continue
            n_del = n_arc = 0
            for k in range(2):
                for l in asmg.arc_range(w << 1 | k):
                    if dels[int(asmg.aw[l]) >> 1]:
                        n_del += 1
                    if not asmg.adel[l]:
                        n_arc += 1
            if not n_del:
                continue
            cov = g.vtx_cov[w]
            g.vtx_cov[w] = int(c_mean * n_arc / 2.0)
            for k in range(2):
                for l in asmg.arc_range(w << 1 | k):
                    if not asmg.adel[l] and asmg.acov[l] > cov:
                        asmg.acov[l] = cov

        # gene list from member sequences
        glist = []
        for j in range(nv):
            w = comp_v[j]
            if g.vtx_del[w]:
                continue
            glist.extend(int(x) for x in sequence_og[w].g)
        glist = sorted(glist, reverse=True)
        dedup = []
        gid = None
        for x in glist:
            if (x >> 32) != gid:
                dedup.append(x)
                gid = x >> 32
        score = [0.0] * 4
        for x in dedup:
            score[(x >> 32) & 0x3] += x & 0xFFFFFFFF
        imax, smax = _max2(score)

        components.append(
            OgComponent(
                og_target,
                score[imax],
                score[smax],
                length,
                comp_s,
                np.array(dedup, np.uint64),
                g,
            )
        )
        if verbose > 0:
            log_info(
                f"subgraph seeding from {asg.segs[v].name}: segs, {len(comp_s)}; size, "
                f"{length}; classification, {og_target}",
                func="slim_graph",
            )


def find_seeds_in_pure_graph(
    clusts,  # list of dicts: {dps: [idx], mean, size, og_type}
    comp_dps_val: np.ndarray,
    comp_dps_size: np.ndarray,
    gene_num: np.ndarray,  # [nv, 4]
    og_t: int,
    min_mean: float,
    max_mean: float,
    fold_thresh: float,
    min_size: int,
    max_size: int,
    og_seeds: np.ndarray,
    verbose: int = 0,
):
    n_clust = len(clusts)
    nv = len(comp_dps_val)
    gseq_clust = np.zeros(n_clust, np.int64)
    gene_clust = []
    for i, cl in enumerate(clusts):
        ng = 0
        for v in cl["dps"]:
            ng += int(gene_num[v, og_t])
            if gene_num[v, og_t] > 0:
                gseq_clust[i] += comp_dps_size[v]
        if gseq_clust[i] > 0.5 * cl["size"]:
            gseq_clust[i] = cl["size"]
        gene_clust.append((ng << 32) | i)
    gene_clust.sort(reverse=True)

    seed_clust = np.zeros(n_clust, bool)
    min_mean1 = max_mean1 = 0.0
    n_seeds = l_seeds = 0
    for x in gene_clust:
        if (x >> 32) == 0:
            break
        c = x & 0xFFFFFFFF
        if clusts[c]["og_type"] != og_t:
            continue
        c_mean = clusts[c]["mean"]
        if c_mean < min_mean and c_mean > max_mean:
            continue
        if l_seeds + gseq_clust[c] > max_size:
            continue
        seed = False
        if n_seeds == 0:
            min_mean1 = max_mean1 = c_mean
            seed = True
        else:
            if gseq_clust[c] >= min_size:
                if min_mean1 <= c_mean <= max_mean1:
                    seed = True
                elif (
                    abs(np.log(min_mean1 / c_mean)) <= fold_thresh
                    and abs(np.log(max_mean1 / c_mean)) <= fold_thresh
                ):
                    min_mean1 = min(min_mean1, c_mean)
                    max_mean1 = max(max_mean1, c_mean)
                    seed = True
            else:
                seed = True
        if seed:
            seed_clust[c] = True
            n_seeds += 1
            l_seeds += int(gseq_clust[c])

    og_seeds[:] = OG_UNCLASSIFIED
    for i, cl in enumerate(clusts):
        if not seed_clust[i]:
            continue
        all_seq = cl["size"] == gseq_clust[i]
        for v in cl["dps"]:
            if all_seq or gene_num[v, og_t] > 0:
                og_seeds[v] = og_t

    og_t1 = OG_UNCLASSIFIED
    if og_t == OG_MITO:
        og_t1 = OG_PLTD
    elif og_t == OG_PLTD:
        og_t1 = OG_MITO
    ext = []
    ext_l = 0
    for i in range(nv):
        c_mean = comp_dps_val[i]
        if (
            not og_seeds[i]
            and (og_t1 == OG_UNCLASSIFIED or gene_num[i, og_t1] == 0 or gene_num[i, og_t] > 0)
            and min_mean <= c_mean <= max_mean
            and min_mean1 > 0
            and abs(np.log(min_mean1 / c_mean)) <= fold_thresh
        ):
            ext.append(i)
            ext_l += int(comp_dps_size[i])
    if l_seeds + ext_l <= max_size:
        for i in ext:
            og_seeds[i] = og_t
        l_seeds += ext_l

    return l_seeds, min_mean1


def asg_annotation(
    db: AnnotDB, asg: Asg, no_trn, no_rrn, max_eval, n_core, min_len, min_score, fix_og, verbose=0
) -> list[OgComponent] | None:
    """Master classifier with coverage clustering + graph slimming."""
    if db.n == 0:
        return None
    m_gene = db.n_gene
    seg_score = get_sequence_annot_score(db, asg, no_trn, no_rrn, max_eval, 0, verbose)
    sequence_og = annot_sequence_og_type(
        db, asg, no_trn, no_rrn, max_eval, n_core, min_len, min_score, 0, verbose
    )
    subgraph_og = annot_subgraph_og_type(
        db, asg, no_trn, no_rrn, max_eval, n_core, min_len, min_score, 0, verbose
    )

    # global best score per (og, gene) across sequence components
    annot_score = np.zeros((4, m_gene))
    for comp in sequence_og:
        for x in comp.g:
            x = int(x)
            gid = x >> 34
            og = (x >> 32) & 0x3
            sc = x & 0xFFFFFFFF
            if annot_score[og, gid] < sc:
                annot_score[og, gid] = sc

    g_diff = 0.85
    out: list[OgComponent] = []
    for component_g in subgraph_og:
        comp_v = component_g.v
        nv = len(comp_v)
        vals = np.array([float(component_g.asmg.vtx_cov[v]) for v in comp_v])
        sizes = np.array([int(component_g.asmg.vtx_len[v]) for v in comp_v], np.int64)
        gene_num = np.zeros((nv, 4), np.int64)
        for j in range(nv):
            for x in sequence_og[comp_v[j]].g:
                x = int(x)
                og = (x >> 32) & 0x3
                gid = x >> 34
                sc = x & 0xFFFFFFFF
                if sc >= min_score and sc >= annot_score[og, gid] * g_diff:
                    gene_num[j, og] += 1

        clust_id, n_clust = _dbscan_cluster(vals, DBSCAN_EPS, CLUSTV_EPS)
        clusts = []
        for c in range(n_clust):
            dps = [j for j in range(nv) if clust_id[j] == c]
            clusts.append(
                dict(
                    dps=dps,
                    mean=float(vals[dps].mean()),
                    size=int(sizes[dps].sum()),
                    og_type=OG_UNCLASSIFIED,
                )
            )

        l_seeds = np.zeros(4, np.int64)
        n_seeds = np.zeros(4, np.int64)
        for cl in clusts:
            a_s = [0.0] * 4
            g_n = [0] * 4
            for v in cl["dps"]:
                for k in range(4):
                    a_s[k] += seg_score[comp_v[v], k]
                    g_n[k] += int(gene_num[v, k])
            imax, smax = _max2(a_s)
            og_t = OG_UNCLASSIFIED if a_s[imax] == a_s[smax] else imax
            if (
                og_t == OG_PLTD
                and smax == OG_MITO
                and g_n[OG_MITO] > 0
                and (
                    a_s[OG_PLTD] < a_s[OG_MITO] * PLTD_TO_MITO_FST[0]
                    or (
                        a_s[OG_PLTD] < a_s[OG_MITO] * PLTD_TO_MITO_FST[1]
                        and cl["size"] > COMMON_MAX_PLTD_SIZE
                    )
                )
            ):
                og_t = OG_MITO
            for v in cl["dps"]:
                if gene_num[v, og_t] > 0:
                    l_seeds[og_t] += sizes[v]
                    n_seeds[og_t] += 1
            cl["og_type"] = og_t

        if l_seeds[OG_MITO] > 0 and l_seeds[OG_PLTD] > 0:
            if l_seeds[OG_MITO] > min_len and l_seeds[OG_PLTD] < min_len:
                l_seeds[OG_PLTD] = n_seeds[OG_PLTD] = 0
            elif l_seeds[OG_MITO] < min_len and l_seeds[OG_PLTD] > min_len:
                l_seeds[OG_MITO] = n_seeds[OG_MITO] = 0

        og_seeds = np.zeros((4, nv), np.int64)
        c_means = np.zeros(4)
        if l_seeds[OG_MITO] > 0 and l_seeds[OG_PLTD] > 0:
            l_seeds[OG_MITO], c_means[OG_MITO] = find_seeds_in_pure_graph(
                clusts, vals, sizes, gene_num, OG_MITO, 0, np.inf, LOG4_5,
                min_len, COMMON_MAX_MITO_SIZE, og_seeds[OG_MITO], verbose,
            )
            l_seeds[OG_PLTD], c_means[OG_PLTD] = find_seeds_in_pure_graph(
                clusts, vals, sizes, gene_num, OG_PLTD, 0, np.inf, LOG4_5,
                min_len, COMMON_MAX_PLTD_SIZE, og_seeds[OG_PLTD], verbose,
            )
        elif l_seeds[OG_MITO] > 0:
            l_seeds[OG_MITO], c_means[OG_MITO] = find_seeds_in_pure_graph(
                clusts, vals, sizes, gene_num, OG_MITO, 0, np.inf, LOG4_5,
                min_len, COMMON_MAX_MITO_SIZE, og_seeds[OG_MITO], verbose,
            )
        elif l_seeds[OG_PLTD] > 0:
            l_seeds[OG_PLTD], c_means[OG_PLTD] = find_seeds_in_pure_graph(
                clusts, vals, sizes, gene_num, OG_PLTD, 0, np.inf, LOG4_5,
                min_len, COMMON_MAX_PLTD_SIZE, og_seeds[OG_PLTD], verbose,
            )
        elif l_seeds[OG_MINI] > 0:
            l_seeds[OG_MINI], c_means[OG_MINI] = find_seeds_in_pure_graph(
                clusts, vals, sizes, gene_num, OG_MINI, 0, np.inf, LOG4_5,
                min_len, COMMON_MAX_MINICIRCLE_SIZE, og_seeds[OG_MINI], verbose,
            )

        for og in (OG_MITO, OG_PLTD, OG_MINI):
            if l_seeds[og] > 0:
                slim_graph(
                    asg, sequence_og, component_g, gene_num, og, og_seeds[og],
                    c_means[og], min_len, out, verbose,
                )

    if fix_og:
        fix_og_misclassification(out, verbose)
    out.sort(key=lambda c: -c.score)
    return out


def print_og_classification_summary(asg: Asg, db: AnnotDB, components, fo=sys.stderr):
    """Verbosity dump, field-for-field as reference path.c:4199-4221."""
    f = "print_og_classification_summary"
    for i, comp in enumerate(components):
        fo.write(f"[M::{f}] OG component {i} \n")
        fo.write(f"[M::{f}] OG component {i} og_type: {OG_TYPES[comp.type]}\n")
        fo.write(f"[M::{f}] OG component {i} og_score: {comp.score:.1f}\n")
        fo.write(f"[M::{f}] OG component {i} og_sscore: {comp.sscore:.1f}\n")
        fo.write(f"[M::{f}] OG component {i} og_len: {comp.len}\n")
        fo.write(f"[M::{f}] OG component {i} og_nv: {comp.nv}\n")
        names = " ".join(asg.segs[v].name for v in comp.v)
        fo.write(f"[M::{f}] OG component {i} og_v: {names}\n")
        fo.write(f"[M::{f}] OG component {i} og_ng: {comp.ng}\n")
        for gj in comp.g:
            gid = int(gj) >> 34
            score_u32 = int(gj) & 0xFFFFFFFF
            fo.write(f"[M::{f}] OG component {i} og_g: {db.gnames[gid]} {score_u32}\n")
