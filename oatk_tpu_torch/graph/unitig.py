"""Unitigging: merge maximal non-branching paths into compound vertices.

Three-pass strategy of reference graph.c:905-1105: (1) unitigs
attached to junctions, (2) linear paths, (3) remaining circles; then
singleton add, arc re-wiring (endpoints become unitig ends) and syncmer
list expansion with overlap trimming.
"""
from __future__ import annotations

import numpy as np

from .asmg import Asmg, UINT64_MAX

_MID = UINT64_MAX - 1


def _is_junction(g: Asmg, s: int) -> bool:
    return g.arc_n1(s << 1) > 1 or g.arc_n1(s << 1 | 1) > 1


def _vec_add(dst: list[int], src, r: bool):
    if r:
        dst.extend(int(x) ^ 1 for x in reversed(src))
    else:
        dst.extend(int(x) for x in src)


def unitigging(g: Asmg) -> Asmg:
    n_vtx = g.n_vtx
    visited = [False] * n_vtx
    utgs: list[tuple[list[int], bool]] = []  # (directed member list, circ)

    # pass 1: unitigs connected to a junction
    for i in range(n_vtx):
        if g.vtx_del[i] or not _is_junction(g, i):
            continue
        for k in range(2):
            v = i << 1 | k
            n_arc1 = g.arc_n1(v)
            for j in list(g.arc_range(v)):
                if g.adel[j]:
                    continue
                vec: list[int] = []
                if not visited[v >> 1] and n_arc1 == 1:
                    vec.append(v)
                u = int(g.aw[j])
                while not visited[u >> 1] and g.arc_n1(u ^ 1) == 1:
                    vec.append(u)
                    visited[u >> 1] = True
                    if g.arc_n1(u) == 1:
                        u = int(g.aw[g.arc_a1(u)])
                    else:
                        break
                if len(vec) > 1:
                    utgs.append((vec, False))
        visited[i] = True

    # pass 2: linear paths
    for i in range(n_vtx):
        if g.vtx_del[i] or visited[i] or (g.arc_n1(i << 1) > 0 and g.arc_n1(i << 1 | 1) > 0):
            continue
        v = i << 1 if g.arc_n1(i << 1) > 0 else i << 1 | 1
        vec = [v]
        visited[v >> 1] = True
        while g.arc_n1(v) == 1:
            v = int(g.aw[g.arc_a1(v)])
            if visited[v >> 1]:
                break
            vec.append(v)
            visited[v >> 1] = True
        if len(vec) > 1:
            utgs.append((vec, False))

    # pass 3: remaining circles
    for i in range(n_vtx):
        if g.vtx_del[i] or visited[i]:
            continue
        v = i << 1
        vec = [v]
        visited[v >> 1] = True
        while g.arc_n1(v) > 0:
            v = int(g.aw[g.arc_a1(v)])
            if visited[v >> 1]:
                break
            vec.append(v)
            visited[v >> 1] = True
        if len(vec) > 1:
            utgs.append((vec, True))

    # position map: start u<<1, end u<<1|1, mid _MID, singleton UINT64_MAX
    vtx_p = [UINT64_MAX] * n_vtx
    for ui, (vec, _) in enumerate(utgs):
        vtx_p[vec[0] >> 1] = ui << 1
        vtx_p[vec[-1] >> 1] = ui << 1 | 1
        for j in range(1, len(vec) - 1):
            vtx_p[vec[j] >> 1] = _MID
            g.arc_del(vec[j - 1], vec[j], True)
            g.arc_del(vec[j] ^ 1, vec[j - 1] ^ 1, True)
        g.arc_del(vec[-2], vec[-1], True)
        g.arc_del(vec[-1] ^ 1, vec[-2] ^ 1, True)

    # singletons
    singleton_circ: dict[int, bool] = {}
    for i in range(n_vtx):
        if vtx_p[i] == UINT64_MAX and not g.vtx_del[i]:
            vtx_p[i] = len(utgs) << 1
            singleton_circ[len(utgs)] = g.arc_exists1(i << 1, i << 1)
            utgs.append(([i << 1], False))

    ng = Asmg()
    for ui, (vec, circ) in enumerate(utgs):
        if len(vec) == 1:
            circ = singleton_circ.get(ui, False)
        # expand syncmer list
        sv: list[int] = []
        for j, dv in enumerate(vec):
            if j > 0:
                ai = g.arc_idx(vec[j - 1], vec[j])
                trim = int(g.aln[ai])
                if trim:
                    del sv[len(sv) - trim :]
            a = g.vtx_a[dv >> 1]
            _vec_add(sv, a, bool(dv & 1))
        ng.add_vtx(a=np.array(sv, np.uint64), circ=circ)

    # arcs
    g._flush_pending()
    for i in range(len(g.av)):
        if g.adel[i]:
            continue
        v = vtx_p[int(g.av[i]) >> 1]
        w = vtx_p[int(g.aw[i]) >> 1]
        if v == _MID or w == _MID:
            continue
        nv = (v ^ 1) if len(utgs[v >> 1][0]) > 1 else (v | (int(g.av[i]) & 1))
        nw = w if len(utgs[w >> 1][0]) > 1 else (w | (int(g.aw[i]) & 1))
        ng.add_arc(nv, nw, int(g.aln[i]), int(g.als[i]), int(g.alink[i]), int(g.acov[i]), int(g.acomp[i]))

    ng.finalize(True)
    return ng
