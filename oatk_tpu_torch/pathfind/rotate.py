"""Plastid canonical rotation + gene-order Spearman correlation
(path.c:1530-1751 analogue).

Circular pltd paths are rotated to start at the first present gene of
the 71-gene A. thaliana order; orientation is chosen by the higher
Spearman rank correlation of observed vs canonical gene order (forward
vs reverse-complement).
"""
from __future__ import annotations

import numpy as np

from ..annot.db import ATHALIANA_PLTD_G71, AnnotDB
from ..io.gfa import Asg
from .search import Path


def rev_path(path: Path):
    path.v = [x ^ 1 for x in reversed(path.v)]


def _rotate_list(v: list, d: int) -> list:
    n = len(v)
    if n == 0:
        return v
    d %= n
    return v[d:] + v[:d]


def _path_rotate_core(asg: Asg, path: Path, db: AnnotDB, og_type: int) -> float:
    genes = ATHALIANA_PLTD_G71
    g_n = len(genes)
    gene_best: dict[str, int] = {}  # gene name -> annot record index
    gene_rank = {gname: i for i, gname in enumerate(genes)}

    seg_count: dict[int, int] = {}
    for x in path.v:
        seg_count[x >> 1] = seg_count.get(x >> 1, 0) + 1

    for i in range(db.n):
        if db.og_type[i] != og_type:
            continue
        gname = db.gname[i]
        if gname not in gene_rank:
            continue
        sid = asg.name2id(db.sname[i])
        if seg_count.get(sid) != 1:
            continue
        prev = gene_best.get(gname)
        if prev is None or db.score[prev] < db.score[i]:
            gene_best[gname] = i

    # rotation: start at first present canonical gene
    if path.circ:
        s = None
        for gname in genes:
            if gname in gene_best:
                s = gene_best[gname]
                break
        if s is not None:
            sseg = asg.name2id(db.sname[s])
            t = next((i for i, x in enumerate(path.v) if (x >> 1) == sseg), None)
            assert t is not None
            path.v = _rotate_list(path.v, t)

    # gene order list: (seg, midpoint, canonical rank)
    g_ord = []
    for gname, ai in gene_best.items():
        sid = asg.name2id(db.sname[ai])
        mid = (int(db.alifrom[ai]) + int(db.alito[ai])) >> 1
        g_ord.append((sid << 40) | (mid << 8) | gene_rank[gname])
    if not g_ord:
        return 0.0
    g_ord.sort()

    # index per seg
    idx: dict[int, tuple[int, int]] = {}
    last = 0
    for i in range(1, len(g_ord) + 1):
        if i == len(g_ord) or (g_ord[i - 1] >> 40) != (g_ord[i] >> 40):
            idx[g_ord[i - 1] >> 40] = (last, i - last)
            last = i

    p_ord = []
    for x in path.v:
        s = x >> 1
        if s not in idx:
            continue
        p, n = idx[s]
        if x & 1:
            p_ord.extend((g_ord[p + n - 1 - j] & 0xFF) for j in range(n))
        else:
            p_ord.extend((g_ord[p + j] & 0xFF) for j in range(n))
    m = len(p_ord)
    assert m == len(g_ord)

    # collapse rank gaps
    p_gap = np.zeros(g_n, np.int64)
    for r in p_ord:
        p_gap[r] += 1
    p_gap = np.cumsum(p_gap)
    p_ord = [r - (r - p_gap[r] + 1) for r in p_ord]

    ds = sum((float(p) - i) ** 2 for i, p in enumerate(p_ord))
    n = len(p_ord)
    denom = float(n) * n - 1
    if denom == 0.0:
        # reference arithmetic (path.c:1704) with n == 1 divides 0 by 0:
        # IEEE yields NaN, which C lets flow (NaN comparisons are all
        # false, so the rotation keeps the reversed orientation and the
        # path sort/selection treat it as tying) -- reproduce that
        # instead of raising ZeroDivisionError
        return float("nan")
    return 1.0 - 6 * ds / n / denom


def path_rotate(asg: Asg, path: Path, db: AnnotDB, og_type: int):
    coeff = _path_rotate_core(asg, path, db, og_type)
    rev_path(path)
    coeff_rev = _path_rotate_core(asg, path, db, og_type)
    if coeff > coeff_rev:
        rev_path(path)
        if path.circ:
            path.v = _rotate_list(path.v, len(path.v) - 1)
    else:
        coeff = coeff_rev
    path.srcc = coeff
