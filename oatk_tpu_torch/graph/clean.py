"""Graph cleaning: tip dropping, bubble popping, weak-crosslink removal.

Semantics of reference graph.c:314-882 (asmg_uext, asmg_drop_tip
with super-tip protection, asmg_topo_ext + asmg_bub_backtrack with
super-bubble protection, asmg_remove_weak_crosslink).
"""
from __future__ import annotations

import numpy as np

from ..utils import log_info
from .asmg import Asmg, UINT64_MAX

VT_MERGEABLE = 0
VT_TIP = 1
VT_MULTI_OUT = 2
VT_MULTI_NEI = 3


def _arc_n2(g: Asmg, v: int):
    """Live out-degree of v; if exactly one, its target; plus the min
    extension length (vtx len minus max live overlap)."""
    if g.vtx_del[v >> 1]:
        return 0, UINT64_MAX, 0
    nv = 0
    k = -1
    ls = 0
    for i in g.arc_range(v):
        if not g.adel[i]:
            nv += 1
            k = i
            ls = max(ls, int(g.als[i]))
    min_l = g.vtx_len[v >> 1] - ls
    w = int(g.aw[k]) if nv == 1 else UINT64_MAX
    return nv, w, min_l


def uext(g: Asmg, v: int, max_ext: int, collect: list | None, tip_only: bool = False):
    """Unitig extension walk from v; returns (vt, n_ext, l_ext)."""
    n_ext = l_ext = 0
    l = 0
    if collect is not None:
        collect.clear()
        collect.append(v)
    while True:
        nv, w, l = _arc_n2(g, v)
        if nv == 0:
            vt = VT_TIP
        elif nv > 1:
            vt = VT_MULTI_OUT
        else:
            nw = g.arc_n1(w ^ 1)
            vt = VT_MERGEABLE if nw == 1 else VT_MULTI_NEI
        l_ext += l
        if vt != VT_MERGEABLE:
            break
        n_ext += 1
        if collect is not None:
            collect.append(w)
        v = w
        max_ext -= 1
        if max_ext <= 0:
            break
    if tip_only and vt == VT_MULTI_OUT:
        l_ext -= l
        if collect is not None:
            collect.pop()
    return vt, n_ext, l_ext


def cwt_len(g: Asmg, vs: list[int]) -> int:
    """Coverage-weighted path length (asmg_cwt_len)."""
    if not vs:
        return 0
    wt = g.vtx_len[vs[0] >> 1] * g.vtx_cov[vs[0] >> 1]
    for i in range(1, len(vs)):
        ai = g.arc_idx(vs[i - 1], vs[i])
        ov = int(g.als[ai]) if ai is not None else 0
        wt += (g.vtx_len[vs[i] >> 1] - ov) * g.vtx_cov[vs[i] >> 1]
    return wt


def drop_tip(
    g: Asmg, tip_cnt: int, tip_len: int, protect_super_tip: bool, do_cleanup: bool, verbose: int = 0,
    order=None,
) -> int:
    n_vtx = 2 * g.n_vtx
    tip_cnt = min(tip_cnt, n_vtx)
    cnt = 0
    dels: list[int] = []
    a: list[int] = []
    b: list[int] = []
    # `order` shuffles the visit order (the reference's DEBUG_EXEC_ORDER
    # instrumentation, reference graph.c:581-592): the pass must
    # produce the same graph for any permutation, locked by
    # tests/test_graph_ops.py::test_clean_order_invariance
    for v in (range(n_vtx) if order is None else order):
        if g.vtx_del[v >> 1]:
            continue
        if g.arc_n1(v ^ 1) != 0:
            continue  # not a tip start
        vt, _, l_ext = uext(g, v, tip_cnt, a, tip_only=True)
        if len(a) == 0:
            continue
        if vt == VT_MERGEABLE:
            continue  # circular unitig
        if l_ext > tip_len:
            continue
        if vt != VT_TIP and protect_super_tip:
            w = a[-1]
            b_tip = l_ext
            c_tip = cwt_len(g, a)
            ai = g.arc_a1(w)
            w1 = int(g.aw[ai]) ^ 1
            is_tip = False
            for i in g.arc_range(w1):
                # faithful to the reference's operator-precedence quirk:
                # (a1[i].del || a1[i].w ^ 1) == w -- the || yields 0/1,
                # so the "skip self" filter only triggers when w == 1
                lhs = 1 if (g.adel[i] or (int(g.aw[i]) ^ 1) != 0) else 0
                if lhs == w:
                    continue
                _, _, l1 = uext(g, int(g.aw[i]), n_vtx + 1, b)
                if b_tip <= l1 or c_tip * 2 <= cwt_len(g, b):
                    is_tip = True
                    break
            if not is_tip:
                continue
        dels.extend(a)
        cnt += 1
    for v in dels:
        g.vtx_delete(v >> 1, True)
    if do_cleanup and cnt:
        g.finalize(True)
    if verbose:
        log_info(f"dropped {cnt} tips", func="asmg_drop_tip")
    return cnt


def remove_weak_crosslink(
    g: Asmg, c_thresh: float, m_cov: float, do_cleanup: bool, verbose: int = 0,
    order=None,
) -> int:
    """Delete arcs dominated by >=1/c_thresh-fold stronger arcs on both
    the outgoing side of v and the incoming side of w."""
    g._flush_pending()
    cnt = 0
    dels: list[int] = []
    # `order` shuffles the arc visit order (DEBUG_EXEC_ORDER analogue);
    # deletions are deferred so any permutation yields the same graph
    for i in (range(len(g.av)) if order is None else order):
        if g.adel[i] or g.acomp[i]:
            continue
        v, w = int(g.av[i]), int(g.aw[i])
        weak = False
        for k in g.arc_range(v):
            if g.adel[k] or g.acov[k] < m_cov:
                continue
            if g.acov[i] / g.acov[k] < c_thresh:
                weak = True
                break
        if not weak:
            continue
        weak = False
        for k in g.arc_range(w ^ 1):
            if g.adel[k] or g.acov[k] < m_cov:
                continue
            if g.acov[i] / g.acov[k] < c_thresh:
                weak = True
                break
        if not weak:
            continue
        dels.append(i)
        cnt += 1
    for i in dels:
        g.adel[i] = True
        g.arc_del(int(g.aw[i]) ^ 1, int(g.av[i]) ^ 1, True)
    if do_cleanup and cnt:
        g.finalize(True)
    if verbose:
        log_info(f"dropped {cnt} weak cross links", func="asmg_remove_weak_crosslink")
    return cnt


# ---------------- bubble popping ----------------

TE_THRU_SHORT_TIP = 0x1
TE_THRU_BUBBLE = 0x2


class _TBuf:
    def __init__(self, n_dir: int):
        self.p = np.full(n_dir, UINT64_MAX, np.uint64)
        self.d = np.zeros(n_dir, np.int64)
        self.c = np.zeros(n_dir, np.int64)
        self.r = np.zeros(n_dir, np.int64)
        self.s = np.zeros(n_dir, bool)
        self.S: list[int] = []
        self.b: list[int] = []
        self.e: list[int] = []
        self.n_short_tip = 0
        self.n_sink = 0
        self.dist = 0
        self.v_sink = UINT64_MAX
        self.self_cycle = 0

    def reset(self):
        for v in self.b:
            self.p[v] = UINT64_MAX
            self.d[v] = self.c[v] = self.r[v] = 0
            self.s[v] = False


def _topo_ext(g: Asmg, v0: int, max_dist: int, thru_flag: int, b: _TBuf) -> int:
    if g.vtx_del[v0 >> 1]:
        return 0
    n_pending = 0
    max_d = 0
    b.S.clear()
    b.b.clear()
    b.e.clear()
    b.n_short_tip = b.n_sink = b.dist = 0
    b.self_cycle = 0
    b.v_sink = UINT64_MAX
    b.p[v0] = UINT64_MAX
    b.d[v0] = b.c[v0] = b.r[v0] = 0
    b.s[v0] = False
    b.S.append(v0)

    while b.S and max_d <= max_dist:
        v = b.S.pop()
        d = int(b.d[v])
        c = int(b.c[v])
        if not b.S and n_pending == 0:  # sink vertex
            b.dist = d
            b.v_sink = v
            if v != v0:
                b.n_sink += 1
                if not (thru_flag & TE_THRU_BUBBLE):
                    break
        if g.arc_n1(v) == 0:  # a tip
            if d + g.vtx_len[v >> 1] < max_dist:
                if b.S or n_pending:
                    b.n_short_tip += 1
                if thru_flag & TE_THRU_SHORT_TIP:
                    continue
                break
            break
        broke = False
        for i in g.arc_range(v):
            if g.adel[i]:
                continue
            w = int(g.aw[i])
            l = g.vtx_len[v >> 1] - int(g.als[i])
            a = g.vtx_cov[v >> 1] * l
            if (w >> 1) == (v0 >> 1):
                b.self_cycle |= 1 if w == v0 else 2
                broke = True
                break
            b.e.append(i)
            if not b.s[w]:
                b.b.append(w)
                b.p[w] = v
                b.s[w] = True
                b.d[w] = d + l
                b.c[w] = c + a
                b.r[w] = g.arc_n1(w ^ 1)
                n_pending += 1
            else:
                if c + a > b.c[w] or (c + a == b.c[w] and d + l > b.d[w]):
                    b.p[w] = v
                if c + a > b.c[w]:
                    b.c[w] = c + a
                if d + l < b.d[w]:
                    b.d[w] = d + l
            max_d = max(max_d, int(b.d[w]))
            b.r[w] -= 1
            if b.r[w] == 0:
                b.S.append(w)
                n_pending -= 1
        if broke:
            break
    return b.n_sink


def _bub_backtrack(g: Asmg, v0: int, max_del: int, protect_super_bubble: bool, b: _TBuf) -> int:
    assert not b.S
    if max_del > 0:
        n_kept = 0
        v = int(b.v_sink)
        while v != v0:
            n_kept += 1
            v = int(b.p[v])
        if len(b.b) > n_kept + max_del:
            return 0
    if protect_super_bubble:
        n_kept = b_kept = c_kept = 0
        v = int(b.v_sink)
        while v != v0:
            n_kept += 1
            b_kept += g.vtx_len[v >> 1]
            c_kept += g.vtx_len[v >> 1] * g.vtx_cov[v >> 1]
            v = int(b.p[v])
        b_tot = sum(g.vtx_len[x >> 1] for x in b.b)
        c_tot = sum(g.vtx_len[x >> 1] * g.vtx_cov[x >> 1] for x in b.b)
        a: list[int] = []
        _, _, le = uext(g, v0 ^ 1, 2 * g.n_vtx + 1, a)
        le_wt = cwt_len(g, a)
        _, _, re = uext(g, int(b.v_sink), 2 * g.n_vtx + 1, a)
        re_wt = cwt_len(g, a)
        if (c_tot - c_kept) * (le + re) * 2 > (le_wt + re_wt) * (b_tot - b_kept):
            return 0
        if (c_tot - c_kept) * b_kept * 2 > c_kept * (b_tot - b_kept):
            return 0
    for x in b.b:
        g.vtx_del[x >> 1] = True
    for i in b.e:
        g.adel[i] = True
        g.arc_del(int(g.aw[i]) ^ 1, int(g.av[i]) ^ 1, True)
    v = int(b.v_sink)
    while v != v0:
        w = int(b.p[v])
        g.vtx_del[v >> 1] = False
        g.arc_del(w, v, False)
        g.arc_del(v ^ 1, w ^ 1, False)
        v = w
    return 1


def pop_bubble(
    g: Asmg,
    radius: int,
    max_del: int,
    protect_tip: bool,
    protect_super_bubble: bool,
    do_cleanup: bool,
    verbose: int = 0,
    order=None,
) -> int:
    n_dir = 2 * g.n_vtx
    b = _TBuf(n_dir)
    n_pop = 0
    n_tip = 0
    # `order` shuffles the source-vertex visit order (the reference's
    # DEBUG_EXEC_ORDER, reference graph.c:864-871); backtrack
    # deletes in-loop, so invariance here is a real algorithmic property
    for v in (range(n_dir) if order is None else order):
        if g.vtx_del[v >> 1] or g.arc_n1(v) < 2:
            continue
        _topo_ext(g, v, g.vtx_len[v >> 1] + radius, 0 if protect_tip else TE_THRU_SHORT_TIP, b)
        if b.n_sink:
            ret = _bub_backtrack(g, v, max_del, protect_super_bubble, b)
            if ret:
                n_pop += 1
                n_tip += b.n_short_tip
        b.reset()
    if do_cleanup and n_pop:
        g.finalize(True)
    if verbose:
        log_info(f"popped {n_pop} bubbles and trimmed {n_tip} short tips", func="asmg_pop_bubble")
    return n_pop
