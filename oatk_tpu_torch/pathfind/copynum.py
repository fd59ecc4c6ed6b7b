"""Copy-number estimation (path.c:128-974 analogue).

Per-copy coverage search (shortest-30% lower bound + robust fold
scan), EM rounding, and the layout-aware adjustment that models unitig
-extension arc groups as integer variables minimizing
sum weight*(|in-exp| + |out-exp| + |in-out|), weight = log10(len),
solved brute-force (<= 1e8 states) or by simulated annealing
(T=1000, cooling .999, 100 restarts, srand(1234)).  The SA replicates
glibc's rand() so seeded runs match the reference bit-for-bit.
"""
from __future__ import annotations

import numpy as np

from ..graph.clean import uext, VT_MULTI_NEI
from ..io.gfa import Asg
from ..utils import log_info

EM_MAX_ITER = 1000
BRUTE_FORCE_N_LIM = 100000000
FLT_EPSILON = 1.1920928955078125e-07
SA_TEMPERATURE = 1000.0
SA_COOLING_RATE = 0.999
SA_MAX_ATTEMPTS = 100
SA_RESTART_TEMP = 0.99
RAND_MAX = 0x7FFFFFFF


class GlibcRand:
    """glibc TYPE_3 additive-feedback rand(), bit-compatible."""

    def __init__(self, seed: int):
        self.r = [0] * 34
        self.r[0] = seed & 0xFFFFFFFF
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2147483647 via Schrage
            hi, lo = divmod(self.r[i - 1], 127773)
            word = (16807 * lo - 2836 * hi) % 2147483647
            self.r[i] = word
        for i in range(31, 34):
            self.r[i] = self.r[i - 31]
        self.k = 0
        self.buf = self.r[:]
        self.idx = 34
        # discard first 310 outputs
        self._outs = []
        for _ in range(310):
            self._next_raw()

    def _next_raw(self) -> int:
        r = self.buf
        n = len(r)
        v = (r[(self.idx - 31) % n] + r[(self.idx - 3) % n]) & 0xFFFFFFFF
        r[self.idx % n] = v
        self.idx += 1
        return v >> 1

    def rand(self) -> int:
        return self._next_raw()


def _lround(x: float) -> int:
    return int(np.floor(x + 0.5)) if x >= 0 else -int(np.floor(-x + 0.5))


def graph_sequence_coverage_lower_bound(asg: Asg, cov_nq: float) -> float:
    """Length-weighted mean coverage of the shortest-coverage cov_nq
    fraction of sequence, scaled by (1 - cov_nq)."""
    g = asg.asmg
    pairs = []
    tot = 0
    for i in range(g.n_vtx):
        if g.vtx_del[i]:
            continue
        pairs.append((g.vtx_cov[i], g.vtx_len[i]))
        tot += g.vtx_len[i]
    if not pairs:
        return 0.0
    pairs.sort()
    thresh = tot * cov_nq
    tot_len = tot_cov = 0
    i = 0
    while i < len(pairs) and tot_len + pairs[i][1] <= thresh:
        tot_cov += pairs[i][0] * pairs[i][1]
        tot_len += pairs[i][1]
        i += 1
    if tot_len < thresh and i < len(pairs):
        tot_cov += pairs[i][0] * (thresh - tot_len)
    bound = tot_cov / thresh if thresh else 0.0
    return bound * (1 - cov_nq)


def graph_sequence_coverage_rough(asg: Asg, min_cf: float) -> float:
    """Scan candidate per-copy coverages (each seg's coverage) and pick
    the one minimizing |sum(len*cov/avg)/sum(len) - 1|."""
    g = asg.asmg
    lc = []
    for i in range(g.n_vtx):
        if g.vtx_del[i]:
            continue
        lc.append((g.vtx_cov[i], g.vtx_len[i]))
    if not lc:
        return 0.0
    lc.sort()
    best1 = -1
    near1 = np.inf
    for i, (cov_i, _) in enumerate(lc):
        avg = float(cov_i)
        if avg == 0:
            continue
        tot_len = tot_len_c = tot_rm = 0.0
        for cov, ln in lc:
            if cov / avg >= min_cf:
                tot_len += ln
                tot_len_c += ln * cov / avg
            else:
                tot_rm += ln
        if tot_rm / (tot_rm + tot_len) > 0.7:
            break
        if tot_len > 0:
            diff1 = abs(tot_len_c / tot_len - 1.0)
            if diff1 < near1:
                near1 = diff1
                best1 = i
    if near1 == np.inf:
        return 0.0
    return float(lc[best1][0])


def graph_sequence_coverage_precise(
    asg: Asg, min_cf: float, min_copy: int, max_copy: int, want_copy_number: bool = True
):
    """EM: copy = round(cov/avg) clamped to [min_copy, max_copy];
    returns (avg_cov, copy_number array or None)."""
    g = asg.asmg
    n_seg = asg.n_seg
    min_avg = graph_sequence_coverage_lower_bound(asg, 0.3)
    avg = max(graph_sequence_coverage_rough(asg, min_cf), min_avg)
    copy = np.zeros(n_seg, np.int64)
    for i in range(n_seg):
        if g.vtx_del[i]:
            continue
        copy[i] = min(max(min_copy, _lround(g.vtx_cov[i] / avg)), max_copy)
    for _ in range(EM_MAX_ITER):
        tot_l = tot_c = 0.0
        for i in range(n_seg):
            if g.vtx_del[i]:
                continue
            tot_l += g.vtx_len[i] * copy[i]
            tot_c += g.vtx_len[i] * g.vtx_cov[i]
        new_avg = np.finfo(float).max if tot_l < FLT_EPSILON else tot_c / tot_l
        new_avg = max(new_avg, min_avg)
        if abs(new_avg - avg) < FLT_EPSILON:
            break
        avg = new_avg
        for i in range(n_seg):
            if g.vtx_del[i]:
                continue
            copy[i] = min(max(min_copy, _lround(g.vtx_cov[i] / avg)), max_copy)
    return avg, (copy if want_copy_number else None)


def uext_arc_group(g) -> tuple[np.ndarray, int]:
    """Group arcs along unitig extensions (asmg_uext_arc_group)."""
    n_vtx = g.n_vtx
    n_arc = g.max_link_id() + 1
    arc_group = np.full(n_arc, -1, np.int64)
    visited = np.zeros(n_vtx, bool)
    group = 0
    a: list[int] = []
    for i in range(n_vtx):
        if visited[i] or g.vtx_del[i]:
            continue
        na = 0
        for k in range(2):
            v = i << 1 | k
            vt, _, _ = uext(g, v, n_vtx * 2 + 1, a)
            for j in range(1, len(a)):
                ai = g.arc_idx(a[j - 1], a[j], live_only=True)
                arc_group[int(g.alink[ai])] = group
                visited[a[j] >> 1] = True
                na += 1
            if vt == VT_MULTI_NEI:
                ai = g.arc_a1(a[-1])
                arc_group[int(g.alink[ai])] = group
                na += 1
        if na > 0:
            group += 1
        visited[i] = True
    g._flush_pending()
    for i in range(len(g.av)):
        if g.adel[i] or arc_group[int(g.alink[i])] != -1:
            continue
        arc_group[int(g.alink[i])] = group
        group += 1
    return arc_group, group


def adjust_sequence_copy_number_by_graph_layout(
    asg: Asg, seq_coverage: float, copy_number: np.ndarray, max_copy: int, max_round: int
):
    """Returns (updated, adjusted_cov)."""
    g = asg.asmg
    n_seg = asg.n_seg
    if max_round == 0:
        max_round = 1
    arc_group, n_group = uext_arc_group(g)
    if n_group == 0:
        return 0, seq_coverage

    lb = np.zeros(n_group, np.int64)
    ub = np.zeros(n_group, np.int64)
    g._flush_pending()
    for i in range(len(g.av)):
        if g.adel[i]:
            continue
        a_g = arc_group[int(g.alink[i])]
        v, w = int(g.av[i]), int(g.aw[i])
        vlb = copy_number[v >> 1] if g.arc_n1(v) == 1 else 0
        wlb = copy_number[w >> 1] if g.arc_n1(w ^ 1) == 1 else 0
        l = min(vlb, wlb)
        u = max(copy_number[v >> 1], copy_number[w >> 1])
        l = int(l * 2 / 3)
        u = min(int(u * 4 / 3) + 1, max_copy)
        lb[a_g] = min(l, lb[a_g])
        ub[a_g] = max(u, ub[a_g])

    # current variable value per group (starts at lower bound)
    val = lb.copy()

    # objective functions: per live seg, in/out arc groups
    funcs = []  # (weight, v_exp, [(group, in_bit)])
    funcmap = np.full(n_seg, -1, np.int64)
    for i in range(n_seg):
        if g.vtx_del[i]:
            continue
        V = []
        for k in range(2):
            for j in g.arc_range(i << 1 | k):
                if g.adel[j]:
                    continue
                V.append((int(arc_group[int(g.alink[j])]), k))
        if V:
            funcmap[i] = len(funcs)
            funcs.append(
                [np.log10(g.vtx_len[i]), g.vtx_cov[i] / seq_coverage, V]
            )

    def fvals():
        tot = 0.0
        for weight, v_exp, V in funcs:
            s = [0.0, 0.0]
            for grp, bit in V:
                s[bit] += val[grp]
            tot += weight * (
                abs(v_exp - s[0]) / 2 + abs(v_exp - s[1]) / 2 + abs(s[0] - s[1])
            )
        return tot

    min_avg = graph_sequence_coverage_lower_bound(asg, 0.3)
    adjusted = seq_coverage
    sol_space = 1
    for i in range(n_group):
        sol_space *= int(ub[i] - lb[i] + 1)
        if sol_space > BRUTE_FORCE_N_LIM:
            break

    res = val.copy()
    updated = 0
    rounds = 0
    while rounds < max_round:
        rounds += 1
        if sol_space <= BRUTE_FORCE_N_LIM:
            _brute_force(val, lb, ub, fvals, res, sol_space)
        else:
            _siman(val, lb, ub, fvals, res)

        tot_l = tot_c = 0.0
        for i in range(n_seg):
            if g.vtx_del[i]:
                continue
            copies = 0
            for k in range(2):
                for j in g.arc_range(i << 1 | k):
                    if g.adel[j]:
                        continue
                    copies += res[arc_group[int(g.alink[j])]]
            tot_l += g.vtx_len[i] * copies / 2
            tot_c += g.vtx_len[i] * g.vtx_cov[i]
        if tot_l < FLT_EPSILON:
            return updated, adjusted
        new_adj = max(tot_c / tot_l, min_avg)
        if abs(new_adj - adjusted) < FLT_EPSILON:
            break
        adjusted = new_adj
        for i in range(n_seg):
            if funcmap[i] == -1:
                continue
            funcs[funcmap[i]][1] = g.vtx_cov[i] / adjusted
        val[:] = lb

    # update seg copy numbers where in-degree == out-degree
    for i in range(n_seg):
        if g.vtx_del[i]:
            continue
        new_copy = [0, 0]
        for k in range(2):
            for j in g.arc_range(i << 1 | k):
                if g.adel[j]:
                    continue
                new_copy[k] += int(res[arc_group[int(g.alink[j])]])
        if new_copy[0] == new_copy[1] and copy_number[i] != new_copy[0]:
            copy_number[i] = new_copy[0]
            updated = 1
    return updated, adjusted


def _brute_force(val, lb, ub, fvals, res, sol_space):
    m_f = fvals()
    res[:] = val
    sol = 0
    n_var = len(val)
    while sol + 1 < sol_space:
        sol += 1
        # odometer increment with per-variable wrap
        v = 0
        while True:
            val[v] += 1
            if val[v] > ub[v]:
                val[v] = lb[v]
                v += 1
            else:
                break
        f = fvals()
        if f < m_f:
            m_f = f
            res[:] = val
        if abs(m_f) < FLT_EPSILON:
            break


def _siman(val, lb, ub, fvals, res):
    rng = GlibcRand(1234)
    current = fvals()
    optim = current
    res[:] = val
    n_var = len(val)
    temp0 = SA_TEMPERATURE
    for _ in range(SA_MAX_ATTEMPTS):
        temp = temp0
        while temp > 1e-6:
            i = rng.rand() % n_var
            old = val[i]
            # random walk respecting ring structure of the variable chain
            if rng.rand() < (RAND_MAX >> 1):
                val[i] = val[i] + 1 if val[i] == lb[i] else val[i] - 1
            else:
                # move to next unless next wraps to lb
                val[i] = val[i] - 1 if val[i] + 1 > ub[i] else val[i] + 1
            val[i] = min(max(val[i], lb[i]), ub[i])
            new = fvals()
            if new < optim:
                optim = new
                res[:] = val
            p = np.exp(-(new - current) / temp)
            if new < current or rng.rand() / RAND_MAX < p:
                current = new
            else:
                val[i] = old
            temp *= SA_COOLING_RATE
        if optim == 0:
            break
        temp0 *= SA_RESTART_TEMP
        val[:] = res
        current = fvals()
    return optim
