"""Graph traversal utilities: BFS subgraph, path existence, Tarjan SCC.

Ports of reference graph.c:1111-1354 with Tarjan made iterative
(the reference recurses; organelle graphs are small but Python's stack
is not).
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .asmg import Asmg


def subgraph(g: Asmg, seeds, step: int = 0, dist: int = 0, modify_graph: bool = False):
    """Mark/collect the BFS ball around seeds (by arc steps and/or bases).

    modify_graph: delete everything outside the ball (returns None);
    otherwise return the vertex id list inside.
    """
    step = step if step else 0xFFFFFFFF
    dist = dist if dist else 0xFFFFFFFFFFFFFFFF
    n_vtx = g.n_vtx
    flag = np.zeros(2 * n_vtx, np.int8)
    for i in range(n_vtx):
        if g.vtx_del[i]:
            flag[i << 1] = flag[i << 1 | 1] = -1
    q: deque = deque()
    for s in seeds:
        if s < n_vtx:
            q.append((s << 1, 0, 0))
            q.append((s << 1 | 1, 0, 0))
    if modify_graph:
        for i in range(n_vtx):
            g.vtx_del[i] = True
    while q:
        v, r, rd = q.popleft()
        if flag[v] != 0:
            continue
        flag[v] = 1
        if modify_graph:
            g.vtx_del[v >> 1] = False
        if r < step and rd < dist:
            for i in g.arc_range(v):
                if g.adel[i]:
                    continue
                w = int(g.aw[i])
                nd = rd + g.vtx_len[w >> 1] - int(g.als[i])
                if flag[w] == 0:
                    q.append((w, r + 1, nd))
                if flag[w ^ 1] == 0:
                    q.append((w ^ 1, r + 1, nd))
    in_ball = (flag[0::2] > 0) | (flag[1::2] > 0)
    if not modify_graph:
        return np.flatnonzero(in_ball)
    for i in range(len(g.av)):
        if not in_ball[int(g.av[i]) >> 1] or not in_ball[int(g.aw[i]) >> 1]:
            g.adel[i] = True
    return None


def path_exists(g: Asmg, source: int, sink: int, step: int = 0, dist: int = 0):
    """BFS reachability source->sink over directed vertices; returns
    (exists, steps, dist)."""
    n_dir = 2 * g.n_vtx
    if source >= n_dir or sink >= n_dir:
        return False, 0, 0
    step = step if step else 0xFFFFFFFF
    dist = dist if dist else 0xFFFFFFFFFFFFFFFF
    flag = np.zeros(n_dir, bool)
    q: deque = deque([(source, 0, 0)])
    while q:
        v, r, rd = q.popleft()
        if flag[v]:
            continue
        flag[v] = True
        if r < step and rd < dist:
            for i in g.arc_range(v):
                w = int(g.aw[i])
                if w == sink:
                    return True, r, rd
                if not flag[w]:
                    q.append((w, r + 1, rd + g.vtx_len[w >> 1] - int(g.als[i])))
    return False, 0, 0


def tarjans_scc(g: Asmg):
    """Iterative Tarjan on directed vertices; returns (n_scc, scc[2*n_vtx])."""
    n_dir = 2 * g.n_vtx
    scc = np.full(n_dir, -1, np.int64)
    disc = np.full(n_dir, -1, np.int64)
    low = np.full(n_dir, -1, np.int64)
    on_stack = np.zeros(n_dir, bool)
    stack: list[int] = []
    n_scc = 0
    depth = 0

    def live_targets(v):
        out = []
        for i in g.arc_range(v):
            if g.adel[i]:
                continue
            w = int(g.aw[i])
            if not g.vtx_del[w >> 1]:
                out.append(w)
        return out

    for root in range(n_dir):
        if disc[root] != -1 or g.vtx_del[root >> 1]:
            continue
        work = [(root, iter(live_targets(root)))]
        depth += 1
        disc[root] = low[root] = depth
        stack.append(root)
        on_stack[root] = True
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if disc[w] == -1:
                    depth += 1
                    disc[w] = low[w] = depth
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(live_targets(w))))
                    advanced = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], disc[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == disc[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc[w] = n_scc
                    if w == v:
                        break
                n_scc += 1
    return n_scc, scc
