"""Exhaustive circular path search (path.c:976-1401 analogue).

Segments are materialized ``copy`` times with cloned arcs (tandem
self-arcs wired between copies); the search grows a simple-path tree
from the longest sequence of the largest SCC with per-step duplicate
-equivalence pruning and a back-edge containment check, capped at
max_path leaves; linear leaves are re-rooted reversed so both
directions extend; circularity comes from an arc(last -> first); the
longest circular subpath is added for linear paths when the drop stays
within (1 - sub_circ_minf) of the length.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..graph.asmg import UINT64_MAX
from ..graph.traverse import tarjans_scc
from ..io.gfa import Asg, AsgSeg
from ..utils import log_warn

COMMON_AVG_PLTD_SIZE = 160000
FLT_MAX = 3.4028234663852886e38


@dataclass
class Path:
    sid: str | None
    v: list[int]  # seg<<1|orient
    circ: bool
    len: int
    wlen: float
    srcc: float = 0.0
    best: bool = False

    @property
    def nv(self) -> int:
        return len(self.v)


def make_seg_dups(asg: Asg, seg_dups: dict[int, int], s: int, copy: int):
    """Clone segment s copy times (arcs cloned; tandem self-arcs wired
    between copies), then delete the original."""
    g = asg.asmg
    arcs_diff = []
    self_arc = None
    for i in range(2):
        v = s << 1 | i
        for j in g.arc_range(v):
            if g.adel[j]:
                continue
            if (int(g.av[j]) >> 1) != (int(g.aw[j]) >> 1):
                arcs_diff.append(j)
            elif int(g.av[j]) == int(g.aw[j]) and i == 0:
                self_arc = j
    new_ids = []
    for i in range(copy):
        seg = asg.segs[s]
        name = f"{seg.name}_copy{i}"
        sid = asg.add_seg(name)
        asg.segs[sid].len = seg.len
        asg.segs[sid].cov = seg.cov
        asg.segs[sid].seq = seg.seq
        seg_dups[sid] = s
        g.add_vtx(length=seg.len, cov=g.vtx_cov[s] // copy)
        new_ids.append(sid)
        for j in arcs_diff:
            g.add_arc2(
                sid << 1 | (int(g.av[j]) & 1),
                int(g.aw[j]),
                int(g.aln[j]),
                int(g.als[j]),
                UINT64_MAX,
                int(g.acov[j]) // copy,
                int(g.acomp[j]),
            )
        if self_arc is not None:
            for j2 in range(i):
                ln, ls = int(g.aln[self_arc]), int(g.als[self_arc])
                cv = int(g.acov[self_arc]) // copy
                g.add_arc2((sid - i + j2) << 1, sid << 1, ln, ls, UINT64_MAX, cv, 0)
                g.add_arc2(sid << 1, (sid - i + j2) << 1, ln, ls, UINT64_MAX, cv, 0)
    g.finalize(False)
    g.vtx_delete(s, True)


def sequence_duplication_by_copy_number(asg: Asg, copy_number, allow_del: bool) -> dict[int, int]:
    g = asg.asmg
    seg_dups: dict[int, int] = {}
    n_seg0 = asg.n_seg
    for i in range(n_seg0):
        if g.vtx_del[i]:
            continue
        copy = int(copy_number[i])
        if copy > 1:
            make_seg_dups(asg, seg_dups, i, copy)
        elif copy == 0 and allow_del:
            g.vtx_delete(i, True)
    return seg_dups


def find_source_vtx(g, use_max_scc: bool = True) -> int:
    if not use_max_scc:
        best, s = 0, -1
        for i in range(g.n_vtx):
            if g.vtx_del[i]:
                continue
            x = g.vtx_len[i] * g.vtx_cov[i]
            if best < x:
                best, s = x, i
        return s
    n_scc, scc = tarjans_scc(g)
    lens = np.zeros(n_scc, np.int64)
    n_dir = 2 * g.n_vtx
    for i in range(n_dir):
        if scc[i] < 0:
            continue
        if scc[i] != scc[i ^ 1] or (i & 1):
            lens[scc[i]] += g.vtx_len[i >> 1] * g.vtx_cov[i >> 1]
    if n_scc == 0:
        return -1
    m_c = -1
    m_len = 0
    for c in range(n_scc):
        if m_len < lens[c]:
            m_len, m_c = lens[c], c
    if m_c < 0:
        return -1
    m_len, s = 0, -1
    for i in range(n_dir):
        if scc[i] != m_c:
            continue
        x = g.vtx_len[i >> 1] * g.vtx_cov[i >> 1]
        if m_len < x:
            m_len, s = x, i
    return s >> 1 if s >= 0 else -1


class _Node:
    __slots__ = ("v", "prev", "next")

    def __init__(self, v: int, prev=None):
        self.v = v
        self.prev = prev
        self.next: list[_Node] = []


def _path_contains(node: _Node, v: int) -> bool:
    while node is not None:
        if (node.v >> 1) == (v >> 1):
            return True
        node = node.prev
    return False


def _graph_path_extension(g, root: _Node, seg_dups: dict[int, int], max_path: int):
    """BFS tree growth with dup-equivalence pruning; returns
    (leaves, exceeded)."""
    leaves: list[_Node] = []
    q: deque = deque([root])
    while q:
        node = q.popleft()
        v = node.v
        dups: list[int] = []
        for i in g.arc_range(v):
            if g.adel[i]:
                continue
            w = int(g.aw[i])
            orig = seg_dups.get(w >> 1)
            skip = orig is not None and orig in dups
            if not skip and not _path_contains(node, w):
                nxt = _Node(w, node)
                node.next.append(nxt)
                q.append(nxt)
                if orig is not None:
                    dups.append(orig)
        if not node.next:
            leaves.append(node)
        if len(q) + len(leaves) > max_path:
            return [], True
    return leaves, False


def graph_path_finder(
    asg: Asg, seg_dups: dict[int, int], paths: list[Path], max_path: int,
    sub_circ_minf: float, is_pltd: bool,
):
    g = asg.asmg
    s = find_source_vtx(g, True)
    if s < 0:
        return

    root = _Node(s << 1)
    leaves, exceeded = _graph_path_extension(g, root, seg_dups, max_path)
    leaf_nodes: list[_Node] = []
    for node in leaves:
        # re-root reversed from this leaf and extend the other direction
        nr = _Node(node.v ^ 1)
        walk = node
        cur = nr
        while walk.prev is not None:
            nn = _Node(walk.prev.v ^ 1, cur)
            cur.next.append(nn)
            cur = nn
            walk = walk.prev
        assert cur.v == (s << 1 | 1)
        tmp, exceeded2 = _graph_path_extension(g, cur, seg_dups, max_path)
        leaf_nodes.extend(tmp)
        if exceeded2 or len(leaf_nodes) > max_path:
            exceeded = True
            break

    if exceeded:
        log_warn(f"path exploration exceeds limit {max_path}", func="graph_path_finder")
        log_warn("consider an larger value of '-N'", func="graph_path_finder")
        return

    for node in leaf_nodes:
        pv: list[int] = []
        n = node
        while n is not None:
            pv.append(n.v)
            n = n.prev
        pv.reverse()

        circ = g.arc_exists1(pv[-1], pv[0])

        l_seg = []
        ls_next = []
        l = g.vtx_len[pv[0] >> 1]
        wl = float(g.vtx_cov[pv[0] >> 1]) * l
        l_seg.append(g.vtx_len[pv[0] >> 1])
        for j in range(1, len(pv)):
            ai = g.arc_idx(pv[j - 1], pv[j], live_only=True)
            ls = int(g.als[ai])
            ls_next.append(ls)
            l_seg.append(g.vtx_len[pv[j] >> 1])
            l1 = l_seg[j] - ls
            l += l1
            wl += float(g.vtx_cov[pv[j] >> 1]) * l1
        ls_next.append(0)

        l_beg = l_end = None
        if circ:
            ai = g.arc_idx(pv[-1], pv[0], live_only=True)
            ls = int(g.als[ai])
            l -= ls
            wl -= float(g.vtx_cov[pv[0] >> 1]) * ls
        else:
            nvp = len(pv)
            l_beg = [0] * nvp
            for j in range(1, nvp):
                l_beg[j] = l_beg[j - 1] + l_seg[j - 1] - ls_next[j - 1]
            l_end = [l - l_beg[j] - l_seg[j] for j in range(nvp)]

        # replace copies with originals (BEFORE the circular-subpath scan:
        # its arc lookups then see original ids, like the reference)
        mapped = [
            (seg_dups.get(x >> 1, x >> 1) << 1) | (x & 1) for x in pv
        ]
        paths.append(Path(None, mapped, circ, int(l), wl))

        if not circ:
            # longest circular subpath with bounded drop
            L = min(l, COMMON_AVG_PLTD_SIZE) if is_pltd else l
            max_drop = l - L * sub_circ_minf
            nvp = len(pv)
            beg1 = end1 = -1
            min_drop = FLT_MAX
            for beg in range(nvp):
                if l_beg[beg] > max_drop or l_beg[beg] >= min_drop:
                    break
                for end in range(nvp - 1, beg - 1, -1):
                    drop = l_beg[beg] + l_end[end]
                    if drop > max_drop or drop >= min_drop:
                        break
                    if g.arc_exists1(mapped[end], mapped[beg]):
                        beg1, end1, min_drop = beg, end, drop
                        break
            if beg1 >= 0:
                sub = mapped[beg1 : end1 + 1]
                wl2 = l_seg[beg1] * float(g.vtx_cov[mapped[beg1] >> 1])
                for b2 in range(beg1 + 1, end1 + 1):
                    wl2 += (l_seg[b2] - ls_next[b2 - 1]) * float(g.vtx_cov[mapped[b2] >> 1])
                l2 = l - l_beg[beg1] - l_end[end1]
                ai = g.arc_idx(sub[-1], sub[0], live_only=True)
                ls = int(g.als[ai])
                l2 -= ls
                wl2 -= ls * float(g.vtx_cov[sub[0] >> 1])
                paths.append(Path(None, list(sub), True, int(l2), wl2))


def make_path_from_str(asg: Asg, path_str: str, sid: str | None) -> Path:
    g = asg.asmg
    vt = []
    for tok in path_str.replace(" ", ",").split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok[-1] not in "+-":
            raise ValueError(f"invalid path string: {path_str}")
        v = asg.name2id(tok[:-1])
        if v == 0xFFFFFFFF:
            raise ValueError(f"sequence does not exist: {tok[:-1]}")
        vt.append(v << 1 | (tok[-1] == "-"))
    if not vt:
        raise ValueError(f"invalid path string: {path_str}")
    ai = g.arc_idx(vt[-1], vt[0], live_only=True)
    circ = ai is not None
    l = g.vtx_len[vt[0] >> 1]
    cov = g.vtx_cov[vt[0] >> 1]
    wl = float(cov) * l
    if circ:
        l -= int(g.als[ai])
        wl -= cov * int(g.als[ai])
    for i in range(1, len(vt)):
        l1 = g.vtx_len[vt[i] >> 1]
        cov = g.vtx_cov[vt[i] >> 1]
        l += l1
        wl += float(cov) * l1
        ai = g.arc_idx(vt[i - 1], vt[i], live_only=True)
        if ai is None:
            log_warn(
                f"gap introduced as link does not exist: "
                f"{asg.segs[vt[i-1]>>1].name}{'+-'[vt[i-1]&1]} -> "
                f"{asg.segs[vt[i]>>1].name}{'+-'[vt[i]&1]}",
                func="make_path_from_str",
            )
        else:
            l -= int(g.als[ai])
            wl -= float(cov) * int(g.als[ai])
    return Path(sid, vt, circ, int(l), wl)
