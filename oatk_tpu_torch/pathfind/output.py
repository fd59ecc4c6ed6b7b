"""Path ranking, selection and FASTA/BED output (path.c:1403-2001)."""
from __future__ import annotations

import numpy as np

from ..annot.db import AnnotDB, Bed6DB, bed6_sname_add
from ..io.gfa import Asg
from .search import Path

COMMON_AVG_PLTD_SIZE = 160000

_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def path_sort(paths: list[Path]):
    """Sort by wlen desc -> len desc -> circ -> srcc desc -> nv desc and
    flag Pareto-best paths (longest linear unless a circular dominates)."""
    paths.sort(key=lambda p: (-p.wlen, -p.len, not p.circ, -p.srcc, -p.nv))
    b_ll = b_cl = 0.0
    for p in paths:
        if not p.circ and p.wlen > b_ll:
            b_ll = p.wlen
        if p.circ and p.wlen > b_cl:
            b_cl = p.wlen
    if b_cl >= b_ll:
        b_ll = np.finfo(float).max
    for p in paths:
        if not p.circ and p.wlen >= b_ll:
            p.best = True
        if p.circ and p.wlen >= b_cl:
            p.best = True


def select_best_seq(
    asg: Asg, paths: list[Path], fo, out_type: int, seq_cf: float, seq_id: int, is_pltd: bool
) -> int:
    if not paths:
        return -1
    l, j = 0, 0
    for i, p in enumerate(paths):
        if (p.circ or not out_type) and p.len > l:
            l, j = p.len, i
    if not paths[j].circ:
        k, l = -1, 0
        for i, p in enumerate(paths):
            if p.circ and p.len > l:
                l, k = p.len, i
        if k != -1:
            L = paths[j].len
            if is_pltd:
                L = min(L, COMMON_AVG_PLTD_SIZE)
            if l / L >= seq_cf:
                j = k
    if is_pltd:
        circ = paths[j].circ or out_type
        k, coeff = -1, 0.0
        for i, p in enumerate(paths):
            if (p.circ or not circ) and p.srcc > coeff:
                coeff, k = p.srcc, i
        if k != -1 and paths[k].len + 1000 >= paths[j].len:
            j = k
    if fo:
        print_seq(asg, paths[j], fo, seq_id if seq_id > 0 else 1, False, 60, 100)
    return j


def sequence_covered_by_path(asg: Asg, path: Path, length: int) -> float:
    seen = set()
    l = 0
    for x in path.v:
        s = x >> 1
        if s not in seen:
            l += asg.segs[s].len
            seen.add(s)
    return l / length if length else 0.0


def _seg_seq(asg: Asg, v: int, ow: int) -> str:
    """Oriented segment sequence minus the leading overlap ``ow``."""
    seg = asg.segs[v >> 1]
    s = seg.seq
    if v & 1:
        s = s.translate(_COMP)[::-1]
    return s[ow:]


def print_seq(asg: Asg, path: Path, fo, seq_id: int, force_linear: bool, line_wd: int, gap_size: int):
    n = path.nv
    if n == 0:
        return
    for x in path.v:
        if asg.segs[x >> 1].seq is None:
            from ..utils import log_error

            log_error("cannot make FASTA output: sequence not included in the GFA file")
            return
    g = asg.asmg
    lo = cov = 0
    if path.circ and force_linear:
        ai = g.arc_idx(path.v[-1], path.v[0], live_only=True)
        lo = int(g.als[ai])
        cov = g.vtx_cov[path.v[0] >> 1]

    circ_str = "false" if (force_linear or not path.circ) else "true"
    pstr = ",".join(f"{asg.segs[x>>1].name}{'+-'[x&1]}" for x in path.v)
    if path.sid:
        hdr = path.sid
    else:
        hdr = f"ctg{seq_id:06d}{'l' if (force_linear or not path.circ) else 'c'}"
    fo.write(
        f">{hdr}\tlength={path.len + lo} wlength={path.wlen + cov * lo:.1f} nv={path.nv} "
        f"circular={circ_str} path={pstr}\n"
    )

    out = []
    v = path.v[0]
    if force_linear or not path.circ:
        lo0 = 0
    else:
        lo0 = int(g.als[g.arc_idx(path.v[-1], v, live_only=True)])
    out.append(_seg_seq(asg, v, lo0))
    for i in range(1, n):
        v = path.v[i]
        ai = g.arc_idx(path.v[i - 1], v, live_only=True)
        if ai is not None:
            out.append(_seg_seq(asg, v, int(g.als[ai])))
        else:
            out.append("N" * gap_size)
            out.append(_seg_seq(asg, v, 0))
    seq = "".join(out)
    for i in range(0, len(seq), line_wd):
        fo.write(seq[i : i + line_wd])
        fo.write("\n")


def path_add_hmm_annot_bed6(
    bed: Bed6DB,
    db: AnnotDB,
    asg: Asg,
    path: Path,
    seq_id: int,
    force_linear: bool,
    gap_size: int,
    og_type: int,
    max_evalue: float,
):
    n = path.nv
    if n == 0:
        return
    g = asg.asmg
    if path.sid:
        cname = path.sid
    else:
        cname = f"ctg{seq_id:06d}{'l' if (force_linear or not path.circ) else 'c'}"
    bed.snames.append(cname)
    v = path.v[0]
    if force_linear or not path.circ:
        lo = 0
    else:
        lo = int(g.als[g.arc_idx(path.v[-1], v, live_only=True)])
    l = 0
    bed6_sname_add(bed, db, cname, asg.segs[v >> 1].name, asg.segs[v >> 1].len, lo, v & 1, l, og_type, max_evalue)
    l += asg.segs[v >> 1].len - lo
    for i in range(1, n):
        v = path.v[i]
        ai = g.arc_idx(path.v[i - 1], v, live_only=True)
        ls = int(g.als[ai]) if ai is not None else 0
        if ai is None:
            l += gap_size
        bed6_sname_add(bed, db, cname, asg.segs[v >> 1].name, asg.segs[v >> 1].len, ls, v & 1, l, og_type, max_evalue)
        l += asg.segs[v >> 1].len - ls


def path_stats(asg: Asg, paths: list[Path], fo):
    for i, p in enumerate(paths):
        pstr = ",".join(f"{asg.segs[x>>1].name}{'+-'[x&1]}" for x in p.v)
        fo.write(
            f"{'*' if p.best else '#'} {i} {'circle' if p.circ else 'linear'} {p.nv} "
            f"{p.len} {p.wlen:.1f} {p.srcc:.3f} {pstr}\n"
        )
