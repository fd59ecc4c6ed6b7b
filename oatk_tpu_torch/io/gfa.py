"""Named assembly graph (asg_t analogue) with GFA/FASTA IO.

Port of the gfatools-derived reader of reference path.c:2004-2710:
S/L lines with typed aux tags, CIGAR overlap parsing, FASTA/FASTQ
fallback, configurable coverage tags (EC:i / KC:i|FC:i / SC:f), and the
matching printers.
"""
from __future__ import annotations

import gzip
import re
import sys
from dataclasses import dataclass, field

import numpy as np

from ..graph.asmg import Asmg
from ..utils import log_warn

# configurable GFA tags (set by --edge-c-tag etc.)
TAG_ARC_COV: list[str | None] = [None]
TAG_SEQ_COV: list[str | None] = [None]
TAG_SBP_COV: list[str | None] = [None]


def is_valid_gfa_tag(tag: str) -> bool:
    return bool(re.fullmatch(r"[A-Za-z][A-Za-z0-9]:[AifZB]", tag))


@dataclass
class AsgSeg:
    name: str
    seq: str | None = None
    len: int = 0
    cov: float = 0


class Asg:
    """Sequence dictionary + bidirected graph; seg and vtx ids coincide."""

    def __init__(self):
        self.segs: list[AsgSeg] = []
        self.h_seg: dict[str, int] = {}
        self.asmg = Asmg()

    @property
    def n_seg(self) -> int:
        return len(self.segs)

    def add_seg(self, name: str, allow_dups: bool = True) -> int:
        if name in self.h_seg:
            if not allow_dups:
                raise ValueError(f"duplicate segment '{name}'")
            return self.h_seg[name]
        i = len(self.segs)
        self.segs.append(AsgSeg(name))
        self.h_seg[name] = i
        return i

    def name2id(self, name: str) -> int:
        return self.h_seg.get(name, 0xFFFFFFFF)

    def seg_len_total(self) -> int:
        g = self.asmg
        return sum(g.vtx_len[i] for i in range(g.n_vtx) if not g.vtx_del[i])

    def copy(self, with_seq: bool = False) -> "Asg":
        a = Asg()
        for s in self.segs:
            a.segs.append(AsgSeg(s.name, s.seq if with_seq else None, s.len, s.cov))
        a.h_seg = dict(self.h_seg)
        a.asmg = self.asmg.copy()
        return a


def _parse_tags(fields: list[str]) -> dict[str, tuple[str, str]]:
    tags = {}
    for f in fields:
        parts = f.split(":", 2)
        if len(parts) == 3:
            tags[parts[0]] = (parts[1], parts[2])
    return tags


def _tag_decimal(tags, name_type: str | None, *fallbacks: str):
    """Resolve a coverage value honoring a custom tag override."""
    if name_type:
        nm, ty = name_type[:2], name_type[3]
        if nm in tags and tags[nm][0] == ty:
            return float(tags[nm][1])
        return None
    for fb in fallbacks:
        nm, ty = fb.split(":")
        if nm in tags and tags[nm][0] == ty:
            return float(tags[nm][1])
    return None


def _cigar_overlap(s: str) -> tuple[int, int]:
    ov = ow = 0
    for n, op in re.findall(r"(\d+)([A-Z])", s):
        n = int(n)
        if op in "MDN":
            ov += n
        if op in "MIS":
            ow += n
    return ov, ow


def asg_read(path: str) -> Asg:
    """Read a GFA (or FASTA/FASTQ) file into an Asg."""
    opener = gzip.open if path.endswith(".gz") or _is_gz(path) else open
    g = Asg()
    arcs: list[tuple] = []
    is_fa = is_fq = is_gfa = False
    cur_name = None
    cur_seq: list[str] = []

    def flush_fa():
        nonlocal cur_name
        if cur_name is not None:
            i = g.add_seg(cur_name, allow_dups=False)
            g.segs[i].seq = "".join(cur_seq)
            g.segs[i].len = len(g.segs[i].seq)
            cur_name = None

    with opener(path, "rt") as fp:
        it = iter(fp)
        for line in it:
            line = line.rstrip("\n")
            if not line:
                continue
            if not is_gfa and line[0] == ">":
                is_fa = True
                flush_fa()
                cur_name = line[1:].split()[0]
                cur_seq = []
            elif not is_gfa and line[0] == "@" and not is_fa:
                is_fq = True
                name = line[1:].split()[0]
                seq = next(it).rstrip("\n")
                next(it)
                next(it)
                i = g.add_seg(name, allow_dups=False)
                g.segs[i].seq = seq
                g.segs[i].len = len(seq)
            elif is_fa:
                cur_seq.append(line)
            else:
                is_gfa = True
                f = line.split("\t")
                if f[0] == "S":
                    name, seq = f[1], f[2]
                    tags = _parse_tags(f[3:])
                    i = g.add_seg(name, allow_dups=False)
                    sg = g.segs[i]
                    sg.seq = None if seq == "*" else seq
                    if sg.seq is not None:
                        sg.len = len(sg.seq)
                    elif "LN" in tags and tags["LN"][0] == "i":
                        sg.len = int(tags["LN"][1])
                    cov = None
                    if TAG_SBP_COV[0]:
                        v = _tag_decimal(tags, TAG_SBP_COV[0])
                        if v is not None:
                            cov = v / sg.len if sg.len else v
                    elif TAG_SEQ_COV[0]:
                        cov = _tag_decimal(tags, TAG_SEQ_COV[0])
                    else:
                        v = _tag_decimal(tags, None, "KC:i", "FC:i")
                        if v is not None:
                            cov = v / sg.len if sg.len else v
                    if not cov:
                        log_warn(f"the coverage of segment '{name}' is zero")
                        cov = 1
                    sg.cov = cov
                elif f[0] == "L":
                    v = g.add_seg(f[1]) << 1 | (f[2] != "+")
                    w = g.add_seg(f[3]) << 1 | (f[4] != "+")
                    ov = 0
                    if len(f) > 5 and f[5] != "*":
                        if f[5][0].isdigit() and any(c.isalpha() for c in f[5]):
                            ov, _ = _cigar_overlap(f[5])
                        elif f[5].isdigit():
                            ov = int(f[5])
                    tags = _parse_tags(f[6:])
                    cov = _tag_decimal(tags, TAG_ARC_COV[0], "EC:i")
                    if not cov:
                        cov = 1
                    arcs.append((v, w, ov, cov))
        flush_fa()

    for i, sg in enumerate(g.segs):
        g.asmg.add_vtx(length=sg.len, cov=int(sg.cov))
    for v, w, ov, cov in arcs:
        g.asmg.add_arc(v, w, 0, ov, cov=int(cov))
    g.asmg.finalize(False)
    return g


def _is_gz(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def asg_print(g: Asg, fo=sys.stdout, no_seq: bool = False):
    fo.write("H\tVN:Z:1.0\n")
    asmg = g.asmg
    for i, sg in enumerate(g.segs):
        if asmg.n_vtx and asmg.vtx_del[i]:
            continue
        cov = asmg.vtx_cov[i] if asmg.n_vtx else sg.cov
        seq = sg.seq if (sg.seq and not no_seq) else "*"
        fo.write(
            f"S\t{sg.name}\t{seq}\tLN:i:{sg.len}\tKC:i:{int(sg.len * cov)}\tSC:f:{float(cov):.3f}\n"
        )
    asmg._flush_pending()
    for k in range(len(asmg.av)):
        if asmg.adel[k] or asmg.acomp[k]:
            continue
        v, w = int(asmg.av[k]), int(asmg.aw[k])
        fo.write(
            f"L\t{g.segs[v>>1].name}\t{'+-'[v&1]}\t{g.segs[w>>1].name}\t{'+-'[w&1]}\t"
            f"{int(asmg.als[k])}M\tEC:i:{int(asmg.acov[k])}\n"
        )


def asg_print_fa(g: Asg, fo=sys.stdout, line_wd: int = 60):
    for i, sg in enumerate(g.segs):
        if g.asmg.n_vtx and g.asmg.vtx_del[i]:
            continue
        if sg.seq is None:
            log_warn(f"skip empty sequence: {sg.name}")
            continue
        fo.write(f">{sg.name}\n")
        for j in range(0, len(sg.seq), line_wd):
            fo.write(sg.seq[j : j + line_wd])
            fo.write("\n")


def asg_stat(g: Asg, fo=sys.stderr):
    asmg = g.asmg
    n_seg = asmg.vtx_n1()
    tot = g.seg_len_total()
    fo.write(f"Number of segments: {n_seg}\n")
    fo.write(f"Total segment length: {tot}\n")
    if n_seg:
        fo.write(f"Average segment length: {tot / n_seg:.3f}\n")
    asmg._flush_pending()
    n_arc = int(np.count_nonzero(~asmg.adel))
    n_link = int(np.count_nonzero(~asmg.adel & ~asmg.acomp))
    fo.write(f"Number of links: {n_link}\n")
    fo.write(f"Number of arcs: {n_arc}\n")
    degs = [asmg.arc_n1(v) for v in range(2 * asmg.n_vtx)]
    fo.write(f"Max degree: {max(degs) if degs else 0}\n")
    if n_seg:
        fo.write(f"Average degree: {sum(degs) / n_seg / 2:.3f}\n")
