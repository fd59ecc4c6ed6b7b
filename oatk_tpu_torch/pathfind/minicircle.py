"""Minicircle mode (path_finder.c:539-930 analogue).

For small animal mitochondria / plasmids: anchor segment = best OG_MINI
score; circular-path existence check <= 50kb; re-align reads to the
original syncasm graph and extract repeat units from reads whose
alignments revisit the anchor with consistent orientation and a
periodic unitig pattern; dedup; emit the best circular path.
"""
from __future__ import annotations

import sys

import numpy as np

from ..annot.db import OG_MINI, AnnotDB, Bed6DB, bed6_print, formatted_print_sname_list, hmm_annot_read
from ..graph.traverse import path_exists, subgraph as asmg_subgraph
from ..io.gfa import Asg, asg_print, asg_print_fa, asg_read
from ..utils import log_error, log_info
from .classify import annot_subgraph_og_type, get_sequence_annot_score, print_og_classification_summary
from .driver import COMMON_MAX_MINICIRCLE_SIZE
from .output import path_add_hmm_annot_bed6, path_sort, print_seq, select_best_seq
from .search import Path


def _minicircle_unit(ra, anchor_sid: int):
    """Extract the repeat unit of one read alignment; returns
    (beg, end, rev) or None (path_finder.c:545-607)."""
    nfrg = ra.n
    if nfrg < 2:
        return None
    beg = end = rev = None
    for j in range(nfrg):
        uid = ra.frags[j].uid
        if (uid >> 1) != anchor_sid:
            continue
        if beg is None:
            beg = j
        elif end is None:
            end = j - 1
        if rev is None:
            rev = uid & 1
        elif rev != (uid & 1):
            return None
    if beg is None or end is None or rev is None:
        return None
    # repeat-unit periodicity check across the whole alignment
    if beg > 0 or end < nfrg - 2:
        r = end - beg
        if beg > r:
            return None
        k = r - beg
        k = 0 if k + 1 > r else k + 1
        for j in range(nfrg):
            if ra.frags[j].uid != ra.frags[beg + k].uid:
                return None
            k = 0 if k + 1 > r else k + 1
    return beg, end, rev


def extract_minicircles_with_anchor(ra_db, scg, anchor_sid: int, paths: list[Path]) -> int:
    g = scg.utg
    raw = []
    for ra in ra_db:
        unit = _minicircle_unit(ra, anchor_sid)
        if unit is None:
            continue
        beg, end, rev = unit
        vt = [ra.frags[j].uid & 0xFFFFFFFF for j in range(beg, end + 1)]
        if rev:
            vt = [vt[0]] + vt[1:][::-1]
            vt = [x ^ 1 for x in vt]
        raw.append(vt)
    if not raw:
        return 0
    # sort and dedup (path_cmpfunc: by nv then lexicographic)
    raw.sort(key=lambda v: (len(v), v))
    dedup = [raw[0]]
    for v in raw[1:]:
        if v != dedup[-1]:
            dedup.append(v)
    for vt in dedup:
        ai = g.arc_idx(vt[-1], vt[0], live_only=True)
        assert ai is not None
        l = g.vtx_len[vt[0] >> 1]
        cov = g.vtx_cov[vt[0] >> 1]
        wl = float(cov) * l
        l -= int(g.als[ai])
        wl -= cov * int(g.als[ai])
        for j in range(1, len(vt)):
            l1 = g.vtx_len[vt[j] >> 1]
            cov = g.vtx_cov[vt[j] >> 1]
            l += l1
            wl += float(cov) * l1
            ai = g.arc_idx(vt[j - 1], vt[j], live_only=True)
            l -= int(g.als[ai])
            wl -= float(cov) * int(g.als[ai])
        paths.append(Path(None, vt, True, int(l), wl))
    return len(paths)


def parse_organelle_minicircle(
    asg: Asg, annot_db: AnnotDB, og_components, seg_annot_score, scg_meta,
    out_pref: str, out_opt: int, max_eval: float, seq_cf: float, verbose: int = 0,
) -> int:
    if not og_components:
        log_info("no OG component found", func="parse_organelle_minicircle")
        return 1
    tname = "mini"
    out_ctg = open(f"{out_pref}.{tname}.ctg.fasta", "w")
    out_ctg_bed = open(f"{out_pref}.{tname}.ctg.bed", "w")
    out_gfa = open(f"{out_pref}.{tname}.gfa", "w")
    out_gfa_bed = open(f"{out_pref}.{tname}.bed", "w")

    component = og_components[0]
    if component.type != OG_MINI:
        return 1
    max_s = 0.0
    anchor_sid = 0
    for sid in component.v:
        s = seg_annot_score[sid, OG_MINI]
        if s > max_s:
            max_s = s
            anchor_sid = sid
    if verbose > 0:
        log_info(
            f"anchor sequence found: {asg.segs[anchor_sid].name} "
            f"[len {asg.segs[anchor_sid].len}; score, {max_s:.3f}]",
            func="parse_organelle_minicircle",
        )

    asmg = scg_meta.scg.utg
    exists, step, dist = path_exists(
        asmg, anchor_sid << 1, anchor_sid << 1, 0, COMMON_MAX_MINICIRCLE_SIZE
    )
    if verbose > 0:
        log_info(
            f"circular path {'WAS' if exists else 'NOT'} found between anchor sequence "
            f"in the original assembly graph: r={step}, d={dist}",
            func="parse_organelle_minicircle",
        )

    paths: list[Path] = []
    if exists:
        from ..asm.align import scg_read_alignment
        from ..asm.consensus import scg_consensus

        scg_meta.scg.utg.clean_consensus()
        ra_db = scg_read_alignment(scg_meta.read_db, scg_meta.scg, for_unzip=False)
        scg_consensus(scg_meta.read_db, scg_meta.scg, hoco_seq=False, save_seq=False, fo=None,
                      device=scg_meta.device)
        extract_minicircles_with_anchor(ra_db, scg_meta.scg, anchor_sid, paths)

    o_asmg = asg.asmg
    asg.asmg = o_asmg.copy()
    asmg_subgraph(asg.asmg, [anchor_sid], 0, 0, modify_graph=True)
    bed_annots = Bed6DB()

    if not paths:
        if verbose > 0:
            log_info(
                f"subgraph seeding from {asg.segs[anchor_sid].name} is unresolvable, "
                "output unitigs as unassembled",
                func="parse_organelle_minicircle",
            )
        asg_print_fa(asg, sys.stdout, 60)
        c = 0
        for v in component.v:
            if asg.asmg.vtx_del[v]:
                continue
            c += 1
            p = Path(None, [v << 1], False, asg.segs[v].len, float(asg.segs[v].len) * asg.segs[v].cov)
            print_seq(asg, p, out_ctg, c, False, 60, 100)
            path_add_hmm_annot_bed6(bed_annots, annot_db, asg, p, c, False, 100, OG_MINI, max_eval)
    else:
        path_sort(paths)
        b = select_best_seq(asg, paths, None, out_opt, seq_cf, 0, False)
        print_seq(asg, paths[b], out_ctg, 1, False, 60, 100)
        path_add_hmm_annot_bed6(bed_annots, annot_db, asg, paths[b], 1, False, 100, OG_MINI, max_eval)

    bed6_print(bed_annots, out_ctg_bed, True)
    names = [asg.segs[i].name for i in range(asg.n_seg) if not asg.asmg.vtx_del[i]]
    formatted_print_sname_list(annot_db, names, out_gfa_bed, OG_MINI, max_eval, True)
    asg_print(asg, out_gfa, False)
    asg.asmg = o_asmg

    out_ctg.close()
    out_ctg_bed.close()
    out_gfa.close()
    out_gfa_bed.close()
    return 0


def pathfinder_minicircle(
    asg_file: str,
    mini_annot: str,
    scg_meta,
    min_len: int = 5000,
    max_eval: float = 1e-6,
    min_score: float = 300,
    seq_cf: float = 0.90,
    no_trn: int = 1,
    no_rrn: int = 1,
    out_opt: int = 0,
    out_pref: str = "oatk.asm",
    verbose: int = 0,
) -> int:
    asg = asg_read(asg_file)
    if asg is None:
        log_error(f"failed to read the graph: {asg_file}")
        return 1
    annot_db = hmm_annot_read(mini_annot, None, OG_MINI)
    if annot_db is None:
        log_error("failed to read the annotation file")
        return 1
    seg_annot_score = get_sequence_annot_score(annot_db, asg, no_trn, no_rrn, max_eval, 0, verbose)
    og_components = annot_subgraph_og_type(
        annot_db, asg, no_trn, no_rrn, max_eval, 0, min_len, min_score, 1, verbose
    )
    if not og_components:
        log_error("no organelle component found")
        return 1
    if verbose > 1:
        print_og_classification_summary(asg, annot_db, og_components)
    return parse_organelle_minicircle(
        asg, annot_db, og_components, seg_annot_score, scg_meta,
        out_pref, out_opt, max_eval, seq_cf, verbose,
    )
