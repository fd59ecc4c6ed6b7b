"""pathfinder driver: per-component gene gating, copy-number expansion,
two-pass path search and output files (path_finder.c:96-993 analogue).

Outputs (per og type): {out}.{type}.ctg.fasta / .ctg.bed / .gfa / .bed
"""
from __future__ import annotations

import sys

import numpy as np

from ..annot.db import (
    OG_MINI,
    OG_MITO,
    OG_PLTD,
    OG_TYPES,
    AnnotDB,
    Bed6DB,
    bed6_print,
    formatted_print_sname_list,
    hmm_annot_read,
)
from ..graph.clean import drop_tip, pop_bubble, remove_weak_crosslink
from ..graph.traverse import path_exists, subgraph as asmg_subgraph
from ..io.gfa import Asg, asg_print, asg_read, asg_stat
from ..utils import log_error, log_info
from .classify import OgComponent, annot_subgraph_og_type, asg_annotation, get_sequence_annot_score, print_og_classification_summary
from .copynum import adjust_sequence_copy_number_by_graph_layout, graph_sequence_coverage_precise
from .output import path_add_hmm_annot_bed6, path_sort, print_seq, select_best_seq, sequence_covered_by_path
from .rotate import path_rotate
from .search import Path, graph_path_finder, sequence_duplication_by_copy_number

COMMON_MAX_MINICIRCLE_SIZE = 50000


def _parse_subgraphs(asg: Asg):
    g = asg.asmg
    n_seg = asg.n_seg
    visited = np.zeros(n_seg, bool)
    out = []
    for i in range(n_seg):
        if visited[i] or g.vtx_del[i]:
            continue
        vlist = asmg_subgraph(g, [i], 0, 0, modify_graph=False)
        out.append(list(vlist))
        for v in vlist:
            visited[v] = True
    return out


def parse_organelle_component(
    asg: Asg,
    annot_db: AnnotDB,
    og_components: list[OgComponent],
    min_s_len: int,
    max_copy: int,
    max_path: int,
    min_ext_g: int,
    seq_cf: float,
    do_clean: bool,
    min_cf: float,
    min_score: float,
    max_eval: float,
    bubble_size: int,
    tip_size: int,
    weak_cross: float,
    out_pref: str,
    out_opt: int,
    og_type: int,
    verbose: int = 0,
):
    tname = OG_TYPES[og_type]
    out_ctg = open(f"{out_pref}.{tname}.ctg.fasta", "w")
    out_ctg_bed = open(f"{out_pref}.{tname}.ctg.bed", "w")
    out_gfa = open(f"{out_pref}.{tname}.gfa", "w")
    out_gfa_bed = open(f"{out_pref}.{tname}.bed", "w")

    o_asmg = asg.asmg
    n_seg = asg.n_seg
    g_diff = 0.85
    c_diff = 0.6
    bed_annots = Bed6DB()
    sub_v: list[int] = []
    c = 0
    opt_circ = 0
    opt_coverage = 0.0

    # total gene score table
    h_genes: dict[int, int] = {}
    for comp in og_components:
        if comp.type != og_type:
            continue
        for x in comp.g:
            x = int(x)
            if (x >> 32) & 0x3 != og_type:
                continue
            key = x >> 32
            sc = x & 0xFFFFFFFF
            if h_genes.get(key, -1) < sc:
                h_genes[key] = sc
    h_score = float(sum(h_genes.values()))
    if verbose > 0:
        log_info(
            f"total gene score for the organelle: type, {tname}; score, {h_score:.1f}",
            func="parse_organelle_component",
        )

    b_genes: dict[int, int] = {}
    b_score = 0.0
    b_length = 0
    for ci, comp in enumerate(og_components):
        if comp.type != og_type:
            continue
        if verbose > 0:
            log_info(
                f"processing subgraph seeding from {asg.segs[comp.v[0]].name}: type, {tname}; "
                f"score, {comp.score:.1f}; sscore, {comp.sscore:.1f}; len, {comp.len}; "
                f"nv, {comp.nv}; ng, {comp.ng}",
                func="parse_organelle_component",
            )
        ext_g = all_g = 0
        for x in comp.g:
            x = int(x)
            if (x >> 32) & 0x3 != og_type:
                continue
            score = b_genes.get(x >> 32, 0)
            score1 = x & 0xFFFFFFFF
            if score1 >= min_score and score1 >= score:
                ext_g += 1
            if score1 >= score * g_diff:
                all_g += 1
        if ext_g < min_ext_g and all_g < len(b_genes) * c_diff:
            if verbose > 0:
                log_info(
                    f"subgraph seeding from {asg.segs[comp.v[0]].name} SKIPPED due to "
                    f"insufficient gene gain ({ext_g})",
                    func="parse_organelle_component",
                )
            continue
        if (
            og_type == OG_PLTD
            and b_length + comp.len > 160000
            and comp.score * b_length < b_score * comp.len * c_diff
        ):
            if verbose > 0:
                log_info(
                    f"subgraph seeding from {asg.segs[comp.v[0]].name} SKIPPED due to low "
                    "PLTD gene density",
                    func="parse_organelle_component",
                )
            continue
        for x in comp.g:
            x = int(x)
            if (x >> 32) & 0x3 != og_type:
                continue
            key = x >> 32
            sc = x & 0xFFFFFFFF
            if b_genes.get(key, -1) < sc:
                b_genes[key] = sc
        b_score += comp.score
        b_length += comp.len

        asg.asmg = comp.asmg
        if do_clean:
            cleaned = 1
            while cleaned:
                cleaned = 0
                cleaned += pop_bubble(asg.asmg, bubble_size, 0, False, True, False, verbose)
                cleaned += remove_weak_crosslink(asg.asmg, weak_cross, 10, False, verbose)
                cleaned += drop_tip(asg.asmg, 0x7FFFFFFF, tip_size, True, False, verbose)
        if asg.asmg.vtx_n1() == 0:
            asg.asmg = o_asmg
            continue

        clen = asg.seg_len_total()
        avg_coverage, copy_number = graph_sequence_coverage_precise(asg, min_cf, 1, max_copy)
        if verbose > 0:
            log_info(
                f"estimated per-copy sequence coverage: {avg_coverage:.3f}",
                func="parse_organelle_component",
            )
        if og_type == OG_MITO and opt_coverage > 0 and (
            avg_coverage < opt_coverage * min_cf or avg_coverage * min_cf > opt_coverage
        ):
            asg.asmg = o_asmg
            continue
        if opt_coverage == 0.0:
            opt_coverage = avg_coverage

        asg_copy = asg.copy(with_seq=True)
        seg_dups = sequence_duplication_by_copy_number(asg_copy, copy_number, False)
        paths: list[Path] = []
        graph_path_finder(asg_copy, seg_dups, paths, max_path, seq_cf, og_type == OG_PLTD)

        if not paths:
            if verbose > 0:
                log_info(
                    f"subgraph seeding from {asg.segs[comp.v[0]].name} is unresolvable, "
                    "output unitigs as unassembled",
                    func="parse_organelle_component",
                )
            for v in comp.v:
                if asg.asmg.vtx_del[v]:
                    continue
                c += 1
                p = Path(None, [v << 1], False, asg.segs[v].len, float(asg.segs[v].len) * asg.segs[v].cov)
                print_seq(asg, p, out_ctg, c, False, 60, 100)
                path_add_hmm_annot_bed6(bed_annots, annot_db, asg, p, c, False, 100, og_type, max_eval)
            sub_v.append(ci)
        else:
            if og_type == OG_PLTD:
                for p in paths:
                    path_rotate(asg, p, annot_db, OG_PLTD)
            path_sort(paths)
            v_pb = []
            b = select_best_seq(asg, paths, None, out_opt, seq_cf, 0, og_type == OG_PLTD)
            f = sequence_covered_by_path(asg, paths[b], clen)
            is_circ = paths[b].circ
            v_pb.append(b)
            if verbose > 0:
                log_info(
                    f"best path after first pass: type, {'circular' if is_circ else 'linear'}; "
                    f"coverage, {f:.3f}",
                    func="parse_organelle_component",
                )
            if not is_circ or f < 1.0:
                asg_copy = asg.copy(with_seq=True)
                updated, adjusted_cov = adjust_sequence_copy_number_by_graph_layout(
                    asg_copy, avg_coverage, copy_number, max_copy, 10
                )
                if updated:
                    if verbose > 0:
                        log_info(
                            f"adjusted per-copy sequence coverage: {adjusted_cov:.3f}",
                            func="parse_organelle_component",
                        )
                    asg_copy1 = asg_copy.copy(with_seq=True)
                    seg_dups1 = sequence_duplication_by_copy_number(asg_copy1, copy_number, True)
                    vlists = _parse_subgraphs(asg_copy1)
                    is_circ1 = 1
                    f1 = 0.0
                    paths1: list[Path] = []
                    v_pb1 = []
                    o_g1 = asg_copy1.asmg
                    # faithful to the reference's loop-variable reuse
                    # (path_finder.c:361-401): the PLTD rotation loop
                    # clobbers the subgraph index, so after rotating
                    # tmp_paths the outer loop resumes at that count
                    jj = 0
                    while jj < len(vlists):
                        vlist = vlists[jj]
                        g1 = o_g1.copy()
                        for v in range(asg_copy1.n_seg):
                            g1.vtx_del[v] = True
                        for v in vlist:
                            g1.vtx_del[v] = False
                        for a in range(len(g1.av)):
                            if g1.vtx_del[int(g1.av[a]) >> 1] or g1.vtx_del[int(g1.aw[a]) >> 1]:
                                g1.adel[a] = True
                        asg_copy1.asmg = g1
                        tmp_paths: list[Path] = []
                        graph_path_finder(asg_copy1, seg_dups1, tmp_paths, max_path, seq_cf, og_type == OG_PLTD)
                        if og_type == OG_PLTD:
                            for p in tmp_paths:
                                path_rotate(asg_copy1, p, annot_db, OG_PLTD)
                            if tmp_paths:
                                jj = len(tmp_paths) - 1
                        path_sort(tmp_paths)
                        b1 = select_best_seq(asg_copy1, tmp_paths, None, out_opt, seq_cf, 0, og_type == OG_PLTD)
                        if b1 >= 0:
                            f1 += sequence_covered_by_path(asg_copy1, tmp_paths[b1], clen)
                            is_circ1 &= int(tmp_paths[b1].circ)
                            v_pb1.append(b1 + len(paths1))
                        paths1.extend(tmp_paths)
                        jj += 1
                    asg_copy1.asmg = o_g1
                    if verbose > 0:
                        log_info(
                            f"best path in second pass: type, {'circular' if is_circ1 else 'linear'}; "
                            f"coverage, {f1:.3f}",
                            func="parse_organelle_component",
                        )
                    if (
                        (is_circ1 == is_circ and f1 > f)
                        or (is_circ1 > is_circ and f1 >= f * seq_cf)
                        or (is_circ1 < is_circ and f1 * seq_cf >= f)
                    ):
                        f = f1
                        is_circ = is_circ1
                        v_pb = v_pb1
                        paths = paths1

            if is_circ or not opt_circ or clen >= min_s_len:
                if not opt_circ:
                    opt_circ = is_circ
                sub_v.append(ci)
                incl = np.zeros(n_seg, bool)
                for v in comp.v:
                    if not asg.asmg.vtx_del[v]:
                        incl[v] = True
                for bi in v_pb:
                    path = paths[bi]
                    c += 1
                    print_seq(asg, path, out_ctg, c, False, 60, 100)
                    path_add_hmm_annot_bed6(bed_annots, annot_db, asg, path, c, False, 100, og_type, max_eval)
                    for x in path.v:
                        incl[x >> 1] = False
                for v in comp.v:
                    if not incl[v] or asg.segs[v].len < min_s_len:
                        continue
                    c += 1
                    p = Path(None, [v << 1], False, asg.segs[v].len, float(asg.segs[v].len) * asg.segs[v].cov)
                    print_seq(asg, p, out_ctg, c, False, 60, 100)
                    path_add_hmm_annot_bed6(bed_annots, annot_db, asg, p, c, False, 100, og_type, max_eval)
                if verbose > 0:
                    log_info(
                        f"processing subgraph seeding from {asg.segs[comp.v[0]].name} DONE, "
                        f"{ext_g} better genes gained, total score {b_score:.1f}",
                        func="parse_organelle_component",
                    )
        asg.asmg = o_asmg

    bed6_print(bed_annots, out_ctg_bed, True)

    # merged organelle subgraph GFA + BED
    if sub_v:
        g = og_components[sub_v[0]].asmg.copy()
        for ci in sub_v[1:]:
            g1 = og_components[ci].asmg
            for j in range(g.n_vtx):
                cov = 0
                dele = True
                if not g.vtx_del[j]:
                    dele = False
                    cov += g.vtx_cov[j]
                if not g1.vtx_del[j]:
                    dele = False
                    cov += g1.vtx_cov[j]
                if dele:
                    continue
                g.vtx_del[j] = False
                g.vtx_cov[j] = min(cov, o_asmg.vtx_cov[j])
            for j in range(len(g.av)):
                cov = 0
                dele = True
                if not g.adel[j]:
                    dele = False
                    cov += int(g.acov[j])
                if not g1.adel[j]:
                    dele = False
                    cov += int(g1.acov[j])
                if dele:
                    continue
                g.adel[j] = False
                g.acov[j] = min(cov, int(o_asmg.acov[j]))
        asg.asmg = g
        names = [asg.segs[i].name for i in range(n_seg) if not g.vtx_del[i]]
        formatted_print_sname_list(annot_db, names, out_gfa_bed, og_type, max_eval, True)
        asg_print(asg, out_gfa, False)
        asg.asmg = o_asmg

    out_ctg.close()
    out_ctg_bed.close()
    out_gfa.close()
    out_gfa_bed.close()


def pathfinder(
    asg_file: str,
    mito_annot: str | None,
    pltd_annot: str | None,
    min_len: int = 10000,
    ext_p: int = 3,
    ext_m: int = 1,
    max_copy: int = 10,
    max_path: int = 1000000,
    max_eval: float = 1e-6,
    min_score: float = 300,
    min_cf: float = 0.20,
    seq_cf: float = 0.90,
    no_trn: int = 1,
    no_rrn: int = 1,
    do_graph_clean: int = 1,
    bubble_size: int = 100000,
    tip_size: int = 10000,
    weak_cross: float = 0.3,
    out_opt: int = 0,
    out_pref: str = "oatk.asm",
    verbose: int = 0,
) -> int:
    asg = asg_read(asg_file)
    if asg is None:
        log_error(f"failed to read the graph: {asg_file}")
        return 1
    annot_db = None
    if mito_annot:
        annot_db = hmm_annot_read(mito_annot, annot_db, OG_MITO)
    if pltd_annot:
        annot_db = hmm_annot_read(pltd_annot, annot_db, OG_PLTD)
    og_components = asg_annotation(
        annot_db, asg, no_trn, no_rrn, max_eval, 0, min_len, min_score, 1, verbose
    )
    if og_components is None:
        log_error("no organelle component found")
        return 1
    if verbose > 1:
        print_og_classification_summary(asg, annot_db, og_components)
    if mito_annot:
        parse_organelle_component(
            asg, annot_db, og_components, min_len, max_copy, max_path, ext_m, seq_cf,
            do_graph_clean, min_cf, min_score, max_eval, bubble_size, tip_size, weak_cross,
            out_pref, out_opt, OG_MITO, verbose,
        )
    if pltd_annot:
        parse_organelle_component(
            asg, annot_db, og_components, min_len, max_copy, max_path, ext_p, seq_cf,
            do_graph_clean, min_cf, min_score, max_eval, bubble_size, tip_size, weak_cross,
            out_pref, out_opt, OG_PLTD, verbose,
        )
    return 0
