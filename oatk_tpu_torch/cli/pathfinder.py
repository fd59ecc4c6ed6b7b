"""pathfinder CLI (path_finder.c main analogue)."""
from __future__ import annotations

import argparse
import sys

from ..io import gfa as gfa_mod
from ..pathfind.driver import pathfinder
from ..utils.log import print_exit_stats


def build_parser():
    p = argparse.ArgumentParser(prog="pathfinder", description="organelle extraction & circularization from GFA + annotations")
    p.add_argument("gfa", help="assembly graph (GFA)")
    p.add_argument("-m", "--mito-annot", default=None)
    p.add_argument("-p", "--pltd-annot", default=None)
    p.add_argument("-s", "--min-score", type=float, default=300)
    p.add_argument("-g", "--min-gain", default="3,1", help="pltd[,mito] minimum core gene gain")
    p.add_argument("-q", "--min-s-cov", type=float, default=0.20, dest="min_cf")
    p.add_argument("-f", type=float, default=0.90, dest="seq_cf")
    p.add_argument("-c", "--max-copy", type=int, default=10)
    p.add_argument("-e", "--max-eval", type=float, default=1e-6)
    p.add_argument("-l", "--min-s-len", type=int, default=10000)
    p.add_argument("-N", "--max-path", type=int, default=1000000)
    p.add_argument("-o", default="oatk.asm")
    p.add_argument("--longest", action="store_true")
    p.add_argument("--circular", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--edge-c-tag", default=None)
    p.add_argument("--kmer-c-tag", default=None)
    p.add_argument("--seq-c-tag", default=None)
    p.add_argument("--include-trn", action="store_true")
    p.add_argument("--include-rrn", action="store_true")
    p.add_argument("--max-bubble", type=int, default=100000)
    p.add_argument("--max-tip", type=int, default=10000)
    p.add_argument("--weak-cross", type=float, default=0.3)
    p.add_argument("--no-graph-clean", action="store_true")
    p.add_argument("-v", "--verbose", type=int, default=0)
    p.add_argument("--version", action="version", version="1.0")
    return p


def apply_tags(args) -> int:
    for tag, target in (
        (args.edge_c_tag, gfa_mod.TAG_ARC_COV),
        (args.kmer_c_tag, gfa_mod.TAG_SBP_COV),
        (args.seq_c_tag, gfa_mod.TAG_SEQ_COV),
    ):
        if tag is not None:
            if not gfa_mod.is_valid_gfa_tag(tag):
                sys.stderr.write(f"[E::main] invalid GFA tag: {tag}\n")
                return 1
            target[0] = tag
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if apply_tags(args):
        return 1
    if not args.mito_annot and not args.pltd_annot:
        sys.stderr.write("[E::main] provide at least one annotation file (-m and/or -p)\n")
        return 1
    gains = args.min_gain.split(",")
    ext_p = int(gains[0])
    ext_m = int(gains[1]) if len(gains) > 1 else 1
    out_opt = 1 if args.circular else (2 if args.all else 0)
    ret = pathfinder(
        args.gfa,
        args.mito_annot,
        args.pltd_annot,
        min_len=args.min_s_len,
        ext_p=ext_p,
        ext_m=ext_m,
        max_copy=args.max_copy,
        max_path=args.max_path,
        max_eval=args.max_eval,
        min_score=args.min_score,
        min_cf=args.min_cf,
        seq_cf=args.seq_cf,
        no_trn=0 if args.include_trn else 1,
        no_rrn=0 if args.include_rrn else 1,
        do_graph_clean=0 if args.no_graph_clean else 1,
        bubble_size=args.max_bubble,
        tip_size=args.max_tip,
        weak_cross=args.weak_cross,
        out_opt=out_opt,
        out_pref=args.o,
        verbose=args.verbose,
    )
    print_exit_stats("main")
    return ret


def _console() -> int:
    """console_scripts entry point."""
    import sys as _sys

    return int(main(_sys.argv[1:]) or 0)


if __name__ == "__main__":
    sys.exit(main())
