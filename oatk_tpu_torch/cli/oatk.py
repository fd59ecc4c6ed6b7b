"""oatk wrapper CLI (oatk.c analogue): syncasm -> hmmannot -> pathfinder
(PyTorch port of ``oatk_tpu/cli/oatk.py``, with ``--device``)."""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from ..annot.runner import check_executable, hmm_annotate
from ..utils.log import print_exit_stats
from ._common import parse_data_size


def build_parser():
    from .syncasm import ENV_EPILOG

    p = argparse.ArgumentParser(
        prog="oatk", description="organelle genome assembly toolkit",
        epilog=ENV_EPILOG, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("files", nargs="+")
    p.add_argument("-o", default="./oatk.asm")
    p.add_argument(
        "-t", "--threads", type=int, default=1,
        help="number of threads (assembly native stages + nhmmscan "
        "fan-out) [1]",
    )
    p.add_argument("-G", dest="input_asg", action="store_true", help="input is an assembly graph")
    p.add_argument("-M", dest="mini_circle", action="store_true", help="minicircle mode")
    # syncasm
    p.add_argument("-k", type=int, default=1001)
    p.add_argument("-s", type=int, default=31)
    p.add_argument("-c", type=int, default=30)
    p.add_argument("-a", type=float, default=0.35)
    p.add_argument("-D", type=parse_data_size, default=0)
    p.add_argument("--max-bubble", type=int, default=100000)
    p.add_argument("--max-tip", type=int, default=10000)
    p.add_argument("--weak-cross", type=float, default=0.3)
    p.add_argument("--unzip-round", type=int, default=3)
    p.add_argument("--no-read-ec", action="store_true")
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="device for extraction, counting and (under "
        "OATK_TPU_WF_BACKEND=device) EC's wavefront [cuda]; cpu runs the "
        "kernels' plain PyTorch versions",
    )
    p.add_argument(
        "--shards", type=int, default=0,
        help="shard extraction+counting over this many devices of --device [off]",
    )
    # annotation
    p.add_argument("-m", dest="mito_db", default=None)
    p.add_argument("-p", dest="pltd_db", default=None)
    p.add_argument("-b", dest="batch_size", type=int, default=100000)
    p.add_argument("-T", dest="tmpdir", default=None)
    p.add_argument("--nhmmscan", default="nhmmscan")
    # pathfinder
    p.add_argument("-f", type=float, default=0.90, dest="seq_cf")
    p.add_argument("-S", "--min-score", type=float, default=300)
    p.add_argument("-e", "--max-eval", type=float, default=1e-6)
    p.add_argument("-g", "--min-gain", default="3,1")
    p.add_argument("-l", "--min-s-length", type=int, default=-1)
    p.add_argument("-q", "--min-s-cov", type=float, default=0.20, dest="min_cf")
    p.add_argument("-C", "--max-copy", type=int, default=10)
    p.add_argument("-N", "--max-path", type=int, default=1000000)
    p.add_argument("--longest", action="store_true")
    p.add_argument("--circular", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--include-trn", action="store_true")
    p.add_argument("--include-rrn", action="store_true")
    p.add_argument("--no-graph-clean", action="store_true")
    p.add_argument("--edge-c-tag", default=None)
    p.add_argument("--kmer-c-tag", default=None)
    p.add_argument("--seq-c-tag", default=None)
    p.add_argument("-v", "--verbose", type=int, default=0)
    p.add_argument("--version", action="version", version="1.0")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from . import pathfinder as pf_cli

    if pf_cli.apply_tags(args):
        return 1
    if not args.mito_db and not args.pltd_db:
        sys.stderr.write("[E::main] provide at least one HMM profile database (-m and/or -p)\n")
        return 1
    for db in (args.mito_db, args.pltd_db):
        if db and not os.path.isfile(db):
            sys.stderr.write(f"[E::main] input database file does not exist: {db}\n")
            return 1
    if args.mini_circle and args.input_asg:
        sys.stderr.write("[E::main] mini-circle mode is not compatible with '-G' option\n")
        return 1
    if args.mini_circle and args.mito_db and args.pltd_db:
        sys.stderr.write("[E::main] only one HMM profile database allowed for mini-circle mode\n")
        return 1
    min_len = args.min_s_length
    if min_len < 0:
        min_len = 5000 if args.mini_circle else 10000

    outdir = os.path.dirname(args.o) or "."
    os.makedirs(outdir, exist_ok=True)
    outpref = args.o

    # stage 1: assembly
    scg_meta = None
    if args.input_asg:
        asg_file = args.files[0]
        sys.stderr.write(f"[M::main] using user input assembly graph file: {asg_file}\n")
    else:
        from ..asm.pipeline import syncasm

        scg_meta = syncasm(
            args.files, k=args.k, s=args.s, min_k_cov=args.c, min_a_cov_f=args.a,
            bubble_size=args.max_bubble, tip_size=args.max_tip, weak_cross=args.weak_cross,
            do_ec=not args.no_read_ec, do_unzip=args.unzip_round, max_data=args.D,
            out=outpref, verbose=args.verbose, shards=args.shards, threads=args.threads,
            device=args.device,
        )
        if scg_meta.scg is None:
            sys.stderr.write("[E::main] syncasm assembly program failed\n")
            return 1
        asg_file = f"{outpref}.utg.final.gfa"

    # stage 2: annotation
    if not check_executable(args.nhmmscan):
        sys.stderr.write(f"[E::main] executable not found: {args.nhmmscan}\n")
        return 1
    tmpdir = args.tmpdir or tempfile.mkdtemp(prefix="tmp_", dir=outdir)
    mito_annot = pltd_annot = None
    if args.mito_db:
        mito_annot = f"{outpref}.annot_mito.txt"
        with open(mito_annot, "w") as fo:
            hmm_annotate([asg_file], args.nhmmscan, args.mito_db, fo, args.batch_size,
                         args.threads * 5, args.threads, tmpdir)
    if args.pltd_db:
        pltd_annot = f"{outpref}.annot_pltd.txt"
        with open(pltd_annot, "w") as fo:
            hmm_annotate([asg_file], args.nhmmscan, args.pltd_db, fo, args.batch_size,
                         args.threads * 5, args.threads, tmpdir)

    # stage 3: pathfinder
    gains = args.min_gain.split(",")
    ext_p = int(gains[0])
    ext_m = int(gains[1]) if len(gains) > 1 else 1
    out_opt = 1 if args.circular else (2 if args.all else 0)
    if args.mini_circle:
        from ..pathfind.minicircle import pathfinder_minicircle

        ret = pathfinder_minicircle(
            asg_file, mito_annot or pltd_annot, scg_meta, min_len=min_len,
            max_eval=args.max_eval, min_score=args.min_score, seq_cf=args.seq_cf,
            no_trn=0 if args.include_trn else 1, no_rrn=0 if args.include_rrn else 1,
            out_opt=out_opt, out_pref=outpref, verbose=args.verbose,
        )
    else:
        from ..pathfind.driver import pathfinder

        ret = pathfinder(
            asg_file, mito_annot, pltd_annot, min_len=min_len, ext_p=ext_p, ext_m=ext_m,
            max_copy=args.max_copy, max_path=args.max_path, max_eval=args.max_eval,
            min_score=args.min_score, min_cf=args.min_cf, seq_cf=args.seq_cf,
            no_trn=0 if args.include_trn else 1, no_rrn=0 if args.include_rrn else 1,
            do_graph_clean=0 if args.no_graph_clean else 1, bubble_size=args.max_bubble,
            tip_size=args.max_tip, weak_cross=args.weak_cross, out_opt=out_opt,
            out_pref=outpref, verbose=args.verbose,
        )
    if ret:
        sys.stderr.write("[E::main] pathfinder program failed\n")
        return 1
    print_exit_stats("main")
    return 0


def _console() -> int:
    """console_scripts entry point."""
    import sys as _sys

    return int(main(_sys.argv[1:]) or 0)


if __name__ == "__main__":
    sys.exit(main())
