"""hmmannot CLI (run_hmmannot.c main analogue): nhmmscan batch driver."""
from __future__ import annotations

import argparse
import sys

from ..annot.runner import check_executable, hmm_annotate
from ..utils.log import print_exit_stats
from ._common import open_out


def main(argv=None):
    p = argparse.ArgumentParser(prog="hmmannot", description="nhmmscan batch annotation driver")
    p.add_argument("--version", action="version", version="1.0")
    p.add_argument("nhmmdb", help="HMM profile database")
    p.add_argument("files", nargs="+", help="FASTA/FASTQ/GFA input(s)")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-b", "--batch-size", type=int, default=100000)
    p.add_argument("-T", "--tmpdir", default=None)
    p.add_argument("-o", default="-")
    p.add_argument("--nhmmscan", default="nhmmscan")
    p.add_argument("-v", "--verbose", type=int, default=0)
    args = p.parse_args(argv)

    import os

    if not os.path.isfile(args.nhmmdb):
        sys.stderr.write(f"[E::main] input database file does not exist: {args.nhmmdb}\n")
        return 1
    if not check_executable(args.nhmmscan):
        sys.stderr.write(f"[E::main] executable not found: {args.nhmmscan}\n")
        return 1
    fo = open_out(args.o)
    ret = hmm_annotate(
        args.files,
        args.nhmmscan,
        args.nhmmdb,
        fo,
        max_batch_size=args.batch_size,
        max_batch_num=args.threads * 5,
        n_threads=args.threads,
        tmpdir=args.tmpdir,
    )
    if fo is not sys.stdout:
        fo.close()
    print_exit_stats("main")
    return ret


def _console() -> int:
    """console_scripts entry point."""
    import sys as _sys

    return int(main(_sys.argv[1:]) or 0)


if __name__ == "__main__":
    sys.exit(main())
