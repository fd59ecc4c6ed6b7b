"""path_to_fasta CLI (path_to_fasta.c analogue): GFA + path string -> FASTA."""
from __future__ import annotations

import argparse
import gzip
import sys

from ..io.gfa import asg_read
from ..pathfind.output import print_seq
from ..pathfind.search import make_path_from_str
from ..utils.log import print_exit_stats
from ._common import open_out


def main(argv=None):
    p = argparse.ArgumentParser(prog="path_to_fasta")
    p.add_argument("--version", action="version", version="1.0")
    p.add_argument("gfa")
    p.add_argument("path_str", nargs="?", default=None)
    p.add_argument("-p", "--path-file", default=None, help="two-column path file")
    p.add_argument("-s", "--seq-id", default=None)
    p.add_argument("-l", type=int, default=60, help="residues per line; 0 for 2^31-1")
    p.add_argument("-n", type=int, default=100, help="gap Ns between unlinked sequences")
    p.add_argument("-o", default="-")
    p.add_argument("--linear", action="store_true")
    p.add_argument("-v", "--verbose", type=int, default=0)
    args = p.parse_args(argv)

    if not args.path_str and not args.path_file:
        sys.stderr.write("[E::main] need a path file (-p) or path string\n")
        return 1
    line_wd = args.l if args.l else (1 << 31) - 1

    g = asg_read(args.gfa)
    paths = []
    if args.path_str:
        paths.append(make_path_from_str(g, args.path_str, args.seq_id))
    else:
        op = gzip.open if args.path_file.endswith(".gz") else open
        with op(args.path_file, "rt") as fp:
            for lineno, line in enumerate(fp, 1):
                f = line.split()
                if not f:
                    continue
                if len(f) < 2:
                    sys.stderr.write(f"[E::main] invalid line at line {lineno}: {line}")
                    return 1
                paths.append(make_path_from_str(g, f[1], f[0]))

    fo = open_out(args.o)
    for i, path in enumerate(paths):
        print_seq(g, path, fo, i + 1, args.linear, line_wd, args.n)
    if fo is not sys.stdout:
        fo.close()
    print_exit_stats("main")
    return 0


def _console() -> int:
    """console_scripts entry point."""
    import sys as _sys

    return int(main(_sys.argv[1:]) or 0)


if __name__ == "__main__":
    sys.exit(main())
