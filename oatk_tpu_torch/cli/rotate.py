"""rotate CLI (rotate.c analogue): rotate/reverse circular FASTA sequences."""
from __future__ import annotations

import argparse
import gzip
import sys

from ..io.fastx import FastxReader
from ..utils.log import print_exit_stats
from ._common import open_out, print_wrapped, revcomp


def main(argv=None):
    p = argparse.ArgumentParser(prog="rotate")
    p.add_argument("--version", action="version", version="1.0")
    p.add_argument("fasta")
    p.add_argument("seq_id", nargs="?", default=None)
    p.add_argument("pos", nargs="?", type=int, default=None)
    p.add_argument("-s", "--rotate-file", default=None, help="two/three-column rotation file")
    p.add_argument("-r", action="store_true", help="rotate in reverse strand")
    p.add_argument("-l", type=int, default=60)
    p.add_argument("-o", default="-")
    p.add_argument("-v", "--verbose", type=int, default=0)
    args = p.parse_args(argv)

    line_wd = args.l if args.l else (1 << 31) - 1
    regs: dict[str, tuple[int, int]] = {}
    if args.seq_id is not None and args.pos is not None:
        if args.pos <= 0:
            sys.stderr.write(f"[E::main] rotate position must be positive: {args.pos}\n")
            return 1
        regs[args.seq_id] = (args.pos, 1 if args.r else 0)
    elif args.rotate_file:
        op = gzip.open if args.rotate_file.endswith(".gz") else open
        with op(args.rotate_file, "rt") as fp:
            for lineno, line in enumerate(fp, 1):
                f = line.split()
                if not f:
                    continue
                if len(f) < 2:
                    sys.stderr.write(f"[E::main] invalid line at line {lineno}: need two columns\n")
                    return 1
                pos = int(f[1])
                if pos <= 0:
                    sys.stderr.write(f"[E::main] rotate position must be positive: {pos}\n")
                    return 1
                strand = 0
                if len(f) > 2:
                    if f[2] == "-":
                        strand = 1
                    elif f[2] != "+":
                        sys.stderr.write("[E::main] the third column (strand) must be '+' or '-'\n")
                        return 1
                if f[0] in regs:
                    sys.stderr.write(f"[E::main] duplicate sequence '{f[0]}'\n")
                    return 1
                regs[f[0]] = (pos, strand)
    else:
        sys.stderr.write("[E::main] need a file (-s) or two rotation parameters\n")
        return 1

    fo = open_out(args.o)
    for rec in FastxReader([args.fasta]):
        seq = rec.seq.tobytes().decode()
        ln = len(seq)
        fo.write(f">{rec.name}\n")
        if rec.name in regs:
            pos, strand = regs.pop(rec.name)
            if pos > ln:
                sys.stderr.write(
                    f"[E::main] rotation position ({pos}) larger than sequence length ({ln})\n"
                )
                return 1
            if strand:
                out = revcomp(seq[:pos]) + revcomp(seq[pos:])
            else:
                out = seq[pos - 1 :] + seq[: pos - 1]
        else:
            out = seq
        wrote = print_wrapped(fo, out, line_wd)
        if wrote % line_wd != 0:
            fo.write("\n")
    for name in regs:
        sys.stderr.write(f"[W::main] sequence '{name}' not found in the FASTA file\n")
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
