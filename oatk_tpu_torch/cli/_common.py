"""Shared CLI helpers."""
from __future__ import annotations

import sys

_COMP = str.maketrans(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz",
    "TVGHEFCDIJMLKNOPQYSAABWXRZTVGHEFCDIJMLKNOPQYSAABWXRZ",
)


def parse_data_size(s: str) -> int:
    mult = 1
    if s and s[-1] in "kKmMgG":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[s[-1].lower()]
        s = s[:-1]
    return int(s) * mult


def open_out(path: str | None):
    if not path or path == "-":
        return sys.stdout
    return open(path, "w")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def print_wrapped(fo, seq: str, line_wd: int, pos: int = 0) -> int:
    """Emit seq wrapping at line_wd counting from pos; returns new pos."""
    i = 0
    n = len(seq)
    while i < n:
        take = min(line_wd - (pos % line_wd), n - i)
        fo.write(seq[i : i + take])
        i += take
        pos += take
        if pos % line_wd == 0:
            fo.write("\n")
    return pos
