"""Checks against what the sample is known to be: the generator's genomes
and each read's source.  Plain numpy.

- An assembly's segments should spell the sample's organelle genomes:
  :func:`gfa_kmer_errors` counts the 31-mers of the segments that the
  genomes do not hold (either strand, circular) and the genomes' 31-mers
  that no segment holds.
- A corrected read should carry the syncmers of the stretch of genome it
  was read from: :func:`multiset_diff` counts, read by read, the
  syncmers in one list and not the other.
"""
from __future__ import annotations

import numpy as np

K = 31
_NT4 = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _NT4[_c] = _i
    _NT4[_c + 32] = _i


def canonical_kmers(seq: np.ndarray, k: int = K) -> np.ndarray:
    """Canonical 2-bit codes (int64) of every k-mer of an ASCII sequence
    that holds only A, C, G, T."""
    c = _NT4[seq].astype(np.int64)
    n = len(c) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    fwd = np.zeros(n, np.int64)
    rev = np.zeros(n, np.int64)
    for j in range(k):
        fwd = (fwd << 2) | c[j:j + n]
        rev = rev | ((3 - c[j:j + n]) << (2 * j))
    bad = np.convolve((c == 4).astype(np.int64), np.ones(k, np.int64), "valid") > 0
    return np.minimum(fwd, rev)[~bad]


def genome_kmers(genomes: list) -> np.ndarray:
    """Sorted unique canonical k-mers of circular genomes."""
    parts = [canonical_kmers(np.concatenate([g, g[:K - 1]])) for g in genomes]
    return np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int64)


def read_gfa_segments(path: str) -> list:
    """The sequences of a GFA's S lines, as ASCII arrays."""
    out = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"S\t"):
                out.append(np.frombuffer(line.split(b"\t")[2], np.uint8))
    return out


def gfa_kmer_errors(segments: list, truth: np.ndarray) -> tuple[int, int]:
    """(foreign, missed): segment k-mer positions absent from ``truth``
    (sorted unique canonical k-mers), and ``truth`` k-mers in no
    segment."""
    if not segments:
        return 0, len(truth)
    km = np.concatenate([canonical_kmers(s) for s in segments])
    i = np.searchsorted(truth, km)
    i[i == len(truth)] = 0
    found = truth[i] == km if len(truth) else np.zeros(len(km), bool)
    foreign = int((~found).sum())
    missed = len(truth) - len(np.unique(km[found]))
    return foreign, int(missed)


def key_counts(*lists) -> tuple[np.ndarray, np.ndarray]:
    """Counts of each distinct (read, hash) key in each of several lists
    of (read, hash): the read of each key and an [n_keys, n_lists] int64
    array."""
    rd = np.concatenate([np.asarray(r, np.int64) for r, _ in lists])
    h = np.concatenate([np.asarray(x, np.uint64) for _, x in lists])
    which = np.concatenate([np.full(len(r), i, np.int64) for i, (r, _) in enumerate(lists)])
    if len(rd) == 0:
        return np.zeros(0, np.int64), np.zeros((0, len(lists)), np.int64)
    o = np.lexsort((h, rd))
    rd, h, which = rd[o], h[o], which[o]
    new = np.ones(len(rd), bool)
    new[1:] = (rd[1:] != rd[:-1]) | (h[1:] != h[:-1])
    key = np.cumsum(new) - 1
    out = np.zeros((int(key[-1]) + 1, len(lists)), np.int64)
    np.add.at(out, (key, which), 1)
    return rd[new], out


def multiset_diff(rd_a, h_a, rd_b, h_b) -> int:
    """Sum over reads of the size of the multiset symmetric difference of
    two lists of (read, hash)."""
    _, c = key_counts((rd_a, h_a), (rd_b, h_b))
    return int(np.abs(c[:, 0] - c[:, 1]).sum())
