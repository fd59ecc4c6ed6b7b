"""The one traffic generator: a sample of HiFi-like reads from a traffic
file's parameters and ``--seed``.

A traffic file (``portbench/traffic/<name>.json``) names the genomes of
a sample, each as a layout of segments (a segment may repeat, or come
back reverse-complemented, as a mitochondrion's repeat pair or a
plastid's inverted repeat do), whether it is circular, and its coverage.
The file's ``length_seed`` draws the read lengths and its
``content_seed`` the bases, where each read starts, its strand and its
errors, so every run of one traffic file does the same work.  ``--seed``
draws the order of the reads in the FASTA and which of them are written
reverse-complemented (the same molecule read from the other strand).
The part that every seed shares is made once per checkout and kept
under a directory named by a digest of the traffic file
(:func:`cached_canonical`); a run reads it back and writes its own
FASTA in its seed's order.

Bases come from ``genome_sim.random_genome`` (a frozen copy of the
repository's simulator).  Errors follow ``inject_errors`` of the
repository's ``tests/genome_sim.py``:
each base is in error with probability ``err_rate`` (drawn here as the
gaps between errors, which is the same process), a share ``hp_frac`` of
errors lengthen or shorten a homopolymer run, and the rest are
substitutions, insertions and deletions in equal parts.  The whole
sample is made in blocks of reads with numpy, never a Python loop per
base.

The FASTA has one line per read, ``>r<i>`` headers, reads in a shuffled
order.  :class:`Sample` keeps what the checks need: each read's source
(genome, start, strand and error-free length) and the genomes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from dataclasses import dataclass

import numpy as np

from .genome_sim import random_genome

_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCAtgca"):
    _COMP[_a] = _b
_NT = np.frombuffer(b"ACGT", np.uint8)

# bases of reads made per numpy block (bounds the generator's memory)
BLOCK_BASES = 1 << 26


@dataclass
class Sample:
    """A generated sample: the FASTA's reads in file order and their
    sources."""

    names: list  # genome names, in the traffic file's order
    genomes: list  # [np.uint8 ASCII] one per genome
    circular: list  # [bool] one per genome
    src: np.ndarray  # [n] int32 genome index of each read (file order)
    start: np.ndarray  # [n] int64 start in the genome (forward strand)
    length: np.ndarray  # [n] int64 error-free length
    rev: np.ndarray  # [n] bool read from the reverse strand
    seq_len: np.ndarray  # [n] int64 length as written (after errors)
    n_bases: int  # bases written
    organelles: set  # names of the genomes the assembly should spell

    def true_read(self, i: int) -> np.ndarray:
        """The error-free ASCII sequence of read ``i``."""
        g = self.genomes[self.src[i]]
        st, L = int(self.start[i]), int(self.length[i])
        if self.circular[self.src[i]]:
            idx = (st + np.arange(L)) % len(g)
            seq = g[idx]
        else:
            seq = g[st:st + L]
        if self.rev[i]:
            seq = _COMP[seq[::-1]]
        return seq


def _segments(rng, genome_spec: dict, made: dict) -> np.ndarray:
    """One genome from its layout: each part names a segment, made at
    its first mention from ``rng`` and reused (or reverse-complemented,
    ``"rc": true``) at the later ones."""
    parts = []
    for part in genome_spec["layout"]:
        name = part["seg"]
        if name not in made:
            made[name] = np.frombuffer(
                random_genome(rng, int(part["len"])).encode(), np.uint8)
        seg = made[name]
        parts.append(_COMP[seg[::-1]] if part.get("rc") else seg)
    return np.concatenate(parts)


def expand_genomes(traffic: dict) -> list:
    """The traffic file's genomes with each ``"chromosomes": n`` entry
    cut into n separate linear genomes of equal size, named
    ``<name>.<i>``."""
    out = []
    for g in traffic["genomes"]:
        n = int(g.get("chromosomes", 1))
        if n == 1:
            out.append(g)
            continue
        size = genome_size(g) // n
        for i in range(n):
            out.append(dict(g, name=f"{g['name']}.{i}", chromosomes=1,
                            layout=[{"seg": f"{g['name']}.{i}", "len": size}]))
    return out


def read_lengths(traffic: dict) -> list:
    """Read lengths per genome, the same for every seed: ceil(coverage x
    size / mean) reads each, lengths normal around the mean with the
    file's ``len_sd``, at least ``len_min``."""
    rng = np.random.default_rng(int(traffic["length_seed"]))
    mean, sd = int(traffic["read_len"]), int(traffic.get("len_sd", 0))
    lo = int(traffic.get("len_min", 1000))
    out = []
    for g in expand_genomes(traffic):
        size = genome_size(g)
        n = int(np.ceil(float(g["coverage"]) * size / mean))
        if sd:
            L = np.maximum(lo, np.rint(rng.normal(mean, sd, n))).astype(np.int64)
        else:
            L = np.full(n, mean, np.int64)
        if not g.get("circular", False):
            L = np.minimum(L, size)
        out.append(L)
    return out


def genome_size(g: dict) -> int:
    """Size of a genome from its layout (a repeated segment counts at
    each mention)."""
    seen: dict = {}
    total = 0
    for p in g["layout"]:
        if "len" in p:
            seen[p["seg"]] = int(p["len"])
        total += seen[p["seg"]]
    return total


def _inject(rng, a: np.ndarray, off: np.ndarray, rate: float, hp_frac: float):
    """``tests/genome_sim.py:inject_errors`` over a block of reads: ``a`` is the
    block's bases, ``off`` the [n+1] read offsets in it (no homopolymer
    run continues across reads).  Returns (out, per-read length
    change)."""
    n = len(a)
    n_reads = len(off) - 1
    if rate <= 0 or n == 0:
        return a, np.zeros(n_reads, np.int64)
    # Bernoulli(rate) per base, drawn as geometric gaps
    want = int(n * rate * 1.2) + 64
    pos = np.cumsum(rng.geometric(rate, size=want)) - 1
    while pos[-1] < n:
        pos = np.concatenate([pos, np.cumsum(rng.geometric(rate, size=want)) + pos[-1]])
    idx = pos[pos < n]
    ne = len(idx)
    if ne == 0:
        return a, np.zeros(n_reads, np.int64)
    is_hp = rng.random(ne) < hp_frac
    hp_i = idx[is_hp]
    dup = rng.random(len(hp_i)) < 0.5
    # a homopolymer error shortens its run when the left neighbour in
    # the same read continues it, else lengthens it
    first = np.isin(hp_i, off[:-1])
    left_same = np.zeros(len(hp_i), bool)
    nz = ~first
    left_same[nz] = a[hp_i[nz] - 1] == a[hp_i[nz]]
    hp_dup = dup | ~left_same
    ot_i = idx[~is_hp]
    kind = rng.integers(0, 3, size=len(ot_i))
    rnd1 = _NT[rng.integers(0, 4, size=len(ot_i))]
    out = a.copy()
    out[ot_i[kind == 0]] = rnd1[kind == 0]  # substitutions
    # insertions, at original coordinates: a homopolymer copy before its
    # base, a random base after its base (and before any copy of the next
    # base, as np.repeat would place them); each belongs to its base's read
    ins_pos = np.concatenate([ot_i[kind == 1] + 1, hp_i[hp_dup]])
    ins_val = np.concatenate([rnd1[kind == 1], a[hp_i[hp_dup]]])
    ins_base = np.concatenate([ot_i[kind == 1], hp_i[hp_dup]])
    order = np.argsort(ins_pos, kind="stable")
    ins_pos, ins_val, ins_base = ins_pos[order], ins_val[order], ins_base[order]
    dels = np.sort(np.concatenate([hp_i[~hp_dup], ot_i[kind == 2]]))
    out = np.insert(out, ins_pos, ins_val)
    out = np.delete(out, dels + np.searchsorted(ins_pos, dels, side="right"))
    read_of = lambda i: np.searchsorted(off, i, side="right") - 1  # noqa: E731
    change = (np.bincount(read_of(ins_base), minlength=n_reads)
              - np.bincount(read_of(dels), minlength=n_reads))
    return out, change


@dataclass
class Canonical:
    """The part of a sample that every seed shares: the genomes and the
    reads in the order they were made, as one flat array."""

    names: list
    genomes: list
    circular: list
    organelles: set
    flat: np.ndarray  # uint8, every read's bases one after another
    off: np.ndarray  # [n+1] int64 read offsets in ``flat``
    src: np.ndarray  # [n] int32
    start: np.ndarray  # [n] int64
    length: np.ndarray  # [n] int64 error-free length
    rev: np.ndarray  # [n] bool


def make_canonical(traffic: dict) -> Canonical:
    """Generate the genomes and reads of ``traffic`` (the same for every
    seed)."""
    rng = np.random.default_rng(int(traffic["content_seed"]))
    made: dict = {}
    genomes, circ = [], []
    specs = expand_genomes(traffic)
    for g in specs:
        genomes.append(_segments(rng, g, made))
        circ.append(bool(g.get("circular", False)))
    lengths = read_lengths(traffic)
    rate = float(traffic["err_rate"])
    hp_frac = float(traffic.get("hp_frac", 0.0))

    blocks, lens, srcs, starts, revs = [], [], [], [], []
    for gi, (G, L) in enumerate(zip(genomes, lengths)):
        n = len(L)
        size = len(G)
        if circ[gi]:
            st = rng.integers(0, size, size=n)
            gsrc = np.concatenate([G, G[: int(L.max())]])
        else:
            st = rng.integers(0, np.maximum(1, size - L))
            gsrc = G
        rv = rng.random(n) < 0.5
        # blocks of reads of about BLOCK_BASES bases
        cum = np.cumsum(L)
        bounds = np.unique(np.concatenate([
            [0], np.searchsorted(cum, np.arange(BLOCK_BASES, int(cum[-1]), BLOCK_BASES)), [n]]))
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            parts = []
            for i in range(lo, hi):
                seq = gsrc[st[i]:st[i] + L[i]]
                parts.append(_COMP[seq[::-1]] if rv[i] else seq)
            off = np.zeros(hi - lo + 1, np.int64)
            np.cumsum(L[lo:hi], out=off[1:])
            out, change = _inject(rng, np.concatenate(parts), off, rate, hp_frac)
            blocks.append(out)
            lens.append(L[lo:hi] + change)
        srcs.append(np.full(n, gi, np.int32))
        starts.append(st.astype(np.int64))
        revs.append(rv)
    lens = np.concatenate(lens)
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return Canonical(
        names=[g["name"] for g in specs], genomes=genomes, circular=circ,
        organelles={g["name"] for g in specs if g.get("organelle")},
        flat=np.concatenate(blocks), off=off, src=np.concatenate(srcs),
        start=np.concatenate(starts), length=np.concatenate(lengths), rev=np.concatenate(revs))


def arrange(canon: Canonical, seed: int) -> tuple[Sample, np.ndarray, np.ndarray]:
    """``seed``'s file order of the reads and which of them are written
    reverse-complemented.  Returns (Sample, order, flip): file read j is
    made read ``order[j]``, reverse-complemented where ``flip[j]``."""
    run = np.random.default_rng(int(seed))
    n = len(canon.off) - 1
    order = run.permutation(n)
    flip = run.random(n) < 0.5
    seq_len = np.diff(canon.off)[order]
    sample = Sample(
        names=canon.names, genomes=canon.genomes, circular=canon.circular,
        src=canon.src[order], start=canon.start[order], length=canon.length[order],
        rev=canon.rev[order] ^ flip, seq_len=seq_len, n_bases=int(seq_len.sum()),
        organelles=canon.organelles)
    return sample, order, flip


def iter_reads(canon: Canonical, order: np.ndarray, flip: np.ndarray):
    """The reads in file order, one ASCII array at a time."""
    flat, off = canon.flat, canon.off
    for i, f in zip(order.tolist(), flip.tolist()):
        r = flat[off[i]:off[i + 1]]
        yield _COMP[r[::-1]] if f else r


def make_sample(traffic: dict, seed: int) -> tuple[Sample, list]:
    """Generate the sample of ``traffic`` for ``seed``.  Returns the
    Sample and the reads as a list of ASCII arrays in file order."""
    canon = make_canonical(traffic)
    sample, order, flip = arrange(canon, seed)
    return sample, [np.array(r) for r in iter_reads(canon, order, flip)]


_CACHE_ARRAYS = ("off", "src", "start", "length", "rev")


def cache_key(traffic: dict) -> str:
    """The name of a traffic file's cache directory: a digest of its
    parameters, so an edited file never reads a stale sample."""
    return hashlib.sha256(json.dumps(traffic, sort_keys=True).encode()).hexdigest()[:24]


def cached_canonical(traffic: dict, cache_root: str) -> Canonical:
    """``make_canonical(traffic)``, made once and kept under
    ``cache_root/<cache_key>`` (reads and genomes as raw bytes, read back
    as memory maps); later calls read it from there."""
    d = os.path.join(cache_root, cache_key(traffic))
    if os.path.isdir(d):
        return _load(traffic, d)
    canon = make_canonical(traffic)
    part = d + ".part"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    canon.flat.tofile(os.path.join(part, "reads.u8"))
    goff = np.zeros(len(canon.genomes) + 1, np.int64)
    np.cumsum([len(g) for g in canon.genomes], out=goff[1:])
    np.concatenate(canon.genomes).tofile(os.path.join(part, "genomes.u8"))
    np.savez(os.path.join(part, "index.npz"), goff=goff,
             **{k: getattr(canon, k) for k in _CACHE_ARRAYS})
    try:
        os.rename(part, d)
    except OSError:  # another run kept it first
        shutil.rmtree(part, ignore_errors=True)
    return canon


def _bytes(path: str) -> np.ndarray:
    if os.path.getsize(path) == 0:
        return np.zeros(0, np.uint8)
    return np.memmap(path, np.uint8, mode="r")


def _load(traffic: dict, d: str) -> Canonical:
    specs = expand_genomes(traffic)
    with np.load(os.path.join(d, "index.npz")) as z:
        a = {k: z[k] for k in _CACHE_ARRAYS + ("goff",)}
    g = _bytes(os.path.join(d, "genomes.u8"))
    goff = a.pop("goff")
    return Canonical(
        names=[s["name"] for s in specs],
        genomes=[g[goff[i]:goff[i + 1]] for i in range(len(specs))],
        circular=[bool(s.get("circular", False)) for s in specs],
        organelles={s["name"] for s in specs if s.get("organelle")},
        flat=_bytes(os.path.join(d, "reads.u8")), **a)


def prepare(traffic: dict, seed: int, fasta: str, cache_root: str) -> Sample:
    """The sample of ``traffic`` for ``seed``, its reads written to
    ``fasta``; the seed-independent part comes from the cache under
    ``cache_root`` (made there on first use)."""
    canon = cached_canonical(traffic, cache_root)
    sample, order, flip = arrange(canon, seed)
    write_fasta(fasta, iter_reads(canon, order, flip))
    return sample


def write_fasta(path: str, reads) -> int:
    """One line per read (any iterable of ASCII arrays) under ``>r<i>``;
    returns the bytes written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = 0
    with open(path, "wb", buffering=1 << 24) as f:
        for i, r in enumerate(reads):
            h = b">r%d\n" % i
            f.write(h)
            f.write(memoryview(r))
            f.write(b"\n")
            n += len(h) + len(r) + 1
    return n


def read_fasta(path: str) -> tuple[np.ndarray, np.ndarray]:
    """The sequences of a one-line-per-read FASTA as one flat uint8
    array and [n+1] offsets (file order)."""
    data = np.fromfile(path, np.uint8)
    nl = np.flatnonzero(data == 10)
    # lines alternate header, sequence
    starts = nl[0::2] + 1
    ends = nl[1::2]
    off = np.zeros(len(starts) + 1, np.int64)
    np.cumsum(ends - starts, out=off[1:])
    flat = np.empty(int(off[-1]), np.uint8)
    for i, (a, b) in enumerate(zip(starts.tolist(), ends.tolist())):
        flat[off[i]:off[i + 1]] = data[a:b]
    return flat, off
