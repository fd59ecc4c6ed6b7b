"""Plain closed-syncmer extraction in PyTorch: the yardstick that the
port's extraction chain (homopolymer compression, K3d -> K1 -> K4) and
its device count are held to.

It follows the reference's sequential scan (oatk's syncmer.c, as
described in the port's docstrings) in whole-array operations, written
anew from that description:

- homopolymer compression: a run of one base becomes one position; a
  base other than A, C, G, T (an N) is never compressed and breaks every
  s-mer and k-mer that holds it;
- each s-mer (s hoco bases, ending at a position) is the smaller of its
  2-bit forward and reverse-complement codes, ``z`` = 1 where the reverse
  one is smaller, hashed by Thomas Wang's 64-bit mix under a 2s-bit mask;
- a k-mer of w hoco bases holds q = w - s + 1 s-mers; it is a closed
  syncmer when the least hash of its s-mers lies at its first s-mer
  (open) or at its last (closed), and not at both (the scan reports both
  and then drops the pair).  An open syncmer right before an N is not
  reported (the scan looks at it on the N's step, where the run has
  ended);
- a syncmer is recorded at its start, ``pos << 1 | z`` with the ``z`` of
  the minimal s-mer, and identified by MurmurHash64A (seed 1234) of its
  window, 2-bit packed, first base in the high bits, reverse-complemented
  when ``z`` is 1.

Where a window's least hash is reached at more than one s-mer (the same
canonical s-mer twice within one window), the scan's order of events
decides; such windows are counted in ``ties`` and reported, never
guessed at.  Every tensor is int64 (64-bit values as bit patterns; the
logical right shift is masked by hand).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MURMUR_SEED = 1234
_M = -4132994306676758123  # 0xC6A4A7935BD1E995 as a signed 64-bit value
_R = 47
_BIG = (1 << 63) - 1  # an s-mer that cannot be a minimum

# ASCII -> 2-bit code, 4 for anything else
NT4 = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    NT4[_c] = _i
    NT4[_c + 32] = _i
NT4[ord("U")] = NT4[ord("u")] = 3


def srl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def wang_hash(key: torch.Tensor, mask: int) -> torch.Tensor:
    """Thomas Wang's invertible 64-bit mix under ``mask`` (the values
    stay below 2**62 for s <= 31, so every shift sees a non-negative
    number)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def murmur64a(data: torch.Tensor) -> torch.Tensor:
    """MurmurHash64A (seed 1234) of each row of ``data`` ([n, nbytes]
    uint8)."""
    n, nb = data.shape
    d = data.to(torch.int64)
    h = torch.full((n,), MURMUR_SEED ^ _wrap(nb * (_M & ((1 << 64) - 1))), dtype=torch.int64,
                   device=data.device)
    nblk = nb >> 3
    for b in range(nblk):
        k = torch.zeros(n, dtype=torch.int64, device=data.device)
        for j in range(8):
            k = k | (d[:, 8 * b + j] << (8 * j))
        k = k * _M
        k = k ^ srl(k, _R)
        k = k * _M
        h = (h ^ k) * _M
    if nb & 7:
        t = torch.zeros(n, dtype=torch.int64, device=data.device)
        for j in range(nb & 7):
            t = t | (d[:, 8 * nblk + j] << (8 * j))
        h = (h ^ t) * _M
    h = h ^ srl(h, _R)
    h = h * _M
    h = h ^ srl(h, _R)
    return h


def _wrap(x: int) -> int:
    """An integer as a signed 64-bit value."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


def hoco(seq: torch.Tensor, off: torch.Tensor):
    """Homopolymer compression of reads given as one flat ASCII tensor
    and [n+1] offsets.  Returns (codes with N as 4, [n+1] offsets)."""
    dev = seq.device
    c = torch.from_numpy(NT4).to(dev)[seq.long()]
    first = torch.zeros(len(c), dtype=torch.bool, device=dev)
    first[off[:-1][off[:-1] < len(c)]] = True
    keep = first.clone()
    keep[1:] |= (c[1:] != c[:-1]) | (c[1:] == 4) | (c[:-1] == 4)
    rid = torch.repeat_interleave(torch.arange(len(off) - 1, device=dev), off[1:] - off[:-1])
    kept = rid[keep]
    hoff = torch.zeros(len(off), dtype=torch.int64, device=dev)
    hoff[1:] = torch.cumsum(torch.bincount(kept, minlength=len(off) - 1), 0)
    return c[keep], hoff


def _window_min(x: torch.Tensor, q: int) -> torch.Tensor:
    """min(x[i : i + q]) for every i with i + q <= len(x) (van Herk /
    Gil-Werman: block prefix and suffix minima)."""
    n = len(x)
    nb = -(-n // q)
    pad = torch.full((nb * q - n,), _BIG, dtype=x.dtype, device=x.device)
    xb = torch.cat([x, pad]).view(nb, q)
    pre = torch.cummin(xb, 1).values.reshape(-1)
    suf = torch.cummin(xb.flip(1), 1).values.flip(1).reshape(-1)
    m = n - q + 1
    if m <= 0:
        return x[:0]
    return torch.minimum(suf[:m], pre[q - 1:q - 1 + m])


@dataclass
class Selected:
    """Closed syncmers of a batch of reads, in read and position order."""

    read: torch.Tensor  # int64 read index (within the batch)
    mpos: torch.Tensor  # int64 hoco position << 1 | z
    khash: torch.Tensor  # int64 MurmurHash64A bit pattern
    ties: int  # windows whose least hash is reached more than once


def select(codes: torch.Tensor, hoff: torch.Tensor, w: int, s: int,
           hash_bits: int = 64, hash_batch: int = 1 << 17) -> Selected:
    """Closed syncmers of hoco reads (``codes`` flat, ``hoff`` offsets).

    ``hash_bits`` below 64 keeps only the low bits of each s-mer hash when
    choosing minima: the benchmark's control, a selection computed at a
    lower precision than the configuration states."""
    dev = codes.device
    n = len(codes)
    n_reads = len(hoff) - 1
    rid = torch.repeat_interleave(torch.arange(n_reads, device=dev), hoff[1:] - hoff[:-1])
    local = torch.arange(n, device=dev) - hoff[:-1][rid]
    isn = codes == 4
    c = torch.where(isn, torch.zeros_like(codes), codes).to(torch.int64)
    mask = (1 << (2 * s)) - 1
    # s-mer ending at each position: forward and reverse-complement codes
    fwd = torch.zeros(n, dtype=torch.int64, device=dev)
    rev = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(s):
        sh = s - 1 - j  # base at position e - sh
        cj = torch.zeros(n, dtype=torch.int64, device=dev)
        cj[sh:] = c[: n - sh] if sh else c
        fwd = (fwd << 2) | cj
        rev = rev | ((3 - cj) << (2 * j))
    # non-N hoco bases in a row ending at each position, within the read
    idx = torch.arange(n, device=dev)
    last_n = torch.cummax(torch.where(isn, idx, torch.full_like(idx, -1)), 0).values
    run = idx - torch.maximum(last_n, hoff[:-1][rid] - 1)
    smer_ok = (run >= s) & (fwd != rev)
    z = (rev < fwd).to(torch.int64)
    canon = torch.minimum(fwd, rev)
    hval = wang_hash(canon, mask)
    if hash_bits < 64:
        hval = hval & ((1 << hash_bits) - 1)
    hval = torch.where(smer_ok, hval, torch.full_like(hval, _BIG))
    q = w - s + 1
    # k-mer p covers s-mers ending at p+s-1 .. p+w-1
    m = n - w + 1
    if m <= 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return Selected(e, e, e, 0)
    M = _window_min(hval, q)[s - 1:s - 1 + m]
    first_h = hval[s - 1:s - 1 + m]
    last_h = hval[w - 1:w - 1 + m]
    p = torch.arange(m, device=dev)
    kvalid = (run[w - 1:w - 1 + m] >= w) & (M != _BIG)
    is_open = kvalid & (first_h == M)
    is_close = kvalid & (last_h == M)
    # the open check happens on the step after the k-mer, which an N ends
    nxt = p + w
    at_end = local[:m] + w == (hoff[1:] - hoff[:-1])[rid[:m]]
    nxt_n = isn[torch.clamp(nxt, max=n - 1)] & ~at_end
    open_seen = is_open & ~nxt_n
    sel_open = open_seen & ~is_close
    sel_close = is_close & ~open_seen
    # ties: the minimum reached inside the window too, or at both ends
    ties = 0
    if q > 2:
        inner = _window_min(hval, q - 2)[s:s + m]
        ties = int((kvalid & (inner == M) & (is_open | is_close)).sum())
    sel = sel_open | sel_close
    ps = p[sel]
    zsel = torch.where(sel_open[sel], z[ps + s - 1], z[ps + w - 1])
    hashes = torch.empty(len(ps), dtype=torch.int64, device=dev)
    ar = torch.arange(w, device=dev)
    for b0 in range(0, len(ps), hash_batch):
        pb, zb = ps[b0:b0 + hash_batch], zsel[b0:b0 + hash_batch]
        win = c[pb[:, None] + ar[None, :]]
        rc = (3 - win).flip(1)
        win = torch.where(zb[:, None] == 1, rc, win)
        pad = (-w) % 4
        if pad:
            win = torch.cat([win, torch.zeros(len(pb), pad, dtype=win.dtype, device=dev)], 1)
        win = win.view(len(pb), -1, 4)
        packed = (win[:, :, 0] << 6) | (win[:, :, 1] << 4) | (win[:, :, 2] << 2) | win[:, :, 3]
        hashes[b0:b0 + hash_batch] = murmur64a(packed.to(torch.uint8))
    return Selected(rid[ps], (local[ps] << 1) | zsel, hashes, ties)


def extract(seq: np.ndarray, off: np.ndarray, w: int, s: int, device="cpu",
            block_bases: int = 1 << 26, hash_bits: int = 64):
    """Closed syncmers of every read (ASCII ``seq`` flat, ``off`` [n+1]),
    in blocks of whole reads of about ``block_bases`` bases.  Returns
    numpy arrays (read, mpos, khash as uint64), the ties, the hoco length
    of every read and the number of N positions."""
    n_reads = len(off) - 1
    reads, mposs, hashes, hlen = [], [], [], np.zeros(n_reads, np.int64)
    ties = n_n = 0
    lo = 0
    cum = np.asarray(off, np.int64)
    while lo < n_reads:
        hi = int(np.searchsorted(cum, cum[lo] + block_bases, side="right")) - 1
        hi = max(hi, lo + 1)
        hi = min(hi, n_reads)
        sq = torch.from_numpy(np.array(seq[cum[lo]:cum[hi]])).to(device)
        o = torch.from_numpy(cum[lo:hi + 1] - cum[lo]).to(device)
        codes, hoff = hoco(sq, o)
        n_n += int((codes == 4).sum())
        r = select(codes, hoff, w, s, hash_bits=hash_bits)
        hlen[lo:hi] = (hoff[1:] - hoff[:-1]).cpu().numpy()
        reads.append(r.read.cpu().numpy() + lo)
        mposs.append(r.mpos.cpu().numpy())
        hashes.append(r.khash.cpu().numpy().view(np.uint64))
        ties += r.ties
        lo = hi
    cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
    return (cat(reads, np.int64), cat(mposs, np.int64), cat(hashes, np.uint64), ties, hlen,
            n_n)
