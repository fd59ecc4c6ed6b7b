"""Plain banded LV89 wavefront: the yardstick that the port's wavefront
kernel (K2, error correction's device route) is held to, item by item.

Written anew from the kernel's stated contract (the port's
``csrc/wf_ed.cu`` header and the ``kernels/wf_ed.py`` docstring), in
NumPy int64 with no loop over positions inside a diagonal's run.  An
item is one alignment state:

- in: ``meta`` = (tl, ql, is_ext, bw, score, d0, n, 0), the wave ``k[:n]``
  of diagonals d0 .. d0 + n - 1 (d = query position - target position,
  k = target position, -1 before the first base), the target ``ts[:tl]``
  and query ``qs[:ql]`` (bytes), and the item's width S;
- out: ``out_meta`` = (score, d0, n, hit, t_end_raw, q_end_raw, err, 0)
  and ``out_k[:n]``, the new wave; ``out_k`` holds -BIG past n.

A step:

1. each diagonal whose k is below tl and whose k + d is below ql runs
   along exact matches: the last k' such that every target position
   k + 1 .. k' matches its query position, where a target position past
   min(ql - d, tl) - 1 or a negative query position counts as a
   mismatch; the others keep k;
2. a diagonal ends the alignment when its run reaches the query's last
   base or the target's last (``is_ext``), or both (not ``is_ext``).
   The lowest such diagonal j is the hit: diagonals below it take their
   runs, the rest keep the wave they came in with, and the item stops
   with t_end_raw = run end and q_end_raw = run end + d0 + j;
3. otherwise the n + 2 diagonals d0 - 1 .. d0 + n each take the largest
   of an insertion (the run of diagonal i - 2), a mismatch (i - 1, + 1)
   and a deletion (i, + 1), from -BIG where none exists; then the band:
   while the wave is narrower than 2 bw + 1 (or bw < 0) it may span
   [-tl, ql], else [max(mdb, -tl), max(xdb, ql)] with (mdb, xdb) =
   (-bw, bw) when extending and (-(|tl - ql| + bw), |tl - ql| + bw)
   when not (the reference implementation's max_d = max(xdb, ql) kept as
   it is); the diagonals outside are cut
   from both ends; score + 1; the item stops once bw >= 0 and
   score > bw, with the new wave unextended.

err is 1 when the input does not fit (n outside [1, S], tl or ql
negative or above the widths TL, QL the buffer gives them) and 2 when a
new wave would hold no diagonal or more than S; ``out_k`` is then all
-BIG and ``out_meta`` keeps the score, d0 and n of the step it stopped
at, hit 0 and ends -1.

Departures from the description: none in the results.  The wave is
int64 here and int32 in the kernel; every value stays within
[-BIG, tl + 1], so both read the same numbers.

The round buffer (``decode_round``): one int32 array that starts with B
descriptors of 12 words, per item ts offset and qs offset (bytes), meta,
k, out_meta, out_k and scratch offsets (words; scratch -1 on the
shared-memory route), S, TL, QL and two spare words; every offset is
into the same input array, or into the round's output array for
out_meta and out_k.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

BIG = 0x3FFFFFFF
DESC_WORDS = 12
_MAX_CHUNK = 4096


def _runs(ts: np.ndarray, qs: np.ndarray, tl: int, ql: int, d: np.ndarray,
          k: np.ndarray) -> np.ndarray:
    """The end of each diagonal's run of exact matches from target
    position k + 1 on: compared a chunk of positions at a time, the
    chunk doubling for the diagonals still running."""
    end = k.copy()
    last = np.minimum(ql - d, tl) - 1  # the last target position a run may take
    todo = np.arange(len(k))
    nxt = k + 1  # the next target position to compare, per diagonal
    width = 16
    while todo.size:
        p = nxt[todo, None] + np.arange(width)[None, :]
        q = p + d[todo, None]
        inside = (p >= 0) & (p <= last[todo, None]) & (q >= 0)
        same = inside & (ts[np.clip(p, 0, max(tl - 1, 0))] == qs[np.clip(q, 0, max(ql - 1, 0))]) \
            if tl and ql else np.zeros_like(inside)
        stop = ~same
        done = stop.any(axis=1)
        first = stop.argmax(axis=1)
        end[todo[done]] = nxt[todo[done]] + first[done] - 1
        nxt[todo] += width
        todo = todo[~done]
        width = min(2 * width, _MAX_CHUNK)
    return end


def _bounds(tl: int, ql: int, is_ext: int, bw: int, n_old: int) -> tuple[int, int]:
    """The band's lowest and highest diagonal for the wave that follows a
    wave of ``n_old`` diagonals."""
    if bw < 0 or n_old < 2 * bw + 1:
        return -tl, ql
    half = bw if is_ext else abs(tl - ql) + bw
    return max(-half, -tl), max(half, ql)


def align(ts, qs, meta, k, S: int, TL: int | None = None, QL: int | None = None):
    """One item: ``(out_meta[8], out_k[S])`` as int64 arrays.  ``TL`` and
    ``QL`` are the widths the buffer gives ts and qs (default: their
    lengths)."""
    tl, ql, is_ext, bw, score, d0, n = (int(x) for x in meta[:7])
    TL = len(ts) if TL is None else TL
    QL = len(qs) if QL is None else QL
    out_k = np.full(S, -BIG, np.int64)
    if not (1 <= n <= S) or tl < 0 or ql < 0 or tl > TL or ql > QL:
        return np.array([score, d0, n, 0, -1, -1, 1, 0], np.int64), out_k
    ts = np.asarray(ts[:tl], np.int64)
    qs = np.asarray(qs[:ql], np.int64)
    wave = np.asarray(k[:n], np.int64).copy()
    while True:
        d = d0 + np.arange(n)
        runs = wave.copy()
        go = (wave < tl) & (wave + d < ql)
        if go.any():
            runs[go] = _runs(ts, qs, tl, ql, d[go], wave[go])
        at_q = runs + d == ql - 1
        at_t = runs == tl - 1
        ends = go & ((at_q | at_t) if is_ext else (at_q & at_t))
        if ends.any():
            j = int(np.argmax(ends))
            wave[:j] = runs[:j]
            out_k[:n] = wave
            t_end = int(runs[j])
            return np.array([score, d0, n, 1, t_end, t_end + d0 + j, 0, 0], np.int64), out_k
        nxt = np.full(n + 2, -BIG, np.int64)
        nxt[2:] = runs  # insertion: diagonal i - 2
        np.maximum(nxt[1:n + 1], runs + 1, out=nxt[1:n + 1])  # mismatch
        np.maximum(nxt[:n], runs + 1, out=nxt[:n])  # deletion
        lo, hi = _bounds(tl, ql, is_ext, bw, n)
        first = d0 - 1
        cut_lo = min(max(lo - first, 0), n + 2)
        cut_hi = min(max(first + n + 1 - hi, 0), n + 2)
        n_new = n + 2 - cut_lo - cut_hi
        if n_new < 1 or n_new > S:
            return np.array([score, d0, n, 0, -1, -1, 2, 0], np.int64), out_k
        wave = nxt[cut_lo:cut_lo + n_new]
        n, d0, score = n_new, first + cut_lo, score + 1
        if bw >= 0 and score > bw:
            out_k[:n] = wave
            return np.array([score, d0, n, 0, -1, -1, 0, 0], np.int64), out_k


class Item(NamedTuple):
    """One item of a round buffer, as its descriptor places it."""

    ts: np.ndarray
    qs: np.ndarray
    meta: np.ndarray
    k: np.ndarray
    S: int
    TL: int
    QL: int
    out_meta_off: int
    out_k_off: int


def n_items(inp: np.ndarray) -> int:
    """B of a round buffer: its first descriptor's meta offset is 12 B."""
    return int(inp[2]) // DESC_WORDS


def decode_round(inp: np.ndarray, B: int | None = None) -> list:
    """The items of a round's input words (int32)."""
    inp = np.ascontiguousarray(inp, np.int32)
    B = n_items(inp) if B is None else B
    byt = inp.view(np.uint8)
    desc = inp[:B * DESC_WORDS].reshape(B, DESC_WORDS).astype(np.int64)
    items = []
    for ts0, qs0, m0, k0, om0, ok0, _scr, S, TL, QL, _a, _b in desc.tolist():
        meta = inp[m0:m0 + 8].astype(np.int64)
        tl, ql, n = (int(x) for x in meta[[0, 1, 6]])
        items.append(Item(byt[ts0:ts0 + max(min(tl, TL), 0)], byt[qs0:qs0 + max(min(ql, QL), 0)],
                          meta, inp[k0:k0 + max(min(n, S), 0)].astype(np.int64), S, TL, QL,
                          om0, ok0))
    return items


def outputs(out: np.ndarray, item: Item) -> tuple[np.ndarray, np.ndarray]:
    """(out_meta[8], out_k[S]) of ``item`` in a round's output words."""
    return (np.asarray(out[item.out_meta_off:item.out_meta_off + 8], np.int64),
            np.asarray(out[item.out_k_off:item.out_k_off + item.S], np.int64))


def compare(item: Item, out: np.ndarray) -> bool:
    """Whether the round's output for ``item`` equals the reference's:
    every word of out_meta and ``out_k[:n]``."""
    want_m, want_k = align(item.ts, item.qs, item.meta, item.k, item.S, item.TL, item.QL)
    got_m, got_k = outputs(out, item)
    n = min(max(int(want_m[2]), 0), item.S)
    return np.array_equal(got_m, want_m) and np.array_equal(got_k[:n], want_k[:n])
