"""Sequential (host) closed-syncmer extraction — behavioral ground truth.

This is a direct sequential realization of the reference's per-base scan
semantics (reference syncmer.c:243-421): homopolymer compression,
rolling canonical s-mer hashing, closed-syncmer selection via a rolling
minimizer buffer of q = k - s + 1 s-mers (open syncmers at window
expiry, close syncmers on new-minimum insertion), same-position pair
removal, and Murmur k-mer identity hashing of the 2-bit packed canonical
window.

It exists to (a) validate the vectorized device kernel on arbitrary
inputs and (b) serve as a tiny-input fallback.  The production path is
:mod:`oatk_tpu.kernels.syncmer`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .hashes import MURMUR_SEED, hash64_np, murmur64_np

U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

# ASCII -> 2-bit code; ambiguous -> 4 (A/a=0 C/c=1 G/g=2 T/t=3 U/u=3)
SEQ_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    SEQ_NT4[ord(_c)] = _i
    SEQ_NT4[ord(_c.lower())] = _i
SEQ_NT4[ord("U")] = 3
SEQ_NT4[ord("u")] = 3


@dataclass
class ReadSyncmers:
    """Per-read extraction result (mirrors sr_t, reference syncmer.h:48-70)."""

    sid: int
    name: str
    hoco_l: int
    hoco_code: np.ndarray  # [hoco_l] uint8 base codes 0..3 (ambiguous -> 0)
    ho_rl: np.ndarray  # [hoco_l] run length MINUS ONE (reference sr_t
    # ho_rl semantics, reference syncmer.h:56).  Oracle/jnp paths
    # store exact uint32 values; the native loader stores uint8
    # saturated at 255 with exact entries in ReadDB.rl_ovf_*
    is_n: np.ndarray  # [hoco_l] bool, ambiguous base positions
    m_pos: np.ndarray  # [n] uint32: hoco_pos << 1 | rev
    s_mer: np.ndarray  # [n] uint64: smer payload (code<<1 | flag bit)
    k_mer: np.ndarray  # [n] uint64: initially kmer hash; later syncmer id<<1|ec

    @property
    def n(self) -> int:
        return len(self.m_pos)


def hoco_compress_np(seq_ascii: np.ndarray):
    """Vectorized homopolymer compression of an ASCII read.

    Returns (hoco_code, ho_rl, is_n).  Ambiguous bases are kept
    uncompressed (one hoco position each, code 0); runs of an identical
    valid base collapse to one position; ho_rl holds run length MINUS
    ONE (exact uint32 -- the reference's sr_t stores the same quantity
    as u8 with an overflow list, reference syncmer.h:56).
    """
    c = SEQ_NT4[seq_ascii]
    L = len(c)
    if L == 0:
        e = np.zeros(0, dtype=np.uint8)
        return e, np.zeros(0, np.uint32), np.zeros(0, bool)
    prev = np.empty(L, dtype=np.uint8)
    prev[0] = 255
    prev[1:] = c[:-1]
    keep = (c == 4) | (prev == 4) | (c != prev)
    keep[0] = True
    idx = np.flatnonzero(keep)
    nxt = np.empty(len(idx), dtype=np.int64)
    nxt[:-1] = idx[1:]
    nxt[-1] = L
    ho_rl = (nxt - idx - 1).astype(np.uint32)
    code = c[idx]
    is_n = code == 4
    code = np.where(is_n, 0, code).astype(np.uint8)
    return code, ho_rl, is_n


def pack_hoco(code: np.ndarray) -> np.ndarray:
    """2-bit pack hoco codes, 4 bases/byte, first base in bits 7-6."""
    L = len(code)
    pad = (-L) % 4
    c = np.concatenate([code, np.zeros(pad, np.uint8)])
    c = c.reshape(-1, 4)
    return (c[:, 0] << 6 | c[:, 1] << 4 | c[:, 2] << 2 | c[:, 3]).astype(np.uint8)


def kmer_packed_bytes(code: np.ndarray, is_n_unused, pos: int, w: int, rev: int) -> np.ndarray:
    """2-bit packed canonical window bytes for Murmur hashing.

    Equivalent to extracting [pos, pos+w) from the packed hoco sequence,
    reverse-complementing if rev, and repacking aligned to byte 0
    (reference syncmer.c:173-226).
    """
    win = code[pos : pos + w].astype(np.uint8)
    if rev:
        win = (3 - win)[::-1]
    return pack_hoco(win)


def kmer_hash(code: np.ndarray, pos: int, w: int, rev: int) -> np.uint64:
    b = kmer_packed_bytes(code, None, pos, w, rev)
    return murmur64_np(b.tobytes(), MURMUR_SEED)


def syncmers_of_read_oracle(
    seq_ascii: np.ndarray, w: int, s: int, sid: int = 0, name: str = ""
) -> ReadSyncmers:
    """Sequential closed-syncmer scan.  w = k-mer size (hoco bases), s = s-mer size."""
    assert 0 < s < 32 and w > s
    code, ho_rl, is_n = hoco_compress_np(seq_ascii)
    Lh = len(code)
    q = w - s + 1
    mask = np.uint64((1 << (2 * s)) - 1)
    shift1 = np.uint64(2 * (s - 1))

    # rolling canonical smer per hoco position (ending position semantics)
    buf_m = np.full(q, U64MAX, dtype=np.uint64)
    buf_s = np.full(q, U64MAX, dtype=np.uint64)
    mz = U64MAX
    mz_pos = 0
    buf_pos = 0
    l = 0
    fwd = np.uint64(0)
    rev_ = np.uint64(0)

    m_pos: list[int] = []
    s_mer: list[int] = []

    def push(pos: int, z: int, smer_val: np.uint64) -> None:
        m_pos.append(pos << 1 | z)
        s_mer.append(int(smer_val))

    def pop_pair_if_dup() -> None:
        if len(m_pos) >= 2 and (m_pos[-1] >> 1) == (m_pos[-2] >> 1):
            del m_pos[-2:]
            del s_mer[-2:]

    for h in range(Lh):
        m = U64MAX
        smer = U64MAX
        if not is_n[h]:
            c = np.uint64(code[h])
            l += 1
            with np.errstate(over="ignore"):
                fwd = ((fwd << np.uint64(2)) | c) & mask
                rev_ = (rev_ >> np.uint64(2)) | ((np.uint64(3) ^ c) << shift1)
            if fwd != rev_ and l >= s:
                z = 0 if fwd < rev_ else 1
                m = hash64_np(np.array([fwd if z == 0 else rev_], np.uint64), mask)[0]
                smer = np.uint64((int(fwd if z == 0 else rev_) << 1) | z)
        else:
            l = 0

        # open syncmer: expiring slot holds the (oldest-attaining) minimum
        if buf_pos == mz_pos and mz != U64MAX and l > w:
            z = int(buf_s[buf_pos]) & 1
            push(h - w, z, buf_s[buf_pos])
            pop_pair_if_dup()

        buf_m[buf_pos] = m
        buf_s[buf_pos] = smer
        if m <= mz and m != U64MAX:
            if l >= w:
                z = int(smer) & 1
                push(h - w + 1, z, np.uint64(int(smer) ^ 1))
            if m < mz:
                mz = m
                mz_pos = buf_pos
        if m >= mz and buf_pos == mz_pos:
            neq = m != mz
            # recompute minimum, oldest slot first
            mz = U64MAX
            for j in list(range(buf_pos + 1, q)) + list(range(buf_pos + 1)):
                if mz > buf_m[j]:
                    mz = buf_m[j]
                    mz_pos = j
            nxt = buf_pos + 1 if buf_pos + 1 < q else 0
            if (
                neq
                and ((mz_pos == nxt and mz == m) or mz_pos == buf_pos)
                and mz != U64MAX
                and l >= w
            ):
                z = int(smer) & 1
                push(h - w + 1, z, np.uint64(int(smer) ^ 1))
        buf_pos = buf_pos + 1 if buf_pos + 1 < q else 0

    # final open syncmer at read end
    if buf_pos == mz_pos and mz != U64MAX and l >= w:
        z = int(buf_s[buf_pos]) & 1
        push(Lh - w, z, buf_s[buf_pos])
        pop_pair_if_dup()

    m_pos_a = np.asarray(m_pos, dtype=np.uint32)
    s_mer_a = np.asarray(s_mer, dtype=np.uint64)
    k_mer_a = np.array(
        [kmer_hash(code, int(p) >> 1, w, int(p) & 1) for p in m_pos_a], dtype=np.uint64
    )
    return ReadSyncmers(sid, name, Lh, code, ho_rl, is_n, m_pos_a, s_mer_a, k_mer_a)
