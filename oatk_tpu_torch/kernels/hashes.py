"""Hash primitives (numpy / pure-python variants).

The s-mer hash is Thomas Wang's invertible 64-bit mix constrained to a
2s-bit mask; the k-mer identity hash is MurmurHash64A with seed 1234 over
the 2-bit-packed canonical k-mer window.  Bit-for-bit parity with the
reference (syncmer.c:116-170) is required because syncmer
ids downstream derive from the sort order of these hashes.
"""
from __future__ import annotations

import numpy as np

MURMUR_SEED = np.uint64(1234)
_MURMUR_M = np.uint64(0xC6A4A7935BD1E995)
_MURMUR_R = np.uint64(47)

U64 = np.uint64
_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)

# numpy >= 2 keeps uint64 wraparound but warns; silence locally
_err = np.errstate(over="ignore")


def hash64_np(key: np.ndarray, mask: np.uint64) -> np.ndarray:
    """Invertible 64-bit integer finalizer under a bit mask (vectorized)."""
    key = key.astype(np.uint64)
    with np.errstate(over="ignore"):
        key = (~key + (key << U64(21))) & mask
        key = key ^ (key >> U64(24))
        key = (key + (key << U64(3)) + (key << U64(8))) & mask  # * 265
        key = key ^ (key >> U64(14))
        key = (key + (key << U64(2)) + (key << U64(4))) & mask  # * 21
        key = key ^ (key >> U64(28))
        key = (key + (key << U64(31))) & mask
    return key


def murmur64_np(data: bytes | np.ndarray, seed: np.uint64 = MURMUR_SEED) -> np.uint64:
    """MurmurHash64A over a byte buffer (scalar, host oracle path)."""
    if isinstance(data, np.ndarray):
        data = data.astype(np.uint8).tobytes()
    n = len(data)
    with np.errstate(over="ignore"):
        h = U64(seed) ^ (U64(n) * _MURMUR_M)
        nblk = n >> 3
        if nblk:
            blocks = np.frombuffer(data[: nblk * 8], dtype="<u8")
            for k in blocks:
                k = U64(k) * _MURMUR_M
                k ^= k >> _MURMUR_R
                k = k * _MURMUR_M
                h ^= k
                h = h * _MURMUR_M
        tail = data[nblk * 8 :]
        if tail:
            t = U64(0)
            for i in range(len(tail) - 1, -1, -1):
                t = (t << U64(8)) | U64(tail[i])
            h ^= t
            h = h * _MURMUR_M
        h ^= h >> _MURMUR_R
        h = h * _MURMUR_M
        h ^= h >> _MURMUR_R
    return h


def murmur64_blocks_np(blocks: np.ndarray, n_bytes: int, seed: np.uint64 = MURMUR_SEED) -> np.ndarray:
    """Vectorized MurmurHash64A over rows of little-endian u64 blocks.

    ``blocks``: [N, nblk] uint64 where the byte stream of each row is the
    LE concatenation of its blocks, truncated to ``n_bytes``.  Tail bytes
    (n_bytes % 8) must live in the low bytes of the final partial block,
    with the unused high bytes zero.
    """
    n_full = n_bytes >> 3
    n_tail = n_bytes & 7
    with np.errstate(over="ignore"):
        h = np.full(blocks.shape[0], U64(seed) ^ (U64(n_bytes) * _MURMUR_M), dtype=np.uint64)
        for i in range(n_full):
            k = blocks[:, i] * _MURMUR_M
            k ^= k >> _MURMUR_R
            k = k * _MURMUR_M
            h ^= k
            h = h * _MURMUR_M
        if n_tail:
            h ^= blocks[:, n_full]
            h = h * _MURMUR_M
        h ^= h >> _MURMUR_R
        h = h * _MURMUR_M
        h ^= h >> _MURMUR_R
    return h
