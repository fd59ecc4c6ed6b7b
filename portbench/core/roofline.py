"""The extraction chain's least time on the card, from its work.

The chain (homopolymer-compressed bases to selected syncmers: K3d's
decode, K1's selection, K4's compaction and hashes) has to read every
hoco base once, at 2 bits, with one 4-byte position for each N, and to
write every selected syncmer once: its position with the strand bit
(4 bytes) and its 64-bit hash (8 bytes).  Its operations are counted per
hoco position (both rolling s-mer codes, the canonical choice, the
s-mer's hash and the sliding minimum) and per selected syncmer (packing
its window and MurmurHash64A over it), in 64-bit integer operations,
each taken as two 32-bit ones.  The counts follow from the
configuration's k and s, not from how any kernel is written.  Peaks
are in ``portbench/peaks.json``."""
from __future__ import annotations

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "peaks.json")

# 64-bit integer operations per hoco position: the forward s-mer code
# (shift, or, mask: 3) and the reverse one (shift, xor, shift, or: 4),
# the canonical choice and strand (3), Thomas Wang's hash under the mask
# (23), the sliding minimum by block prefix and suffix minima (3), the
# tests of the window's first and last s-mer against it (2)
OPS_PER_POSITION = 38
# per selected syncmer: MurmurHash64A's 6 operations per 8-byte block of
# the packed window, and 3 (two shifts and an or) per 32 bases to cut the
# window out of the 2-bit codes
MURMUR_OPS_PER_BLOCK = 6
WINDOW_OPS_PER_WORD = 3


def peaks() -> dict:
    with open(_PEAKS) as f:
        return json.load(f)


def chain_bytes(n_hoco: int, n_n: int, n_sel: int) -> float:
    return n_hoco / 4.0 + 4.0 * n_n + 12.0 * n_sel


def chain_ops32(n_hoco: int, n_sel: int, k: int) -> float:
    """32-bit integer operations of the chain."""
    blocks = -(-((k + 3) // 4) // 8)
    per_sel = MURMUR_OPS_PER_BLOCK * blocks + WINDOW_OPS_PER_WORD * -(-k // 32)
    return 2.0 * (OPS_PER_POSITION * n_hoco + per_sel * n_sel)


def least_seconds(n_hoco: int, n_n: int, n_sel: int, k: int, card: str = "H100") -> tuple:
    """(least seconds, 'bytes' or 'operations') of one pass of the chain."""
    p = peaks()[card]
    tb = chain_bytes(n_hoco, n_n, n_sel) / p["hbm_bytes_per_s"]
    to = chain_ops32(n_hoco, n_sel, k) / p["int32_ops_per_s"]
    return (tb, "bytes") if tb >= to else (to, "operations")
