"""The wavefront kernel's (K2's) least time on the card, from its work.

Error correction's device route counts, in the split of its rounds
(``kernels/wf_ed.py:wf_ed_lockstep``), what the kernel had to do, from
each item's meta in and out_meta alone (any kernel that keeps the
contract reads the same counts):

- ``seq_bytes``: the target and query bases of every item, tl + ql, one
  byte each, read once;
- ``wave_in`` and ``wave_out``: the diagonals of the waves in and out,
  4 bytes each, read once and written once;
- ``items``: 32 bytes of meta in and 32 of out_meta an item, 64 in all;
- ``wave_cells``: the cells of the waves the kernel stepped through,
  (score out - score in) x (n in + n out) / 2 summed over the items.

Bytes: seq_bytes + 4 (wave_in + wave_out) + 64 items.  Operations: 4
32-bit integer operations a wave cell (a diagonal of the next wave takes
the largest of three candidates: two additions and two maxima), over the
32-bit integer rate.  The least time is the larger of bytes over HBM bandwidth
and operations over that rate (peaks in ``portbench/peaks.json``).

A lower bound: the extension's base compares along each diagonal, which
depend on where the sequences differ and are not read from the metas,
are left out, and so are the descriptors, the padding and the cells of a
wave that hits before it steps."""
from __future__ import annotations

from . import roofline

META_BYTES = 64
OPS_PER_CELL = 4


def k2_bytes(seq_bytes: float, wave_in: float, wave_out: float, items: float) -> float:
    return seq_bytes + 4.0 * (wave_in + wave_out) + META_BYTES * items


def k2_ops32(wave_cells: float) -> float:
    return OPS_PER_CELL * wave_cells


def least_seconds(seq_bytes: float, wave_in: float, wave_out: float, items: float,
                  wave_cells: float, card: str = "H100") -> tuple:
    """(least seconds, 'bytes' or 'operations') of the counted work."""
    p = roofline.peaks()[card]
    tb = k2_bytes(seq_bytes, wave_in, wave_out, items) / p["hbm_bytes_per_s"]
    to = k2_ops32(wave_cells) / p["int32_ops_per_s"]
    return (tb, "bytes") if tb >= to else (to, "operations")


def least_seconds_of(split: dict, card: str = "H100") -> tuple:
    """:func:`least_seconds` of one EC run's split."""
    return least_seconds(split["seq_bytes"], split["wave_in"], split["wave_out"],
                         sum(split["items"]), split["wave_cells"], card)
