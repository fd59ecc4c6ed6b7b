"""Unsigned 64-bit values held as int64 bit patterns.

The JAX package computes hashes, s-mer payloads, sort keys and pair
keys in ``uint64``.  PyTorch's ``torch.uint64`` lacks the operations the
port needs (``>>``, ``<``, sorting and ``searchsorted`` raise
``NotImplementedError`` on the CPU build), so the port keeps every such
value in an ``int64`` tensor with the same 64 bits and does the
unsigned work here:

- ``+``, ``*``, ``^``, ``&``, ``|`` and ``<<`` on int64 wrap exactly as
  uint64 does (two's complement);
- ``>>`` on int64 is arithmetic, so :func:`srl` masks off the sign
  fill;
- comparisons and sorts go through :func:`ukey`, which flips the sign
  bit so signed order equals unsigned order.
"""
from __future__ import annotations

import numpy as np
import torch

SIGN = -(1 << 63)  # int64 bit pattern of 0x8000000000000000


def as_i64(v: int) -> int:
    """A Python int in [0, 2^64) as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by a constant k."""
    if k == 0:
        return x
    if not 0 < k < 64:
        raise ValueError(f"shift {k} out of range")
    return (x >> k) & ((1 << (64 - k)) - 1)


def ukey(x: torch.Tensor) -> torch.Tensor:
    """Signed int64 whose order is the unsigned order of x (an
    involution: ``ukey(ukey(x)) == x``)."""
    return x ^ SIGN


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b."""
    return ukey(a) < ukey(b)


def ule(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a <= b."""
    return ukey(a) <= ukey(b)


def to_numpy_u64(x: torch.Tensor) -> np.ndarray:
    """int64 bit patterns -> numpy uint64 (copied to the host)."""
    return x.detach().cpu().numpy().view(np.uint64)


def from_numpy_u64(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint64 (or any 8-byte integer) -> int64 bit patterns on
    ``device``."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize != 8 or a.dtype.kind not in "iu":
        raise TypeError(f"expected an 8-byte integer array, got {a.dtype}")
    if not a.flags.writeable:
        a = a.copy()  # torch tensors may not wrap read-only memory
    return torch.from_numpy(a.view(np.int64)).to(device)
