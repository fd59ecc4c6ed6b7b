"""Closed-syncmer selection: the hand-written CUDA kernel, its build and
binding, and its plain PyTorch version.

Replaces the TPU kernel ``oatk_tpu/kernels/syncmer_pallas.py:
syncmer_select_pallas``.  The kernel source is ``csrc/syncmer_select.cu``
(its header notes the design and what bounds it); it is compiled at
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into the
git-ignored ``build/kernels/`` directory at the repository root and
loaded with ctypes.

Contract (same as the Pallas kernel): ``codes_padded`` is
``[B, 1 + L + w + 2]`` with 0-3 a base, 4 an N and 5 pad (column 0 and
the right pad are 5); the result is int32 ``[B, L]`` in {0 none,
1 open, 2 close}.

Any w runs: a block's shared memory grows with its tile, not with w
(:func:`run_length` keeps the run table near ``THREADS`` entries), and
:func:`choose_tile` takes the largest tile up to ``TILE`` of which the
CUDA runtime fits ``MIN_BLOCKS`` blocks on an SM (PERF.md has the tiles
measured at k=1001).

:func:`syncmer_select` takes the plain version only for a tensor on the
CPU.  For a CUDA tensor it launches the kernel or raises; nothing falls
back.  Each launch adds one to ``syncmer_select.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..utils.trace import once
from . import cuda_build

_SRC = cuda_build.source("syncmer_select.cu")
_SO = f"{cuda_build.SO_DIR}/libsyncmer_select.so"

I64MAX = (1 << 63) - 1
THREADS = 256  # kThreads of csrc/syncmer_select.cu
TILE = 4096  # largest tile (outputs per block) that choose_tile considers
MIN_BLOCKS = 2  # blocks per SM that choose_tile asks for

_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile the kernel if needed; returns the compiler's report."""
    return cuda_build.build(_SRC, _SO)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            with once("syncmer_select"):
                build()
                lib = ctypes.CDLL(_SO)
                lib.syncmer_select_launch.restype = ctypes.c_int
                lib.syncmer_select_launch.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ]
                lib.syncmer_select_smem_bytes.restype = ctypes.c_size_t
                lib.syncmer_select_smem_bytes.argtypes = [ctypes.c_int] * 3
                lib.syncmer_select_occupancy.restype = ctypes.c_int
                lib.syncmer_select_occupancy.argtypes = [
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ]
                _lib = lib
    return _lib


def run_length(tile: int, w: int, s: int) -> int:
    """Columns per run R of a tile's extent (tile + w + 4 columns): about
    one run per thread, so the run table stays near THREADS entries for
    every w, and at most W2 = w - s - 1, where the run decomposition of
    the sliding minimum is exact."""
    R = -(-(tile + w + 4) // THREADS)
    return min(R, w - s - 1) if w - s - 1 >= 1 else R


def occupancy(tile: int, w: int, s: int) -> tuple[int, int]:
    """(shared memory bytes per block, blocks per SM) of the kernel at
    this tile and w, as the CUDA runtime reports them."""
    lib = _load()
    R = run_length(tile, w, s)
    blocks = ctypes.c_int(0)
    rc = lib.syncmer_select_occupancy(tile, w, R, ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"syncmer_select occupancy query failed: CUDA error {rc}")
    return int(lib.syncmer_select_smem_bytes(tile, w, R)), blocks.value


def choose_tile(L: int, w: int, s: int) -> int:
    """The largest tile up to TILE (and the row length), in steps of 256,
    at which MIN_BLOCKS blocks fit on an SM (at 256 a block needs about
    10 KB): a larger tile rehashes less halo per output, but shared
    memory grows with the tile (not with w), and fewer blocks per SM hide
    less latency."""
    return _largest_tile(min(TILE, max(32, -(-L // 32) * 32)), w, s)


@functools.lru_cache(maxsize=None)
def _largest_tile(cap: int, w: int, s: int) -> int:
    tile = cap
    while tile > 256 and occupancy(tile, w, s)[1] < MIN_BLOCKS:
        tile -= 256
    return tile


def _check(codes_padded: torch.Tensor, w: int, s: int) -> int:
    """Validate the arguments; returns L."""
    if codes_padded.dim() != 2:
        raise ValueError(f"codes_padded must be [B, 1+L+w+2], got {tuple(codes_padded.shape)}")
    if not 1 <= s <= 31 or w < s:
        raise ValueError(f"need 1 <= s <= 31 and w >= s, got w={w} s={s}")
    L = codes_padded.shape[1] - w - 3
    if L < 0:
        raise ValueError(f"row of {codes_padded.shape[1]} columns is shorter than w+3={w + 3}")
    return L


def syncmer_select(codes_padded: torch.Tensor, w: int, s: int) -> torch.Tensor:
    """Selection codes int32 [B, L] (0 none, 1 open, 2 close)."""
    L = _check(codes_padded, w, s)
    if codes_padded.device.type == "cpu":
        return syncmer_select_plain(codes_padded, w, s)
    if codes_padded.device.type != "cuda":
        raise ValueError(f"syncmer_select: unsupported device {codes_padded.device}")
    if codes_padded.dtype != torch.uint8:
        raise TypeError(f"syncmer_select: CUDA input must be uint8, got {codes_padded.dtype}")
    if not codes_padded.is_contiguous():
        raise ValueError("syncmer_select: CUDA input must be contiguous")
    lib = _load()
    B, Lp = codes_padded.shape
    out = torch.empty((B, L), dtype=torch.int32, device=codes_padded.device)
    if out.numel() == 0:
        return out  # nothing to launch
    with torch.cuda.device(codes_padded.device):
        tile = choose_tile(L, w, s)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.syncmer_select_launch(
            codes_padded.data_ptr(), out.data_ptr(), B, Lp, L, w, s, tile,
            run_length(tile, w, s), stream,
        )
    if rc != 0:
        raise RuntimeError(f"syncmer_select kernel launch failed: CUDA error {rc}")
    syncmer_select.launches += 1
    return out


syncmer_select.launches = 0


def _shift_l(x: torch.Tensor, d: int, fill: int) -> torch.Tensor:
    """x[:, e + d] with columns past the end set to fill."""
    if d == 0:
        return x
    return torch.cat([x[:, d:], x.new_full((x.shape[0], d), fill)], dim=1)


def _winmin(M: torch.Tensor, width: int) -> torch.Tensor:
    """min M[:, e : e+width] (sentinel past the end; empty window ->
    sentinel) by a doubling sparse table."""
    if width <= 0:
        return torch.full_like(M, I64MAX)
    t = M
    span = 1
    while span * 2 <= width:
        t = torch.minimum(t, _shift_l(t, span, I64MAX))
        span *= 2
    if span < width:
        t = torch.minimum(t, _shift_l(t, width - span, I64MAX))
    return t


def _window_has(flag: torch.Tensor, width: int) -> torch.Tensor:
    """any(flag[:, e : e+width]), columns past the end counting as set."""
    B, n = flag.shape
    f = torch.cat([flag, flag.new_ones((B, width))], dim=1).to(torch.int32)
    cum = torch.cat([f.new_zeros((B, 1)), f.cumsum(1, dtype=torch.int32)], dim=1)
    return (cum[:, width : width + n] - cum[:, :n]) > 0


def hash64(key: torch.Tensor, mask: int) -> torch.Tensor:
    """Thomas Wang 64-bit mix under a 2s-bit mask on int64 lanes (values
    stay below 2^62, and every right shift follows a mask, so the
    arithmetic shift of int64 is exact here)."""
    k = (~key + (key << 21)) & mask
    k = k ^ (k >> 24)
    k = (k + (k << 3) + (k << 8)) & mask
    k = k ^ (k >> 14)
    k = (k + (k << 2) + (k << 4)) & mask
    k = k ^ (k >> 28)
    return (k + (k << 31)) & mask


def syncmer_select_plain(codes_padded: torch.Tensor, w: int, s: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in int64 whole-row ops (the
    sentinel is INT64_MAX: hash values are below 2^62)."""
    L = _check(codes_padded, w, s)
    B, Lp = codes_padded.shape
    q = w - s + 1
    mask = (1 << (2 * s)) - 1
    code = codes_padded.to(torch.int64)
    inv = code >= 4
    c2 = torch.where(inv, 0, code)
    c2p = torch.cat([c2, c2.new_zeros((B, s - 1))], dim=1)
    fwd = torch.zeros_like(code)
    rev = torch.zeros_like(code)
    for j in range(s):
        cj = c2p[:, j : j + Lp]
        fwd |= cj << (2 * (s - 1 - j))
        rev |= (3 - cj) << (2 * j)
    bad = _window_has(inv, s) | (fwd == rev)
    M = torch.where(bad, I64MAX, hash64(torch.minimum(fwd, rev), mask))

    C2 = _winmin(M, q - 2)
    B1 = _winmin(M, q - 1)
    Mp, Mm1, La = M[:, 1 : 1 + L], M[:, :L], M[:, q : q + L]
    Bq1, D = B1[:, 1 : 1 + L], B1[:, 2 : 2 + L]
    C1 = C2[:, 2 : 2 + L]
    noN = ~_window_has(inv, w)[:, 1 : 1 + L]
    code_pw = code[:, w + 1 : w + 1 + L]

    open_ = (Mp != I64MAX) & (Mp <= D) & noN & (code_pw != 4)
    case2 = (La <= Mm1) & (La <= Bq1)
    case3 = (
        ~case2
        & (Mm1 <= Bq1)
        & (Mm1 != I64MAX)
        & ((La < Bq1) | ((Mp == La) & (Mp <= C1)))
    )
    close_ = (La != I64MAX) & noN & (case2 | case3)
    sel = torch.where(open_, 1, 2)
    return torch.where(open_ ^ close_, sel, 0).to(torch.int32)
