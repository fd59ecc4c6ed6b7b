"""Binding of ``csrc/stream_pack.c``: the key route's 2-bit stream of one
parse segment, packed by the parse workers in one native call (the
interpreter lock released), for the row gather on the device
(``kernels/syncmer_details.py:decode_rows``).

The source is compiled at first use with ``$CC`` into the git-ignored
``build/native/`` directory (:func:`..kernels.cuda_build.build_host`) and
loaded with ctypes; a failed build raises with the compiler's message.
"""
from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass

import numpy as np

from ..kernels import cuda_build
from ..utils.trace import once

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                    "stream_pack.c")
_SO = os.path.join(cuda_build.HOST_SO_DIR, "libstream_pack.so")

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            with once("stream_pack"):
                cuda_build.build_host(_SRC, _SO)
                lib = ctypes.CDLL(_SO)
                lib.stream_pack.restype = ctypes.c_int64
                lib.stream_pack.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + \
                    [ctypes.c_void_p] * 5
                _lib = lib
    return _lib


@dataclass
class SegStream:
    """One parse segment's reads as the key route uploads them: ``stream``
    holds read i's 2-bit codes (base 4j in bits 7-6 of byte j) from byte
    ``row_off[i]`` on, a multiple of 16, zeros to the next multiple of 16
    and 16 spare zero bytes at its end; ``hl`` the hoco lengths (i32),
    ``lp`` the padded length bucket of each read (``asm/reads.py:
    _bucket_len`` of max(hl, w+4), i32); ``n_rows`` the N bases as ``i<<32
    | p`` (read i, hoco position p, i64)."""

    stream: np.ndarray
    row_off: np.ndarray
    hl: np.ndarray
    lp: np.ndarray
    n_rows: np.ndarray


def pack_stream(offs: np.ndarray, codes: np.ndarray, isn: np.ndarray, w: int) -> SegStream:
    """The :class:`SegStream` of the reads ``codes[offs[i]:offs[i+1]]`` (hoco
    codes 0-3, ``offs[0]`` = 0) with Ns at the sorted hoco positions
    ``isn``."""
    lib = _load()
    offs = np.ascontiguousarray(offs, np.int64)
    isn = np.ascontiguousarray(isn, np.int64)
    n = len(offs) - 1
    # each read takes at most h/64 + 1 blocks of 16 bytes, and 16 spare
    stream = np.empty(16 * (int(offs[-1]) // 64 + n + 2), np.uint8)
    row_off = np.empty(n, np.int64)
    hl = np.empty(n, np.int32)
    lp = np.empty(n, np.int32)
    n_rows = np.empty(len(isn), np.int64)
    used = lib.stream_pack(codes.ctypes.data, offs.ctypes.data, n, isn.ctypes.data, len(isn),
                           w + 4, stream.ctypes.data,
                           row_off.ctypes.data, hl.ctypes.data, lp.ctypes.data, n_rows.ctypes.data)
    return SegStream(stream[:used], row_off, hl, lp, n_rows)
