"""Binding of ``csrc/ec_lockstep.c``: error correction's per-read DFS as a
native state machine that lays out, packs and unpacks the wavefront
kernel's ragged rounds itself (the device wavefront backend's driver).

The source is compiled at first use with ``$CC`` (default ``cc``) ``-O3
-shared -fPIC -pthread`` into the git-ignored ``build/native/`` directory
at the repository root, as the native library is, and loaded with ctypes.
A failed build raises with the compiler's message.

:class:`Lockstep` holds one EC run: ``layout`` advances every read in
flight to its next wavefront request and lays the round out
(``kernels/wf_ed.py:round_layout``'s layout), ``pack`` writes the round's
input words (``pack_round``'s words), ``unpack`` applies the kernel's
output, ``finish`` gives ``native.ec_correct_reads``'s outputs.
``kernels/wf_ed.py:wf_ed_lockstep`` runs the rounds.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple

import numpy as np

from ..kernels import cuda_build
from ..utils.trace import once

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "ec_lockstep.c")
_SO = os.path.join(os.path.dirname(_PKG), "build", "native", "libec_lockstep.so")

_OOM, _I32, _STATE = -2, -3, -4

_lib = None
_lib_lock = threading.Lock()

_P, _I = ctypes.c_void_p, ctypes.c_int64


def build() -> str:
    """Compile the source if the library is missing or older than it
    (:func:`..kernels.cuda_build.build_host`)."""
    return cuda_build.build_host(_SRC, _SO)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            with once("ec_lockstep"):
                build()
                lib = ctypes.CDLL(_SO)
                lib.ecl_new.restype = _P
                lib.ecl_new.argtypes = [
                    _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _P, _P, _P, _I, _P, _P, _P, _I, ctypes.c_double, _I, _I,
                ]
                lib.ecl_free.restype = None
                lib.ecl_free.argtypes = [_P]
                lib.ecl_layout.restype = _I
                lib.ecl_layout.argtypes = [_P, _I, _I, _P]
                lib.ecl_pack.restype = _I
                lib.ecl_pack.argtypes = [_P, _P]
                lib.ecl_unpack.restype = _I
                lib.ecl_unpack.argtypes = [_P, _P]
                lib.ecl_out_size.restype = _I
                lib.ecl_out_size.argtypes = [_P]
                lib.ecl_finish.restype = _I
                lib.ecl_finish.argtypes = [_P, _P, _P, _P, _P, _P, _I]
                lib.ecl_extensions.restype = _I
                lib.ecl_extensions.argtypes = [_P]
                lib.ecl_work.restype = None
                lib.ecl_work.argtypes = [_P, _P]
                _lib = lib
    return _lib


class RoundShape(NamedTuple):
    """What ``layout`` laid out: the items, the round's input, output and
    scratch words, the dynamic shared memory of a block, and the items on
    the global-memory route."""

    B: int
    in_words: int
    out_words: int
    scratch_words: int
    smem: int
    n_global: int


def _arr(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype)


class Lockstep:
    """One EC run of the C lockstep driver over the graph and read arrays
    (the arguments of ``native.ec_correct_reads``, in its order), with at
    most ``inflight`` reads in flight (0: all) and ``n_threads`` threads.
    The arrays are kept alive here while the C side reads them."""

    def __init__(self, idx_p, idx_n, aw, als, adel, seq_flat, seq_off, vtx_len, scm_del,
                 kflat, mflat, moff, code_flat, hoff, hoco_l, w: int, max_edist: float,
                 inflight: int = 0, n_threads: int = 1,
                 lazy_src=None, lazy_rev=None, lazy_codes=None):
        self._h = None
        lib = _load()
        moff, hoff, hoco_l, idx_p = (_arr(a, np.int64) for a in (moff, hoff, hoco_l, idx_p))
        n_reads = len(moff) - 1
        if len(hoco_l) != n_reads or len(hoff) != n_reads + 1:
            raise ValueError("ec_lockstep: moff, hoff and hoco_l disagree on the read count")
        self._keep = [
            idx_p, _arr(idx_n, np.int64), _arr(aw, np.uint64), _arr(als, np.int64),
            _arr(adel, np.uint8), _arr(seq_flat, np.uint8), _arr(seq_off, np.int64),
            _arr(vtx_len, np.int64), _arr(scm_del, np.uint8),
            None if lazy_src is None else _arr(lazy_src, np.int64),
            None if lazy_rev is None else _arr(lazy_rev, np.uint8),
            None if lazy_codes is None else _arr(lazy_codes, np.uint8),
            _arr(kflat, np.uint64), _arr(mflat, np.uint32), moff,
            _arr(code_flat, np.uint8), hoff, hoco_l,
        ]
        ptr = [None if a is None else a.ctypes.data for a in self._keep]
        self.n_reads = n_reads
        self._lib = lib
        self._h = lib.ecl_new(
            *ptr[:2], len(idx_p), *ptr[2:15], n_reads, *ptr[15:],
            int(w), ctypes.c_double(max_edist), int(inflight), int(n_threads),
        )
        if not self._h:
            raise MemoryError("ec_lockstep: cannot allocate the driver")
        self._shape = np.zeros(6, np.int64)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        if self._h:
            self._lib.ecl_free(self._h)
            self._h = None

    def __del__(self):
        if self._h:
            self.close()

    def layout(self, smem_limit: int, force_global: bool = False) -> RoundShape:
        """Advance every read in flight to its next request (admitting
        reads as places free up) and lay the round out; B is 0 once every
        read is done."""
        rc = self._lib.ecl_layout(self._h, int(smem_limit), int(bool(force_global)),
                                  self._shape.ctypes.data)
        if rc == _I32:
            raise ValueError(f"wf_ed: a round of {int(self._shape[0])} items does not fit int32 offsets")
        if rc == _OOM:
            raise MemoryError("ec_lockstep: out of memory")
        return RoundShape(*(int(x) for x in self._shape))

    def pack(self, h32: np.ndarray, shape: RoundShape) -> None:
        """Write the laid-out round's input words into ``h32`` (int32,
        contiguous, at least ``shape.in_words`` long)."""
        if h32.dtype != np.int32 or not h32.flags.c_contiguous or h32.size < shape.in_words:
            raise ValueError("ec_lockstep: pack needs a contiguous int32 buffer of in_words")
        if self._lib.ecl_pack(self._h, h32.ctypes.data) != 0:
            raise RuntimeError("ec_lockstep: pack before layout")

    def unpack(self, o: np.ndarray, shape: RoundShape) -> int:
        """Apply the round's output words ``o``; returns -1, or the index
        of the first item whose ``err`` is set (nothing applied then)."""
        if o.dtype != np.int32 or not o.flags.c_contiguous or o.size < shape.out_words:
            raise ValueError("ec_lockstep: unpack needs a contiguous int32 buffer of out_words")
        rc = self._lib.ecl_unpack(self._h, o.ctypes.data)
        if rc == _OOM:
            raise MemoryError("ec_lockstep: out of memory")
        if rc == _STATE:
            raise RuntimeError("ec_lockstep: unpack before layout")
        return int(rc)

    def finish(self):
        """(stats[11], out_kmer, out_mpos, out_cut, out_upd) as
        ``native.ec_correct_reads`` returns them; every read must be done."""
        total = self._lib.ecl_out_size(self._h)
        if total < 0:
            raise RuntimeError("ec_lockstep: finish before every read is done")
        stats = np.zeros(11, np.int64)
        out_kmer = np.empty(total, np.uint64)
        out_mpos = np.empty(total, np.uint32)
        out_cut = np.empty(self.n_reads + 1, np.int64)
        out_upd = np.empty(self.n_reads, np.uint8)
        n = self._lib.ecl_finish(self._h, stats.ctypes.data, out_kmer.ctypes.data,
                                 out_mpos.ctypes.data, out_cut.ctypes.data, out_upd.ctypes.data,
                                 total)
        if n != total:
            raise RuntimeError(f"ec_lockstep: finish wrote {n} of {total} syncmers")
        return stats, out_kmer, out_mpos, out_cut, out_upd

    def extensions(self) -> int:
        """The wavefront extensions made so far (items applied)."""
        return int(self._lib.ecl_extensions(self._h))

    def work(self) -> tuple:
        """The kernel's work over the items this handle applied, from each
        item's meta in and out_meta alone (any kernel that keeps the
        contract reads the same): the target and query bases (sum of tl +
        ql), the diagonals of the waves in and out (sums of n), and the
        wave cells, sum of (score out - score in) x (n in + n out) / 2."""
        w = np.zeros(4, np.int64)
        self._lib.ecl_work(self._h, w.ctypes.data)
        return int(w[0]), int(w[1]), int(w[2]), int(w[3]) / 2.0
