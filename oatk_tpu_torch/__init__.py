"""oatk_tpu_torch: the PyTorch/CUDA port of oatk_tpu (NVIDIA Hopper).

The JAX package ``oatk_tpu`` is the reference; this package mirrors its
tree (``asm/``, ``index/``, ``kernels/``, ``graph/``, ``io/``,
``utils/``, ``native/``, ``cli/``) so the counterpart of
``oatk_tpu/X/y.py`` is ``oatk_tpu_torch/X/y.py``.  It imports torch and
numpy and never jax: the device code is rewritten in PyTorch ops around
hand-written CUDA kernels (``csrc/``), and the host stages (numpy plus
the native C library) are copies, the C sources included
(``native/*.c``).

Every function that creates a tensor takes an explicit ``device``; the
CLI threads ``--device`` (default ``cuda``) down to them.  There is no
silent CPU fallback: a CUDA device without a card raises.
"""

__version__ = "0.1.0"

import os as _os

# Host allocator settings carried from oatk_tpu/__init__.py (the host
# stages are the same numpy code, so the same allocation pattern).
#
# Disable numpy's MADV_HUGEPAGE on large allocations: on kernels where
# transparent hugepages are slow to fault/collapse every fresh large
# array pays a large hidden first-touch cost, and the host stages are
# allocation-heavy.  Runtime switch so it works regardless of import
# order.
if _os.environ.get("OATK_TPU_HUGEPAGE", "0") != "1":
    try:
        try:
            from numpy._core.multiarray import _set_madvise_hugepage as _smh
        except ImportError:  # pragma: no cover - numpy < 2
            from numpy.core.multiarray import _set_madvise_hugepage as _smh
        _smh(False)
    except Exception:  # pragma: no cover - private symbol moved/removed
        pass  # purely a perf tweak; never block the import

# Keep large allocations on the reusable brk heap: glibc mmaps
# allocations above M_MMAP_THRESHOLD and munmaps them on free, so each
# big numpy temporary re-pays the page-fault cost; raising the threshold
# (and the trim threshold, so the heap top is not returned) makes freed
# pages reusable.  Values are clamped to INT_MAX (mallopt takes int).
if _os.environ.get("OATK_TPU_MALLOC_REUSE", "1") == "1":
    try:
        import ctypes as _ct

        _libc = _ct.CDLL("libc.so.6")
        _libc.mallopt(-3, 0x7FFFFFFF)  # M_MMAP_THRESHOLD
        _libc.mallopt(-1, 0x7FFFFFFF)  # M_TRIM_THRESHOLD
    except Exception:  # pragma: no cover - non-glibc libc
        pass
