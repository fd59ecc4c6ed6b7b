"""Build a hand-written CUDA kernel source into a shared library with a
plain C interface (loaded with ctypes): ``nvcc -gencode
arch=compute_90a,code=sm_90a``, at first use, into the git-ignored
``build/kernels/`` directory at the repository root; and the port's own
host C sources under ``csrc/`` (:func:`build_host`: ``$CC``, into
``build/native/``)."""
from __future__ import annotations

import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SO_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
HOST_SO_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")


def source(name: str) -> str:
    """Path of ``csrc/<name>`` in the package."""
    return os.path.join(_PKG, "csrc", name)


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(src: str, so: str) -> str:
    """Compile ``src`` into ``so`` (if the library is missing or older
    than its source) and return the compiler's report (``-Xptxas -v``:
    registers, shared memory, spills); empty when nothing was built."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return ""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, src,
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {src}:\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, so)
    return res.stdout + res.stderr


def build_host(src: str, so: str) -> str:
    """Compile the host C source ``src`` into ``so`` with ``$CC`` (default
    ``cc``) ``-O3 -shared -fPIC -pthread`` if the library is missing or
    older than its source; returns the compiler's output (empty when
    nothing was built), and raises RuntimeError with it when the build
    fails."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return ""
    name = os.path.splitext(os.path.basename(src))[0]
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # per-process temp name: parallel test workers may build at once
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC", "-pthread", src, "-o", tmp, "-lm"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{name}: cannot run the C compiler {cmd[0]!r}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{name}: {' '.join(cmd)} failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return res.stdout + res.stderr
