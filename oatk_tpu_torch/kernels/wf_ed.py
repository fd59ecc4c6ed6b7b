"""Banded LV89 edit-distance wavefront: the hand-written CUDA kernel, its
build and binding, its plain PyTorch version, and the single-state
entry point that error correction calls.

Replaces the TPU kernel ``oatk_tpu/kernels/wavefront_pallas.py:
wf_ed_core_pallas_batch`` and its single-state entry
``wf_ed_core_pallas``.  The kernel source is ``csrc/wf_ed.cu`` (its
header notes the design and what bounds it); it is compiled at first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into the git-ignored
``build/kernels/`` directory at the repository root and loaded with
ctypes.

Contract (the Pallas kernel's, without its length cap): ``ts`` uint8
``[B, TL]``, ``qs`` uint8 ``[B, QL]``, ``meta`` int32 ``[B, 8]`` = (tl, ql,
is_ext, bw, score, d0, n, 0), ``k`` int32 ``[B, D_cap]`` holding the
wavefront in ``k[:, :n]``; returns ``out_meta`` int32 ``[B, 8]`` = (score,
d0, n, hit, t_end_raw, q_end_raw, err, 0) and ``out_k`` int32 ``[B, D_cap]``
(the new wavefront in ``[:n]``, -BIG after it).  ``err`` is 0, 1 when the
input does not fit (n outside [1, D_cap], tl > TL or ql > QL) or 2 when a
wave would leave [1, D_cap]; ``out_k`` is then all -BIG.  TL and QL may
be any widths at or above the lengths.

:func:`wf_ed_core_batch` takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the kernel or raises; nothing falls
back.  Each launch adds one to ``wf_ed_core_batch.launches``.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import cuda_build

_SRC = cuda_build.source("wf_ed.cu")
_SO = f"{cuda_build.SO_DIR}/libwf_ed.so"

BIG = 0x3FFFFFFF
# the kernel's own static shared memory, kept free of the dynamic part
_STATIC_SMEM = 64

_lib = None
_lib_lock = threading.Lock()
_smem_limit: dict[int, int] = {}


def build() -> str:
    """Compile the kernel if needed; returns the compiler's report."""
    return cuda_build.build(_SRC, _SO)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(_SO)
            lib.wf_ed_smem_limit.restype = ctypes.c_int
            lib.wf_ed_smem_limit.argtypes = []
            lib.wf_ed_launch.restype = ctypes.c_int
            lib.wf_ed_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            _lib = lib
    return _lib


def smem_bytes(TL: int, QL: int, D_cap: int) -> int:
    """Dynamic shared memory of one block on the shared-memory route."""
    return -(-(8 * D_cap + TL + QL) // 16) * 16


def _smem_limit_of(lib, device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _smem_limit:
        with torch.cuda.device(idx):
            lim = lib.wf_ed_smem_limit()
        if lim <= 0:
            raise RuntimeError("wf_ed: cannot read the device's shared-memory limit")
        _smem_limit[idx] = lim - _STATIC_SMEM
    return _smem_limit[idx]


def _check(ts, qs, meta, k) -> tuple[int, int, int, int]:
    """Validate shapes and types; returns (B, TL, QL, D_cap)."""
    if ts.dim() != 2 or qs.dim() != 2 or meta.dim() != 2 or k.dim() != 2:
        raise ValueError("wf_ed: ts, qs, meta and k must be 2-D")
    B = ts.shape[0]
    if qs.shape[0] != B or meta.shape != (B, 8) or k.shape[0] != B:
        raise ValueError(
            f"wf_ed: batch shapes disagree: ts {tuple(ts.shape)} qs {tuple(qs.shape)} "
            f"meta {tuple(meta.shape)} k {tuple(k.shape)}"
        )
    if ts.dtype != torch.uint8 or qs.dtype != torch.uint8:
        raise TypeError(f"wf_ed: ts and qs must be uint8, got {ts.dtype} and {qs.dtype}")
    if meta.dtype != torch.int32 or k.dtype != torch.int32:
        raise TypeError(f"wf_ed: meta and k must be int32, got {meta.dtype} and {k.dtype}")
    devs = {t.device for t in (ts, qs, meta, k)}
    if len(devs) != 1:
        raise ValueError(f"wf_ed: tensors on different devices: {devs}")
    return B, ts.shape[1], qs.shape[1], k.shape[1]


def wf_ed_core_batch(ts, qs, meta, k, out_meta=None, out_k=None, force_global: bool = False):
    """Run the wavefront core for B independent alignments; returns
    (out_meta, out_k).  ``out_meta``/``out_k`` may be given as output
    buffers on the same device.  ``force_global`` takes the kernel's
    global-memory route even where the shared-memory one fits (to test
    it)."""
    B, TL, QL, D_cap = _check(ts, qs, meta, k)
    dev = ts.device
    if dev.type == "cpu":
        om, ok = wf_ed_core_batch_plain(ts, qs, meta, k)
        if out_meta is not None:
            out_meta.copy_(om)
            out_k.copy_(ok)
            return out_meta, out_k
        return om, ok
    if dev.type != "cuda":
        raise ValueError(f"wf_ed_core_batch: unsupported device {dev}")
    for t in (ts, qs, meta, k):
        if not t.is_contiguous():
            raise ValueError("wf_ed_core_batch: CUDA inputs must be contiguous")
    if out_meta is None:
        out_meta = torch.empty((B, 8), dtype=torch.int32, device=dev)
        out_k = torch.empty((B, D_cap), dtype=torch.int32, device=dev)
    elif (out_meta.shape != (B, 8) or out_k.shape != (B, D_cap) or out_meta.device != dev
          or out_k.device != dev or out_meta.dtype != torch.int32 or out_k.dtype != torch.int32
          or not out_meta.is_contiguous() or not out_k.is_contiguous()):
        raise ValueError("wf_ed_core_batch: output buffers do not match the inputs")
    if B == 0:
        return out_meta, out_k
    lib = _load()
    smem = smem_bytes(TL, QL, D_cap)
    scratch = None
    if force_global or smem > _smem_limit_of(lib, dev):
        smem = 0
        scratch = torch.empty((B, 2, D_cap), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.wf_ed_launch(
            ts.data_ptr(), qs.data_ptr(), meta.data_ptr(), k.data_ptr(),
            out_meta.data_ptr(), out_k.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            B, TL, QL, D_cap, smem, stream,
        )
    if rc != 0:
        raise RuntimeError(f"wf_ed kernel launch failed: CUDA error {rc}")
    wf_ed_core_batch.launches += 1
    return out_meta, out_k


wf_ed_core_batch.launches = 0


def _band(tl: int, ql: int, is_ext: bool, bw: int, n: int, nd0: int):
    """(stt, rtrim) of the next wave of n + 2 diagonals starting at nd0,
    with the reference's max_d = max(xdb, ql) quirk
    (wavefront_pallas.py:116-135)."""
    n2 = n + 2
    if bw < 0 or n < 2 * bw + 1:
        min_d, max_d = -tl, ql
    else:
        if is_ext:
            mdb, xdb = -bw, bw
        else:
            mdb = (ql - tl - bw) if ql < tl else (tl - ql - bw)
            xdb = (tl - ql + bw) if tl > ql else (ql - tl + bw)
        min_d, max_d = max(mdb, -tl), max(xdb, ql)
    stt = min(max(min_d - nd0, 0), n2)
    rtrim = min(max(nd0 + n2 - 1 - max_d, 0), n2)
    return stt, rtrim


def _extend(ts, qs, tl: int, ql: int, d: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Extend each diagonal (d, k) along exact matches: the last k' with
    positions k+1..k' all matching, where a position past
    max_k = min(ql-d, tl)-1 or with a negative query index counts as a
    mismatch.  Windows of doubling width: a gathered [m, W] compare and a
    first-mismatch argmax per window."""
    dev = k.device
    out = k.clone()
    act = torch.arange(k.numel(), device=dev)
    base = k + 1
    max_k = (ql - d).clamp(max=tl) - 1
    # one sentinel past each end, so clamped indices stay in range
    tsp = torch.nn.functional.pad(ts[:tl].to(torch.int32), (0, 1), value=-1)
    qsp = torch.nn.functional.pad(qs[:ql].to(torch.int32), (0, 1), value=-2)
    W = 32
    while act.numel():
        kp = base[:, None] + torch.arange(W, device=dev)[None, :]
        qi = d[act][:, None] + kp
        valid = (kp >= 0) & (kp <= max_k[act][:, None]) & (qi >= 0)
        eq = valid & (tsp[kp.clamp(0, tl)] == qsp[qi.clamp(0, ql)])
        miss = ~eq
        found = miss.any(1)
        first = miss.to(torch.uint8).argmax(1)
        out[act[found]] = base[found] + first[found] - 1
        keep = ~found
        act = act[keep]
        base = base[keep] + W
        W = min(W * 2, 4096)
    return out


def _plain_one(ts, qs, meta: list[int], k: torch.Tensor, TL: int, QL: int, D_cap: int):
    """One alignment of the plain version; returns (meta8, k[:n] or None)."""
    tl, ql, is_ext, bw, score, d0, n = meta[:7]
    if n < 1 or n > D_cap or tl < 0 or ql < 0 or tl > TL or ql > QL:
        return [score, d0, n, 0, -1, -1, 1, 0], None
    dev = k.device
    K = k[:n].to(torch.int64)
    while True:
        j = torch.arange(n, device=dev)
        dj = d0 + j
        skip = (K >= tl) | (K + dj >= ql)
        E = K.clone()
        live = (~skip).nonzero().flatten()
        if live.numel():
            E[live] = _extend(ts, qs, tl, ql, dj[live], K[live])
        at_q = E + dj == ql - 1
        at_t = E == tl - 1
        hitv = ~skip & (at_q | at_t) & ((is_ext != 0) | (at_q & at_t))
        hits = hitv.nonzero().flatten()
        if hits.numel():
            fh = int(hits[0])
            K[:fh] = E[:fh]
            t_end = int(E[fh])
            return [score, d0, n, 1, t_end, t_end + d0 + fh, 0, 0], K
        # next wave: insertion E[i-2], mismatch E[i-1]+1, deletion E[i]+1
        nk = torch.full((n + 2,), -BIG, dtype=torch.int64, device=dev)
        nk[2:] = E
        nk[1 : n + 1] = torch.maximum(nk[1 : n + 1], E + 1)
        nk[:n] = torch.maximum(nk[:n], E + 1)
        stt, rtrim = _band(tl, ql, is_ext != 0, bw, n, d0 - 1)
        n_new = n + 2 - stt - rtrim
        if n_new < 1 or n_new > D_cap:
            return [score, d0, n, 0, -1, -1, 2, 0], None
        K = nk[stt : stt + n_new]
        n, d0, score = n_new, d0 - 1 + stt, score + 1
        if bw >= 0 and score > bw:
            return [score, d0, n, 0, -1, -1, 0, 0], K


def wf_ed_core_batch_plain(ts, qs, meta, k):
    """Plain PyTorch version of the kernel, on the inputs' device: a
    Python loop over the batch and over wavefront steps, each step in
    int64 tensor ops over the live diagonals (extension by gathered
    window compares, first hit by the smallest hitting index, the next
    wave and band by the same formulas)."""
    B, TL, QL, D_cap = _check(ts, qs, meta, k)
    out_meta = torch.zeros((B, 8), dtype=torch.int32, device=ts.device)
    out_k = torch.full((B, D_cap), -BIG, dtype=torch.int32, device=ts.device)
    meta_h = meta.cpu().tolist()
    for b in range(B):
        om, kb = _plain_one(ts[b], qs[b], meta_h[b], k[b], TL, QL, D_cap)
        out_meta[b] = torch.tensor(om, dtype=torch.int32)
        if kb is not None:
            out_k[b, : kb.numel()] = kb.to(torch.int32)
    return out_meta, out_k


def d_cap_for(tl: int, ql: int, n: int, bw: int, is_ext: bool) -> int:
    """A k width no wave of this alignment can outgrow: after the band a
    wave spans at most [-tl, max(ql, xdb)] (xdb = bw, or |tl-ql| + bw
    when not extending; the band applies only for bw >= 0), and the
    input wave must fit too.  Rounded up to 32."""
    xdb = (bw if is_ext else abs(tl - ql) + bw) if bw >= 0 else 0
    need = max(n, tl + max(ql, xdb) + 1)
    return -(-need // 32) * 32


class _Buffers:
    """Reused host (pinned for a card) and device buffers of one device."""

    def __init__(self):
        self.words = 0
        self.h_in = self.d_in = self.h_out = self.d_out = None

    def ensure(self, words: int, dev: torch.device):
        if words <= self.words:
            return
        words = max(words, 2 * self.words, 4096)
        pin = dev.type == "cuda"
        self.h_in = torch.empty(words, dtype=torch.int32, pin_memory=pin)
        self.h_out = torch.empty(words, dtype=torch.int32, pin_memory=pin)
        if pin:
            self.d_in = torch.empty(words, dtype=torch.int32, device=dev)
            self.d_out = torch.empty(words, dtype=torch.int32, device=dev)
        else:
            self.d_in, self.d_out = self.h_in, self.h_out
        self.words = words


_bufs: dict[torch.device, _Buffers] = {}


def wf_ed_core_device(st) -> None:
    """Advance the wavefront state ``st`` (a ``kernels.wavefront.WfState``)
    in place on ``st.device``, with the state conversion of the JAX
    package's ``wf_ed_core_pallas``: ``wd = d0 + arange(n)``, ``t_end`` and
    ``q_end`` +1 after a hit, else 0.  No capacity check: ``k`` is sized
    so that no wave can outgrow it.

    ts, qs, meta and k travel in one reused host buffer: one copy to the
    device, one launch, and one copy of out_meta and out_k[:n_out] back
    (the read-back synchronises; the DFS needs the result)."""
    dev = torch.device(st.device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    tl, ql, n = len(st.ts), len(st.qs), len(st.wk)
    bw, is_ext, score = int(st.bw), bool(st.is_ext), int(st.score)
    D_cap = d_cap_for(tl, ql, n, bw, is_ext)
    TL = -(-max(tl, 1) // 16) * 16
    QL = -(-max(ql, 1) // 16) * 16
    o_k, o_ts = 8, 8 + D_cap
    o_qs = o_ts + TL // 4
    words = o_qs + QL // 4
    # n_out <= n + 2 per step, and a band stops the loop after
    # max(1, bw - score + 1) steps
    n_back = min(D_cap, n + 2 * max(1, bw - score + 1)) if bw >= 0 else D_cap

    buf = _bufs.get(dev)
    if buf is None:
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"wf_ed: device {dev} requested but no CUDA device is available")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"wf_ed: unsupported device {dev}")
        buf = _bufs[dev] = _Buffers()
    buf.ensure(words, dev)
    h = buf.h_in.numpy()
    h[:8] = (tl, ql, int(is_ext), bw, score, int(st.wd[0]), n, 0)
    h[o_k : o_k + n] = st.wk
    h[o_k + n : o_ts] = -BIG
    hb = h[o_ts:words].view(np.uint8)
    hb[:tl] = st.ts
    hb[TL : TL + ql] = st.qs

    d_in, d_out = buf.d_in, buf.d_out
    if dev.type == "cuda":
        d_in[:words].copy_(buf.h_in[:words], non_blocking=True)
    meta = d_in[:8].view(1, 8)
    k = d_in[o_k : o_ts].view(1, D_cap)
    ts = d_in[o_ts:o_qs].view(torch.uint8).view(1, TL)
    qs = d_in[o_qs:words].view(torch.uint8).view(1, QL)
    out_meta = d_out[:8].view(1, 8)
    out_k = d_out[8 : 8 + D_cap].view(1, D_cap)
    wf_ed_core_batch(ts, qs, meta, k, out_meta, out_k)
    if dev.type == "cuda":
        buf.h_out[: 8 + n_back].copy_(d_out[: 8 + n_back], non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
    o = buf.h_out.numpy()
    score, d0, nn, hit, t_raw, q_raw, err = (int(x) for x in o[:7])
    if err or nn > n_back:
        raise RuntimeError(
            f"wf_ed: the wavefront left its buffer (err={err}, n={nn}, D_cap={D_cap}, "
            f"read back {n_back})"
        )
    st.score = score
    st.wd = d0 + np.arange(nn, dtype=np.int64)
    st.wk = o[8 : 8 + nn].astype(np.int64)
    if hit:
        st.t_end = t_raw + 1
        st.q_end = q_raw + 1
    else:
        st.t_end = 0
        st.q_end = 0
