"""Banded LV89 edit-distance wavefront: the hand-written CUDA kernel, its
build and binding, its plain PyTorch versions, and the round driver that
error correction calls.

Replaces the TPU kernel ``oatk_tpu/kernels/wavefront_pallas.py:
wf_ed_core_pallas_batch`` and its single-state entry
``wf_ed_core_pallas``.  The kernel source is ``csrc/wf_ed.cu`` (its
header notes the design and what bounds it); it is compiled at first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into the git-ignored
``build/kernels/`` directory at the repository root and loaded with
ctypes.

Two contracts, one launch of one kernel:

- padded, the Pallas kernel's without its length cap
  (:func:`wf_ed_core_batch`): ``ts`` uint8 ``[B, TL]``, ``qs`` uint8
  ``[B, QL]``, ``meta`` int32 ``[B, 8]`` = (tl, ql, is_ext, bw, score, d0,
  n, 0), ``k`` int32 ``[B, D_cap]`` holding the wavefront in ``k[:, :n]``;
  returns ``out_meta`` int32 ``[B, 8]`` = (score, d0, n, hit, t_end_raw,
  q_end_raw, err, 0) and ``out_k`` int32 ``[B, D_cap]`` (the new wavefront
  in ``[:n]``, -BIG after it).  ``err`` is 0, 1 when the input does not
  fit (n outside [1, D_cap], tl > TL or ql > QL) or 2 when a wave would
  leave [1, D_cap]; ``out_k`` is then all -BIG.  TL and QL may be any
  widths at or above the lengths.
- ragged (:func:`wf_ed_core_ragged`): one int32 buffer that starts with B
  descriptors of ``DESC_WORDS`` words (the layout is in ``csrc/wf_ed.cu``)
  naming, per item, where its meta, k, ts and qs lie in the same buffer
  and where its out_meta and out_k (of the item's own width S) go in the
  output buffer.  :func:`wf_ed_core_rounds` packs a list of ``WfState``s
  this way, so that one upload, one launch and one read-back advance all
  of them; :func:`wf_ed_lockstep` runs the rounds of EC's C lockstep
  driver (``csrc/ec_lockstep.c``), which lays out and packs the same
  words itself.

The wrappers take the plain versions only for tensors on the CPU.  For
CUDA tensors they launch the kernel or raise; nothing falls back.  Each
launch adds one to ``wf_ed_core_batch.launches`` and its item count to
``wf_ed_core_batch.items``; each round of either driver, on any device,
adds one to ``wf_ed_core_rounds.rounds``.
"""
from __future__ import annotations

import ctypes
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..utils.trace import once
from . import cuda_build

_SRC = cuda_build.source("wf_ed.cu")
_SO = f"{cuda_build.SO_DIR}/libwf_ed.so"

BIG = 0x3FFFFFFF
DESC_WORDS = 12
# threads per block; the kernel is built for 128 and 256.  chip_smoke.py
# times a round of 2,000 EC-shaped states at both: on an H100 80GB HBM3
# (700 W) 0.408-0.428 ms at 256 against 0.669-0.684 ms at 128 (its
# variant spills, and wide waves keep all eight warps busy)
THREADS = 256
# the kernel's own static shared memory, kept free of the dynamic part
_STATIC_SMEM = 64
_I32_MAX = (1 << 31) - 1

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
            with once("wf_ed"):
                build()
                lib = ctypes.CDLL(_SO)
                lib.wf_ed_smem_limit.restype = ctypes.c_int
                lib.wf_ed_smem_limit.argtypes = []
                lib.wf_ed_launch.restype = ctypes.c_int
                lib.wf_ed_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                _lib = lib
    return _lib


def _r16(x):
    return -(-x // 16) * 16


def smem_bytes(TL: int, QL: int, D_cap: int) -> int:
    """Dynamic shared memory of one block on the shared-memory route: K
    and E of D_cap words, then ts of TL and qs of QL bytes, each part
    16-byte aligned."""
    return _r16(8 * D_cap) + _r16(TL) + _r16(QL)


def _smem_limit_of(lib, device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _smem_limit:
        with torch.cuda.device(idx):
            lim = lib.wf_ed_smem_limit()
        if lim <= 0:
            raise RuntimeError("wf_ed: cannot read the device's shared-memory limit")
        _smem_limit[idx] = lim - _STATIC_SMEM
    return _smem_limit[idx]


def _launch(dev, desc, ts, qs, meta, k, out_meta, out_k, scratch, B: int, smem: int) -> None:
    """One launch on ``dev``'s current stream (pointers as ints or None)."""
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.wf_ed_launch(desc, ts, qs, meta, k, out_meta, out_k, scratch, B, smem, THREADS,
                              stream)
    if rc != 0:
        raise RuntimeError(f"wf_ed kernel launch failed: CUDA error {rc}")
    wf_ed_core_batch.launches += 1
    wf_ed_core_batch.items += B


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
    """Run the wavefront core for B independent alignments in the padded
    layout; returns (out_meta, out_k).  ``out_meta``/``out_k`` may be
    given as output buffers on the same device.  ``force_global`` takes
    the kernel's global-memory route even where the shared-memory one
    fits (to test it).  On a card this is the ragged launch with
    descriptors that stride over the padded rows."""
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
    smem = smem_bytes(TL, QL, D_cap)
    glob = force_global or smem > _smem_limit_of(_load(), dev)
    b = np.arange(B, dtype=np.int64)
    desc = np.zeros((B, DESC_WORDS), np.int64)
    desc[:, 0], desc[:, 1], desc[:, 2], desc[:, 3] = b * TL, b * QL, b * 8, b * D_cap
    desc[:, 4], desc[:, 5] = b * 8, b * D_cap
    desc[:, 6] = b * 2 * D_cap if glob else -1
    desc[:, 7], desc[:, 8], desc[:, 9] = D_cap, TL, QL
    if B * max(TL, QL, 2 * D_cap) > _I32_MAX:
        raise ValueError("wf_ed_core_batch: a row offset does not fit in int32")
    d_desc = torch.from_numpy(desc.astype(np.int32)).to(dev)
    scratch = torch.empty((B, 2, D_cap), dtype=torch.int32, device=dev) if glob else None
    _launch(dev, d_desc.data_ptr(), ts.data_ptr(), qs.data_ptr(), meta.data_ptr(), k.data_ptr(),
            out_meta.data_ptr(), out_k.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, B, 0 if glob else smem)
    return out_meta, out_k


wf_ed_core_batch.launches = 0
wf_ed_core_batch.items = 0


def _check_ragged(inp, out, B: int) -> None:
    for name, t in (("inp", inp), ("out", out)):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise TypeError(f"wf_ed_core_ragged: {name} must be 1-D int32, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"wf_ed_core_ragged: {name} must be contiguous")
    if inp.device != out.device:
        raise ValueError(f"wf_ed_core_ragged: inp on {inp.device}, out on {out.device}")
    if inp.numel() < B * DESC_WORDS:
        raise ValueError(f"wf_ed_core_ragged: {inp.numel()} words hold no {B} descriptors")


def wf_ed_core_ragged(inp, out, B: int, smem: int, scratch=None):
    """Run the ragged round of the B items that ``inp`` describes, writing
    each item's out_meta and out_k into ``out``; returns ``out``.
    ``smem`` is the dynamic shared memory of a block (at least the need of
    the largest shared-memory item); ``scratch`` is an int32 device buffer
    covering every global-route item's ``2 S`` words at its scratch
    offset, and may be None when no item takes that route.
    :func:`round_layout` computes both; the CPU path reads neither."""
    _check_ragged(inp, out, B)
    dev = inp.device
    if dev.type == "cpu":
        return wf_ed_core_ragged_plain(inp, out, B)
    if dev.type != "cuda":
        raise ValueError(f"wf_ed_core_ragged: unsupported device {dev}")
    if B == 0:
        return out
    if smem > _smem_limit_of(_load(), dev):
        raise ValueError(f"wf_ed_core_ragged: {smem} B of shared memory exceed the card's limit")
    p, q = inp.data_ptr(), out.data_ptr()
    _launch(dev, p, p, p, p, p, q, q, scratch.data_ptr() if scratch is not None else None, B, smem)
    return out


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


def wf_ed_core_ragged_plain(inp, out, B: int):
    """Plain PyTorch version of the ragged contract, on the inputs'
    device: :func:`_plain_one` on each item at its descriptor's offsets
    (routes and scratch offsets are the kernel's business and are not
    read).  Returns ``out``."""
    _check_ragged(inp, out, B)
    desc = inp[: B * DESC_WORDS].view(B, DESC_WORDS).tolist()
    byt = inp.view(torch.uint8)
    for ts_off, qs_off, meta_off, k_off, om_off, ok_off, _scr, S, TL, QL, *_ in desc:
        meta = inp[meta_off : meta_off + 8].tolist()
        om, kb = _plain_one(byt[ts_off : ts_off + TL], byt[qs_off : qs_off + QL], meta,
                            inp[k_off : k_off + S], TL, QL, S)
        out[om_off : om_off + 8] = torch.tensor(om, dtype=torch.int32)
        out[ok_off : ok_off + S] = -BIG
        if kb is not None:
            out[ok_off : ok_off + kb.numel()] = kb.to(torch.int32)
    return out


def d_cap_for(tl, ql, n, bw, is_ext):
    """A k width no wave of this alignment can outgrow: after the band a
    wave spans at most [-tl, max(ql, xdb)] (xdb = bw, or |tl-ql| + bw
    when not extending; the band applies only for bw >= 0), and the
    input wave must fit too.  Rounded up to 32.  Takes numbers or numpy
    arrays of them."""
    xdb = np.where(np.asarray(bw) >= 0, np.where(is_ext, bw, np.abs(np.subtract(tl, ql)) + bw), 0)
    need = np.maximum(n, np.add(tl, np.maximum(ql, xdb)) + 1)
    cap = -(-need // 32) * 32
    return int(cap) if np.ndim(cap) == 0 else cap


def slot_width(tl, ql, n, bw, is_ext, score):
    """The k/out_k width S of an item in a ragged round: d_cap_for, or
    when banded n + 2 * max(1, bw - score + 1), whichever is smaller (a
    step adds at most 2 diagonals, and the band stops the loop after
    max(1, bw - score + 1) steps).  Takes numbers or numpy arrays."""
    cap = d_cap_for(tl, ql, n, bw, is_ext)
    s = np.where(np.asarray(bw) >= 0,
                 np.minimum(cap, np.add(n, 2 * np.maximum(1, np.subtract(bw, score) + 1))), cap)
    return int(s) if np.ndim(s) == 0 else s


class RoundLayout(NamedTuple):
    """Where each item of a ragged round lies: ``desc`` int64
    ``[B, DESC_WORDS]`` (byte offsets of ts/qs, word offsets of meta, k,
    out_meta, out_k and scratch, S, TL, QL), ``meta`` int64 ``[B, 8]``,
    and the round's input, output and scratch words and shared memory."""

    desc: np.ndarray
    meta: np.ndarray
    in_words: int
    out_words: int
    scratch_words: int
    smem: int


def round_layout(states, smem_limit: int, force_global=False) -> RoundLayout:
    """The ragged layout of ``states`` (``WfState``s): descriptors, then
    metas, then per item k, ts and qs at 16-byte aligned offsets; per
    item out_meta and out_k side by side in the output.  An item whose
    shared-memory need exceeds ``smem_limit``, or that ``force_global``
    (a bool, or one per item) names, takes the global route."""
    B = len(states)
    meta = np.zeros((B, 8), np.int64)
    meta[:, :7] = [(len(s.ts), len(s.qs), int(bool(s.is_ext)), int(s.bw), int(s.score),
                    int(s.wd[0]), len(s.wk)) for s in states]
    tl, ql, is_ext, bw, score, _d0, n = meta[:, :7].T
    S = slot_width(tl, ql, n, bw, is_ext != 0, score)
    kb, tb, qb = _r16(4 * n), _r16(tl), _r16(ql)
    size = kb + tb + qb
    start = B * (DESC_WORDS + 8) * 4 + np.cumsum(size) - size
    in_bytes = B * (DESC_WORDS + 8) * 4 + int(size.sum())
    osz = 8 + S
    om_off = np.cumsum(osz) - osz
    glob = (_r16(8 * S) + tb + qb > smem_limit) | np.asarray(force_global, bool)
    scr = np.where(glob, 2 * S, 0)
    desc = np.zeros((B, DESC_WORDS), np.int64)
    desc[:, 0] = start + kb
    desc[:, 1] = start + kb + tb
    desc[:, 2] = B * DESC_WORDS + 8 * np.arange(B)
    desc[:, 3] = start // 4
    desc[:, 4] = om_off
    desc[:, 5] = om_off + 8
    desc[:, 6] = np.where(glob, np.cumsum(scr) - scr, -1)
    desc[:, 7], desc[:, 8], desc[:, 9] = S, tl, ql
    out_words, scratch_words = int(osz.sum()), int(scr.sum())
    if max(in_bytes, 4 * out_words, 4 * scratch_words) > _I32_MAX:
        raise ValueError(f"wf_ed: a round of {B} items does not fit int32 offsets")
    smem = int((_r16(8 * S) + tb + qb)[~glob].max()) if (~glob).any() else 0
    return RoundLayout(desc, meta, in_bytes // 4, out_words, scratch_words, smem)


def pack_round(h32: np.ndarray, lay: RoundLayout, states) -> None:
    """Write the round's input words into ``h32`` (int32, at least
    ``lay.in_words`` long)."""
    B = len(states)
    h8 = h32.view(np.uint8)
    h32[: B * DESC_WORDS] = lay.desc.ravel()
    h32[B * DESC_WORDS : B * (DESC_WORDS + 8)] = lay.meta.ravel()
    d = lay.desc
    for st, t0, q0, k0 in zip(states, d[:, 0].tolist(), d[:, 1].tolist(), d[:, 3].tolist()):
        h32[k0 : k0 + len(st.wk)] = st.wk
        h8[t0 : t0 + len(st.ts)] = st.ts
        h8[q0 : q0 + len(st.qs)] = st.qs


def _item_failed(i: int, B: int, err: int, meta: list, S: int) -> RuntimeError:
    return RuntimeError(f"wf_ed: item {i} of a round of {B} failed (err={err}, meta {meta}, "
                        f"width {S})")


def unpack_round(o: np.ndarray, lay: RoundLayout, states) -> None:
    """Set each state from its out_meta and out_k in ``o`` (the round's
    output words), with the state conversion of the JAX package's
    ``wf_ed_core_pallas``: ``wd = d0 + arange(n)``, ``t_end`` and
    ``q_end`` +1 after a hit, else 0.  Raises on an item's ``err``."""
    om = o[lay.desc[:, 4, None] + np.arange(8)]
    bad = np.flatnonzero(om[:, 6])
    if bad.size:
        i = int(bad[0])
        raise _item_failed(i, len(states), int(om[i, 6]), lay.meta[i, :7].tolist(),
                           int(lay.desc[i, 7]))
    for st, (score, d0, nn, hit, t_raw, q_raw), k0 in zip(
        states, om[:, :6].tolist(), lay.desc[:, 5].tolist()
    ):
        st.score = score
        st.wd = d0 + np.arange(nn, dtype=np.int64)
        st.wk = o[k0 : k0 + nn].astype(np.int64)
        if hit:
            st.t_end = t_raw + 1
            st.q_end = q_raw + 1
        else:
            st.t_end = 0
            st.q_end = 0


WORK_KEYS = ("seq_bytes", "wave_in", "wave_out", "wave_cells")


class _Buffers:
    """Reused host (pinned for a card) and device buffers of one device."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.h_in = self.h_out = self.d_in = self.d_out = self.d_scr = None

    @staticmethod
    def _grow(t, words: int, device=None, pin: bool = False):
        have = 0 if t is None else t.numel()
        if words <= have:
            return t
        return torch.empty(max(words, 2 * have, 4096), dtype=torch.int32, device=device,
                           pin_memory=pin)

    def ensure(self, in_words: int, out_words: int, scr_words: int) -> None:
        card = self.dev.type == "cuda"
        self.h_in = self._grow(self.h_in, in_words, pin=card)
        self.h_out = self._grow(self.h_out, out_words, pin=card)
        if card:
            self.d_in = self._grow(self.d_in, in_words, self.dev)
            self.d_out = self._grow(self.d_out, out_words, self.dev)
            if scr_words:
                self.d_scr = self._grow(self.d_scr, scr_words, self.dev)
        else:
            self.d_in, self.d_out = self.h_in, self.h_out


_bufs: dict[torch.device, _Buffers] = {}


def _device_of(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"wf_ed: device {dev} requested but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"wf_ed: unsupported device {dev}")
    return dev


def wf_ed_core_rounds(states, device=None) -> None:
    """Advance every ``WfState`` of ``states`` in place, in one ragged
    round on ``device`` (default: the first state's ``device``): one
    packed upload, one launch, one read-back of each item's out_meta and
    out_k, one synchronise (the DFS needs the results).  No capacity
    check: each item's width S is sized so that no wave can outgrow it,
    and an ``err`` raises."""
    if not states:
        return
    dev = _device_of(states[0].device if device is None else device)
    buf = _bufs.get(dev)
    if buf is None:
        buf = _bufs[dev] = _Buffers(dev)
    card = dev.type == "cuda"
    # on the CPU every item is computed by the plain version: no routes
    lay = round_layout(states, _smem_limit_of(_load(), dev) if card else _I32_MAX)
    buf.ensure(lay.in_words, lay.out_words, lay.scratch_words)
    pack_round(buf.h_in[: lay.in_words].numpy(), lay, states)
    d_in, d_out = buf.d_in[: lay.in_words], buf.d_out[: lay.out_words]
    if card:
        d_in.copy_(buf.h_in[: lay.in_words], non_blocking=True)
    wf_ed_core_ragged(d_in, d_out, len(states), lay.smem,
                      buf.d_scr if lay.scratch_words else None)
    if card:
        buf.h_out[: lay.out_words].copy_(d_out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
    wf_ed_core_rounds.rounds += 1
    unpack_round(buf.h_out[: lay.out_words].numpy(), lay, states)


wf_ed_core_rounds.rounds = 0


def wf_ed_lockstep(driver, device, smem_limit: int | None = None, force_global: bool = False) -> dict:
    """Run the rounds of a lockstep ``driver`` (``asm/ec_lockstep.py:
    Lockstep``, which lays out, packs and unpacks each round in C) on
    ``device`` until its reads are done.  Each round: ``driver.layout``,
    the buffers grown, ``driver.pack`` into the pinned host buffer, a
    ``non_blocking`` upload, :func:`wf_ed_core_ragged`, the read-back into
    the pinned output buffer and one synchronise, ``driver.unpack``.
    ``smem_limit`` (default: the card's, or no limit on the CPU, whose
    plain version takes no routes) and ``force_global`` choose each item's
    route as in :func:`round_layout`.  An item's ``err`` raises.

    Returns the run's split, also kept in ``wf_ed_lockstep.last``: rounds,
    items per round, bytes uploaded and read back, host seconds in
    layout, pack (with growing the buffers), the round trip (upload,
    launch, read-back, synchronise) and unpack, items on the global
    route, the kernel's work as ``driver.work()`` counts it
    (``WORK_KEYS``); with ``wf_ed_lockstep.events`` set on a card, the
    upload, kernel and read-back device times in ms (CUDA events)."""
    dev = _device_of(device)
    buf = _bufs.get(dev)
    if buf is None:
        buf = _bufs[dev] = _Buffers(dev)
    card = dev.type == "cuda"
    if smem_limit is None:
        smem_limit = _smem_limit_of(_load(), dev) if card else _I32_MAX
    timed = card and wf_ed_lockstep.events
    split = dict(rounds=0, items=[], in_bytes=0, out_bytes=0, n_global=0, layout_s=0.0,
                 pack_s=0.0, trip_s=0.0, unpack_s=0.0, upload_ms=0.0, kernel_ms=0.0,
                 readback_ms=0.0, seq_bytes=0, wave_in=0, wave_out=0, wave_cells=0.0)
    wf_ed_lockstep.last = split
    clock = time.perf_counter
    while True:
        t0 = clock()
        shape = driver.layout(smem_limit, force_global)
        t1 = clock()
        split["layout_s"] += t1 - t0
        if shape.B == 0:
            split.update(zip(WORK_KEYS, driver.work()))
            return split
        buf.ensure(shape.in_words, shape.out_words, shape.scratch_words)
        h_in, h_out = buf.h_in[: shape.in_words], buf.h_out[: shape.out_words]
        driver.pack(h_in.numpy(), shape)
        t2 = clock()
        d_in, d_out = buf.d_in[: shape.in_words], buf.d_out[: shape.out_words]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if timed else None
        if card:
            if timed:
                ev[0].record()
            d_in.copy_(h_in, non_blocking=True)
            if timed:
                ev[1].record()
        wf_ed_core_ragged(d_in, d_out, shape.B, shape.smem,
                          buf.d_scr if shape.scratch_words else None)
        if card:
            if timed:
                ev[2].record()
            h_out.copy_(d_out, non_blocking=True)
            if timed:
                ev[3].record()
            torch.cuda.current_stream(dev).synchronize()
        t3 = clock()
        wf_ed_core_rounds.rounds += 1
        o = h_out.numpy()
        bad = driver.unpack(o, shape)
        if bad >= 0:
            w = h_in.numpy()
            meta = w[shape.B * DESC_WORDS + 8 * bad:][:7].tolist()
            desc = w[bad * DESC_WORDS:][:DESC_WORDS]
            raise _item_failed(bad, shape.B, int(o[desc[4] + 6]), meta, int(desc[7]))
        split["unpack_s"] += clock() - t3
        split["pack_s"] += t2 - t1
        split["trip_s"] += t3 - t2
        split["rounds"] += 1
        split["items"].append(shape.B)
        split["in_bytes"] += 4 * shape.in_words
        split["out_bytes"] += 4 * shape.out_words
        split["n_global"] += shape.n_global
        if timed:
            split["upload_ms"] += ev[0].elapsed_time(ev[1])
            split["kernel_ms"] += ev[1].elapsed_time(ev[2])
            split["readback_ms"] += ev[2].elapsed_time(ev[3])


wf_ed_lockstep.events = False
wf_ed_lockstep.last = None


def wf_ed_core_device(st) -> None:
    """Advance the wavefront state ``st`` in place on ``st.device``: a
    round of one item."""
    wf_ed_core_rounds([st])
