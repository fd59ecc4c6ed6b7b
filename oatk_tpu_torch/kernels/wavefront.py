"""Landau-Vishkin / Myers O(nd) wavefront edit distance with stepwise
restart (levdist.c analogue).

The diagonal wavefront state (d = query_pos - target_pos, k = target
pos) can be snapshotted and restored so the query may *grow* between
calls -- the property the error-correction DFS relies on
(reference levdist.c:48-440, stepwise API validated by the
reference's LEVDIST_TEST_STEP).

Host cores (NumPy and the shared native C library), and the ``device``
backend: the hand-written CUDA kernel of :mod:`.wf_ed` on
``WfState.device`` (its plain PyTorch version on a CPU device).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class WfState:
    """Mutable wavefront config/state (wf_config_t analogue)."""

    ts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))  # target
    qs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))  # query
    is_ext: bool = True
    bw: int = -1
    score: int = 0
    t_end: int = 0
    q_end: int = 0
    # wavefront: parallel arrays of diagonals
    wd: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    wk: np.ndarray = field(default_factory=lambda: np.full(1, -1, np.int64))
    # optional traceback: per step (d0, packed 2-bit parent codes)
    tb: list | None = None
    # where the 'device' backend runs the core (a torch device or its name)
    device: object = "cpu"

    def reset(self, ts: np.ndarray):
        self.ts = ts
        self.qs = np.zeros(0, np.uint8)
        self.score = 0
        self.t_end = 0
        self.q_end = 0
        self.wd = np.zeros(1, np.int64)
        self.wk = np.full(1, -1, np.int64)

    def snapshot(self):
        return (self.score, self.t_end, self.q_end, self.wd.copy(), self.wk.copy())

    def restore(self, snap):
        self.score, self.t_end, self.q_end, wd, wk = snap
        self.wd = wd.copy()
        self.wk = wk.copy()


def _extend_one(ts: np.ndarray, qs: np.ndarray, dd: int, kk: int) -> int:
    """Extend one diagonal along exact matches (uses vectorized compare)."""
    tl, ql = len(ts), len(qs)
    max_k = min(ql - dd, tl) - 1
    span = max_k - kk
    if span <= 0:
        return kk
    neq = ts[kk + 1 : max_k + 1] != qs[dd + kk + 1 : dd + max_k + 1]
    first = int(np.argmax(neq)) if neq.any() else span
    return kk + first


def wf_step(st: WfState) -> int:
    """One wavefront step; returns -1 when an end is reached (fills
    t_end/q_end as raw -1-based), else the new wavefront size.

    Diagonals extend in order; on the first end hit the step aborts with
    earlier diagonals updated and the hitting one left unextended,
    matching the reference's resumable state exactly."""
    ts, qs = st.ts, st.qs
    tl, ql = len(ts), len(qs)
    d, k = st.wd, st.wk
    n = len(d)

    for j in range(n):
        kj, dj = int(k[j]), int(d[j])
        if kj >= tl or kj + dj >= ql:
            continue
        kk = _extend_one(ts, qs, dj, kj)
        if kk + dj == ql - 1 or kk == tl - 1:
            if st.is_ext or (kk + dj == ql - 1 and kk == tl - 1):
                st.t_end = kk
                st.q_end = kk + dj
                return -1
        k[j] = kk

    # next wave (parent codes: -1 ins/from-left-diag, 0 mismatch, 1 del)
    nd = np.empty(n + 2, np.int64)
    nk = np.empty(n + 2, np.int64)
    npr = np.empty(n + 2, np.int64)
    nd[0] = d[0] - 1
    nk[0] = k[0] + 1
    npr[0] = 1
    nd[1] = d[0]
    npr[1] = 0 if (n == 1 or k[0] > k[1]) else 1
    nk[1] = (k[0] if (n == 1 or k[0] > k[1]) else k[1]) + 1
    if n >= 3:
        a0 = k[:-2]
        a1 = k[1:-1] + 1
        a2 = k[2:] + 1
        pr = np.full(n - 2, -1, np.int64)
        best = a0.copy()
        take1 = best <= a1
        pr[take1] = 0
        best = np.maximum(best, a1)
        take2 = best <= a2
        pr[take2] = 1
        best = np.maximum(best, a2)
        nd[2:n] = d[1 : n - 1]
        nk[2:n] = best
        npr[2:n] = pr
    if n >= 2:
        nd[n] = d[n - 1]
        npr[n] = -1 if k[n - 2] > k[n - 1] + 1 else 0
        nk[n] = max(k[n - 2], k[n - 1] + 1)
    nd[n + 1] = d[n - 1] + 1
    npr[n + 1] = -1
    nk[n + 1] = k[n - 1]

    stt, en = 0, n + 2
    if st.bw < 0 or n < 2 * st.bw + 1:
        if nd[0] < -tl:
            stt += 1
        if nd[n + 1] > ql:
            en -= 1
    else:
        if st.is_ext:
            min_d, max_d = -st.bw, st.bw
        else:
            min_d = (ql - tl - st.bw) if ql < tl else (tl - ql - st.bw)
            max_d = (tl - ql + st.bw) if tl > ql else (ql - tl + st.bw)
        min_d = max(min_d, -tl)
        max_d = max(max_d, ql)
        while nd[stt] < min_d:
            stt += 1
        while nd[en - 1] > max_d:
            en -= 1
    st.wd = nd[stt:en].copy()
    st.wk = nk[stt:en].copy()
    if st.tb is not None:
        st.tb.append((int(nd[stt]), npr[stt:en].copy()))
    return en - stt


def _wf_ed_core_native(st: WfState) -> bool:
    """Dispatch to the C core (native/wavefront.c); returns False when
    the native library is unavailable (caller falls back to numpy).
    The diagonal set is always contiguous (d0..d0+n-1), so state
    converts losslessly at the call boundary."""
    from .. import native

    if not native.available():
        return False
    n = len(st.wk)
    tl, ql = len(st.ts), len(st.qs)
    # diagonals are always trimmed to [-tl, ql] so n <= tl+ql+1
    cap = max(64, tl + ql + 16, n)
    hdr = np.array([st.score, -1, -1, int(st.wd[0]), n], np.int64)
    k = np.empty(cap, np.int64)
    k[:n] = st.wk
    ts = np.ascontiguousarray(st.ts, np.uint8)
    qs = np.ascontiguousarray(st.qs, np.uint8)
    ret = native.wf_ed_core_native(ts, qs, int(st.is_ext), st.bw, hdr, k)
    if ret < 0:  # capacity exceeded (shouldn't happen; be safe)
        return False
    st.score = int(hdr[0])
    nn = int(hdr[4])
    st.wd = hdr[3] + np.arange(nn, dtype=np.int64)
    st.wk = k[:nn].copy()
    if ret == 1:
        st.t_end = int(hdr[1]) + 1
        st.q_end = int(hdr[2]) + 1
    else:
        st.t_end = 0
        st.q_end = 0
    return True


# wavefront core backend: 'auto' = native C with numpy fallback,
# 'numpy' = host reference, 'device' = the wavefront kernel on
# WfState.device (kernels/wf_ed.py; 'pallas' is the JAX package's
# spelling of the same value).  Settable via OATK_TPU_WF_BACKEND; the EC
# DFS goes through wf_ed_core, so 'device' drives the whole error
# correction through the kernel, with no length cap and no fallback.
import os as _os

WF_BACKEND = _os.environ.get("OATK_TPU_WF_BACKEND", "auto")
DEVICE_BACKENDS = ("device", "pallas")


def wf_ed_core(st: WfState):
    """Run wavefront steps until an end is reached or the band is
    exceeded; resumes from the current state (stepwise restart)."""
    if WF_BACKEND in DEVICE_BACKENDS and st.tb is None:
        from .wf_ed import wf_ed_core_device

        wf_ed_core_device(st)
        return
    if WF_BACKEND != "numpy" and st.tb is None and _wf_ed_core_native(st):
        return
    t_end = q_end = -1
    while True:
        na = wf_step(st)
        if na < 0:
            t_end, q_end = st.t_end, st.q_end
            break
        st.score += 1
        if st.bw >= 0 and st.score > st.bw:
            break
    st.t_end = t_end + 1
    st.q_end = q_end + 1


def wf_ed(ts: np.ndarray, qs: np.ndarray, is_ext: bool = True, bw: int = -1):
    """One-shot edit distance; returns (score, t_endl, q_endl)."""
    st = WfState()
    st.reset(np.asarray(ts, np.uint8))
    st.qs = np.asarray(qs, np.uint8)
    st.is_ext = is_ext
    st.bw = bw
    wf_ed_core(st)
    return st.score, st.t_end, st.q_end


# CIGAR ops (htslib codes): 1=I 2=D 7='=' 8=X
def wf_traceback(st: WfState) -> list[tuple[int, int]]:
    """CIGAR traceback [(len, op)] from the recorded step parents
    (requires st.tb enabled before alignment; levdist.c:227-263)."""
    ts, qs = st.ts, st.qs
    cigar: list[list[int]] = []  # [op, len], built reversed

    def push(op, ln):
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += ln
        else:
            cigar.append([op, ln])

    i = st.q_end - 1
    k = st.t_end - 1
    s = len(st.tb) - 1
    while True:
        k0 = k
        while i >= 0 and k >= 0 and qs[i] == ts[k]:
            i -= 1
            k -= 1
        if k0 - k > 0:
            push(7, k0 - k)
        if i < 0 or k < 0:
            break
        d0, codes = st.tb[s]
        j = i - k - d0
        pre = int(codes[j])
        if pre == 0:
            push(8, 1)
            i -= 1
            k -= 1
        elif pre < 0:
            push(1, 1)
            i -= 1
        else:
            push(2, 1)
            k -= 1
        s -= 1
    if i >= 0:
        push(1, i + 1)
    elif k >= 0:
        push(2, k + 1)
    return [(ln, op) for op, ln in reversed(cigar)]


def cigar_string(cigar: list[tuple[int, int]]) -> str:
    return "".join(f"{ln}{'MIDNSHP=XB'[op]}" for ln, op in cigar)
