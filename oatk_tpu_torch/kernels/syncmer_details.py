"""The extraction chain around the selection kernel: the upload blob's
decode (K3d) and the ordered compaction with the per-selected details
(K4), each as a hand-written CUDA kernel with its build, binding and
plain PyTorch version.

Counterparts of two parts of the JAX package's one device program per
chunk (``oatk_tpu/kernels/syncmer.py:extract_hoco_fused_pallas``): the
blob decode and N mark of ``_extract_hoco_packed_impl`` and
``_selected_details``; on the key route also the device count's
per-chunk key decode (``oatk_tpu/index/devcount.py`` ``keys_jit`` and
``write_jit``).  The kernel source is ``csrc/syncmer_details.cu`` (its
header notes the design and what bounds it), compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into the git-ignored
``build/kernels/`` directory at the repository root and loaded with
ctypes.

- :func:`decode_rows`: K3d as a row gather.  2-bit packed reads in a
  stream (row r's bases from byte ``row_off[r]`` on, ``hl[r]`` of them),
  cut into length buckets ``(row0, B, Lp)`` of consecutive table rows ->
  the selection kernel's input ``codes_padded`` uint8 ``[B, 1+Lp+w+2]``
  per bucket (0-3 a base, 4 an N, 5 pad and past each read's end), all in
  one launch (two with Ns): the loader's key route lays out a whole unit
  of parse segments this way.
- :func:`decode_blob`: the same kernel on the packed route's padded blob
  ``[B*Lp/4 | hl i32[B] | n_pos i32[n_cap]]``, row b at ``b*Lp/4``.
- :func:`selected_details`: ``codes_padded`` and the selection codes
  ``sel`` int32 ``[B, L]`` -> the packed int64 ``[3, max_out+1]``: row 0
  ``flat<<1|z`` (flat = b*L + p, ascending), row 1 the s-mer payload,
  row 2 the Murmur k-mer hash; slot ``[0, max_out]`` the exact n_sel,
  lanes at or past min(n_sel, max_out) 0.
- :func:`selected_keys`: the same selections written straight into the
  device count's five carry buffers at an offset, lane for lane what
  ``index/devcount.py:chunk_keys`` decodes from the packed result; the
  exact n_sel comes back as a one-element device tensor.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises, nothing falls back.  ``decode_rows.launches``,
``decode_blob.launches``, ``selected_details.launches`` and
``selected_keys.launches`` count kernel launches (the decode makes two
when it has N positions to mark, K4 one per call), and nothing else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .._u64 import as_i64, srl
from ..utils.trace import once
from . import cuda_build
from .hashes import MURMUR_SEED

_SRC = cuda_build.source("syncmer_details.cu")
_SO = f"{cuda_build.SO_DIR}/libsyncmer_details.so"

_MURMUR_M = as_i64(0xC6A4A7935BD1E995)
_SHIFTS = (6, 4, 2, 0)
KBUCKETS = 32  # csrc/syncmer_details.cu:kBuckets, K3d's buckets a launch
DETAILS_LAUNCHES = 1  # K4: compaction and details in one launch

_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile the kernels if needed; returns the compiler's report."""
    return cuda_build.build(_SRC, _SO)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            with once("syncmer_details"):
                build()
                lib = ctypes.CDLL(_SO)
                lib.syncmer_decode_launch.restype = ctypes.c_int
                i64p, i32p = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
                lib.syncmer_decode_launch.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, i64p, i64p,
                    i32p, i64p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
                lib.syncmer_details_launch.restype = ctypes.c_int
                lib.syncmer_details_launch.argtypes = (
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_longlong]
                    + [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                )
                lib.syncmer_details_tiles.restype = ctypes.c_longlong
                lib.syncmer_details_tiles.argtypes = [ctypes.c_longlong, ctypes.c_int]
                _lib = lib
    return _lib


def _device_of(name: str, *tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for tensors that share one device; raises for any
    other device or a mix."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError(f"{name}: tensors on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _check_blob(blob: torch.Tensor, B: int, Lp: int, n_cap: int, w: int) -> None:
    if blob.dtype != torch.uint8 or blob.dim() != 1:
        raise TypeError(f"decode_blob: blob must be 1-D uint8, got {blob.dtype} {tuple(blob.shape)}")
    if not blob.is_contiguous():
        raise ValueError("decode_blob: blob must be contiguous")
    if B < 0 or Lp < 0 or (B * Lp) % 16 or n_cap < 0 or w < 1:
        # B*Lp/4 packed bytes, a multiple of 4: the int32 fields that
        # follow are 4-byte aligned in the blob
        raise ValueError(f"decode_blob: bad sizes B={B} Lp={Lp} n_cap={n_cap} w={w}")
    need = B * Lp // 4 + 4 * B + 4 * n_cap
    if blob.numel() < need:
        raise ValueError(f"decode_blob: blob of {blob.numel()} B is shorter than {need} B")


def _launch_decode(src, row_off_ptr: int, hl_ptr: int, buckets, offs, n32_ptr: int,
                   n64_ptr: int, n_cap: int, w: int, out: torch.Tensor) -> None:
    """One K3d call (``csrc/syncmer_details.cu:syncmer_decode_launch``)
    over ``buckets`` (row0, B, Lp) with their output offsets ``offs``."""
    lib = _load()
    nb = len(buckets)
    row0 = (ctypes.c_longlong * nb)(*(int(b[0]) for b in buckets))
    rows = (ctypes.c_longlong * nb)(*(int(b[1]) for b in buckets))
    lps = (ctypes.c_int * nb)(*(int(b[2]) for b in buckets))
    oo = (ctypes.c_longlong * nb)(*(int(o) for o in offs))
    with torch.cuda.device(out.device):
        rc = lib.syncmer_decode_launch(src.data_ptr(), row_off_ptr or None, hl_ptr, nb, row0, rows,
                                       lps, oo, n32_ptr or None, n64_ptr or None, n_cap, w,
                                       out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"syncmer decode kernel launch failed: CUDA error {rc}")


def decode_blob(blob: torch.Tensor, B: int, Lp: int, n_cap: int, w: int) -> torch.Tensor:
    """``codes_padded`` uint8 ``[B, 1+Lp+w+2]`` from an upload blob."""
    _check_blob(blob, B, Lp, n_cap, w)
    if _device_of("decode_blob", blob) == "cpu":
        return decode_blob_plain(blob, B, Lp, n_cap, w)
    if blob.data_ptr() % 4:
        raise ValueError("decode_blob: a CUDA blob must start 4-byte aligned (its int32 fields)")
    out = torch.empty((B, 1 + Lp + w + 2), dtype=torch.uint8, device=blob.device)
    if B == 0:
        return out  # nothing to launch
    p = blob.data_ptr()
    _launch_decode(blob, 0, p + B * Lp // 4, [(0, B, Lp)], [0],
                   p + B * Lp // 4 + 4 * B if n_cap else 0, 0, n_cap, w, out)
    decode_blob.launches += 2 if n_cap else 1
    return out


decode_blob.launches = 0


def decode_blob_plain(blob: torch.Tensor, B: int, Lp: int, n_cap: int, w: int) -> torch.Tensor:
    """Plain PyTorch version of the decode: unpack, 5 past each read's
    end, 4 at every N position (the pad entries B*Lp land in a spare slot
    that is dropped), pad columns."""
    np_ = B * Lp // 4
    packed = blob[:np_].view(B, Lp // 4)
    hl = blob[np_ : np_ + 4 * B].view(torch.int32)
    n_pos = blob[np_ + 4 * B : np_ + 4 * B + 4 * n_cap].view(torch.int32)
    codes = _unpack_rows(packed, hl, Lp)
    sel_in = torch.cat([codes.view(-1), codes.new_zeros(1)])
    if n_cap:
        sel_in[n_pos.long()] = 4
    return _pad_columns(sel_in[: B * Lp].view(B, Lp), w)


def _unpack_rows(packed: torch.Tensor, hl: torch.Tensor, Lp: int) -> torch.Tensor:
    """[B, Lp/4] packed bytes -> [B, Lp] codes, 5 from each row's hl on."""
    sh = torch.tensor(_SHIFTS, dtype=torch.uint8, device=packed.device)
    codes = ((packed.unsqueeze(2) >> sh) & 3).view(packed.shape[0], Lp)
    pos = torch.arange(Lp, dtype=torch.int32, device=packed.device)
    return torch.where(pos < hl.unsqueeze(1), codes, 5).to(torch.uint8)


def _pad_columns(codes: torch.Tensor, w: int) -> torch.Tensor:
    """A 5 before each row and w+2 after it."""
    five = codes.new_full((codes.shape[0], 1), 5)
    return torch.cat([five, codes, five.expand(codes.shape[0], w + 2)], dim=1)


def rows_layout(buckets, w: int) -> tuple[list[int], int]:
    """Where :func:`decode_rows` puts each bucket's ``[B, 1+Lp+w+2]``
    output in its one buffer: (byte offsets, each a multiple of 16; the
    buffer's size)."""
    offs, at = [], 0
    for _row0, B, Lp in buckets:
        offs.append(at)
        at += -(-B * (1 + Lp + w + 2) // 16) * 16
    return offs, at


def _check_rows(stream, row_off, hl, buckets, n_rows, w) -> None:
    if stream.dtype != torch.uint8 or stream.dim() != 1 or not stream.is_contiguous():
        raise TypeError(f"decode_rows: stream must be contiguous 1-D uint8, got {stream.dtype} "
                        f"{tuple(stream.shape)}")
    for t, dt, name in ((row_off, torch.int64, "row_off"), (hl, torch.int32, "hl"),
                        (n_rows, torch.int64, "n_rows")):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"decode_rows: {name} must be contiguous 1-D {dt}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if row_off.numel() != hl.numel() or w < 1:
        raise ValueError(f"decode_rows: {row_off.numel()} row offsets, {hl.numel()} lengths, w={w}")
    for row0, B, Lp in buckets:
        if row0 < 0 or B < 0 or row0 + B > hl.numel() or Lp < 0 or Lp % 4:
            raise ValueError(f"decode_rows: bad bucket rows [{row0}, {row0 + B}) of {hl.numel()}, "
                             f"Lp={Lp}")


def decode_rows(stream: torch.Tensor, row_off: torch.Tensor, hl: torch.Tensor, buckets,
                n_rows: torch.Tensor, w: int) -> list[torch.Tensor]:
    """``codes_padded`` uint8 ``[B, 1+Lp+w+2]`` for each bucket ``(row0, B,
    Lp)`` of the row table: row ``row0 + b``'s bases are the 2-bit codes
    from byte ``row_off[row0+b]`` of ``stream`` on (base 4j in bits 7-6 of
    byte j), ``hl[row0+b] <= Lp`` of them; each entry ``r<<32 | p`` of
    ``n_rows`` marks column p of table row r as an N.  On a card the
    outputs are views of one buffer laid out by :func:`rows_layout`, and
    the stream must hold 8 bytes past each row's last packed byte."""
    _check_rows(stream, row_off, hl, buckets, n_rows, w)
    if _device_of("decode_rows", stream, row_off, hl, n_rows) == "cpu":
        return decode_rows_plain(stream, row_off, hl, buckets, n_rows, w)
    if stream.data_ptr() % 4 or hl.data_ptr() % 4:
        raise ValueError("decode_rows: a CUDA stream and its lengths must start 4-byte aligned")
    offs, size = rows_layout(buckets, w)
    out = torch.empty(size, dtype=torch.uint8, device=stream.device)
    n_cap = n_rows.numel()
    if any(B for _r, B, _l in buckets):
        _launch_decode(stream, row_off.data_ptr(), hl.data_ptr(), buckets, offs, 0,
                       n_rows.data_ptr() if n_cap else 0, n_cap, w, out)
        decode_rows.launches += (2 if n_cap else 1) * -(-len(buckets) // KBUCKETS)
    return [out[o : o + B * (1 + Lp + w + 2)].view(B, 1 + Lp + w + 2)
            for o, (_r, B, Lp) in zip(offs, buckets)]


decode_rows.launches = 0


def decode_rows_plain(stream: torch.Tensor, row_off: torch.Tensor, hl: torch.Tensor, buckets,
                      n_rows: torch.Tensor, w: int) -> list[torch.Tensor]:
    """Plain PyTorch version of the row gather: each bucket's rows
    gathered from the stream as packed ``[B, Lp/4]``, then the blob
    decode's unpack, read-end mask, N marks and pad columns."""
    dev = stream.device
    out = []
    nr = n_rows.long()
    # rows that end near the stream's end read zeros past it
    src = torch.cat([stream, stream.new_zeros(max((Lp // 4 for _r, _b, Lp in buckets), default=0))])
    for row0, B, Lp in buckets:
        ro = row_off[row0 : row0 + B]
        packed = src[ro.unsqueeze(1) + torch.arange(Lp // 4, device=dev)]
        codes = _unpack_rows(packed, hl[row0 : row0 + B], Lp)
        b, p = (nr >> 32) - row0, nr & 0xFFFFFFFF
        hit = (b >= 0) & (b < B) & (p < Lp)
        codes.view(-1)[b[hit] * Lp + p[hit]] = 4
        out.append(_pad_columns(codes, w))
    return out


def _check_details(codes_padded: torch.Tensor, sel: torch.Tensor, w: int, s: int,
                   max_out: int) -> tuple[int, int]:
    """Validate the arguments; returns (B, L)."""
    if codes_padded.dtype != torch.uint8 or sel.dtype != torch.int32:
        raise TypeError(f"selected_details: need uint8 codes_padded and int32 sel, got "
                        f"{codes_padded.dtype} and {sel.dtype}")
    if codes_padded.dim() != 2 or sel.dim() != 2:
        raise ValueError(f"selected_details: need 2-D tensors, got {tuple(codes_padded.shape)} "
                         f"and {tuple(sel.shape)}")
    if not 1 <= s <= 31 or w < s:
        raise ValueError(f"need 1 <= s <= 31 and w >= s, got w={w} s={s}")
    B, L = sel.shape
    if tuple(codes_padded.shape) != (B, 1 + L + w + 2):
        raise ValueError(f"selected_details: codes_padded {tuple(codes_padded.shape)} does not "
                         f"match sel {(B, L)} at w={w} (need [B, 1+L+w+2])")
    if not codes_padded.is_contiguous() or not sel.is_contiguous():
        raise ValueError("selected_details: codes_padded and sel must be contiguous")
    if max_out < 0:
        raise ValueError(f"selected_details: max_out={max_out}")
    return B, L


_status_lock = threading.Lock()
_status_bufs: dict = {}


def _status(device: torch.device, n_tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's status words (one per tile) and its three counters on the
    current stream of ``device``: zero when made, and every launch that
    runs to its end leaves them zero.  Kept per (device, stream), since
    launches on one stream never overlap; grown by doubling."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    with _status_lock:
        st = _status_bufs.get(key)
        if st is None or st[0].numel() < n_tiles:
            cap = max(n_tiles, 2 * st[0].numel() if st is not None else 1024)
            st = (torch.zeros(cap, dtype=torch.int64, device=device),
                  torch.zeros(4, dtype=torch.int32, device=device))
            _status_bufs[key] = st
        return st


def _launch_details(codes_padded, sel, w, s, max_out, packed=None, keys=None, off=0, n_sel=None,
                    sids=None) -> None:
    B, L = sel.shape
    lib = _load()
    dev = sel.device
    with torch.cuda.device(dev):
        status, ctr = _status(dev, int(lib.syncmer_details_tiles(B, L)))
        # lane off of each key buffer, by address (no view per call)
        ptrs = [0] * 5 if keys is None else [k.data_ptr() + off * k.element_size() for k in keys]
        rc = lib.syncmer_details_launch(
            codes_padded.data_ptr(), sel.data_ptr(), B, L, w, s, max_out,
            0 if packed is None else packed.data_ptr(), *ptrs,
            0 if n_sel is None else n_sel.data_ptr(), 0 if sids is None else sids.data_ptr(),
            0 if sids is None else sids.numel(), status.data_ptr(), ctr.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"syncmer details kernel launch failed: CUDA error {rc}")


def selected_details(codes_padded: torch.Tensor, sel: torch.Tensor, w: int, s: int,
                     max_out: int) -> torch.Tensor:
    """Packed int64 ``[3, max_out+1]`` of the selected positions."""
    _check_details(codes_padded, sel, w, s, max_out)
    if _device_of("selected_details", codes_padded, sel) == "cpu":
        return selected_details_plain(codes_padded, sel, w, s, max_out)
    out = torch.empty((3, max_out + 1), dtype=torch.int64, device=sel.device)
    _launch_details(codes_padded, sel, w, s, max_out, packed=out)
    selected_details.launches += DETAILS_LAUNCHES
    return out


selected_details.launches = 0


def _check_keys(sids: torch.Tensor, bufs, off: int, max_out: int) -> None:
    if sids.dtype != torch.int64 or sids.dim() != 1 or sids.numel() < 1 or not sids.is_contiguous():
        raise ValueError(f"selected_keys: sids must be a non-empty contiguous 1-D int64 tensor, "
                         f"got {sids.dtype} {tuple(sids.shape)}")
    if len(bufs) != 5:
        raise ValueError(f"selected_keys: need five key buffers, got {len(bufs)}")
    want = (torch.int64,) * 4 + (torch.int32,)
    for buf, dt in zip(bufs, want):
        if buf.dtype != dt or buf.dim() != 1 or not buf.is_contiguous():
            raise ValueError(f"selected_keys: key buffers must be contiguous 1-D "
                             f"(int64 x4, int32), got {buf.dtype} {tuple(buf.shape)}")
        if off < 0 or off + max_out > buf.numel():
            raise ValueError(f"selected_keys: lanes [{off}, {off + max_out}) outside a buffer "
                             f"of {buf.numel()}")


def selected_keys(codes_padded: torch.Tensor, sel: torch.Tensor, w: int, s: int, max_out: int,
                  sids: torch.Tensor, bufs, off: int) -> torch.Tensor:
    """Write the selections' key lanes (hash, low, smer, m32, invalid) into
    lanes ``[off, off+max_out)`` of the device count's buffers ``bufs``,
    row b's read id being ``sids[b]``; returns the exact n_sel as an int64
    tensor of one element on the buffers' device."""
    _check_details(codes_padded, sel, w, s, max_out)
    _check_keys(sids, bufs, off, max_out)
    if _device_of("selected_keys", codes_padded, sel, sids, *bufs) == "cpu":
        return selected_keys_plain(codes_padded, sel, w, s, max_out, sids, bufs, off)
    n_sel = torch.empty(1, dtype=torch.int64, device=sel.device)
    _launch_details(codes_padded, sel, w, s, max_out, keys=bufs, off=off, n_sel=n_sel, sids=sids)
    selected_keys.launches += DETAILS_LAUNCHES
    return n_sel


selected_keys.launches = 0


def selected_keys_plain(codes_padded: torch.Tensor, sel: torch.Tensor, w: int, s: int,
                        max_out: int, sids: torch.Tensor, bufs, off: int) -> torch.Tensor:
    """Plain PyTorch version of the key route: the device count's decode
    (``index/devcount.py:chunk_keys``) of the packed result, written into
    the buffers."""
    from ..index import devcount

    packed = selected_details_plain(codes_padded, sel, w, s, max_out)
    for buf, k in zip(bufs, devcount.chunk_keys(packed, sids, sel.shape[1])):
        buf[off : off + max_out] = k
    return packed[0, max_out:].clone()


def murmur64_rows(blocks: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """MurmurHash64A (seed 1234) over rows of little-endian 64-bit blocks
    held as int64 bit patterns; int64 multiply wraps like uint64."""
    m = _MURMUR_M
    n_full = n_bytes >> 3
    h0 = as_i64(int(MURMUR_SEED) ^ ((n_bytes * 0xC6A4A7935BD1E995) & ((1 << 64) - 1)))
    h = torch.full((blocks.shape[0],), h0, dtype=torch.int64, device=blocks.device)
    for i in range(n_full):
        k = blocks[:, i] * m
        k = k ^ srl(k, 47)
        h = (h ^ (k * m)) * m
    if n_bytes & 7:
        h = (h ^ blocks[:, n_full]) * m
    h = h ^ srl(h, 47)
    h = h * m
    return h ^ srl(h, 47)


def pack_windows(win: torch.Tensor, w: int) -> torch.Tensor:
    """[N, w] 2-bit codes (uint8) -> [N, nblk] int64 Murmur blocks: byte j
    holds bases 4j..4j+3 with base 4j in bits 7-6, zero-padded past
    ceil(w/4) bytes; block i is the little-endian read of bytes 8i..8i+7
    (the reference's in-memory layout)."""
    n = win.shape[0]
    n_bytes = (w - 1) // 4 + 1
    nblk = -(-n_bytes // 8)
    padded = torch.zeros((n, nblk * 32), dtype=torch.uint8, device=win.device)
    padded[:, :w] = win
    quads = padded.view(n, nblk * 8, 4)
    by = (quads[..., 0] << 6) | (quads[..., 1] << 4) | (quads[..., 2] << 2) | quads[..., 3]
    return by.contiguous().view(torch.int64)


def selected_details_plain(codes_padded: torch.Tensor, sel: torch.Tensor, w: int, s: int,
                           max_out: int) -> torch.Tensor:
    """Plain PyTorch version of the compaction and details: exact
    ``torch.nonzero`` compaction (ascending flat order; on a CUDA tensor
    it synchronises with the host), then per selected position its
    window gathered from ``codes_padded`` (column 1 + p on, ``& 3``), the
    boundary s-mer payload and strand, the 2-bit pack of the oriented
    window and MurmurHash64A."""
    B, L = _check_details(codes_padded, sel, w, s, max_out)
    dev = sel.device
    q = w - s + 1
    mask = (1 << (2 * s)) - 1
    flat_sel = sel.view(-1)
    idx = torch.nonzero(flat_sel).squeeze(1)  # ascending flat order
    n_sel = idx.shape[0]
    idx = idx[:max_out]
    n = idx.shape[0]
    out = torch.zeros((3, max_out + 1), dtype=torch.int64, device=dev)
    out[0, max_out] = n_sel
    if n == 0:
        return out
    oc = flat_sel[idx]

    # every selected window [p, p+w) lies inside its read (the selection
    # kernel checked it N- and pad-free), so a strided view gathers it
    b = idx // L
    start = b * codes_padded.shape[1] + 1 + (idx - b * L)
    win = codes_padded.view(-1).unfold(0, w, 1)[start] & 3  # [n, w] uint8
    sm = torch.where((oc == 1).unsqueeze(1), win[:, :s], win[:, q - 1 : q - 1 + s]).long()
    j = torch.arange(s, dtype=torch.int64, device=dev)
    fwd = (sm << (2 * (s - 1 - j))).sum(1) & mask
    rev = ((3 - sm) << (2 * j)).sum(1) & mask
    z = fwd > rev
    payload = (torch.minimum(fwd, rev) << 1) | z.long()
    payload = torch.where(oc == 2, payload ^ 1, payload)

    # Murmur identity over the oriented k-mer window: forward when z = 0,
    # else its reverse complement
    oriented = torch.where(z.unsqueeze(1), 3 - win.flip(1), win)
    khash = murmur64_rows(pack_windows(oriented, w), (w - 1) // 4 + 1)

    out[0, :n] = (idx << 1) | z.long()
    out[1, :n] = payload
    out[2, :n] = khash
    return out
