"""Device syncmer extraction from the loader's upload blob (PyTorch ops
around the selection kernel).

Port of ``oatk_tpu/kernels/syncmer.py:extract_hoco_fused_pallas`` (and
the ``_extract_hoco_packed_impl`` / ``_selected_details`` chain it
runs): decode the blob, mark the Ns, run the closed-syncmer selection
kernel (:mod:`.syncmer_select`), compact the selected positions, then
per selected position the boundary s-mer payload and strand, the 2-bit
window pack, the reverse complement and MurmurHash64A.
:func:`extract_syncmers_ascii` (``OATK_TPU_DEVICE_HOCO``) starts from raw
ASCII rows instead: :func:`hoco_phase` compresses homopolymers on the
device, then the same selection and details run.

What the JAX chain does only to run well on the TPU is not ported: the
sort-funnel compaction (``_compact_sel``/``_compact_funnel``) with its
inflated overflow report, the MXU one-hot N mask and the aligned-block
window gather (``_gather_windows``).  Here compaction is exact
(``torch.nonzero`` in ascending flat order), the N positions are one
index-set, and each window is gathered directly.  ``torch.nonzero`` on a
CUDA tensor synchronises with the host once per chunk.
"""
from __future__ import annotations

import torch

from .._u64 import as_i64, srl
from .hashes import MURMUR_SEED
from .oracle import SEQ_NT4
from .syncmer_select import syncmer_select

_MURMUR_M = as_i64(0xC6A4A7935BD1E995)
_SHIFTS = (6, 4, 2, 0)


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


def extract_hoco_fused(
    blob: torch.Tensor,  # [B*Lp//4 + 4*B + 4*n_cap] uint8: packed | hl(i32) | n_pos(i32)
    B: int,
    Lp: int,
    n_cap: int,
    w: int,
    s: int,
    max_out: int,
) -> torch.Tensor:
    """Packed int64 ``[3, max_out+1]`` result, as the JAX entry point:
    row 0 ``flat<<1|z`` (flat = b*Lp + p, slot ``max_out`` = the EXACT
    n_sel), row 1 the s-mer payload, row 2 the Murmur k-mer hash.  Lanes
    at or past min(n_sel, max_out) are 0; when n_sel > max_out the caller
    regrows max_out and calls again."""
    dev = blob.device
    np_ = B * Lp // 4
    packed = blob[:np_].view(B, Lp // 4)
    hl = blob[np_ : np_ + 4 * B].view(torch.int32)
    n_pos = blob[np_ + 4 * B : np_ + 4 * B + 4 * n_cap].view(torch.int32)

    sh = torch.tensor(_SHIFTS, dtype=torch.uint8, device=dev)
    codes = ((packed.unsqueeze(2) >> sh) & 3).view(B, Lp)
    pos = torch.arange(Lp, dtype=torch.int32, device=dev)
    codes = torch.where(pos < hl.unsqueeze(1), codes, 5).to(torch.uint8)
    # N positions mark ONLY the selection input; the window gather reads
    # only windows the kernel verified N-free.  Pad entries (B*Lp) land
    # in a spare slot that is dropped.
    sel_in = torch.cat([codes.view(-1), codes.new_zeros(1)])
    if n_cap:
        sel_in[n_pos.long()] = 4
    sel_in = sel_in[: B * Lp].view(B, Lp)
    five = codes.new_full((B, 1), 5)
    codes_padded = torch.cat([five, sel_in, five.expand(B, w + 2)], dim=1)
    sel = syncmer_select(codes_padded, w, s)
    hoco_c = torch.where(codes < 4, codes, 0)
    return selected_details(hoco_c, sel, w, s, max_out)


def extract_hoco_rows(codes: torch.Tensor, w: int, s: int, max_out: int) -> torch.Tensor:
    """Syncmer extraction from host-compressed hoco code rows (port of
    ``oatk_tpu/kernels/syncmer.py:extract_hoco_batch_pallas``, the
    sharded loader's route): ``codes`` uint8 ``[b, L]`` holds 0-3 for a
    base, 4 for an N and 5 past the read's end.  Returns the packed
    ``[3, max_out+1]`` of :func:`extract_hoco_fused` (flat = row*L + p)."""
    b = codes.shape[0]
    five = codes.new_full((b, 1), 5)
    sel = syncmer_select(torch.cat([five, codes, five.expand(b, w + 2)], dim=1), w, s)
    return selected_details(torch.where(codes < 4, codes, 0), sel, w, s, max_out)


def hoco_phase(seq: torch.Tensor, lens: torch.Tensor) -> dict:
    """Homopolymer compression on the device (port of
    ``oatk_tpu/kernels/syncmer.py:_hoco_phase``): ASCII ``[B, L]`` uint8
    rows with int32 lengths ``[B]`` -> ``hoco_c`` uint8 ``[B, L]`` (codes
    0-3, an N as 0), ``hoco_l`` int32 ``[B]``, ``ho_rl`` int32 ``[B, L]``
    (run length minus one), ``is_n`` bool ``[B, L]``, and the selection
    masks ``eff_n`` (N or past the hoco end) and ``h_in``.

    Kept raw positions scatter to their hoco index; every other position
    scatters to a spare column L that is dropped (the JAX scatter's
    ``mode="drop"``), so no two writes meet in a kept column."""
    B, L = seq.shape
    dev = seq.device
    nt4 = torch.from_numpy(SEQ_NT4).to(dev)
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    c = torch.where(pos < lens.unsqueeze(1), nt4[seq.long()], 5)
    prev = torch.cat([c.new_full((B, 1), 255), c[:, :-1]], dim=1)
    keep = ((c == 4) | (prev == 4) | (c != prev)) & (c != 5)
    hpos = torch.cumsum(keep, dim=1, dtype=torch.int32) - 1
    last = hpos[torch.arange(B, device=dev), torch.clamp(lens.long() - 1, min=0)]
    hoco_l = torch.where(lens > 0, last + 1, 0).to(torch.int32)
    scat = torch.where(keep, hpos, L).long()
    del hpos, prev

    def scatter(fill, src):
        out = torch.full((B, L + 1), fill, dtype=src.dtype, device=dev)
        return out.scatter_(1, scat, src)[:, :L].contiguous()

    hoco_c = scatter(0, torch.where(c == 4, 0, c).to(torch.uint8))
    is_n = scatter(False, c == 4)
    raw_of = scatter(-1, pos.expand(B, L))
    del scat, c, keep
    nxt_raw = torch.cat([raw_of[:, 1:], raw_of.new_full((B, 1), -1)], dim=1)
    h_in = pos < hoco_l.unsqueeze(1)
    ho_rl = torch.where(
        h_in, torch.where(nxt_raw >= 0, nxt_raw, lens.unsqueeze(1)) - raw_of - 1, 0
    ).to(torch.int32)
    return dict(hoco_c=hoco_c, hoco_l=hoco_l, ho_rl=ho_rl, is_n=is_n,
                eff_n=is_n | ~h_in, h_in=h_in)


def extract_syncmers_ascii(
    seq: torch.Tensor, lens: torch.Tensor, w: int, s: int, max_out: int,
    return_hoco: bool = False,
) -> dict:
    """Syncmer extraction from raw ASCII rows (port of
    ``oatk_tpu/kernels/syncmer.py:extract_syncmers_batch_pallas``): the
    hoco phase, the selection kernel on its codes (4 for an N inside the
    read, 5 past its end), then :func:`selected_details`.  Returns
    ``{"packed": [3, max_out+1]}``, plus the hoco arrays ``hoco_c``,
    ``hoco_l``, ``ho_rl`` and ``is_n`` when ``return_hoco``."""
    B = seq.shape[0]
    h = hoco_phase(seq, lens)
    codes = torch.where(
        h["eff_n"], torch.where(h["h_in"], 4, 5).to(torch.uint8), h["hoco_c"]
    )
    five = codes.new_full((B, 1), 5)
    codes_padded = torch.cat([five, codes, five.expand(B, w + 2)], dim=1)
    del codes
    sel = syncmer_select(codes_padded, w, s)
    del codes_padded
    out = {"packed": selected_details(h["hoco_c"], sel, w, s, max_out)}
    if return_hoco:
        out.update({k: h[k] for k in ("hoco_c", "hoco_l", "ho_rl", "is_n")})
    return out


def selected_details(
    hoco_c: torch.Tensor, sel: torch.Tensor, w: int, s: int, max_out: int
) -> torch.Tensor:
    """Per-selected strand / s-mer payload / Murmur hash from selection
    codes ``sel`` [B, L] (0 none, 1 open, 2 close) -> packed
    ``[3, max_out+1]`` int64."""
    dev = sel.device
    q = w - s + 1
    mask = (1 << (2 * s)) - 1
    flat_sel = sel.view(-1)
    idx = torch.nonzero(flat_sel).squeeze(1)  # ascending flat order; syncs
    n_sel = idx.shape[0]
    idx = idx[:max_out]
    n = idx.shape[0]
    oc = flat_sel[idx]

    # every selected window [p, p+w) lies inside its read (the kernel
    # checked it N- and pad-free), so a strided view gathers it directly
    win = hoco_c.view(-1).unfold(0, w, 1)[idx]  # [n, w] uint8
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

    out = torch.zeros((3, max_out + 1), dtype=torch.int64, device=dev)
    out[0, :n] = (idx << 1) | z.long()
    out[0, max_out] = n_sel
    out[1, :n] = payload
    out[2, :n] = khash
    return out
