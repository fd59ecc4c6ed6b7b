"""Device syncmer extraction: the selection kernel and the kernels
around it, chained per chunk.

Port of ``oatk_tpu/kernels/syncmer.py:extract_hoco_fused_pallas`` (and
the ``_extract_hoco_packed_impl`` / ``_selected_details`` chain it
runs): the blob decode (:func:`.syncmer_details.decode_blob`, K3d), the
closed-syncmer selection (:mod:`.syncmer_select`, K1), then the ordered
compaction and per selected position the boundary s-mer payload and
strand, the 2-bit window pack, the reverse complement and MurmurHash64A
(:func:`.syncmer_details.selected_details`, K4).  On a card a chunk is
four launches at most (K3d one or two, K1, K4) and no host read; the
caller reads n_sel once.  :func:`extract_hoco_fused_keys` runs the same
chain but has K4 write the device count's key lanes itself;
:func:`select_keys` is its K1 -> K4 part, for rows that K3d laid out
already (the loader decodes a whole unit of reads in one K3d call,
:func:`.syncmer_details.decode_rows`, then selects per length bucket).
:func:`extract_hoco_rows` (``--shards``) starts from host-compressed
code rows and :func:`extract_syncmers_ascii` (``OATK_TPU_DEVICE_HOCO``,
K11) from raw ASCII rows: :func:`hoco_phase` compresses homopolymers on
the device, then the same selection and details run.
"""
from __future__ import annotations

import torch

from .oracle import SEQ_NT4
from .syncmer_details import decode_blob, selected_details, selected_keys
from .syncmer_select import syncmer_select


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
    codes_padded = decode_blob(blob, B, Lp, n_cap, w)
    return selected_details(codes_padded, syncmer_select(codes_padded, w, s), w, s, max_out)


def extract_hoco_fused_keys(
    blob: torch.Tensor,
    B: int,
    Lp: int,
    n_cap: int,
    w: int,
    s: int,
    max_out: int,
    sids: torch.Tensor,  # [>= rows with reads] int64 read id of each row
    bufs,  # the device count's (hash, low, smer, m32, invalid) buffers
    off: int,
) -> torch.Tensor:
    """The chain of :func:`extract_hoco_fused` with the keys written
    straight into lanes ``[off, off+max_out)`` of the device count's
    buffers (:func:`.syncmer_details.selected_keys`): no packed result is
    made.  Returns the EXACT n_sel as a one-element int64 tensor on the
    device; when n_sel > max_out the caller regrows max_out and writes
    the same lanes again."""
    return select_keys(decode_blob(blob, B, Lp, n_cap, w), w, s, max_out, sids, bufs, off)


def select_keys(codes_padded: torch.Tensor, w: int, s: int, max_out: int, sids: torch.Tensor,
                bufs, off: int) -> torch.Tensor:
    """K1 and K4 of :func:`extract_hoco_fused_keys` over rows already
    decoded (``codes_padded`` ``[B, 1+L+w+2]``): the keys in lanes
    ``[off, off+max_out)``, the exact n_sel as a device tensor."""
    return selected_keys(codes_padded, syncmer_select(codes_padded, w, s), w, s, max_out,
                         sids, bufs, off)


def extract_hoco_rows(codes: torch.Tensor, w: int, s: int, max_out: int) -> torch.Tensor:
    """Syncmer extraction from host-compressed hoco code rows (port of
    ``oatk_tpu/kernels/syncmer.py:extract_hoco_batch_pallas``, the
    sharded loader's route): ``codes`` uint8 ``[b, L]`` holds 0-3 for a
    base, 4 for an N and 5 past the read's end.  Returns the packed
    ``[3, max_out+1]`` of :func:`extract_hoco_fused` (flat = row*L + p)."""
    b = codes.shape[0]
    five = codes.new_full((b, 1), 5)
    codes_padded = torch.cat([five, codes, five.expand(b, w + 2)], dim=1)
    return selected_details(codes_padded, syncmer_select(codes_padded, w, s), w, s, max_out)


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
    out = {"packed": selected_details(codes_padded, sel, w, s, max_out)}
    if return_hoco:
        out.update({k: h[k] for k in ("hoco_c", "hoco_l", "ho_rl", "is_n")})
    return out

