"""Device-resident syncmer counting (PyTorch port of
``oatk_tpu/index/devcount.py``).

The reference's HOT LOOP 2 is a global sort of 128-bit
(kmerhash<<64 | sid<<32 | idx<<1 | rev) keys plus per-cluster collision
resolution (reference syncmer.c:1397-1451).  As in the JAX
package, every extraction chunk appends its (hash, low, smer, m32,
invalid) key lanes to device carry buffers, and ONE finalize

- sorts by (invalid, hash, low) -- the reference's total key order --
  as stable ``argsort`` passes from the least significant key up, on
  unsigned keys (:mod:`.._u64`: values are int64 bit patterns);
- assigns dense syncmer ids over cluster starts, counts s-mer payload
  mismatches against the cluster head (hash collisions, ``n_susp``) and
  compacts the head (hash, smer) pairs;
- re-sorts ids to per-read flat order (ascending ``low``) and compacts
  the read starts;
- sort-reduces the canonical adjacent-pair keys ``cv0<<32|cv1`` (sorted
  as unsigned) into unique keys and counts for the graph builder.

:meth:`DevCountState.build` fetches the results and assembles the
SyncmerDB on the host with the JAX package's own numpy code
(``_restore_read_views`` and ``_build_db_from_gid`` are carried, but
that the main route hands the reads' syncmer flats whole to the
loader's record table instead of making a view per read).  Arrays
handed to host code carry the JAX path's numpy dtypes: uint64 hashes,
smers, lows and pair keys, uint32 m32, int32 gid.

The finalize uses exact-size boolean compaction where the JAX program
sorted fixed-capacity buffers, so its outputs are the valid prefixes of
the JAX outputs.  It comes in two parts: :func:`finalize_sorted` (the
three sort passes over every lane, no host read), which the loader
queues before it assembles the reads on the host, and
:func:`finalize_compact` (the rest over the valid lanes, whose number
the loader knows from its n_sel drain, with one read of three counts),
which :meth:`DevCountState.build` runs.
"""
from __future__ import annotations

import numpy as np
import torch

from .._u64 import from_numpy_u64, srl, to_numpy_u64, ukey


def chunk_keys(packed: torch.Tensor, sids: torch.Tensor, Lp: int):
    """Decode one chunk's packed ``[3, max_out+1]`` result into max_out
    key lanes: (hash, low = sid<<32|idx<<1|z, smer, m32 = pos<<1|z,
    invalid).  The plain version of the key route
    (``kernels/syncmer_details.py:selected_keys``), whose kernel writes
    the same lanes itself; the card's loader does not call it."""
    dev = packed.device
    max_out = packed.shape[1] - 1
    B = sids.shape[0]
    n_sel = packed[0, max_out]
    lane = torch.arange(max_out, dtype=torch.int64, device=dev)
    valid = lane < torch.clamp(n_sel, max=max_out)
    flat = packed[0, :max_out]
    z = flat & 1
    fi = flat >> 1  # non-negative: arithmetic shift is exact
    b = fi // Lp
    # rank within read: first lane with the same row (selected rows are
    # ascending; invalid lanes map to sentinel B so they group last)
    bkey = torch.where(valid, b, B)
    first = torch.searchsorted(bkey, bkey)
    idx = lane - first
    sid = sids[torch.clamp(b, 0, B - 1)]
    low = (sid << 32) | (idx << 1) | z
    m32 = ((fi % Lp) << 1) | z
    vinv = torch.where(valid, 0, 1).to(torch.int32)
    return packed[2, :max_out], low, packed[1, :max_out], m32, vinv


def finalize_sorted(bh, bl, bs, bm, bv):
    """The finalize's sorts, queued with no host read: the lane order by
    (invalid, hash, low) -- stable ``argsort`` passes, least significant
    key first, unsigned comparisons through ``ukey`` -- which puts the
    valid lanes first, and their number as a device tensor.
    :func:`finalize_compact` takes it from there."""
    order = torch.sort(ukey(bl), stable=True).indices
    order = order[torch.sort(ukey(bh[order]), stable=True).indices]
    order = order[torch.sort(bv[order], stable=True).indices]
    return (bh, bl, bs, bm, order, (bv == 0).sum())


def finalize_compact(part, n_tot: int | None = None):
    """The rest of the finalize over :func:`finalize_sorted`'s result,
    for ``n_tot`` valid lanes (read from the device when not given).
    Returns exact-size tensors (gid_flat, m32_flat, rs_sid, rs_pos, hh,
    hs, h1, l1, s1, scalars, pk_u, pcnt): the valid prefixes of the JAX
    finalize's outputs; ``scalars[0]`` is the device's own count of
    valid lanes, which the caller holds against ``n_tot``."""
    bh, bl, bs, bm, order, n_valid = part
    if n_tot is None:
        n_tot = int(n_valid)
    order = order[:n_tot]
    h1, l1, s1, m1 = bh[order], bl[order], bs[order], bm[order]
    dev = bh.device
    i = torch.arange(n_tot, dtype=torch.int64, device=dev)

    f = torch.ones(n_tot, dtype=torch.bool, device=dev)
    f[1:] = h1[1:] != h1[:-1]
    gid = torch.cumsum(f, 0) - 1
    head = torch.cummax(torch.where(f, i, -1), 0).values
    # one read: the device's valid count, the clusters, the collisions
    n_dev, n_scm, n_susp = torch.stack([n_valid, f.sum(), (s1 != s1[head]).sum()]).tolist()
    hh, hs = h1[f], s1[f]

    # back to per-read flat order (= ascending low; lows are unique)
    o2 = torch.sort(ukey(l1)).indices
    lf, gid_flat, m32_flat = l1[o2], gid[o2], m1[o2]
    sidf = srl(lf, 32)
    fr = torch.ones(n_tot, dtype=torch.bool, device=dev)
    fr[1:] = sidf[1:] != sidf[:-1]
    rs_sid, rs_pos = sidf[fr], i[fr]

    # arc pairs: adjacent lanes of one read, canonical orientation,
    # packed cv0<<32|cv1 and sort-reduced as unsigned keys.  gid fits
    # int32, so v = gid<<1|rev fits 32 bits and the packing cannot
    # collide (asm/scg.py's consumer relies on the same invariant).
    v = (gid_flat << 1) | (lf & 1)
    pok = sidf[:-1] == sidf[1:]
    v0, v1 = v[:-1][pok], v[1:][pok]
    flip = v0 > v1
    cv0 = torch.where(flip, v1 ^ 1, v0)
    cv1 = torch.where(flip, v0 ^ 1, v1)
    pks = torch.sort(ukey((cv0 << 32) | cv1)).values
    pk_u, pcnt = torch.unique_consecutive(pks, return_counts=True)
    pk_u = ukey(pk_u)

    scalars = torch.tensor(
        [n_dev, n_scm, n_susp, len(pk_u), len(rs_sid)], dtype=torch.int64
    )
    return (gid_flat, m32_flat, rs_sid, rs_pos, hh, hs, h1, l1, s1, scalars, pk_u, pcnt)


def finalize(bh, bl, bs, bm, bv):
    """One finalize over the carry buffers (int64 bit patterns; bv int32
    0 valid / 1 invalid): :func:`finalize_sorted`, then
    :func:`finalize_compact`."""
    return finalize_compact(finalize_sorted(bh, bl, bs, bm, bv))


def final_to_numpy(final):
    """Finalize outputs -> host arrays with the JAX path's dtypes."""
    (gid_flat, m32_flat, rs_sid, rs_pos, hh, hs, h1, l1, s1,
     scalars, pk_u, pcnt) = final
    return (
        gid_flat.cpu().numpy().astype(np.int32),
        m32_flat.cpu().numpy().astype(np.uint32),
        rs_sid.cpu().numpy().astype(np.int64),
        rs_pos.cpu().numpy().astype(np.int64),
        to_numpy_u64(hh), to_numpy_u64(hs),
        to_numpy_u64(h1), to_numpy_u64(l1), to_numpy_u64(s1),
        scalars.numpy(),
        to_numpy_u64(pk_u), pcnt.cpu().numpy().astype(np.int64),
    )


class DevCountState:
    """Device carry buffers accumulating (hash, low, smer, m32, invalid)
    key lanes across extraction chunks; finalize builds the SyncmerDB.

    The reference's contract (``oatk_tpu/index/devcount.py:313-347``):
    :meth:`append` queues a chunk and commits its ``max_out`` lanes at
    once, handing back its n_sel as a device tensor; the lanes of a chunk
    found to have overflowed are invalidated (:meth:`invalidate`) and the
    chunk is appended again with room, and the finalize's global sort
    makes the append order irrelevant."""

    def __init__(self, device, cap_hint: int = 0):
        self.device = torch.device(device)
        self._bufs = None  # (bh, bl, bs, bm, bv) device tensors
        self._final = None  # finalize_sorted's result (device tensors)
        self.cap = 0
        self.cap_hint = cap_hint  # expected total lanes (avoids growth)
        self.n_fill = 0  # append offset
        self.n_occ = 0  # loader-tracked occurrence count (sum of n_sel)
        # evidence counters: growth steps, chunk appends, invalidations
        self.n_grow = 0
        self.n_append = 0
        self.n_invalidate = 0

    @classmethod
    def from_numpy(cls, bh, bl, bs, bm, bv, device="cpu") -> "DevCountState":
        """Carry buffers taken from the JAX package's state (uint64 hash /
        low / smer, uint32 m32, int32 invalid flag)."""
        st = cls(device)
        st._bufs = (
            from_numpy_u64(bh, device),
            from_numpy_u64(bl, device),
            from_numpy_u64(bs, device),
            torch.from_numpy(np.asarray(bm).astype(np.int64)).to(device),
            torch.from_numpy(np.asarray(bv).astype(np.int32)).to(device),
        )
        st.cap = st.n_fill = len(bh)
        st.n_occ = int((np.asarray(bv) == 0).sum())
        return st

    def _ensure(self, need: int):
        if self._bufs is None:
            self.cap = max(need, self.cap_hint)
            dev = self.device
            self._bufs = (
                torch.full((self.cap,), -1, dtype=torch.int64, device=dev),
                torch.full((self.cap,), -1, dtype=torch.int64, device=dev),
                torch.full((self.cap,), -1, dtype=torch.int64, device=dev),
                torch.zeros(self.cap, dtype=torch.int64, device=dev),
                torch.ones(self.cap, dtype=torch.int32, device=dev),
            )
        if self.n_fill + need > self.cap:
            # the copy runs on the compute stream, behind every kernel
            # already queued against the old buffers, so those need only
            # stay referenced until queued: the caching allocator hands
            # their memory out again in the same stream order
            new_cap = max(2 * self.cap, self.n_fill + need)
            grown = []
            for buf, fill in zip(self._bufs, (-1, -1, -1, 0, 1)):
                g = buf.new_full((new_cap,), fill)
                g[: self.cap] = buf
                grown.append(g)
            self._bufs = tuple(grown)
            self.cap = new_cap
            self.n_grow += 1

    def _drop_final(self):
        self._final = None

    @property
    def bufs(self):
        """The carry buffers (hash, low, smer, m32, invalid)."""
        return self._bufs

    def append(self, blob, B: int, Lp: int, n_cap: int, w: int, s: int, max_out: int,
               sids) -> tuple[int, torch.Tensor]:
        """Queue one chunk on the key route (K3d -> K1 -> K4 over the
        uploaded ``blob``, row b's read id ``sids[b]``), its key lanes
        written at the append offset, and commit its ``max_out`` lanes.
        Returns (the chunk's offset, its exact n_sel as a one-element
        device tensor); nothing is read back."""
        from ..kernels.syncmer import extract_hoco_fused_keys

        return self._commit(max_out, lambda off: extract_hoco_fused_keys(
            blob, B, Lp, n_cap, w, s, max_out, sids, self._bufs, off))

    def append_rows(self, codes_padded, w: int, s: int, max_out: int,
                    sids) -> tuple[int, torch.Tensor]:
        """:meth:`append` for rows that K3d laid out already
        (``codes_padded`` ``[B, 1+L+w+2]``): K1 -> K4 only."""
        from ..kernels.syncmer import select_keys

        return self._commit(max_out, lambda off: select_keys(
            codes_padded, w, s, max_out, sids, self._bufs, off))

    def _commit(self, max_out: int, write) -> tuple[int, torch.Tensor]:
        """Give ``write(off)`` (which queues the keys at lane ``off`` and
        returns the n_sel tensor) ``max_out`` lanes at the append offset."""
        self._drop_final()
        self._ensure(max_out)
        off = self.n_fill
        n_sel = write(off)
        self.n_fill = off + max_out
        self.n_append += 1
        return off, n_sel

    def invalidate(self, off: int, n: int):
        """Mark previously appended lanes invalid (an overflowed chunk
        before its regrow, or a discarded parse attempt)."""
        if self._bufs is None:
            return
        self._drop_final()
        self._bufs[4][off : off + n] = 1
        self.n_invalidate += 1

    def start_finalize(self):
        """Queue the finalize's sorts over the current buffers
        (:func:`finalize_sorted`, no host read); a later append or
        invalidate drops the result and :meth:`build` queues it again."""
        if self._bufs is not None and self._final is None:
            self._final = finalize_sorted(*(b[: self.n_fill] for b in self._bufs))

    def build(self, read_db):
        """Finalize, fetch, give the reads their syncmer arrays, and build
        the SyncmerDB on the host.  Returns None when no occurrences were
        collected."""
        from .syncmer_db import build_db_from_sorted

        if self._bufs is None:
            return None
        self.start_finalize()
        (gid_flat, m32_f, rs_sid, rs_pos, hh, hs, sh, sl, ss,
         scalars, pk_u, pcnt) = final_to_numpy(finalize_compact(self._final, self.n_occ))
        self._drop_final()
        self._bufs = None

        n_exp = self.n_occ
        n_reads = len(read_db.reads)
        if n_exp == 0 or n_reads == 0:
            return None
        n_tot, n_scm, n_susp, n_pu, n_ru = (int(x) for x in scalars)
        if n_tot != n_exp:
            raise RuntimeError(
                f"device counting holds {n_tot} occurrences, loader saw {n_exp}"
            )

        # per-read occurrence counts from the compacted read starts
        mc = np.zeros(n_reads, np.int64)
        mc[rs_sid] = np.diff(np.append(rs_pos, n_tot))
        offs = np.zeros(n_reads + 1, np.int64)
        np.cumsum(mc, out=offs[1:])

        if n_susp:
            # hash collision between distinct sequences: rebuild the
            # per-occurrence smer stream from the hash-sorted keys, restore
            # the per-read views, then resolve exactly on host (reference
            # process_kmer_cluster semantics)
            sid_s = (sl >> np.uint64(32)).astype(np.int64)
            idx_s = ((sl >> np.uint64(1)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
            sm_np = np.empty(n_tot, np.uint64)
            sm_np[offs[sid_s] + idx_s] = ss
            _restore_read_views(read_db, offs, m32_f, sm_np)
            return build_db_from_sorted(read_db, sh, sl, ss, offs)

        # per-occurrence smer = head smer of its cluster: guaranteed by
        # n_susp == 0 (the finalize counted every mismatching lane)
        sm_np = hs[gid_flat]
        db = _build_db_from_gid(
            read_db, gid_flat, n_scm, hh, hs, mc, offs, m32_f, sm_np,
        )
        if n_pu:
            read_db._dev_pairs = (read_db.version, pk_u, pcnt)
        return db


# ---- carried from oatk_tpu/index/devcount.py ----


def _check_sid_contiguous(reads) -> None:
    """The loader appends reads in sid order, so slice i of the fetched
    flat arrays belongs to read i: a hard check (not an assert: -O must
    not strip it) -- if the loader ever produced out-of-order sids the
    slices would silently attach to the wrong reads and corrupt the
    assembly."""
    if reads and (reads[0].sid != 0 or reads[-1].sid != len(reads) - 1):
        raise RuntimeError(
            f"devcount: reads not sid-contiguous (first={reads[0].sid}, "
            f"last={reads[-1].sid}, n={len(reads)})"
        )


def _restore_read_views(read_db, offs, m32_np, sm_np):
    """Point every read's m_pos/s_mer at its slice of the fetched flat
    arrays (the collision route; its host build rewrites k_mer)."""
    reads = read_db.reads
    _check_sid_contiguous(reads)
    for i, r in enumerate(reads):
        o0, o1 = offs[i], offs[i + 1]
        r.m_pos = m32_np[o0:o1]
        r.s_mer = sm_np[o0:o1]


def _build_db_from_gid(
    read_db, gid_flat, n_scm, heads_h, heads_s, mc, offs, m32_np, sm_np
):
    """Assemble the SyncmerDB from device-assigned ids in per-read flat
    order: coverage by bincount, position lists by a radix counting sort
    of the host-computed low keys by id -- stable over the ascending
    flat (sid, idx, rev) order, exactly the reference's per-cluster
    order -- and the reads' k_mer (rewritten to id<<1), m_pos and s_mer
    (full-fetch mode: the loader never saw them), handed whole to the
    loader's :class:`~oatk_tpu_torch.asm.reads.ReadTable`."""
    from .. import native
    from ..asm.consensus import set_read_flats
    from .syncmer_db import FlatViews, SyncmerDB

    n_tot = len(gid_flat)
    cov = np.bincount(gid_flat, minlength=n_scm).astype(np.uint32)
    cuts = np.zeros(n_scm + 1, np.int64)
    np.cumsum(cov.astype(np.int64), out=cuts[1:])

    # lows in flat order (= the reference's 128-bit key low half)
    n_reads = len(mc)
    idx = (np.arange(n_tot, dtype=np.int64) - np.repeat(offs[:-1], mc)).astype(
        np.uint64
    )
    sids = np.arange(n_reads, dtype=np.uint64)
    lows_flat = (
        (np.repeat(sids, mc) << np.uint64(32))
        | (idx << np.uint64(1))
        | (m32_np.astype(np.uint64) & np.uint64(1))
    )
    order = native.argsort_u64(gid_flat.astype(np.uint64))
    if order is None:
        order = np.argsort(gid_flat, kind="stable")
    mp_flat = lows_flat[order]

    db = SyncmerDB(
        h=heads_h.copy(),
        s=heads_s.copy(),
        cov=cov,
        del_=np.zeros(n_scm, dtype=bool),
        m_pos=FlatViews(mp_flat, cuts),
        mp_flat=mp_flat,
        mp_off=cuts,
    )

    new_kmer = gid_flat.astype(np.uint64) << np.uint64(1)
    # every read's m_pos/s_mer/k_mer: its slice of these flats, made when
    # a stage first reads it
    _check_sid_contiguous(read_db.reads)
    read_db.table.set_syncmers(offs, m32_np, sm_np, new_kmer)
    read_db.version = getattr(read_db, "version", 0) + 1
    set_read_flats(
        read_db, mc, new_kmer, m32_np, sm_np, sids.astype(np.int64)
    )

    assert int(db.cov.sum()) == n_tot
    return db
