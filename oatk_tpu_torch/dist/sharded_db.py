"""Multi-device syncmer collection (PyTorch port of
``oatk_tpu/dist/sharded_db.py``): data-parallel extraction and a
hash-range-sharded occurrence store feeding the assembly pipeline.

It replaces the reference's global qsort of 128-bit
(kmerhash<<64 | sid<<32 | idx<<1 | rev) keys (reference
syncmer.c:1397-1451):

- reads are split over the mesh's shards; each shard extracts the closed
  syncmers of its rows with the selection kernel (the single-device
  kernel, so hashes and positions are bit-identical);
- every occurrence goes to its *owner* shard, the top bits of its k-mer
  hash, so the shards own ascending disjoint hash ranges; the counts go
  first, so every transfer and every owner's buffer is exactly sized
  and nothing is dropped;
- each owner appends the (hash, low) pairs it receives to a buffer that
  grows across batches;
- finalize sorts each shard once on (hash, low), unsigned: because the
  owners' ranges ascend with the hash, joining the shards' runs in shard
  order is the reference's total 128-bit order, and the host builds the
  SyncmerDB with the single-device code (:mod:`..index.syncmer_db`).

Across processes every rank parses every input, extracts its own block
of rows, and the packed extraction results are allgathered, so every
rank assembles the same ReadDB; each rank clusters its own hash range
and the cluster results are allgathered (:func:`_build_multiproc_impl`).

What the JAX module does only for jit's static shapes is not ported:
the fixed routing and shard capacities with their drop counters (and
``OATK_TPU_SHARD_CAP_SCALE``), the raise on an extraction overflow (the
capacity regrows here, as the single-device loader's does), the
power-of-two row buckets (rows use the single-device loader's
``_bucket_len``) and the choice of extractor (``OATK_TPU_SHARDED_IMPL``:
the port always runs the selection kernel on host-compressed codes).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._u64 import srl, to_numpy_u64, ukey
from ..index.syncmer_db import SyncmerDB, build_db_from_sorted, flatten_occurrences
from . import comm
from .sharding import Mesh, exchange
from .stages import shard_ranges


def _owner_bits(n_shards: int) -> int:
    return max(1, (n_shards - 1).bit_length())


def owner_of(khash: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owner shard of each hash (int64 bit patterns): its top
    ``_owner_bits`` bits, unsigned, with owners past the last shard
    clamped to it (a mesh of 5 sends owners 4..7 to shard 4)."""
    return torch.clamp(srl(khash, 64 - _owner_bits(n_shards)), max=n_shards - 1)


def route_keys(packed: torch.Tensor, n_sel: int, row_len: int, sids: torch.Tensor):
    """One shard's extraction result -> ``[n_sel, 2]`` (hash, low) rows,
    low = sid<<32 | idx<<1 | rev with idx the rank of the occurrence
    within its read (the flat order is (row, position) ascending)."""
    row0 = packed[0, :n_sel]
    b = torch.div(row0 >> 1, row_len, rounding_mode="floor")
    first = torch.searchsorted(b, b)
    idx = torch.arange(n_sel, dtype=torch.int64, device=b.device) - first
    low = (sids[b] << 32) | (idx << 1) | (row0 & 1)
    return torch.stack([packed[2, :n_sel], low], dim=1)


def finalize_sort(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hash, low) rows sorted as unsigned 2-key: a stable sort on the
    low key, then a stable sort on the hash (sign-flipped int64 keys)."""
    h, lo = keys[:, 0], keys[:, 1]
    o = torch.sort(ukey(lo), stable=True).indices
    o = o[torch.sort(ukey(h[o]), stable=True).indices]
    return h[o], lo[o]


class _GrowBuffer:
    """Rows ``[n, 2]`` int64 on one device, doubling its capacity as
    rows arrive."""

    def __init__(self, device):
        self.buf = torch.empty((0, 2), dtype=torch.int64, device=device)
        self.n = 0

    def append(self, rows: torch.Tensor) -> None:
        need = self.n + len(rows)
        if need > len(self.buf):
            grown = torch.empty((max(need, 2 * len(self.buf)), 2), dtype=torch.int64,
                                device=self.buf.device)
            grown[: self.n] = self.buf[: self.n]
            self.buf = grown
        self.buf[self.n : need] = rows
        self.n = need

    def rows(self) -> torch.Tensor:
        return self.buf[: self.n]


@dataclass
class ShardedSyncmerCollector:
    """Accumulates hash-routed syncmer occurrences on a mesh and builds
    the SyncmerDB at finalize.  ``occ_per_shard`` (after ``build``) and
    ``exchange_bytes`` (the (hash, low) bytes that left their shard) are
    the layer's counters."""

    mesh: Mesh
    w: int
    s: int
    _bufs: dict = field(default_factory=dict, repr=False)
    n_steps: int = 0
    exchange_bytes: int = 0
    occ_per_shard: list = field(default_factory=list)

    def add_batch(self, seq: np.ndarray, sids: np.ndarray, max_out: int) -> list:
        """Extract + route one batch of hoco code rows ``seq`` [B, L]
        uint8 (0-3 bases, 4 N, 5 pad) with global read ids ``sids`` [B];
        shard d takes the d-th contiguous block of rows, ``max_out`` is
        each shard's starting capacity.  Returns every shard's packed
        extraction result as a host int64 array [3, n_sel]."""
        from ..asm.reads import _round_up
        from ..kernels.syncmer import extract_hoco_rows

        D = self.mesh.size
        L = seq.shape[1]
        ranges = shard_ranges(seq.shape[0], D)
        packs: dict[int, np.ndarray] = {}
        sends = {}
        for d in self.mesh.local_shards():
            lo, hi = ranges[d]
            dev = self.mesh.devices[d]
            if d not in self._bufs:
                self._bufs[d] = _GrowBuffer(dev)
            if hi == lo:  # fewer rows than shards: nothing to launch
                keys = torch.empty((0, 2), dtype=torch.int64, device=dev)
                sends[d] = (keys, keys[:, 0])
                packs[d] = np.zeros((3, 0), np.int64)
                continue
            rows = torch.from_numpy(np.ascontiguousarray(seq[lo:hi])).to(dev)
            mo = max_out
            while True:
                packed = extract_hoco_rows(rows, self.w, self.s, mo)
                n_sel = int(packed[0, mo])
                if n_sel <= mo:
                    break
                mo = _round_up(n_sel + 1024, 1024)
            keys = route_keys(packed, n_sel, L, torch.from_numpy(sids[lo:hi]).to(dev))
            sends[d] = (keys, owner_of(keys[:, 0], D))
            packs[d] = packed[:, :n_sel].cpu().numpy()
        owned, moved = exchange(self.mesh, sends)
        for d, rows in owned.items():
            self._bufs[d].append(rows)
        self.exchange_bytes += moved
        self.n_steps += 1
        if self.mesh.ranks is None:
            return [packs[d] for d in range(D)]
        (mine,) = packs.values()
        return [np.ascontiguousarray(p.T) for p in comm.allgather_var(np.ascontiguousarray(mine.T))]

    def build(self, read_db) -> SyncmerDB | None:
        """Finalize: per-shard sort, the runs joined in shard order (the
        global 128-bit key order), the DB built with the shared host
        code.  Raises when the shards hold another number of occurrences
        than the ReadDB."""
        if read_db.total_syncmers() == 0:
            return None
        D = self.mesh.size
        runs = {}
        for d in self.mesh.local_shards():
            buf = self._bufs.get(d)
            keys = buf.rows() if buf is not None else torch.empty((0, 2), dtype=torch.int64)
            h, lo = finalize_sort(keys)
            runs[d] = (to_numpy_u64(h), to_numpy_u64(lo))
        self._bufs = {}
        counts = np.zeros(D, np.int64)
        for d, (h, _) in runs.items():
            counts[d] = len(h)
        if self.mesh.ranks is not None:
            counts = np.sum(comm.allgather_var(counts), axis=0)
            self.occ_per_shard = counts.tolist()
            return _build_multiproc_impl(read_db, runs, D)
        self.occ_per_shard = counts.tolist()
        sh = np.concatenate([runs[d][0] for d in range(D)])
        sl = np.concatenate([runs[d][1] for d in range(D)])
        n_tot = read_db.total_syncmers()
        if len(sh) != n_tot:
            raise RuntimeError(f"sharded collector holds {len(sh)} occurrences, ReadDB has {n_tot}")
        # s-mer payloads + per-read bases from the assembled ReadDB
        _, _, smers, base = flatten_occurrences(read_db)
        sid = (sl >> np.uint64(32)).astype(np.int64)
        idx = ((sl >> np.uint64(1)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
        return build_db_from_sorted(read_db, sh, sl, smers[base[sid] + idx], base)


def _build_multiproc_impl(read_db, runs: dict, n_shards: int):
    """Process-sharded host DB assembly: each process clusters only the
    hash-range shards it owns (clusters cannot span shards: ownership is
    by hash prefix), and the allgather ships results -- per-cluster
    heads and coverage plus the grouped lows that become mp_flat -- not
    the raw sorted keys.  Shard results are reordered by shard id after
    the gather, which restores the global 128-bit key order; the
    SyncmerDB is byte-identical to the replicated build."""
    from ..index.syncmer_db import assemble_db_from_clusters, cluster_occurrences

    _, _, smers, base = flatten_occurrences(read_db)
    ids, meta, hparts, sparts, covparts, clparts = [], [], [], [], [], []
    for g in sorted(runs):
        hrun, lrun = runs[g]
        n = len(hrun)
        sid = (lrun >> np.uint64(32)).astype(np.int64)
        idx = ((lrun >> np.uint64(1)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
        ssr = smers[base[sid] + idx] if n else np.zeros(0, np.uint64)
        gid, n_scm_l, rep = cluster_occurrences(read_db, hrun, lrun, ssr)
        cov_l = np.bincount(gid, minlength=n_scm_l).astype(np.int64)
        if n_scm_l and not bool((gid[1:] >= gid[:-1]).all()):
            cl = lrun[np.argsort(gid, kind="stable")]
        else:
            cl = lrun
        ids.append(g)
        meta.append((n_scm_l, n))
        hparts.append(hrun[rep])
        sparts.append(ssr[rep])
        covparts.append(cov_l)
        clparts.append(cl)

    z64, zi = np.zeros(0, np.uint64), np.zeros(0, np.int64)
    tag = np.asarray([[g, m[0], m[1]] for g, m in zip(ids, meta)], np.int64).reshape(-1, 3)
    tag_all = comm.allgather_var(tag)
    h_all = comm.allgather_var(np.concatenate(hparts) if hparts else z64)
    s_all = comm.allgather_var(np.concatenate(sparts) if sparts else z64)
    c_all = comm.allgather_var(np.concatenate(covparts) if covparts else zi)
    cl_all = comm.allgather_var(np.concatenate(clparts) if clparts else z64)

    recs = []
    for r in range(len(tag_all)):
        o_scm = o_occ = 0
        for g, n_scm_l, n_occ_l in tag_all[r]:
            recs.append((
                int(g),
                h_all[r][o_scm : o_scm + n_scm_l],
                s_all[r][o_scm : o_scm + n_scm_l],
                c_all[r][o_scm : o_scm + n_scm_l],
                cl_all[r][o_occ : o_occ + n_occ_l],
            ))
            o_scm += int(n_scm_l)
            o_occ += int(n_occ_l)
    recs.sort(key=lambda t: t[0])
    if [t[0] for t in recs] != list(range(n_shards)):
        raise RuntimeError(f"shard results incomplete: {[t[0] for t in recs]}")
    cl_sorted = np.concatenate([t[4] for t in recs])
    n_tot = read_db.total_syncmers()
    if len(cl_sorted) != n_tot:
        raise RuntimeError(
            f"sharded collector holds {len(cl_sorted)} occurrences, ReadDB has {n_tot}"
        )
    return assemble_db_from_clusters(
        read_db,
        np.concatenate([t[1] for t in recs]),
        np.concatenate([t[2] for t in recs]),
        np.concatenate([t[3] for t in recs]).astype(np.uint32),
        cl_sorted,
        base,
    )


def _parse_native(paths: list[str]):
    """Every file through the threaded native parser: (names, per-read
    (codes, rl, is_n), total raw bases, flat parts) or None when the
    parser rejects a file."""
    from .. import native
    from ..asm.reads import _read_isn_views
    from ..io.fastx import read_source_bytes

    names_l, hoco, flat_parts = [], [], []
    total = 0
    for path in paths:
        res = native.parse_fastx_hoco_mt(read_source_bytes(path))
        if res is None:
            return None
        names, rawlen, offs, codes, rlv, isn_pos, ovf_p, ovf_l = res
        isn_views = _read_isn_views(isn_pos, offs, len(names))
        for i in range(len(names)):
            o0, o1 = int(offs[i]), int(offs[i + 1])
            hoco.append((codes[o0:o1], rlv[o0:o1], isn_views[i]))
        names_l.extend(names)
        total += int(rawlen.sum())
        flat_parts.append((codes, rlv, offs, ovf_p, ovf_l))
    return names_l, hoco, total, flat_parts


def _set_flats(db, flat_parts) -> None:
    """The whole-run hoco streams (per-read arrays are views into them),
    which the consumers (_Flats) reuse instead of re-concatenating."""
    base = 0
    offs_all, ovf_pos_all, ovf_len_all = [], [], []
    for _codes, _rlv, offs, ovf_p, ovf_l in flat_parts:
        offs_all.append(offs[:-1].astype(np.int64) + base)
        if len(ovf_p):
            ovf_pos_all.append(ovf_p + base)
            ovf_len_all.append(ovf_l)
        base += int(offs[-1])
    one = len(flat_parts) == 1
    db.hoco_flat = flat_parts[0][0] if one else np.concatenate([p[0] for p in flat_parts])
    db.rl_flat = flat_parts[0][1] if one else np.concatenate([p[1] for p in flat_parts])
    z64 = np.zeros(0, np.int64)
    db.rl_ovf_pos = np.concatenate(ovf_pos_all) if ovf_pos_all else z64
    db.rl_ovf_len = np.concatenate(ovf_len_all) if ovf_len_all else z64
    db.hoco_off = np.concatenate(offs_all + [np.asarray([base], np.int64)]).astype(
        np.int64, copy=False)


def load_and_extract_sharded(
    paths: list[str],
    w: int,
    s: int,
    mesh: Mesh,
    max_data: int = 0,
    batch_bases: int = 32 << 20,
):
    """Multi-device counterpart of
    :func:`oatk_tpu_torch.asm.reads.load_and_extract`: reads are parsed
    and homopolymer-compressed on the host (the threaded native parser;
    the Python reader under ``max_data`` or when the parser rejects a
    file), bucketed by padded hoco length into chunks of about
    ``batch_bases`` positions per shard, and each chunk's code rows go
    through :meth:`ShardedSyncmerCollector.add_batch`; the host assembles
    the per-read view from the shards' extraction results.

    Returns (ReadDB, ShardedSyncmerCollector); call ``collector.build``
    for the SyncmerDB (the reference's stage order: read stats run on
    raw hashes before collect_syncmer_from_reads rewrites them,
    run_syncasm.c:88-103)."""
    from .. import native
    from ..asm.reads import ReadDB, _bucket_len, _round_up, _sel_divisor, _unpack_packed
    from ..io.fastx import read_fastx
    from ..kernels.oracle import ReadSyncmers, hoco_compress_np

    if not native.available():
        raise RuntimeError("the native host library (oatk_tpu_torch/native/*.c) failed to build")
    D = mesh.size
    parsed = None if max_data else _parse_native(paths)
    if parsed is None:
        records = read_fastx(paths, max_data)
        names_l = [r.name for r in records]
        hoco = [hoco_compress_np(r.seq) for r in records]
        flat_parts = None
    else:
        names_l, hoco, _total, flat_parts = parsed
    db = ReadDB(k=w, s=s)
    db.reads = [None] * len(hoco)  # type: ignore
    if flat_parts:
        _set_flats(db, flat_parts)

    buckets: dict[int, list[int]] = {}
    for i, (code, _, _) in enumerate(hoco):
        buckets.setdefault(_bucket_len(max(len(code), w + 4)), []).append(i)
    collector = ShardedSyncmerCollector(mesh=mesh, w=w, s=s)
    up = 0
    for Lp, idxs in sorted(buckets.items()):
        bsz = max(D, D * (batch_bases // Lp))
        for start in range(0, len(idxs), bsz):
            chunk = idxs[start : start + bsz]
            B = len(chunk)
            seq = np.full((B, Lp), 5, dtype=np.uint8)
            for bi, ri in enumerate(chunk):
                code, _, is_n = hoco[ri]
                seq[bi, : len(code)] = code
                seq[bi, : len(code)][is_n] = 4
            ranges = shard_ranges(B, D)
            bpd = max(hi - lo for lo, hi in ranges)
            max_out = _round_up(max(1024, int(bpd * Lp / _sel_divisor(w, s))), 1024)
            packs = collector.add_batch(seq, np.asarray(chunk, np.int64), max_out)
            up += seq.nbytes
            for (lo, hi), pk in zip(ranges, packs):
                n_sel = pk.shape[1]
                sel_b, sel_p, sel_z, sel_smer, sel_kh = _unpack_packed(pk, n_sel, Lp)
                cuts = np.searchsorted(sel_b, np.arange(hi - lo + 1))
                for bl in range(hi - lo):
                    ri = chunk[lo + bl]
                    a, b = cuts[bl], cuts[bl + 1]
                    code, ho_rl, is_n = hoco[ri]
                    db.reads[ri] = ReadSyncmers(
                        sid=ri,
                        name=names_l[ri],
                        hoco_l=len(code),
                        hoco_code=code,
                        ho_rl=ho_rl,
                        is_n=is_n,
                        m_pos=(sel_p[a:b].astype(np.uint32) << 1) | sel_z[a:b].astype(np.uint32),
                        s_mer=sel_smer[a:b].astype(np.uint64),
                        k_mer=sel_kh[a:b].copy(),
                    )
    db.upload_bytes = up
    return db, collector
