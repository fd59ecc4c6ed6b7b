"""Global syncmer (k-mer) database: counting and id assignment (HOT LOOP 2).

Replaces the reference's global qsort of 128-bit (hash | sid | idx | rev)
keys plus per-cluster exact-sequence collision resolution
(reference syncmer.c:1270-1451).

Design: occurrences across all reads are flattened to (hash, low) key
pairs and sorted; equal-hash runs become clusters.  Hash collisions
between *different* k-mer sequences are detected with an exact
packed-sequence comparison inside each cluster (vectorized against the
cluster head, rare slow path on mismatch).  Syncmer ids follow the
sorted-hash / first-occurrence order, matching the reference's id
assignment exactly.

Two front-ends share the cluster/id/position-list builder
(:func:`build_db_from_sorted`):

- :func:`collect_syncmer_db` -- single-process host lexsort.
- ``oatk_tpu.dist.sharded_db`` -- multi-chip path: every occurrence is
  routed to its hash-range owner shard on device, each shard sorts its
  slice, and the concatenated per-shard runs ARE the global sort order
  (ranges partition hash space monotonically), so both paths feed
  byte-identical input here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..asm.reads import ReadDB
from ..kernels.oracle import kmer_packed_bytes

MAX_RD_SCM = 0x7FFFFFFF


class FlatViews:
    """Lazy list-of-arrays over a flat backing array + offsets.

    ``m_pos[i]`` materializes the i-th view on demand; building 10^4-10^5
    eager views per DB (re)build dominated profiles at scale."""

    __slots__ = ("flat", "off")

    def __init__(self, flat: np.ndarray, off: np.ndarray):
        self.flat = flat
        self.off = off

    def __len__(self) -> int:
        return len(self.off) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.flat[self.off[i] : self.off[i + 1]]

    def __iter__(self):
        flat, off = self.flat, self.off
        for i in range(len(off) - 1):
            yield flat[off[i] : off[i + 1]]


@dataclass
class SyncmerDB:
    """Distinct syncmers (syncmer_db_t analogue, reference syncmer.h:98-114)."""

    h: np.ndarray  # [n] uint64 kmer hash
    s: np.ndarray  # [n] uint64 smer payload
    cov: np.ndarray  # [n] uint32 occurrence count
    del_: np.ndarray  # [n] bool deleted flag
    m_pos: list  # [n] arrays of uint64: sid<<32 | read_idx<<1 | rev
    version: int = 0  # bumped whenever m_pos/cov are rebuilt (EC)
    # flat view backing m_pos (kept so consumers can skip re-concatenating
    # the per-syncmer lists); entries of m_pos are views into mp_flat
    mp_flat: np.ndarray | None = None
    mp_off: np.ndarray | None = None

    @property
    def n(self) -> int:
        return len(self.h)


def _packed_kmer_of(read_db: ReadDB, sid: int, idx: int, rev: int) -> bytes:
    r = read_db.reads[sid]
    pos = int(r.m_pos[idx]) >> 1
    return kmer_packed_bytes(r.hoco_code, None, pos, read_db.k, rev).tobytes()


def flatten_occurrences(read_db: ReadDB):
    """Flatten per-read syncmer arrays to parallel (hash, low, smer)
    arrays plus per-read base offsets into the flat order.

    low = sid<<32 | idx<<1 | rev  -- the low 64 bits of the reference's
    128-bit sort key (reference syncmer.c:1419).
    """
    from ..asm.consensus import read_flats

    reads = read_db.reads
    nr = read_db.n
    rf = read_flats(read_db)
    mc, sids = rf.mc, rf.sids
    n_tot = int(mc.sum())
    offs = np.zeros(nr + 1, dtype=np.int64)
    np.cumsum(mc, out=offs[1:])
    base = np.zeros(nr + 1, dtype=np.int64)
    base[sids] = offs[:-1]
    base[nr] = n_tot
    if n_tot == 0:
        z = np.zeros(0, np.uint64)
        return z, z, z, base
    hashes = rf.kflat
    smers = rf.smer(reads)
    revs = rf.mflat.astype(np.uint64, copy=False) & np.uint64(1)
    idx = (np.arange(n_tot, dtype=np.int64) - np.repeat(offs[:-1], mc)).astype(np.uint64)
    lows = (
        (np.repeat(sids, mc).astype(np.uint64) << np.uint64(32))
        | (idx << np.uint64(1))
        | revs
    )
    return hashes, lows, smers, base


def cluster_occurrences(
    read_db: ReadDB,
    sh: np.ndarray,  # [n] uint64 hashes, sorted by (hash, low)
    sl: np.ndarray,  # [n] uint64 lows, co-sorted
    ss: np.ndarray,  # [n] uint64 smer payloads, co-sorted
):
    """Cluster a sorted occurrence run and resolve hash collisions by
    exact sequence; returns (gid, n_scm, rep_idx) with gid the
    0-based cluster id per occurrence (run-local).  Shared by the host
    build and the process-sharded build (a hash-range shard is a
    self-contained run: clusters never span shards)."""
    n_tot = len(sh)

    # cluster boundaries on hash
    starts = np.flatnonzero(np.concatenate([[True], sh[1:] != sh[:-1]]))
    ends = np.concatenate([starts[1:], [n_tot]])

    # exact-sequence collision check: compare each member to its cluster
    # head.  The vectorized proxy first compares s-mer payloads
    # (identical k-mers always share the canonical s-mer), escalating to
    # byte comparison only on mismatch -- in practice never.
    head_of = np.repeat(starts, ends - starts)
    suspicious = ss != ss[head_of]

    sub_id = np.zeros(n_tot, dtype=np.int64)  # sub-cluster within hash cluster
    n_collision_clusters = 0
    if suspicious.any():
        for ci in np.unique(head_of[suspicious]):
            lo = int(ci)
            hi = int(ends[np.searchsorted(starts, lo)])
            reps: list[bytes] = []
            for j in range(lo, hi):
                sid = int(sl[j] >> np.uint64(32))
                idx = int(sl[j] >> np.uint64(1)) & MAX_RD_SCM
                rev = int(sl[j]) & 1
                b = _packed_kmer_of(read_db, sid, idx, rev)
                for ri, rb in enumerate(reps):
                    if rb == b:
                        sub_id[j] = ri
                        break
                else:
                    sub_id[j] = len(reps)
                    reps.append(b)
            if len(reps) > 1:
                n_collision_clusters += 1
        # collisions are resolved silently, as in the reference (the
        # reference only reports them under DEBUG_CHECK_HASH_COLLISION,
        # syncmer.c:1383) -- keeps -v stderr byte parity

    # assign global syncmer ids: clusters in sorted-hash order, sub-clusters
    # by first occurrence
    max_sub = int(sub_id.max()) + 1 if n_tot else 1
    if max_sub == 1:
        gid = np.repeat(np.arange(len(starts), dtype=np.int64), ends - starts)
        n_scm = len(starts)
        rep_idx = starts
    else:
        # rare path: renumber (cluster, sub) pairs by first occurrence
        key = head_of * max_sub + sub_id
        uniq, first_pos, inv = np.unique(key, return_index=True, return_inverse=True)
        # order sub-clusters by (cluster, first occurrence)
        ord2 = np.argsort(first_pos, kind="stable")
        remap = np.empty(len(uniq), dtype=np.int64)
        remap[ord2] = np.arange(len(uniq))
        gid = remap[inv]
        n_scm = len(uniq)
        rep_idx = first_pos[ord2]
    return gid, n_scm, rep_idx


def build_db_from_sorted(
    read_db: ReadDB,
    sh: np.ndarray,  # [n_tot] uint64 hashes, globally sorted by (hash, low)
    sl: np.ndarray,  # [n_tot] uint64 lows, co-sorted
    ss: np.ndarray,  # [n_tot] uint64 smer payloads, co-sorted
    base: np.ndarray,  # [n_reads+1] int64 per-read offsets into flat order
) -> SyncmerDB:
    """Cluster sorted occurrences, resolve hash collisions by exact
    sequence, assign global syncmer ids in sorted order, build position
    lists, and rewrite per-read k_mer from hash to syncmer id<<1."""
    gid, n_scm, rep_idx = cluster_occurrences(read_db, sh, sl, ss)
    cov = np.bincount(gid, minlength=n_scm).astype(np.uint32)
    # m_pos lists per syncmer, in sorted order (sid, idx ascending).
    # gid is already nondecreasing unless the (never-hit-in-practice)
    # collision sub-clustering renumbered ids.
    if n_scm and not bool((gid[1:] >= gid[:-1]).all()):
        cl_sorted = sl[np.argsort(gid, kind="stable")]
    else:
        cl_sorted = sl
    return assemble_db_from_clusters(
        read_db, sh[rep_idx].copy(), ss[rep_idx].copy(), cov, cl_sorted, base
    )


def assemble_db_from_clusters(
    read_db: ReadDB,
    h_heads: np.ndarray,  # [n_scm] uint64 cluster head hashes (global id order)
    s_heads: np.ndarray,  # [n_scm] uint64 cluster head smer payloads
    cov: np.ndarray,  # [n_scm] uint32 cluster sizes
    cl_sorted: np.ndarray,  # [n_tot] uint64 lows grouped by cluster (= mp_flat)
    base: np.ndarray,  # [n_reads+1] int64 per-read offsets into flat order
) -> SyncmerDB:
    """Assemble the SyncmerDB + per-read k_mer rewrite from
    cluster-level arrays.  Shared tail of the host build and the
    process-sharded build (each process clusters its own hash range;
    the rank-order concatenation of shard results feeds here)."""
    n_scm = len(cov)
    n_tot = len(cl_sorted)
    db = SyncmerDB(
        h=h_heads,
        s=s_heads,
        cov=cov.astype(np.uint32, copy=False),
        del_=np.zeros(n_scm, dtype=bool),
        m_pos=None,
    )
    cuts = np.zeros(n_scm + 1, dtype=np.int64)
    np.cumsum(cov.astype(np.int64), out=cuts[1:])
    db.m_pos = FlatViews(cl_sorted, cuts)
    db.mp_flat = cl_sorted
    db.mp_off = cuts

    # rewrite read k_mer: hash -> syncmer id << 1, scattered back to the
    # per-read flat order via (sid, idx); gid per occurrence follows
    # from the cluster cuts
    gid = np.repeat(np.arange(n_scm, dtype=np.int64), cov.astype(np.int64))
    sid_all = (cl_sorted >> np.uint64(32)).astype(np.int64)
    idx_all = ((cl_sorted >> np.uint64(1)) & np.uint64(MAX_RD_SCM)).astype(np.int64)
    new_kmer = np.empty(n_tot, dtype=np.uint64)
    new_kmer[base[sid_all] + idx_all] = gid.astype(np.uint64) << np.uint64(1)
    for r in read_db.reads:
        n = r.n
        if n:
            off = base[r.sid]
            # views into the flat rewrite: per-read arrays are never
            # written in place (EC replaces whole arrays)
            r.k_mer = new_kmer[off : off + n]
        elif r.k_mer is None:
            # device-count loads leave k_mer unset until the id rewrite
            # (reads.py:130); a zero-syncmer read (shorter than k) must
            # still end with an empty array or read_flats' concatenate
            # crashes -- hit via the hash-collision fallback route
            r.k_mer = new_kmer[:0]
    # k_mer contents changed (hash -> id): re-key the per-version flats
    # cache.  new_kmer IS the new kflat (same sid-block layout), so the
    # cache updates in place instead of forcing a rebuild.
    old_key = getattr(read_db, "version", 0)
    read_db.version = old_key + 1
    cached = getattr(read_db, "_rflats_cache", None)
    if cached is not None and cached[0] == old_key:
        from ..asm.consensus import set_read_flats

        o = cached[1]
        set_read_flats(read_db, o.mc, new_kmer, o.mflat, o._sflat, o.sids)

    assert int(db.cov.sum()) == n_tot
    return db


def collect_syncmer_db(read_db: ReadDB) -> SyncmerDB | None:
    """Build the syncmer DB and rewrite per-read k_mer to syncmer id<<1.

    When the loader accumulated the keys on device (device-resident
    counting, index/devcount.py), the global sort + id assignment run
    there and the host only fetches ids; otherwise the host sorts."""
    state = getattr(read_db, "_devcount", None)
    if state is not None:
        read_db._devcount = None
        # evidence counters survive the handoff (validate_large prints
        # cap/append/grow/invalidate for the at-scale BASELINE rows)
        read_db._devcount_stats = state
        return state.build(read_db)
    hashes, lows, smers, base = flatten_occurrences(read_db)
    n_tot = len(hashes)
    if n_tot == 0:
        return None
    # reads flatten in (sid, idx) order, so `lows` is already ascending
    # and a single stable sort on the hash equals the 2-key lexsort
    if n_tot > 1 and bool((lows[1:] >= lows[:-1]).all()):
        from .. import native

        order = native.argsort_u64(hashes)
        if order is None:
            order = np.argsort(hashes, kind="stable")
    else:
        order = np.lexsort((lows, hashes))
    return build_db_from_sorted(read_db, hashes[order], lows[order], smers[order], base)
