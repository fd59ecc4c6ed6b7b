"""Process sharding of the read-parallel host stages (PyTorch port of
``oatk_tpu/dist/stages.py``).

The reference parallelises read->graph alignment and graph-path error
correction with host threads (reference alignment.c:636-676,
syncerr.c:882); both are per-read independent, so they scale across
processes as well: reads partition into contiguous sid blocks, every
process runs the (itself thread-parallel) native stage on its block
against the replicated graph, and the flat results allgather in rank
order -- which IS read order, so the merged result is bit-identical to
an unsharded run.

In one process, ``n_shards`` forces the partition and merge over
in-process blocks (OATK_TPU_STAGE_SHARDS), to check them without a
process group.  The collectives are those of :mod:`.comm`.
"""
from __future__ import annotations

import numpy as np

from ..utils.trace import span
from . import comm


def shard_ranges(n: int, k: int) -> list[tuple[int, int]]:
    """k contiguous [lo, hi) ranges covering [0, n) (balanced +-1)."""
    return [((n * r) // k, (n * (r + 1)) // k) for r in range(k)]


def _fingerprint(packed: np.ndarray) -> np.ndarray:
    """Length and two order-sensitive checksums of a uint64 stream."""
    pos = np.arange(len(packed), dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    mixed = (packed ^ pos) * np.uint64(0xBF58476D1CE4E5B9)
    return np.asarray(
        [len(packed), np.bitwise_xor.reduce(mixed) if len(mixed) else 0,
         mixed.sum(dtype=np.uint64)], np.uint64,
    )


def sharded_pair_reduce(packed: np.ndarray, n_shards: int = 0):
    """Range-partitioned sort-reduce of packed canonical pair keys ->
    (pk_unique, counts), bit-identical to one global sort + unique.

    The adjacent-pair stream feeding make_syncmer_graph is replicated on
    every process (reference analogue: the arc-counting scan in
    syncasm.c:116-368), but the sort need not be: each rank owns a
    contiguous key range (splitters from a stride sample of the stream,
    so every rank derives the same bounds), sorts + uniques only its
    range, and the variable-length allgather concatenates in rank order
    -- ascending key-range order, so the merged arrays ARE the global
    sorted unique keys and counts.  Across processes the ranks first
    check that they hold the same stream (length and checksums); a rank
    that differs makes every rank raise.

    Returns None when there is nothing to shard (one process and
    n_shards <= 1); in one process ``n_shards`` forces the partition."""
    from .. import native

    cross = comm.process_count() > 1
    if cross:
        fp = _fingerprint(packed)
        if not comm.all_ranks_ok(bool(np.array_equal(comm.allgather_var(fp)[0], fp))):
            raise RuntimeError(
                "sharded_pair_reduce: the ranks hold different pair streams "
                f"(this rank: {len(packed)} keys)"
            )
    if n_shards <= 0:
        n_shards = comm.process_count()
    if n_shards <= 1:
        return None
    if len(packed) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    stride = max(1, len(packed) // 8192)
    sample = np.sort(packed[::stride])
    qs = np.linspace(0, len(sample) - 1, n_shards + 1).astype(np.int64)[1:-1]
    bounds = sample[qs]  # n_shards-1 splitters; shard r owns
    # [bounds[r-1], bounds[r]) with open ends, so duplicate keys equal
    # to a splitter all land in one shard
    my = [comm.process_index()] if cross else range(n_shards)
    pks, cnts = [], []
    for r in my:
        if r == 0:
            mine = packed[packed < bounds[0]]
        elif r == n_shards - 1:
            mine = packed[packed >= bounds[r - 1]]
        else:
            mine = packed[(packed >= bounds[r - 1]) & (packed < bounds[r])]
        mine = np.ascontiguousarray(mine)
        if not native.sort_u64(mine):
            mine.sort(kind="stable")
        if len(mine):
            new = np.concatenate([[True], mine[1:] != mine[:-1]])
            starts = np.flatnonzero(new)
            c = np.diff(np.concatenate([starts, [len(mine)]]))
            pks.append(mine[starts])
            cnts.append(c.astype(np.int64))
        else:
            pks.append(np.zeros(0, np.uint64))
            cnts.append(np.zeros(0, np.int64))
    if cross:
        return np.concatenate(comm.allgather_var(pks[0])), np.concatenate(comm.allgather_var(cnts[0]))
    return np.concatenate(pks), np.concatenate(cnts)


def ec_gather(parts: list) -> list:
    """Allgather this process's EC output part from every process.

    The part is (stats[11] i64, out_kmer u64, out_mpos u32, out_cut i64,
    out_upd u8) over the process's read range; the return is the full
    part list in rank (= read) order."""
    assert len(parts) == 1, "one contiguous range per process"
    st, out_kmer, out_mpos, out_cut, out_upd = parts[0]
    sts = comm.allgather_var(np.asarray(st, np.int64))
    kms = comm.allgather_var(np.asarray(out_kmer, np.uint64))
    mps = comm.allgather_var(np.asarray(out_mpos, np.uint32))
    cts = comm.allgather_var(np.asarray(out_cut, np.int64))
    ups = comm.allgather_var(np.asarray(out_upd))
    return [(sts[r], kms[r], mps[r], cts[r], ups[r]) for r in range(len(sts))]


def merge_aln_flats(parts: list[dict | None]) -> dict:
    """Concatenate per-shard alignment flats (rank order = sid order):
    chain cuts offset by cumulative fragment counts, read spans by
    cumulative chain counts."""
    sids_l, frag_l, ms_l = [], [], []
    cut_l = [np.zeros(1, np.int64)]
    off_l = [np.zeros(1, np.int64)]
    frag_base = chain_base = 0
    for p in parts:
        if p is None or len(p["sids"]) == 0:
            continue
        sids_l.append(p["sids"])
        frag_l.append(p["frag6"])
        ms_l.append(p["max_score"])
        cut_l.append(np.asarray(p["aln_cut"], np.int64)[1:] + frag_base)
        off_l.append(np.asarray(p["read_aln_off"], np.int64)[1:] + chain_base)
        frag_base += len(p["frag6"])
        chain_base += len(p["aln_cut"]) - 1
    if not sids_l:
        return dict(
            sids=np.zeros(0, np.int64),
            frag6=np.zeros((0, 6), np.int64),
            aln_cut=np.zeros(1, np.int64),
            read_aln_off=np.zeros(1, np.int64),
            max_score=np.zeros(0, np.int64),
        )
    return dict(
        sids=np.concatenate(sids_l),
        frag6=np.concatenate(frag_l),
        aln_cut=np.concatenate(cut_l),
        read_aln_off=np.concatenate(off_l),
        max_score=np.concatenate(ms_l),
    )


def _log_aln(read_db, flat) -> None:
    from ..asm.consensus import read_flats
    from ..utils import log_info

    mc = read_flats(read_db).mc
    n_mappable = int((mc > 0).sum())
    n_a_read = np.diff(flat["read_aln_off"])
    n_mapped = int((n_a_read > 0).sum())
    n_unique = int((n_a_read == 1).sum())
    log_info(
        f"{n_mappable} mappable reads, {n_mapped} mapped ({n_unique} unique mapping)",
        func="scg_read_alignment",
    )


_FLAT_KEYS = ("sids", "frag6", "aln_cut", "read_aln_off", "max_score")


def sharded_read_alignment(
    read_db, scg, for_unzip: bool = False, old_ra_db=None, n_shards: int = 0
):
    """Read->graph alignment partitioned over processes or, with
    ``n_shards`` in one process, over in-process blocks.  Bit-identical
    to the unsharded call, and logs its one line as that call does."""
    from .. import native
    from ..asm.align import RaDB, scg_read_alignment

    cross = comm.process_count() > 1
    native_ok = native.available()
    if cross:
        # agreement BEFORE any data collective: if one rank cannot run
        # the native flat path, every rank takes the replicated path or
        # the others wait in the allgathers below
        native_ok = comm.all_ranks_ok(native_ok)
    if not native_ok:
        # the object path has no flat arrays to merge: align every read
        # here (replicated across processes)
        from collections import Counter

        from ..asm.consensus import read_flats
        from ..utils import log_info

        ra_db = scg_read_alignment(read_db, scg, for_unzip, old_ra_db, shard=(0, 1))
        cnt = Counter(ra.sid for ra in ra_db)
        mc = read_flats(read_db).mc
        log_info(
            f"{int((mc > 0).sum())} mappable reads, {len(cnt)} mapped "
            f"({sum(1 for v in cnt.values() if v == 1)} unique mapping)",
            func="scg_read_alignment",
        )
        return ra_db

    if cross:
        n_shards = comm.process_count()
        my = [comm.process_index()]
    else:
        n_shards = max(1, n_shards)
        my = range(n_shards)
    # in one process the blocks run in turn, each call re-deriving the
    # shared setup (_arc_table, gating): this mode checks the partition
    # and merge; production sharding is one block per process
    parts: list[dict | None] = [
        getattr(scg_read_alignment(read_db, scg, for_unzip, old_ra_db, shard=(r, n_shards)),
                "flat", None)
        for r in my
    ]
    if cross:
        with span("gather"):
            p = parts[0] if parts[0] is not None else merge_aln_flats([])
            cols = {k: comm.allgather_var(np.asarray(p[k], np.int64)) for k in _FLAT_KEYS}
            parts = [{k: cols[k][r] for k in _FLAT_KEYS} for r in range(n_shards)]

    ra_db = RaDB()
    ra_db.flat = merge_aln_flats(parts)
    ra_db._lazy = True
    _log_aln(read_db, ra_db.flat)
    return ra_db
