"""The comparison that decides ``correct``, on the window's last job.

Each number that a cell's limits file (``portbench/limits/<cell>.json``)
names is held to its limit there:

- ``sel_mismatch``: syncmer occurrences, as (read, pos << 1 | z, hash),
  in the program's extraction (as the count left it) or the plain
  reference's, not both;
- ``count_mismatch``: distinct syncmer hashes whose count differs between
  the program's count and the reference's;
- over a sample of organelle reads drawn from the seed, each compared
  with the error-free stretch of genome it was read from (multisets of
  syncmer hashes, read by read): ``ec_residual_pct``, the syncmers of the
  corrected reads that the sources do not hold and the other way round,
  per 100 syncmers of the sources; ``ec_left_pct``, the raw reads'
  wrong syncmers that error correction left in place, per 100 of them;
  ``ec_untouched_pct``, the reads with a wrong syncmer that error
  correction left exactly as they were read, per 100 such reads;
- ``gfa_foreign``: 31-mers of the final GFA's segments that the organelle
  genomes do not hold (either strand, circular), and ``gfa_missed``, the
  genomes' 31-mers that no segment holds (an empty or cut GFA reads the
  genomes' whole count).

The program's outputs are taken first (:func:`take`), so that its state
can be freed before the reference runs."""
from __future__ import annotations

import numpy as np

from ..data.gen import read_fasta
from ..reference import syncmers as ref
from ..reference import truth


def take(program, sample, seed: int, n_ec: int) -> dict:
    """What the checks need of the program's last job, as plain arrays."""
    snap, res = program.snap, program.last
    if snap.per_read is None:
        mc = np.asarray(snap.mc, np.int64)
        rd = np.repeat(np.arange(len(mc), dtype=np.int64), mc)
        mpos = np.asarray(snap.mflat, np.int64)
        kid = (np.asarray(snap.kflat, np.uint64) >> np.uint64(1)).astype(np.int64)
    else:
        rd = np.concatenate([np.full(len(m), i, np.int64) for i, (m, _) in enumerate(snap.per_read)])
        mpos = np.concatenate([np.asarray(m, np.int64) for m, _ in snap.per_read])
        kid = np.concatenate([(np.asarray(k, np.uint64) >> np.uint64(1)).astype(np.int64)
                              for _, k in snap.per_read])
    h = np.asarray(snap.h, np.uint64)
    cov = np.asarray(snap.cov, np.int64)
    # the sampled organelle reads after error correction
    org = [i for i, g in enumerate(sample.names) if g in sample.organelles]
    cand = np.flatnonzero(np.isin(sample.src, org))
    pick = np.sort(np.random.default_rng([int(seed), 7]).choice(
        cand, size=min(n_ec, len(cand)), replace=False))
    post_h = np.asarray(res.scm_db.h, np.uint64)
    reads = res.read_db.reads
    ec_rd, ec_h = [], []
    for j, i in enumerate(pick.tolist()):
        km = np.asarray(reads[i].k_mer if i < len(reads) else [], np.uint64) >> np.uint64(1)
        ec_h.append(post_h[km.astype(np.int64)])
        ec_rd.append(np.full(len(km), j, np.int64))
    return dict(rd=rd, mpos=mpos, hash=h[kid], h=h, cov=cov, pick=pick,
                ec_rd=np.concatenate(ec_rd) if ec_rd else np.zeros(0, np.int64),
                ec_h=np.concatenate(ec_h) if ec_h else np.zeros(0, np.uint64),
                n_reads=len(res.read_db.reads))


def numbers(taken: dict, fasta: str, gfa: str, sample, k: int, s: int, device,
            hash_bits: int = 64) -> dict:
    """Every compared number, and the readings printed beside them.
    ``hash_bits`` < 64 puts the reference computed at that precision in
    the program's place (the control)."""
    seq, off = read_fasta(fasta)
    r_rd, r_mpos, r_h, ties, hlen, n_n = ref.extract(seq, off, k, s, device=device)
    if hash_bits < 64:
        c_rd, c_mpos, c_h, *_ = ref.extract(seq, off, k, s, device=device,
                                              hash_bits=hash_bits)
        taken = dict(taken, rd=c_rd, mpos=c_mpos, hash=c_h)
        u, cnt = np.unique(c_h, return_counts=True)
        taken.update(h=u, cov=cnt)
    key_p = (taken["rd"] << 32) | taken["mpos"]
    key_r = (r_rd << 32) | r_mpos
    sel = truth.multiset_diff(key_p, taken["hash"], key_r, r_h)

    uh, inv = np.unique(taken["h"], return_inverse=True)
    pc = np.bincount(inv, weights=taken["cov"]).astype(np.int64)
    rh, rc = np.unique(r_h, return_counts=True)
    allh = np.concatenate([uh, rh])
    allc = np.concatenate([pc, -rc])
    o = np.argsort(allh, kind="stable")
    allh, allc = allh[o], allc[o]
    starts = np.flatnonzero(np.concatenate([[True], allh[1:] != allh[:-1]]))
    count_mm = int((np.add.reduceat(allc, starts) != 0).sum()) if len(allh) else 0

    # error correction: corrected reads against their error-free sources,
    # and the raw reads against the same (what an unchanged state reads)
    pick = taken["pick"]
    tr = [sample.true_read(i) for i in pick.tolist()]
    toff = np.zeros(len(tr) + 1, np.int64)
    np.cumsum([len(t) for t in tr], out=toff[1:])
    t_rd, _, t_h, *_ = ref.extract(np.concatenate(tr) if tr else np.zeros(0, np.uint8),
                                     toff, k, s, device=device)
    sel_raw = np.isin(r_rd, pick)
    raw_rd = np.searchsorted(pick, r_rd[sel_raw])
    # per (read, hash): counts in the corrected reads, the raw reads, the sources
    key_rd, c = truth.key_counts((taken["ec_rd"], taken["ec_h"]), (raw_rd, r_h[sel_raw]),
                                 (t_rd, t_h))
    ca, cr, cb = c[:, 0], c[:, 1], c[:, 2]
    resid = int(np.abs(ca - cb).sum())
    raw = int(np.abs(cr - cb).sum())
    wrong = np.maximum(cr - cb, 0)
    left = np.minimum(wrong, np.maximum(ca - cb, 0))
    denom = max(1, len(t_h))
    # reads with a wrong raw syncmer, and those of them EC did not touch
    bad_reads = np.unique(key_rd[wrong > 0])
    changed = np.unique(key_rd[ca != cr])
    untouched = np.setdiff1d(bad_reads, changed)

    foreign, missed = gfa_numbers(gfa, sample)
    return {
        "sel_mismatch": sel,
        "count_mismatch": count_mm,
        "ec_residual_pct": 100.0 * resid / denom,
        "ec_left_pct": 100.0 * int(left.sum()) / max(1, int(wrong.sum())),
        "ec_untouched_pct": 100.0 * len(untouched) / max(1, len(bad_reads)),
        "gfa_foreign": foreign,
        "gfa_missed": missed,
        # readings printed beside the compared numbers
        "ec_raw_pct": 100.0 * raw / denom,
        "ties": ties,
        "ref_syncmers": int(len(r_h)),
        "ref_hoco": int(hlen.sum()),
        "ref_n": n_n,
        "ec_reads": int(len(pick)),
        "ec_source_syncmers": int(len(t_h)),
    }


def gfa_numbers(gfa: str, sample) -> tuple[int, int]:
    """(gfa_foreign, gfa_missed) of the GFA at ``gfa`` against the
    sample's organelle genomes."""
    genomes = [g for g, n in zip(sample.genomes, sample.names) if n in sample.organelles]
    return truth.gfa_kmer_errors(truth.read_gfa_segments(gfa), truth.genome_kmers(genomes))


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name."""
    out = {n: {"value": nums[n], "limit": limits[n]} for n in limits}
    return all(v["value"] <= v["limit"] for v in out.values()), out
