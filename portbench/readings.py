#!/usr/bin/env python3
"""Readings that the limits of ``portbench/limits/<cell>.json`` are set
from, for one cell, on many seeds in one process (the benchmark's own
runs never run this):

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 4 5 6] [--kinds KIND ...] [--out FILE]

For every seed: the sample, one warm job (the first seed's also builds),
then one job of the cell's own input whose outputs are compared, as a
run compares its last job: the program's readings.  For each control
seed besides:

- the control: the plain reference computed with 32-bit s-mer hashes
  put in the program's place (a selection at a lower precision than the
  configuration states);
- a state left unchanged: error correction made to return the reads as
  they were read (planted in the program for one job);
- half of the batch left out: the program run on the first half of the
  reads, compared with the whole sample;
- an answer altered where it is produced: one base of the final GFA's
  longest segment changed (``fault_gfa_base``), or that segment lost
  from the GFA (``fault_gfa_segment``).

``--kinds`` keeps only the named kinds for the control seeds (all by
default).  One JSON line per seed and kind."""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.core import cells, check, hostenv  # noqa: E402
from portbench.core.main import SAMPLE_CACHE  # noqa: E402

KINDS = ("control_hash32", "fault_gfa_base", "fault_gfa_segment", "fault_ec_unchanged",
         "fault_half_batch")


def alter_gfa(gfa: str, out: str, drop: bool) -> None:
    """``gfa`` with its longest segment lost (``drop``) or one base in the
    middle of that segment changed, written to ``out``."""
    with open(gfa, "rb") as f:
        lines = f.read().split(b"\n")
    seg = max((i for i, ln in enumerate(lines) if ln.startswith(b"S\t")),
              key=lambda i: len(lines[i].split(b"\t")[2]))
    if drop:
        del lines[seg]
    else:
        f = lines[seg].split(b"\t")
        sq = bytearray(f[2])
        mid = len(sq) // 2
        sq[mid] = ord("A") if sq[mid] != ord("A") else ord("C")
        f[2] = bytes(sq)
        lines[seg] = b"\t".join(f)
    with open(out, "wb") as f:
        f.write(b"\n".join(lines))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS)
    a = ap.parse_args(argv)
    cell = cells.find(a.workload)
    cfg = cell.config
    threads = int(cfg["threads"])
    hostenv.set_pool_env(threads, cfg.get("env", {}))
    import torch

    if a.device == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    hostenv.set_torch_pools(threads)
    from portbench.core.program import Program
    from portbench.data import gen

    k, s = int(cfg["syncasm"]["k"]), int(cfg["syncasm"]["s"])
    n_ec = int(cfg.get("ec_sample_reads", 2000))
    program = Program(cfg["syncasm"], threads, a.device)
    out_f = open(a.out, "a") if a.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")
            out_f.flush()

    for seed in a.seeds + [c for c in a.control_seeds if c not in a.seeds]:
        tmp = tempfile.mkdtemp(prefix="portbench-readings-")
        try:
            t0 = time.perf_counter()
            fasta = os.path.join(tmp, "reads.fa")
            sample = gen.prepare(cell.traffic, seed, fasta, SAMPLE_CACHE)
            t_gen = time.perf_counter() - t0
            outp = os.path.join(tmp, "out")
            program.job(fasta, outp)
            t1 = time.perf_counter()
            program.job(fasta, outp)
            t_job = time.perf_counter() - t1
            gfa = outp + ".utg.final.gfa"
            taken = check.take(program, sample, seed, n_ec)
            program.last = program.snap = None
            gc.collect()
            nums = check.numbers(taken, fasta, gfa, sample, k, s, a.device)
            emit(dict(kind="program", seed=seed, gen_s=t_gen, job_s=t_job, **nums))
            if seed not in a.control_seeds:
                continue
            if "control_hash32" in a.kinds:
                ctl = check.numbers(taken, fasta, gfa, sample, k, s, a.device, hash_bits=32)
                emit(dict(kind="control_hash32", seed=seed, **ctl))
            for kind in ("fault_gfa_base", "fault_gfa_segment"):
                if kind in a.kinds:
                    alt = os.path.join(tmp, "altered.gfa")
                    alter_gfa(gfa, alt, drop=kind == "fault_gfa_segment")
                    foreign, missed = check.gfa_numbers(alt, sample)
                    emit(dict(nums, kind=kind, seed=seed, gfa_foreign=foreign,
                              gfa_missed=missed))
            if "fault_ec_unchanged" in a.kinds:
                # a state left unchanged: error correction returns at once
                import oatk_tpu_torch.asm.ec as ec_mod

                real_ec = ec_mod.read_error_correction
                ec_mod.read_error_correction = lambda *args, **kw: None
                try:
                    program.job(fasta, outp)
                finally:
                    ec_mod.read_error_correction = real_ec
                tu = check.take(program, sample, seed, n_ec)
                program.last = program.snap = None
                gc.collect()
                emit(dict(kind="fault_ec_unchanged", seed=seed,
                          **check.numbers(tu, fasta, gfa, sample, k, s, a.device)))
            if "fault_half_batch" in a.kinds:
                # half of the batch left out
                half = os.path.join(tmp, "half.fa")
                flat, off = gen.read_fasta(fasta)
                gen.write_fasta(half, (flat[off[i]:off[i + 1]] for i in range((len(off) - 1) // 2)))
                del flat, off
                program.job(half, outp)
                th = check.take(program, sample, seed, n_ec)
                program.last = program.snap = None
                gc.collect()
                fh = check.numbers(th, fasta, gfa, sample, k, s, a.device)
                emit(dict(kind="fault_half_batch", seed=seed, **fh))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
