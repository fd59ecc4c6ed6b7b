#!/usr/bin/env python3
"""Times error correction's C lockstep driver (``csrc/ec_lockstep.c``) alone,
on the state ``oatk`` hands it at 110 Mbp: each ``layout``, ``pack`` and
``unpack`` call of a full run of rounds, cold (the process's first run)
and then warm, with the rounds run on the card by
``kernels/wf_ed.py:wf_ed_lockstep``.

Run it from a checkout root, on a machine with a card:

    python3 tools/ec_driver_probe.py [--src C_SOURCE] [--threads N] [--reps R] [--fa FASTA]

``--src`` builds and loads another version of the driver's source (a
variant made by editing a copy), so that designs compare in one call, one
process each.  The reads are ``--fa``, by default
``build/chip_smoke/set_110mbp.fa``, made with ``chip_smoke.py``'s 110 Mbp
recipe when absent; they are loaded and taken through ``syncasm``'s
pre-EC stages once (k=1001, s=31, the error syncmers at ``oatk``'s c=30),
then the driver runs R times on the same inputs (EC's splice is not run,
so each run starts from the same state).  Each run prints one JSON line:
the run's total milliseconds, the extensions and rounds, and each call's
milliseconds.  ``--device cpu`` with ``--k 151 --s 13 --c 3`` and a small
set rehearses it on a host without a card.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None, help="driver C source (default: the package's)")
    ap.add_argument("--threads", type=int, default=0, help="0: the native default")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--fa", default=os.path.join("build", "chip_smoke", "set_110mbp.fa"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k", type=int, default=1001)
    ap.add_argument("--s", type=int, default=31)
    ap.add_argument("--c", type=int, default=30)
    args = ap.parse_args()

    sys.path.insert(0, os.getcwd())
    sys.path.insert(1, os.path.join(HERE, "tests"))  # genome_sim
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ec_driver_probe: no CUDA device", file=sys.stderr)
        return 2
    fa = os.path.abspath(args.fa)
    if not os.path.exists(fa):
        import chip_smoke

        os.makedirs(os.path.dirname(fa), exist_ok=True)
        made, _ = chip_smoke.dataset_110mbp(os.path.dirname(fa))
        os.replace(made, fa)

    from oatk_tpu_torch import native
    from oatk_tpu_torch.asm import ec as EC
    from oatk_tpu_torch.asm import ec_lockstep as ECL
    from oatk_tpu_torch.asm.consensus import scg_consensus
    from oatk_tpu_torch.asm.pipeline import load_reads
    from oatk_tpu_torch.asm.scg import make_syncmer_graph
    from oatk_tpu_torch.index.histogram import read_db_stat
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db
    from oatk_tpu_torch.kernels import wf_ed as WE

    if args.src:
        src = os.path.abspath(args.src)
        ECL._SRC, ECL._SO = src, os.path.splitext(src)[0] + ".so"
    # syncasm's steps before EC (asm/pipeline.py), then EC's own first step
    rd = load_reads([fa], args.k, args.s, 0, args.device)
    scm = collect_syncmer_db(rd)
    read_db_stat(rd, io.StringIO(), 0)
    scg = make_syncmer_graph(rd, scm, 0, 0.0)
    scg_consensus(rd, scg, hoco_seq=True, save_seq=True, fo=None)
    scg._kmer_size = rd.k
    EC.find_error_syncmers(scg, args.c, 10 * args.c, args.c, 0.35, True)
    x = EC._ec_inputs(rd, scg)
    threads = args.threads or native.n_threads_default()
    for rep in range(args.reps):
        calls = {"layout": [], "pack": [], "unpack": []}
        t0 = time.perf_counter()
        with ECL.Lockstep(*x.graph, x.kflat, x.mflat, x.moff, x.code_flat, x.hoff, x.hoco_l,
                          rd.k, 0.02, inflight=0, n_threads=threads, **x.lazy) as ls:
            for name, ms in calls.items():
                real = getattr(ls, name)

                def timed(*a, real=real, ms=ms):
                    t = time.perf_counter()
                    try:
                        return real(*a)
                    finally:
                        ms.append(round((time.perf_counter() - t) * 1000, 3))

                setattr(ls, name, timed)
            split = WE.wf_ed_lockstep(ls, args.device)
            ls.finish()
            ext = ls.extensions()
        total = (time.perf_counter() - t0) * 1000
        print(json.dumps(dict(src=args.src or ECL._SRC, threads=threads, rep=rep,
                              total_ms=round(total, 3), extensions=ext, rounds=split["rounds"],
                              **calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
