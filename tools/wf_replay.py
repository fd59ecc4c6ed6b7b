#!/usr/bin/env python3
"""Replay one whole job's wavefront rounds through the plain reference.

    python3 tools/wf_replay.py [--config portbench/configs/athal-syncasm-wfdev.json]
        [--traffic portbench/traffic/q27-110M.json] [--seed N]
        [--out build/wf_replay/replay.json]

Run from a checkout's root on a machine with a CUDA card.  It takes a
configuration of the device-EC route and a traffic mix of the
benchmark's generator (by default the device-EC deployment on the 110
Mbp Q27 sample) and runs the sample at those settings as the benchmark
does (``portbench/core/program.py``: the
thread pools, the ``syncasm`` arguments, two warm whole jobs first),
then one more whole job on the same path in which every round's input
words (as ``csrc/ec_lockstep.c`` packed them) and output words (as the
kernel wrote them and the read-back brought them) are copied as they
go.  Every item of every round is decoded from its round's descriptors
and recomputed by ``portbench/reference/wavefront.py``, in blocks over a
process per core; every out_meta word and ``out_k[:n]`` must be equal.  It prints and writes the counts of rounds, items compared and
mismatches (the first few with their metas), the replayed job's ``ec``
keys and whether any steady job recorded a ``once`` key.  Exit 1 on any
mismatch.  ``--device cpu --traffic FILE --args JSON`` rehearses it on the CPU with
a small traffic file (``portbench/tests/data/tiny_traffic.json``) and
``syncasm`` arguments that suit it (``'{"k": 151, "s": 13, "min_k_cov": 3}'``)."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORK = os.path.join(ROOT, "build", "wf_replay")

_ROUNDS: list = []  # (input words, output words, B) of the replayed job, shared with forks


def _check_block(block: list) -> list:
    """(round, item, matched, meta) of each (round, item) of ``block``."""
    from portbench.reference import wavefront as ref

    out, decoded = [], {}
    for r, i in block:
        if r not in decoded:
            inp, _, B = _ROUNDS[r]
            decoded[r] = ref.decode_round(inp, B)
        it = decoded[r][i]
        out.append((r, i, ref.compare(it, _ROUNDS[r][1]), it.meta[:7].tolist()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=os.path.join(ROOT, "portbench", "configs",
                                                     "athal-syncasm-wfdev.json"))
    ap.add_argument("--traffic", default=os.path.join(ROOT, "portbench", "traffic",
                                                      "q27-110M.json"))
    ap.add_argument("--seed", type=int, default=3300000001)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--args", default="{}", help="syncasm arguments over the cell's (JSON)")
    ap.add_argument("--out", default=os.path.join(WORK, "replay.json"))
    args = ap.parse_args(argv)

    from portbench.core import hostenv

    with open(args.config) as f:
        cfg = json.load(f)
    with open(args.traffic) as f:
        traffic = json.load(f)
    threads = int(cfg["threads"])
    hostenv.set_pool_env(threads, cfg.get("env", {}))
    import torch

    hostenv.set_torch_pools(threads)
    from portbench.core.main import SAMPLE_CACHE
    from portbench.core.program import Program
    from portbench.data import gen

    os.makedirs(WORK, exist_ok=True)
    fasta, out = os.path.join(WORK, "reads.fa"), os.path.join(WORK, "o")
    gen.prepare(traffic, args.seed, fasta, SAMPLE_CACHE)
    program = Program(dict(cfg["syncasm"], **json.loads(args.args)), threads, args.device)
    card = args.device.startswith("cuda")
    timings = [program.job(fasta, out)[0] for _ in range(2)]

    from oatk_tpu_torch.asm.ec_lockstep import Lockstep

    real_pack, real_unpack, packed = Lockstep.pack, Lockstep.unpack, []

    def pack(self, h32, shape):
        real_pack(self, h32, shape)
        packed.append(h32[: shape.in_words].copy())

    def unpack(self, o, shape):
        _ROUNDS.append((packed[-1], o[: shape.out_words].copy(), shape.B))
        return real_unpack(self, o, shape)

    Lockstep.pack, Lockstep.unpack = pack, unpack
    try:
        t0 = time.perf_counter()
        tm, split = program.job(fasta, out)
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Lockstep.pack, Lockstep.unpack = real_pack, real_unpack
    if not _ROUNDS or split is None:
        print("[wf_replay] the job ran no wavefront rounds", file=sys.stderr)
        return 2
    every = [(r, i) for r, (_, _, B) in enumerate(_ROUNDS) for i in range(B)]
    blocks = [every[j: j + 256] for j in range(0, len(every), 256)]
    t1 = time.perf_counter()
    import multiprocessing as mp

    with mp.get_context("fork").Pool(len(os.sched_getaffinity(0))) as pool:
        res = [x for b in pool.map(_check_block, blocks) for x in b]
    bad = [x for x in res if not x[2]]
    report = {
        "card": torch.cuda.get_device_name(0) if card else "cpu",
        "config": os.path.basename(args.config), "traffic": os.path.basename(args.traffic),
        "seed": args.seed, "job_wall_s": wall,
        "rounds": len(_ROUNDS), "items_in_job": len(every), "items_compared": len(res),
        "mismatches": len(bad), "first_mismatches": [(r, i, m) for r, i, _, m in bad[:10]],
        "replay_s": time.perf_counter() - t1,
        "split": {k: v for k, v in split.items() if k != "items"}, "items_per_round": split["items"],
        "ec_ms": {k: 1000.0 * v for k, v in tm.items() if k == "ec" or k.startswith("ec.")},
        "once_in_steady_jobs": sorted({k for t in timings[1:] + [tm] for k in t if ".once." in k}),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[wf_replay] {report['card']} {report['config']} {report['traffic']} "
          f"seed {args.seed}: {len(_ROUNDS)} rounds, "
          f"{len(every)} items, {len(res)} compared, {len(bad)} mismatches "
          f"({report['replay_s']:.1f} s to replay); once keys in steady jobs: "
          f"{report['once_in_steady_jobs']}")
    print("[wf_replay] ec keys (ms): " + " ".join(
        f"{k}={v:.2f}" for k, v in report["ec_ms"].items()))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
