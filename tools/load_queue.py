#!/usr/bin/env python3
"""Where the main thread's time goes in the key route of the PyTorch
port's loader (``oatk_tpu_torch/asm/reads.py:load_and_extract`` on a
CUDA card), at 110 Mbp, k=1001, s=31.

Run it from the root of the checkout whose ``oatk_tpu_torch`` it is to
time:

    python3 PATH/TO/tools/load_queue.py [--fa FASTA] [--runs N]

The reads are ``--fa``, by default ``build/chip_smoke/set_110mbp.fa``
under the current directory, made with the 110 Mbp recipe of the
``chip_smoke.py`` beside this file when it is absent.  After two warm-up
runs, N loader runs, each with ``load.extract`` and the summed host time
of the uploads (``Uploads.put``) and of the count's appends
(``DevCountState._commit``, which every append passes through), split
into those queued while a parse worker was still running and those
queued after the last one had finished.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, S = 1001, 31


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fa", default=os.path.join("build", "chip_smoke", "set_110mbp.fa"))
    ap.add_argument("--runs", type=int, default=8)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("load_queue: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location("chip_smoke_recipe", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fa = os.path.abspath(args.fa)
    if not os.path.exists(fa):
        sys.path.insert(1, os.path.join(HERE, "tests"))  # genome_sim
        os.makedirs(os.path.dirname(fa), exist_ok=True)
        made, _ = smoke.dataset_110mbp(os.path.dirname(fa))
        os.replace(made, fa)

    from oatk_tpu_torch.asm import reads as R
    from oatk_tpu_torch.index.devcount import DevCountState

    print(f"[loadq] {smoke.card_line()}", flush=True)
    ends: list = []
    spans: list = []  # (kind, host start, host end)
    real_pp, real_put, real_app = R._parse_pack_segment, R.Uploads.put, DevCountState._commit

    def parse_pack(*a, **kw):
        r = real_pp(*a, **kw)
        ends.append(time.perf_counter())
        return r

    def timed(kind, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            spans.append((kind, t0, time.perf_counter()))
            return r
        return call

    R._parse_pack_segment = parse_pack
    R.Uploads.put = timed("put", real_put)
    DevCountState._commit = timed("append", real_app)
    rows = []
    for i in range(args.runs + 2):
        ends.clear()
        spans.clear()
        db = R.load_and_extract([fa], K, S, device="cuda")
        torch.cuda.synchronize()
        last = max(ends)
        row = {"extract": db.load_timings["extract"]}
        for kind in ("put", "append"):
            for phase, during in (("during", True), ("after", False)):
                xs = [t1 - t0 for k, t0, t1 in spans if k == kind and (t0 < last) == during]
                row[f"{kind}_{phase}"] = sum(xs)
                row[f"n_{phase}"] = len(xs)
        if i >= 2:
            rows.append(row)

    def med(key):
        return 1000 * statistics.median(r[key] for r in rows)

    print(f"[loadq] loader, median of {len(rows)} runs: load.extract {med('extract'):.2f} ms; "
          f"uploads and appends queued while a parse worker ran {statistics.median(r['n_during'] for r in rows)}: "
          f"put {med('put_during'):.2f} ms, append {med('append_during'):.2f} ms; queued after "
          f"the last worker {statistics.median(r['n_after'] for r in rows)}: put "
          f"{med('put_after'):.2f} ms, append {med('append_after'):.2f} ms", flush=True)

    R._parse_pack_segment, R.Uploads.put, DevCountState._commit = real_pp, real_put, real_app
    return 0


if __name__ == "__main__":
    sys.exit(main())
