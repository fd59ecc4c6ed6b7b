#!/usr/bin/env python3
"""Wall time, stage split and the extraction kernels' device time (the
selection kernel K1, the blob decode K3d and the compaction and details
K4) of full ``syncasm`` runs of the PyTorch port at 110 Mbp on a CUDA
card.

Run it from the root of the checkout whose ``oatk_tpu_torch`` it is to
time (that directory comes first on ``sys.path``):

    python3 PATH/TO/tools/k1_profile.py [--fa FASTA] [--runs N] [--walls W]

so that the same file times another commit when it is run from the root
of that commit's unpacked archive.  The reads are ``--fa``, by default
``build/chip_smoke/set_110mbp.fa`` under the current directory, made
with the 110 Mbp recipe of the ``chip_smoke.py`` beside this file when it
is absent.  ``syncasm`` runs at k=1001, s=31, c=30 (EC on, 3 unzip
rounds) once to warm up, then N runs under ``torch.profiler`` (for each:
wall, ``syncmer_select_kernel`` launches and their summed device time,
the same for each kernel of the decode and details named by the
``chip_smoke.py`` beside this file, the number of device events, their
summed time and their number per chunk, the sha256 of
``.utg.final.gfa``), then W runs
without it, each with its wall time, stage split, the load stage's
own split (``load.*``: file read, parse wait, extraction, assembly) and
peak device memory; the loader's counters (``load_counters``: n_sel
reads, regrows, pinned staging bytes, copy-stream uploads) once, where
the package has them.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fa", default=os.path.join("build", "chip_smoke", "set_110mbp.fa"))
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--walls", type=int, default=5)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("k1_profile: no CUDA device", file=sys.stderr)
        return 2
    root = os.getcwd()
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_recipe", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fa = os.path.abspath(args.fa)
    if not os.path.exists(fa):
        sys.path.insert(1, os.path.join(HERE, "tests"))  # genome_sim
        os.makedirs(os.path.dirname(fa), exist_ok=True)
        made, _ = smoke.dataset_110mbp(os.path.dirname(fa))
        os.replace(made, fa)

    import oatk_tpu_torch
    from oatk_tpu_torch.asm.pipeline import syncasm

    tag = os.path.basename(os.path.dirname(os.path.dirname(os.path.abspath(oatk_tpu_torch.__file__))))
    out = os.path.join(root, "build", "k1prof", "o")
    os.makedirs(os.path.dirname(out), exist_ok=True)

    def run():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = syncasm([fa], k=1001, s=31, min_k_cov=30, do_ec=True, do_unzip=3, out=out, device="cuda")
        torch.cuda.synchronize()
        tm = dict(res.timings or {})
        # the load stage's own split (read, parse wait, extract, assemble)
        tm.update({f"load.{k}": v for k, v in (getattr(res.read_db, "load_timings", None) or {}).items()})
        # chunks counted on the device (none in a checkout whose count keeps no stats)
        tm["chunks"] = getattr(getattr(res.read_db, "_devcount_stats", None), "n_append", 0)
        tm["peak"] = torch.cuda.max_memory_allocated()
        tm["counters"] = getattr(res.read_db, "load_counters", None)
        return time.perf_counter() - t0, tm

    print(f"[k1prof] {smoke.card_line()}; package from {tag}; warm-up run {run()[0]:.3f} s", flush=True)
    for i in range(args.runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall, tm = run()
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        k1 = [e.time_range.elapsed_us() for e in dev if "syncmer_select_kernel" in e.name]
        busy = sum(e.time_range.elapsed_us() for e in dev)
        chain = []
        for name in smoke.DEVICE_KERNELS[1:]:  # the decode and details kernels
            us = [e.time_range.elapsed_us() for e in dev if name in e.name]
            chain.append(f"{name} {len(us)} x {sum(us):.1f} us")
        with open(out + ".utg.final.gfa", "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        print(f"[k1prof] {tag} profiled run {i}: wall {wall:.3f} s; syncmer_select_kernel "
              f"{len(k1)} launches, {sum(k1):.1f} us device (largest {max(k1, default=0):.1f} us); "
              f"{'; '.join(chain)}; all device events: {len(dev)}, {busy:.1f} us, "
              f"{len(dev) / max(1, tm['chunks']):.1f} per chunk over {tm['chunks']} chunks; "
              f".utg.final.gfa sha256 {sha[:16]}", flush=True)
    for i in range(args.walls):
        wall, tm = run()
        stages = " ".join(f"{k}={v * 1000:.1f}ms" for k, v in tm.items()
                          if k not in ("chunks", "peak", "counters"))
        print(f"[k1prof] {tag} wall {wall:.4f} s; {stages}; max_memory_allocated={tm['peak']} B",
              flush=True)
        if i == 0:
            print(f"[k1prof] {tag} loader counters: {tm['counters']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
