#!/usr/bin/env python3
"""Where a whole syncasm job's time goes, by the port's own stage recorder.

    python3 tools/trace_report.py [--workload athal-syncasm.wgs-1G] [--seed N]
        [--jobs 6] [--traced 3] [--out build/trace_report/report.json]

Run from a checkout's root on a machine with a CUDA card.  It takes a benchmark
cell's input and configuration (``portbench/``: the sample, the thread
pools, the ``syncasm`` arguments) and runs whole jobs in one process:
the first job (its ``once`` keys against a steady job), ``--jobs``
steady jobs, then ``--traced`` jobs under ``OATK_TPU_PROFILE``.  For
every job it gives the call's wall (``syncasm``), the part of it that
no top-level stage covers, the process's CPU seconds and the loader's
split and counters and the views its reads' record table made, by
field; over the jobs the median of every key, untraced and traced (the
profiler's cost by stage); and over each traced job the device's busy
time and its idle gaps by the program's top-level span they fell in
(``portbench/core/trace.reduce`` over the profile's Chrome trace).
``--device cpu --traffic FILE`` rehearses it on the CPU with a small
traffic file (``portbench/tests/data/tiny_traffic.json``)."""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORK = os.path.join(ROOT, "build", "trace_report")
ROOT_KEYS = ("syncasm", "syncasm_cpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def top_level(tm: dict) -> dict:
    return {k: v for k, v in tm.items() if "." not in k and k not in ROOT_KEYS}


def job_facts(wall: float, tm: dict) -> dict:
    top = sum(top_level(tm).values())
    load_main = {k: v for k, v in tm.items() if k.startswith("load.") and k.count(".") == 1}
    return {
        "wall_s": wall, "root_s": tm["syncasm"], "cpu_s": tm["syncasm_cpu"],
        "covered_pct": 100.0 * top / tm["syncasm"], "uncovered_ms": 1000.0 * (tm["syncasm"] - top),
        "load_uncovered_ms": 1000.0 * (tm["load"] - sum(load_main.values())),
        "once": {k: v for k, v in tm.items() if "once" in k.split(".")},
    }


def medians_ms(tms: list) -> dict:
    keys = sorted({k for tm in tms for k in tm})
    return {k: 1000.0 * statistics.median(tm.get(k, 0.0) for tm in tms) for k in keys}


def reduce_chrome(path: str, stage_names: set) -> dict:
    """Busy time and idle gaps by program span of one call's profile."""
    from portbench.core import trace as tr

    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    out, annotations, root = [], 0, None
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = int(float(e["ts"]) * 1000)
        end = s + int(float(e.get("dur", 0)) * 1000)
        if cat == "gpu_user_annotation":
            annotations += 1  # the device's copies of the program's ranges: no device work
        elif cat in DEVICE_CATS:
            out.append((name, True, s, end))
        elif cat == "user_annotation":
            if name == "syncasm":
                root = (s, end)
            out.append((name, False, s, end))
    r = tr.reduce(out, root[0], root[1], stage_names)
    return {"window_s": r.window_s, "busy_s": r.busy_s, "device_annotations": annotations,
            "idle_by_span_s": dict(sorted(r.idle_by_span.items(), key=lambda kv: -kv[1])),
            "device_ops_s": dict(tr.top(r.kernel_s, 8))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="athal-syncasm.wgs-1G")
    ap.add_argument("--traffic", help="a traffic file in place of the cell's")
    ap.add_argument("--seed", type=int, default=3100000001)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--traced", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(WORK, "report.json"))
    args = ap.parse_args(argv)

    from portbench.core import cells, hostenv

    cell = cells.find(args.workload)
    cfg = cell.config
    threads = int(cfg["threads"])
    hostenv.set_pool_env(threads, cfg.get("env", {}))
    import torch

    hostenv.set_torch_pools(threads)
    from portbench.core.main import SAMPLE_CACHE
    from portbench.data import gen

    traffic = cell.traffic
    if args.traffic:
        with open(args.traffic) as f:
            traffic = json.load(f)
    os.makedirs(WORK, exist_ok=True)
    fasta, out = os.path.join(WORK, "reads.fa"), os.path.join(WORK, "o")
    sample = gen.prepare(traffic, args.seed, fasta, SAMPLE_CACHE)
    from oatk_tpu_torch.asm.pipeline import syncasm

    card = args.device.startswith("cuda")
    kw = dict(cfg["syncasm"], threads=threads)

    counters = []  # the loader's load_counters of every job
    views = []  # the views the reads' record table made in every job, by field, and its reads

    def job():
        t0 = time.perf_counter()
        res = syncasm([fasta], out=out, device=args.device, **kw)
        if card:
            torch.cuda.synchronize()
        counters.append(dict(getattr(res.read_db, "load_counters", None) or {}))
        table = getattr(res.read_db, "table", None)
        views.append(dict(table.views, reads=res.read_db.n) if table is not None else {})
        return time.perf_counter() - t0, res.timings

    first = job()
    steady = [job() for _ in range(args.jobs)]
    traced, chrome = [], []
    for i in range(args.traced):
        d = os.path.join(WORK, f"profile_{i}")
        os.environ["OATK_TPU_PROFILE"] = d
        try:
            traced.append(job())
        finally:
            del os.environ["OATK_TPU_PROFILE"]
        chrome.append(reduce_chrome(os.path.join(d, "syncasm_trace.json"),
                                    set(top_level(traced[-1][1]))))
    med = medians_ms([tm for _, tm in steady])
    med_t = medians_ms([tm for _, tm in traced]) if traced else {}
    report = {
        "card": torch.cuda.get_device_name(0) if card else "cpu",
        "workload": args.workload, "seed": args.seed, "job_mbp": sample.n_bases / 1e6,
        "first": dict(job_facts(*first), extra_ms={
            k: 1000.0 * v - med.get(k, 0.0) for k, v in top_level(first[1]).items()}),
        "steady": [job_facts(*j) for j in steady],
        "traced": [dict(job_facts(*j), **c) for j, c in zip(traced, chrome)],
        "median_ms": med, "traced_median_ms": med_t,
        "first_timings_ms": {k: 1000.0 * v for k, v in first[1].items()},
        "load_counters": counters,
        "read_views": views,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[trace_report] {report['card']} {args.workload} seed {args.seed}: first job "
          f"{first[0]:.3f} s, once {report['first']['once']}")
    for name, jobs in (("steady", report["steady"]), ("traced", report["traced"])):
        for j in jobs:
            print(f"[trace_report] {name}: wall {j['wall_s']:.3f} s root {j['root_s']:.3f} s "
                  f"covered {j['covered_pct']:.3f}% (uncovered {j['uncovered_ms']:.1f} ms, "
                  f"load's {j['load_uncovered_ms']:.1f} ms) cpu {j['cpu_s']:.3f} s "
                  f"once {sorted(j['once'])}" + (
                      f" busy {j['busy_s']:.3f} of {j['window_s']:.3f} s" if "busy_s" in j else ""))
    print(f"[trace_report] load_counters, last steady job: {counters[args.jobs]}")
    print(f"[trace_report] read_views, last steady job: {views[args.jobs]}")
    for k in sorted(med, key=lambda k: -med[k]):
        if k.count(".") > 1 or (k.count(".") == 1 and not k.startswith("load")):
            continue
        print(f"[trace_report] {k}: {med[k]:.1f} ms untraced, {med_t.get(k, float('nan')):.1f} traced")
    return 0


if __name__ == "__main__":
    sys.exit(main())
