"""One run of one cell: set-up, the window, the checks, the result line.

Set-up: the configuration's thread pools, the sample (made once per
checkout and kept under ``build/portbench/samples/``, then written in
the seed's order as a FASTA under the run's TMPDIR), the port imported (its
kernels and native libraries load from, or are built into, the
checkout's fixed ``build/`` directories) and two whole warm jobs of the
cell's own input.  The window: whole jobs back to back
(:mod:`.window`).  After it: the peak device memory, the program's
outputs taken, its state freed, the plain reference's comparison, and
one JSON line on standard output."""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from . import cells, hostenv, window

FORBIDDEN = ("jax", "jaxlib", "flax", "oatk_tpu")
# the seed-independent part of each traffic mix's sample, made on a
# checkout's first run of it (gen.cached_canonical)
SAMPLE_CACHE = os.path.join(cells.ROOT, "build", "portbench", "samples")


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def _min_med_max(xs: list) -> tuple:
    xs = sorted(xs)
    return xs[0], xs[len(xs) // 2], xs[-1]


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             work_dir: str | None = None,
             cache_dir: str = SAMPLE_CACHE) -> tuple[dict, list, list]:
    """Set-up, window and checks of ``cell``.  Returns (result, lines for
    standard output before the result, lines for the end of standard
    error)."""
    from ..data import gen

    cfg = cell.config
    threads = int(cfg["threads"])
    import torch

    hostenv.set_torch_pools(threads)
    card = device.startswith("cuda")
    tmp = tempfile.mkdtemp(prefix="portbench-", dir=work_dir)
    try:
        t_sample = time.perf_counter()
        fasta = os.path.join(tmp, "reads.fa")
        sample = gen.prepare(cell.traffic, seed, fasta, cache_dir)
        out = os.path.join(tmp, "out")
        from .program import Program

        t_port = time.perf_counter()
        program = Program(cfg["syncasm"], threads, device)
        t = time.perf_counter()
        program.job(fasta, out)
        first_job_s = time.perf_counter() - t
        program.job(fasta, out)
        if card:
            torch.cuda.synchronize()
        t_ready = time.perf_counter()
        setup_s = t_ready - t_start
        setup_split = (f"setup_split_s=start:{t_sample - t_start:.3f},"
                       f"sample:{t_port - t_sample:.3f},port:{t - t_port:.3f},"
                       f"job1:{first_job_s:.3f},job2:{t_ready - t - first_job_s:.3f}")

        prof = None
        if trace:
            from . import trace as tr
            from .program import STAGES

            program.add_spans()
            prof = tr.profiler()
            prof.start()

        def job():
            if prof is None:
                return program.job(fasta, out)
            with torch.profiler.record_function("job"):
                return program.job(fasta, out)

        c0 = hostenv.cpu_times()
        spans, recs = window.run(job, seconds)
        c1 = hostenv.cpu_times()
        if prof is not None:
            prof.stop()
        peak = torch.cuda.max_memory_allocated() if card else 0
        reading = None
        if prof is not None:
            stage_names = {n for names in STAGES.values() for n in names}
            evs = list(tr.events_of(prof, stage_names | {"job"}))
            jobs = [(s, e) for n, d, s, e in evs if n == "job" and not d]
            reading = tr.reduce(evs, min(s for s, _ in jobs), max(e for _, e in jobs), stage_names)
            del evs, prof

        from . import check

        k, s = int(cfg["syncasm"]["k"]), int(cfg["syncasm"]["s"])
        taken = check.take(program, sample, seed, int(cfg.get("ec_sample_reads", 2000)))
        program.last = program.snap = None
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        nums = check.numbers(taken, fasta, out + ".utg.final.gfa", sample, k, s, device)
        ok, checks = check.judge(nums, cell.limits)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    ctx = dict(cell=cell, spans=spans, recs=recs, job_mbp=sample.n_bases / 1e6,
               setup_s=setup_s, first_job_s=first_job_s, trace=reading, peak_bytes=peak,
               nums=nums, k=k, s=s, n_jobs=len(spans))
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = cells.metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if card else "cpu",
           "kind": torch.cuda.get_device_name(0) if card else "cpu",
           "count": cell.chips if card else 0, "memory_peak_bytes": int(peak)}
    if reading is not None:
        dev["busy_s"] = reading.busy_s
        dev["window_s"] = reading.window_s
    result = {"correct": bool(ok), "attempted": len(spans), "failed": 0, "metrics": metrics,
              "device": dev}
    if reading is not None:
        result["breakdown"] = {"device_ops": tr.top(reading.kernel_s),
                               "idle_gaps": tr.top(reading.idle_by_span)}
    g = hostenv.grant()
    js = _min_med_max([e - b for b, e in spans])
    facts = (f"host: affinity={g['affinity']} cgroup_cores={g['cgroup_cores']} "
             f"cpu_count={g['cpu_count']} threads={threads} jobs={len(spans)} "
             f"window_s={window.seconds_of(spans):.3f} job_s_min_med_max={js[0]:.3f}/"
             f"{js[1]:.3f}/{js[2]:.3f} "
             f"{setup_split} steal_pct={hostenv.steal_pct(c0, c1)} "
             f"loadavg={hostenv.loadavg()} card={power_limit() if card else 'none'} "
             f"ties={nums['ties']} ec_raw_pct={nums['ec_raw_pct']:.4f} "
             f"ec_left_pct={nums['ec_left_pct']:.4f} "
             f"ec_untouched_pct={nums['ec_untouched_pct']:.4f}")
    keys = sorted({k for t, _ in recs for k in (t or {})})
    stage = " ".join(
        f"{k}={'/'.join(f'{1000 * x:.0f}' for x in _min_med_max([t.get(k, 0.0) for t, _ in recs]))}"
        for k in keys)
    facts_stages = f"stages_ms_min_med_max: {stage}"
    check_lines = [f"check: {n} = {v['value']} (limit {v['limit']})" for n, v in checks.items()]
    result["checks"] = checks
    return result, [facts], [facts, facts_stages] + check_lines


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        cell = cells.find(args.workload)
    except (KeyError, OSError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    threads = int(cell.config["threads"])
    hostenv.set_pool_env(threads, cell.config.get("env", {}))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, out_lines, err_lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                            "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for line in err_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    for line in out_lines:
        print(line)
    print(json.dumps(result))
    return 0
