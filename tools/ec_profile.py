#!/usr/bin/env python3
"""Wall time, stage split and the ``ec`` stage's own split of full ``oatk``
runs of the PyTorch port at 110 Mbp on a CUDA card, with EC on the device
wavefront backend (OATK_TPU_WF_BACKEND=device: every read's DFS in
lockstep rounds, one wavefront launch per round).

Run it from the root of the checkout whose ``oatk_tpu_torch`` it is to
time (that directory comes first on ``sys.path``):

    python3 PATH/TO/tools/ec_profile.py [--fa FASTA] [--runs N] [--inflight K] [--python-dfs]

so that the same file times another commit when it is run from the root
of that commit's unpacked archive.  The reads are ``--fa``, by default
``build/chip_smoke/set_110mbp.fa`` under the current directory, made with
the 110 Mbp recipe of the ``chip_smoke.py`` beside this file when it is
absent; ``oatk`` runs through its CLI at its defaults (k=1001, s=31, c=30,
EC on, 3 unzip rounds) with that script's stub ``nhmmscan``, once to warm
up, then N times.  ``--inflight`` sets ``EC_INFLIGHT`` (1: one launch per
DFS extension); ``--python-dfs`` hides the native library while EC runs,
which sends the device backend to the Python DFS where the package has
the C driver.

Each run prints one JSON line (``"ec_profile": ...``): wall, the
``[T::syncasm]`` stages, the ``ec`` stage, rounds, launches, items and
extensions, the host time inside ``wf_ed_core_rounds`` (the Python DFS's
round driver), and, where the package has ``kernels/wf_ed.py:
wf_ed_lockstep`` and the run took it, its split (host seconds in the C
driver's layout, pack and unpack and in the round trip; upload, kernel
and read-back by CUDA events; items per round; bytes each way), peak
device memory and the pinned round buffers' bytes.  A last line gives
the medians over the N runs.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fa", default=os.path.join("build", "chip_smoke", "set_110mbp.fa"))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--inflight", type=int, default=0, help="EC_INFLIGHT (0: every read)")
    ap.add_argument("--python-dfs", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ec_profile: no CUDA device", file=sys.stderr)
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
    from oatk_tpu_torch import native
    from oatk_tpu_torch.asm import ec as EC
    from oatk_tpu_torch.kernels import wf_ed as WE

    tag = os.path.basename(os.path.dirname(os.path.dirname(os.path.abspath(oatk_tpu_torch.__file__))))
    work = os.path.join(root, "build", "ecprof")
    os.makedirs(work, exist_ok=True)
    exe, db = os.path.join(work, "fake_nhmmscan"), os.path.join(work, "fake.hmm")
    with open(exe, "w") as f:
        f.write(smoke.FAKE_NHMMSCAN)
    os.chmod(exe, 0o755)
    with open(db, "w") as f:
        f.write("dummy\n")
    lockstep = getattr(WE, "wf_ed_lockstep", None)
    if lockstep is not None:
        lockstep.events = True
    real_rounds, real_ec = WE.wf_ed_core_rounds, EC.read_error_correction
    in_rounds = [0.0]

    def timed_rounds(states, device=None):
        t0 = time.perf_counter()
        try:
            return real_rounds(states, device)
        finally:
            in_rounds[0] += time.perf_counter() - t0

    def python_dfs(*a, **kw):
        saved = native.available
        native.available = lambda: False
        try:
            return real_ec(*a, **kw)
        finally:
            native.available = saved

    ec_fn = python_dfs if args.python_dfs else real_ec
    EC.EC_INFLIGHT = args.inflight or None
    rows = []
    for i in range(args.runs + 1):
        torch.cuda.reset_peak_memory_stats()
        WE.wf_ed_core_batch.launches = WE.wf_ed_core_batch.items = 0
        timed_rounds.rounds = 0
        ec_fn.wf_calls = 0
        in_rounds[0] = 0.0
        if lockstep is not None:
            lockstep.last = None
        WE.wf_ed_core_rounds, EC.read_error_correction = timed_rounds, ec_fn
        try:
            r = smoke.run_oatk(fa, os.path.join(work, "o.asm"), "cuda", "device", exe, db)
        finally:
            WE.wf_ed_core_rounds, EC.read_error_correction = real_rounds, real_ec
        if r["rc"] != 0:
            print(f"ec_profile: oatk failed with {r['rc']}", file=sys.stderr)
            return 1
        buf = WE._bufs.get(torch.device("cuda", torch.cuda.current_device()))
        split = lockstep.last if lockstep is not None else None
        row = dict(
            tag=tag, run=i, warm=i > 0, inflight=args.inflight, python_dfs=args.python_dfs,
            wall=r["wall"], ec_ms=smoke.ec_stage_ms(r["stages"]), stages=r["stages"],
            rounds=timed_rounds.rounds, launches=WE.wf_ed_core_batch.launches,
            items=WE.wf_ed_core_batch.items, extensions=ec_fn.wf_calls,
            rounds_host_ms=in_rounds[0] * 1000, split=split,
            peak=torch.cuda.max_memory_allocated(),
            pinned=sum(4 * t.numel() for t in (buf.h_in, buf.h_out) if t is not None) if buf else 0,
        )
        print(json.dumps({"ec_profile": row}), flush=True)
        if i:
            rows.append(row)

    def med(key, of=None):
        vals = [(r[of] or {}).get(key) if of else r[key] for r in rows]
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    summary = {k: med(k) for k in ("wall", "ec_ms", "rounds_host_ms", "peak", "pinned")}
    summary.update({k: med(k, "split") for k in ("layout_s", "pack_s", "trip_s", "unpack_s",
                                                   "upload_ms", "kernel_ms", "readback_ms")})
    print(json.dumps({"ec_profile_median": dict(tag=tag, runs=len(rows), inflight=args.inflight,
                                                python_dfs=args.python_dfs, **summary)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
