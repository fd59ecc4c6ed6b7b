#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``oatk_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure makes the exit code non-zero):

1. the card's name and power limit, and the torch / CUDA versions;
2. build the CUDA kernel (``oatk_tpu_torch/csrc/syncmer_select.cu``) from
   the sources in the checkout, with the compiler's register report;
3. the kernel against its plain PyTorch version, both on the card,
   exactly: one main-path chunk at k=1001/s=31 (2048 rows x 16384
   positions = 32 Mi positions, ragged read ends, Ns at 1e-3) and small
   (w, s) cases; median times by CUDA events;
4. full ``syncasm`` on the card and with ``device="cpu"`` (the kernels'
   plain versions) on a 1.2 Mbp set (k=151/s=13/c=3) and a ~10 Mbp set
   (k=1001/s=31/c=3): the GFAs must be byte-identical;
5. full ``syncasm`` on the card on the 110 Mbp organelle-plus-nuclear
   set (k=1001, s=31, c=30, EC on, 3 unzip rounds): wall time, stage
   split, kernel launch count (must be above 0), peak device memory,
   S/L line counts and the sha256 of ``.utg.final.gfa``.

The last two lines of standard output are the card line and a JSON
object ``{"ok": true, "device": {...}}``; the line before them lists the
kernels with their launch counts and times.  Without a CUDA device the
script prints no result and exits with code 2.  Datasets are generated
from fixed seeds into ``build/chip_smoke/`` (git-ignored).
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

K_MAIN, S_MAIN = 1001, 31
# (w, s, B, L) small selection cases: Ns, pads, rows shorter than w+4,
# multi-tile rows
SMALL_CASES = [
    (15, 5, 16, 700),
    (51, 11, 16, 3000),
    (91, 13, 8, 5000),
    (151, 13, 8, 9000),
    (1001, 31, 8, 16384),
    (1001, 31, 4, 900),
]


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if lines else f"nvidia-smi failed: {r.stderr.strip()}"


def log(msg: str) -> None:
    print(msg, flush=True)


def make_select_input(rng, B: int, L: int, w: int, n_rate: float, device):
    """codes_padded [B, 1+L+w+2] uint8: random bases, Ns at n_rate,
    ragged read ends (pad 5 after each row's length), pad columns."""
    import numpy as np
    import torch

    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < n_rate] = 4
    hl = rng.integers(max(1, L // 2), L + 1, B)
    hl[0] = L
    if B > 1:
        hl[1] = min(L, w + 3)  # a row shorter than w+4
    for b in range(B):
        codes[b, hl[b]:] = 5
    cp = np.pad(codes, ((0, 0), (1, w + 2)), constant_values=5)
    return torch.from_numpy(cp).to(device)


def median_ms(fn, reps: int) -> float:
    """Median time of fn() on the card, by CUDA events."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_kernel(device, main_shape=(2048, 16384), small=SMALL_CASES, reps=10) -> dict:
    """Kernel vs plain version on the same card tensors, exactly."""
    import numpy as np
    import torch

    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select, syncmer_select_plain

    rng = np.random.default_rng(20261016)
    worst = 0
    ok = True
    cases = [(K_MAIN, S_MAIN, *main_shape, 1e-3)] + [(w, s, B, L, 1e-3) for w, s, B, L in small]
    res = {}
    for i, (w, s, B, L, nr) in enumerate(cases):
        x = make_select_input(rng, B, L, w, nr, device)
        got = syncmer_select(x, w, s)
        torch.cuda.synchronize()
        ref = syncmer_select_plain(x, w, s)
        err = int((got.long() - ref.long()).abs().max()) if got.numel() else 0
        n_sel = int((ref != 0).sum())
        same = bool(torch.equal(got, ref))
        ok &= same and (n_sel > 0 or i > 0)
        worst = max(worst, err)
        ms = median_ms(lambda: syncmer_select(x, w, s), reps)
        plain_ms = median_ms(lambda: syncmer_select_plain(x, w, s), max(3, reps // 3))
        log(f"[kernel] w={w} s={s} B={B} L={L}: equal={same} max_abs_err={err} "
            f"n_sel={n_sel} kernel {ms:.4f} ms plain {plain_ms:.4f} ms (median, CUDA events)")
        if i == 0:
            res["ms"], res["plain_ms"] = ms, plain_ms
        del x, got, ref
    res["max_abs_err"] = worst
    res["ok"] = ok
    return res


def write_fasta(path: str, reads) -> int:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return sum(len(r) for r in reads)


def dataset_small(work: str) -> str:
    """1.2 Mbp: a(20 kbp) + rep(1.5 kbp) + b(16 kbp) + rep, 30x of 4 kbp."""
    import numpy as np
    from genome_sim import random_genome, sample_reads

    path = os.path.join(work, "set_1p2mbp.fa")
    rng = np.random.default_rng(7)
    a = random_genome(rng, 20_000)
    rep = random_genome(rng, 1_500)
    b = random_genome(rng, 16_000)
    reads = sample_reads(rng, a + rep + b + rep, coverage=30, read_len=4000,
                         err_rate=0.002, hp_frac=0.85)
    n = write_fasta(path, reads)
    log(f"[data] {path}: {len(reads)} reads, {n} bp")
    return path


def dataset_10mbp(work: str) -> str:
    """~10 Mbp: a 300 kbp genome at ~30x of 15 kbp reads."""
    import numpy as np
    from genome_sim import random_genome, sample_reads

    path = os.path.join(work, "set_10mbp.fa")
    rng = np.random.default_rng(2026)
    g = random_genome(rng, 300_000)
    reads = sample_reads(rng, g, coverage=33, read_len=15_000, err_rate=0.001, hp_frac=0.85)
    n = write_fasta(path, reads)
    log(f"[data] {path}: {len(reads)} reads, {n} bp")
    return path


def dataset_110mbp(work: str) -> tuple[str, int]:
    """The 110 Mbp organelle-plus-nuclear recipe (mito 370 kbp with a
    12 kbp direct repeat at 120x, quadripartite plastid 154 kbp at 250x,
    nuclear background at 3x; 15 kbp reads, 0.1% errors)."""
    import numpy as np
    from genome_sim import random_genome, revcomp, sample_reads

    path = os.path.join(work, "set_110mbp.fa")
    rng = np.random.default_rng(20260818)
    core_a = random_genome(rng, 160_000)
    rep = random_genome(rng, 12_000)
    core_b = random_genome(rng, 186_000)
    mito = core_a + rep + core_b + rep
    lsc = random_genome(rng, 86_000)
    ir = random_genome(rng, 25_000)
    ssc = random_genome(rng, 18_000)
    pltd = lsc + ir + ssc + revcomp(ir)
    reads = []
    reads += sample_reads(rng, mito, coverage=120, read_len=15_000,
                          err_rate=0.001, hp_frac=0.85)
    reads += sample_reads(rng, pltd, coverage=250, read_len=15_000,
                          err_rate=0.001, hp_frac=0.85)
    need = 110_000_000 - sum(len(r) for r in reads)
    for _ in range(8):
        g = random_genome(rng, int(need / 3 / 8))
        reads += sample_reads(rng, g, coverage=3, read_len=15_000,
                              err_rate=0.001, circular=False, hp_frac=0.85)
    rng.shuffle(reads)
    n = write_fasta(path, reads)
    log(f"[data] {path}: {len(reads)} reads, {n} bp")
    return path, n


def run_syncasm(fa: str, k: int, s: int, c: int, out: str, device, ec=True, unzip=3):
    import torch

    from oatk_tpu_torch.asm.pipeline import syncasm

    t0 = time.perf_counter()
    res = syncasm([fa], k=k, s=s, min_k_cov=c, do_ec=ec, do_unzip=unzip, out=out,
                  device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def gfa_summary(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    s_lines = [ln for ln in lines if ln.startswith(b"S\t")]
    return dict(
        bytes=len(data),
        S=len(s_lines),
        L=sum(1 for ln in lines if ln.startswith(b"L\t")),
        seg_bp=sum(len(ln.split(b"\t")[2]) for ln in s_lines),
        sha256=hashlib.sha256(data).hexdigest(),
    )


def phase_parity(work: str) -> bool:
    """Card vs CPU (plain versions) GFAs, byte for byte."""
    ok = True
    sets = [("1p2mbp", dataset_small(work), 151, 13, 3), ("10mbp", dataset_10mbp(work), K_MAIN, S_MAIN, 3)]
    for name, fa, k, s, c in sets:
        outs = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(work, f"{name}_{dev}")
            _res, wall = run_syncasm(fa, k, s, c, out, dev)
            outs[dev] = out
            log(f"[parity] {name} k={k} s={s} c={c} device={dev}: wall {wall:.3f} s")
        for suf in (".utg.gfa", ".utg.final.gfa"):
            a = gfa_summary(outs["cuda"] + suf)
            b = gfa_summary(outs["cpu"] + suf)
            same = a["sha256"] == b["sha256"]
            ok &= same and a["S"] > 0
            log(f"[parity] {name}{suf}: identical={same} S={a['S']} L={a['L']} "
                f"bytes={a['bytes']} (cpu S={b['S']} bytes={b['bytes']})")
    return ok


def phase_full(work: str) -> dict:
    """The main path on the card at 110 Mbp, with the launch count."""
    import torch

    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select

    fa, n_bp = dataset_110mbp(work)
    out = os.path.join(work, "full_110mbp")
    torch.cuda.reset_peak_memory_stats()
    syncmer_select.launches = 0
    res, wall = run_syncasm(fa, K_MAIN, S_MAIN, 30, out, "cuda", ec=True, unzip=3)
    launches = syncmer_select.launches
    peak = torch.cuda.max_memory_allocated()
    summ = gfa_summary(out + ".utg.final.gfa")
    stages = " ".join(f"{k}={v * 1000:.1f}ms" for k, v in (res.timings or {}).items())
    log(f"[full] 110 Mbp ({n_bp} bp) k={K_MAIN} s={S_MAIN} c=30 EC on, 3 unzip rounds: "
        f"wall {wall:.3f} s ({n_bp / 1e6 / wall:.3f} Mbp/s)")
    log(f"[full] [T::syncasm] {stages}")
    log(f"[full] syncmer_select launches={launches} max_memory_allocated={peak} B")
    log(f"[full] .utg.final.gfa: S={summ['S']} L={summ['L']} seg_bp={summ['seg_bp']} "
        f"sha256={summ['sha256']}")
    ok = launches > 0 and summ["S"] > 0 and res.scg is not None
    return dict(ok=ok, launches=launches)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        import genome_sim  # noqa: F401  (dataset generator)

        from oatk_tpu_torch.kernels import syncmer_select as SS
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    card = card_line()
    log(f"[card] {card}")
    log(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    os.makedirs(WORK, exist_ok=True)
    ok = True

    t0 = time.perf_counter()
    report = SS.build()
    SS._load()
    log(f"[build] syncmer_select.cu built in {time.perf_counter() - t0:.3f} s")
    for ln in report.splitlines():
        if "registers" in ln or "spill" in ln or "smem" in ln:
            log(f"[build] {ln.strip()}")

    kern = phase_kernel("cuda")
    ok &= kern["ok"]
    ok &= phase_parity(WORK)
    full = phase_full(WORK)
    ok &= full["ok"]

    kernels = {"kernels": [{
        "name": "syncmer_select",
        "route": "cuda",
        "source": "oatk_tpu_torch/csrc/syncmer_select.cu",
        "replaces": "oatk_tpu/kernels/syncmer_pallas.py:401",
        "launches": full["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}
    if not ok:
        log("[done] a phase failed")
        return 1
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
