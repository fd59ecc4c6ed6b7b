#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``oatk_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure makes the exit code non-zero):

1. the card's name and power limit, and the torch / CUDA versions;
2. build the CUDA sources (``oatk_tpu_torch/csrc/syncmer_select.cu``,
   ``oatk_tpu_torch/csrc/wf_ed.cu``, ``oatk_tpu_torch/csrc/syncmer_details.cu``)
   from the checkout, one nvcc each, and EC's C lockstep driver
   (``oatk_tpu_torch/csrc/ec_lockstep.c``, cc), started together, with the
   compiler's register, shared-memory and spill report;
3. the selection kernel against its plain PyTorch version, both on the
   card, exactly: one main-path chunk at k=1001/s=31 (2048 rows x 16384
   positions = 32 Mi positions, ragged read ends, Ns at 1e-3) and small
   (w, s) cases up to k=20001, each with at least 20 selections where its
   rows allow them; median times by CUDA events, the tile, shared memory
   per block and blocks per SM of each case;
3b. the blob decode (K3d) and the compaction and details (K4) kernels
   against their plain versions on the card, exactly over the whole
   output: the same bench chunk as an upload blob (K1 between them), the
   small cases, a forced overflow, a dense chunk and rows of odd length,
   K4 on its packed route and on its key route (all five key buffers
   and n_sel), and the rows and ASCII routes against their CPU runs;
   median times by CUDA events and device times beside each bound and
   the previous design's device times, the plain versions' and
   ``torch.nonzero``'s on the same ``sel``, each launch's device time,
   and the device events and K4 launches of one loader chunk on either
   route;
4. the wavefront kernel against its plain version on the card, exactly
   over the whole output state: 2,000 single states shaped like error
   correction's calls at k=1001 (tl up to 5,700, ql up to 6,600, EC's
   band, restarts from waves of up to ~200 diagonals), 40 unbanded
   small cases, one batched launch of 256 states on both of the
   kernel's memory routes, and one ragged round of the 2,000 EC-shaped
   states (as EC's lockstep scheduler launches them) on both routes;
   per-call, per-round and kernel-only times by CUDA events, the round's
   kernel at 128 and at 256 threads per block;
5. full ``syncasm`` on the card and with ``device="cpu"`` (the kernels'
   plain versions) on a 1.2 Mbp set (k=151/s=13/c=3) and a ~10 Mbp set
   (k=1001/s=31/c=3): the GFAs must be byte-identical;
6. full ``syncasm`` on the card on the 110 Mbp organelle-plus-nuclear
   set (k=1001, s=31, c=30, EC on, 3 unzip rounds): wall time, stage
   split and the load stage's own split (``load.extract``: the loader's
   main-thread queueing, ``load.finalize_dispatch``, ``load.nsel_drain``),
   the launch counts of K1, K3d and K4 (each must be above 0, every K4
   launch on the key route), ``torch.nonzero`` calls inside the loader
   and ``chunk_keys`` calls (both must be 0), the loader's counters (one
   n_sel read per file and none per chunk, or the phase fails; regrows,
   pinned staging bytes at 110 and 9.9 Mbp, uploads on the copy stream),
   peak device memory, S/L line counts and the sha256 of
   ``.utg.final.gfa``; then one run under torch.profiler (each kernel's
   summed device time, all device events and their number per chunk,
   the host-to-device copies from pinned memory and those that overlap
   another chunk's K1 or K4) and a third run: the three GFAs must be
   byte-identical;
7. ``oatk`` (syncasm -> annotation -> pathfinder) through its CLI at its
   defaults on the same 110 Mbp set, with a stub nhmmscan written into
   the work directory: on the card with OATK_TPU_WF_BACKEND=device (EC's
   DFS of every read in lockstep, driven from C by ``csrc/ec_lockstep.c``,
   one wavefront launch per round), with ``--device cpu`` and the default
   backend, on the card with ``EC_INFLIGHT = 1`` (one launch per DFS
   extension), in lockstep again, and in lockstep with the DFS in Python
   (the native library hidden while EC runs).  Every output file
   byte-identical to the CPU run's, ``.utg.final.gfa`` equal to phase 6's,
   each card run on its EC route and no other, both kernels launched,
   every EC extension a launched item (no call left the kernel), one
   launch per round, in lockstep fewer than one launch per 20 extensions
   and an ``ec`` stage below the one-read run's, the Python DFS's rounds,
   items and extensions the C driver's; wall time, stage split, the
   ``ec`` stage's split (the C driver's layout, pack and unpack on the
   host, the round trip, and upload, kernel and read-back by CUDA events;
   bytes each way, pinned bytes, the card's idle share), rounds, items
   per launch, annotation and pathfinder time, peak device memory;
8. ``syncasm -D 55M`` through its CLI at 110 Mbp (the capped sequential
   loader, host counting) on the card and with ``--device cpu``: GFAs
   byte-identical, the data-limit line printed, fewer reads than phase 6,
   selection kernel launched;
9. OATK_TPU_COUNT=host (each chunk's rows fetched, host sort) at 110 and
   9.9 Mbp on the card: ``.utg.final.gfa`` equal to the device-count
   runs' (phases 6 and 5); load and collect_db times beside theirs;
10. OATK_TPU_DEVICE_HOCO=1 at 110 Mbp on the card (Python reader, raw
    ASCII upload, hoco phase on the card): ``.utg.final.gfa`` equal to
    phase 6's, every read's hoco codes, run lengths and N flags equal to
    phase 6's native-parse ReadDB; load time, bytes uploaded, peak memory;
11. a mixed FASTA/FASTQ file (the 9.9 Mbp reads, every other record as
    FASTQ) on the card and the CPU: the native loader steps aside, the
    Python reader's route extracts on the card, GFAs byte-identical;
12. OATK_TPU_DEVICE_CONSENSUS=1 at 110 Mbp on the card: ``.utg.final.gfa``
    equal to phase 6's; device call count and consensus stage times;
13. OATK_TPU_DEVICE_EM=1 at 110 Mbp on the card: at every EM call the
    card's coverage within max |dev - host| / max(1, |host|) <= 1e-9 of
    the host loop on the same inputs and iteration counts at most 2
    apart; whether ``.utg.final.gfa`` equals phase 6's is reported;
14. ``syncasm --cpu`` (host oracle extraction) through its CLI at 1.2 Mbp
    with ``--device cuda``: GFAs equal to phase 5's card GFAs;
15. ``syncasm --shards 1`` through its CLI at 110 Mbp (the sharded loader
    on a one-card mesh) on the card and with ``--device cpu``: both GFAs
    equal to phase 6's, the selection kernel launched; wall, load and
    collect_db beside phase 6's, peak device memory;
16. in-process meshes of 4 and 5 shards on ``cuda:0`` at 110 Mbp
    (``load_and_extract_sharded`` + ``build``): every read's m_pos, s_mer
    and k_mer and the SyncmerDB's h, s, cov and position lists equal to
    the single-device loader's; occurrences per shard, exchange bytes;
17. ``--shards 1`` with OATK_TPU_STAGE_SHARDS=4 at 110 Mbp (alignment and
    EC in 4 read blocks): both GFAs equal to phase 6's;
18. K11 (``sharded_extract_count_step``) on a 4-shard ``cuda:0`` mesh over
    2,048 reads of the 110 Mbp set: n_sel, n_distinct and the histogram
    equal to numpy's unique over the single-device extraction of the same
    rows, n_dropped all zero.

The kernels line's ``launches_by_route`` gives each kernel's launches
in each of phases 8-18 that reports them (K4 on every route, phases 10
and 15-18 included), read right after the run that drove it.

The last two lines of standard output are the card line and a JSON
object ``{"ok": true, "device": {...}}``; the line before them lists the
kernels with their launch counts, times and bounds (the larger of the
bytes each must move over 3.35 TB/s, the H100 SXM's memory rate, and its
operations over a compute rate: for the selection kernel the 32-bit
instructions of the function's own work on this run's input (``K1_OPS``),
each at its pipe's rate on 132 SMs at the card's maximum SM clock; for
the wavefront kernel its cell operations over 67 T/s; for the details
the larger of their bytes and their operations (``K4_OPS``) over 67 T/s;
for the decode its bytes).  The short card loops are
``python3 -c 'import chip_smoke as c; c.kernel_loop()'`` (the selection
kernel) and ``c.details_loop()`` (the decode and details kernels).
Without a CUDA device the script prints no result and exits with code 2.  Datasets are generated
from fixed seeds into ``build/chip_smoke/`` (git-ignored).
"""
from __future__ import annotations

import contextlib
import hashlib
import io
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
    # k above the shared-memory limit of a tile-plus-halo design
    (6001, 31, 8, 40000),
    (9001, 31, 8, 54000),
    (20001, 31, 8, 100000),
]
MIN_SELECTED = 20  # selections each case must hold where its rows are 2w long


HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
ALU_OPS = 67e12    # H100 SXM non-tensor rate, operations/s
SMS = 132          # H100 SXM
# 32-bit instructions per SM and clock (compute capability 9.0): the ALU
# pipe and the FMA pipe's IMAD each take 64 lanes; four schedulers issue
# one warp instruction each, 128 lanes in all
ALU_LANES, IMAD_LANES, ISSUE_LANES = 64, 64, 128

# The selection function's own work, for its bound: 32-bit instructions
# (ALU pipe only, IMAD only, either pipe) per unit of the data that needs
# them.  A 64-bit value is two words: a u64 compare is two ISETP, a u64
# min two ISETP and two SEL.  Loop control, addressing, loads and stores
# are not counted, nor is work the data does not need: an s-mer that
# holds a code >= 4 is the sentinel unhashed, and an output whose w codes
# hold one is 0 without its rules.
K1_OPS = {
    # every column: the code >= 4 test, the N-count prefix sum (an add)
    # and the test that the column's s-mer holds no code >= 4
    "column": (2, 0, 1),
    # every s-mer with no code >= 4: roll the forward code (funnel shift,
    # mask, shift-add) and its reverse complement (funnel shift, shift,
    # complement, shift-add): 5 + 2; canonical min, palindrome test and
    # sentinel select: 8; the Thomas-Wang hash: three shift-xor steps of
    # four, three multiplies by a constant as an IMAD pair plus the mask,
    # the first step's shift, add with carry and mask: 19 + 6 + 1; the
    # sliding minimum (prefix, suffix and their join, three u64 mins): 12
    "smer": (44, 6, 3),
    # every output: the N test (two prefix counts compared)
    "output": (1, 0, 0),
    # every output whose w codes hold no code >= 4: Bq1 and D (two u64
    # mins) 8, the open rule 4, case 2 4, case 3 9, the close rule 1,
    # joining the predicates 3, the code (two SEL) 2
    "clean": (31, 0, 0),
}

WF_STATES = 2000   # single states with the measured EC call distribution
WF_BATCH = 256     # one batched launch
WF_UNBANDED = 40   # unbanded small cases
OATK_SUFFIXES = (".utg.gfa", ".utg.final.gfa")


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


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, MHz (nvidia-smi clocks.max.sm)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(r.stdout.split()[0])


def sass_inner_loops(so: str, kernel: str) -> list:
    """Innermost loops of ``kernel`` in the SASS of ``so`` (``cuobjdump
    -sass``): for each backward branch whose span holds no other one, the
    opcodes from its target to the branch."""
    import re
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", so], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    body = next(f for f in text.split("Function : ")[1:] if kernel in f.split("\n", 1)[0])
    ins = [(int(m.group(1), 16), m.group(2).strip())
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    at = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, op) in enumerate(ins):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in at:
            loops.append((at[int(m.group(1), 16)], i))
    inner = [(b, e) for b, e in loops
             if not any(b <= b2 and e2 <= e and (b2, e2) != (b, e) for b2, e2 in loops)]
    return [[op for _, op in ins[b:e + 1]] for b, e in inner]


def k1_instructions() -> tuple[int, int]:
    """SASS instructions of the selection kernel's two per-position loop
    bodies, a diagnostic beside the bound (they hold the design's own
    overhead): the per-column pass (the one that loads a code byte and
    stores to shared memory) and the per-output rules (the one that
    stores to global memory); each body is one column or one output."""
    from oatk_tpu_torch.kernels import syncmer_select as SS

    SS._load()  # builds the library if this process has not
    loops = sass_inner_loops(SS._SO, "syncmer_select_kernel")
    col = max((lp for lp in loops if any("LDG" in op and "U8" in op for op in lp)
               and any(" STS" in f" {op}" for op in lp)), key=len)
    rules = max((lp for lp in loops if any("STG" in op for op in lp)), key=len)
    return len(col), len(rules)


def k1_work(x, w: int, s: int) -> tuple[dict, tuple, float]:
    """The selection function's work on ``x`` [B, 1+L+w+2]: how many of
    each unit of ``K1_OPS`` this input holds, the instructions (ALU, IMAD,
    either pipe) they need, and the least SM clocks that takes: the
    larger of each pipe's share over its lanes and all of them over the
    issue rate."""
    from oatk_tpu_torch.kernels.syncmer_select import _window_has

    B, Lp = x.shape
    L = Lp - w - 3
    inv = x >= 4
    n = dict(column=B * Lp, smer=int((~_window_has(inv, s)).sum()), output=B * L,
             clean=int((~_window_has(inv, w)[:, 1:1 + L]).sum()))
    ins = tuple(sum(n[u] * K1_OPS[u][i] for u in n) for i in range(3))
    clocks = max(ins[0] / ALU_LANES, ins[1] / IMAD_LANES, sum(ins) / ISSUE_LANES)
    return n, ins, clocks


def phase_kernel(device, main_shape=(2048, 16384), small=SMALL_CASES, reps=10) -> dict:
    """Kernel vs plain version on the same card tensors, exactly, each
    case with at least MIN_SELECTED selections where its rows are 2w
    long; per case the tile, shared memory per block and blocks per SM,
    and the bound: the larger of the bytes over HBM_BPS and the
    function's own instructions on this input (``k1_work``) over SMS at
    the card's maximum SM clock."""
    import numpy as np
    import torch

    from oatk_tpu_torch.kernels import syncmer_select as SS
    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select, syncmer_select_plain

    n_col, n_rules = k1_instructions()
    clk = sm_clock_mhz()
    log(f"[kernel] bound: the function's own 32-bit instructions (K1_OPS, per unit as ALU/IMAD/"
        f"either: {K1_OPS}) at {ALU_LANES}/{IMAD_LANES}/{ISSUE_LANES} lanes per SM and clock "
        f"(ALU, IMAD, issue) x {SMS} SMs x {clk:.0f} MHz (clocks.max.sm); diagnostic: the "
        f"kernel's SASS holds {n_col} instructions in its per-column body and {n_rules} in its "
        f"per-output body")
    ok = True
    worst = 0
    # Ns at 1e-3, or 0.3 per window where that is rarer (large k)
    cases = [(K_MAIN, S_MAIN, *main_shape, 1e-3)] + [(w, s, B, L, min(1e-3, 0.3 / w))
                                                      for w, s, B, L in small]
    res = {}
    for i, (w, s, B, L, nr) in enumerate(cases):
        x = make_select_input(np.random.default_rng((20261016, i)), B, L, w, nr, device)
        got = syncmer_select(x, w, s)
        torch.cuda.synchronize()
        ref = syncmer_select_plain(x, w, s)
        err = int((got.long() - ref.long()).abs().max()) if got.numel() else 0
        n_sel = int((ref != 0).sum())
        need = MIN_SELECTED if L >= 2 * w else 0
        same = bool(torch.equal(got, ref))
        ok &= same and n_sel >= need
        worst = max(worst, err)
        ms = median_ms(lambda: syncmer_select(x, w, s), reps)
        plain_ms = median_ms(lambda: syncmer_select_plain(x, w, s), max(3, reps // 3))
        tile = SS.choose_tile(L, w, s)
        smem, blocks = SS.occupancy(tile, w, s)
        # each input byte read once, each int32 code written once
        nbytes = x.numel() + 4 * B * L
        units, ins, clocks = k1_work(x, w, s)
        ops_s = clocks / (SMS * clk * 1e6)
        bound_ms = 1000 * max(nbytes / HBM_BPS, ops_s)
        bound_by = "bytes" if nbytes / HBM_BPS >= ops_s else "operations"
        log(f"[kernel] w={w} s={s} B={B} L={L}: equal={same} max_abs_err={err} n_sel={n_sel} "
            f"(at least {need}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms (median, CUDA events); "
            f"tile {tile} R {SS.run_length(tile, w, s)} smem {smem} B/block, {blocks} blocks/SM")
        log(f"[kernel] w={w} s={s} B={B} L={L}: bound {bound_ms:.4f} ms by {bound_by}: {nbytes} B "
            f"= {1000 * nbytes / HBM_BPS:.4f} ms; {units} -> ALU {ins[0]} IMAD {ins[1]} either "
            f"{ins[2]} instructions = {clocks:.0f} SM clocks = {1000 * ops_s:.4f} ms; "
            f"{100 * bound_ms / ms:.1f}% of it")
        if i == 0:
            res.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del x, got, ref
    res["max_abs_err"] = worst
    res["ok"] = ok
    return res


def kernel_loop() -> int:
    """The short card loop: build the selection kernel and run phase 3
    alone (``python3 -c 'import chip_smoke as c; c.kernel_loop()'``)."""
    from oatk_tpu_torch.kernels import syncmer_select as SS

    build_kernels({"syncmer_select.cu": SS})
    r = phase_kernel("cuda")
    log(f"[kernel] ok={r['ok']} {json.dumps({k: v for k, v in r.items() if k != 'ok'})}")
    return 0 if r["ok"] else 1


def make_blob(rng, B: int, Lp: int, w: int, n_rate: float, dense: bool = False):
    """An upload blob as the loader packs it (``asm/reads.py:chunk_blob``):
    random bases (near-periodic ones when ``dense``, so that most
    positions select), Ns at n_rate, ragged read ends (row 1 shorter than
    w+4).  Returns (blob uint8 numpy, n_cap)."""
    import numpy as np

    from oatk_tpu_torch.asm.reads import chunk_blob

    codes = rng.integers(0, 4, (B, Lp)).astype(np.uint8)
    if dense:
        period = np.tile(rng.integers(0, 4, 7).astype(np.uint8), Lp // 7 + 1)[:Lp]
        codes = np.where(rng.random((B, Lp)) < 0.2, codes, np.stack([np.roll(period, 3 * b) for b in range(B)]))
    q = codes.reshape(B, Lp // 4, 4)
    hl = rng.integers(max(1, Lp // 2), Lp + 1, B)
    hl[0] = Lp
    if B > 1:
        hl[1] = min(Lp, w + 3)
    blob, packed, hl_v, n_cap = chunk_blob(B, Lp, np.flatnonzero(rng.random(B * Lp) < n_rate))
    packed[:] = (q[..., 0] << 6) | (q[..., 1] << 4) | (q[..., 2] << 2) | q[..., 3]
    hl_v[:] = hl
    return blob, n_cap


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two int64 tensors of one shape, exactly (the
    bit patterns are unsigned hashes: compared as Python ints)."""
    d = (a != b).nonzero()
    if d.shape[0] == 0:
        return 0
    idx = tuple(d[:1000].t().cpu())
    return max(abs(int(x) - int(y)) for x, y in zip(a[idx].tolist(), b[idx].tolist()))


def ascii_rows(rng, B: int, L: int):
    """Raw read rows for the ASCII route: homopolymer-rich bases, upper
    and lower case, Ns at 1e-4, ragged lengths."""
    import numpy as np

    alphabet = np.frombuffer(b"ACGTacgt", np.uint8)
    seq = alphabet[rng.integers(0, 8, (B, L))]
    run = rng.random((B, L)) < 0.3
    for j in range(1, L):
        seq[:, j] = np.where(run[:, j], seq[:, j - 1], seq[:, j])
    seq[rng.random((B, L)) < 1e-4] = ord("N")
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lens[0] = L
    return seq, lens


def kernel_name(name: str) -> str:
    """A device event's name without its return type, namespace,
    template arguments and arguments."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].removeprefix("void ")


def profile_spans(fn) -> list:
    """(name, start us, end us) of every device event (kernels, copies,
    fills) that fn() made, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_device(fn) -> list:
    """(name, device us) of every device event that fn() made."""
    return [(name, t1 - t0) for name, t0, t1 in profile_spans(fn)]


def copy_overlaps(spans) -> tuple[int, int, int]:
    """Of a profiled run's host-to-device copies: (those from pinned
    memory, all of them, those that overlap a K1 or K4 launch).  A
    chunk's kernels wait for its own upload, so a copy that overlaps one
    is another chunk's."""
    kern = [(t0, t1) for name, t0, t1 in spans
            if "syncmer_select_kernel" in name or "sel_tiles_kernel" in name]
    copies = [(name, t0, t1) for name, t0, t1 in spans if "HtoD" in name]
    hit = sum(any(t0 < k1 and k0 < t1 for k0, k1 in kern) for _n, t0, t1 in copies)
    return sum("Pinned" in name for name, _a, _b in copies), len(copies), hit


def keys_case(cp, sel, w: int, s: int, max_out: int) -> tuple[bool, int, int]:
    """K4's key route (``selected_keys``) against its plain version on the
    same card tensors: every lane of the five buffers (the lanes around
    the chunk's too) and n_sel, exactly.  Returns (equal, max_abs_err,
    n_sel)."""
    import torch

    from oatk_tpu_torch.kernels import syncmer_details as SD

    B = sel.shape[0]
    off, n = 17, max_out + 40
    sids = torch.arange(B, dtype=torch.int64, device=sel.device) * 3 + 5
    bufs = [[torch.full((n,), 99, dtype=dt, device=sel.device)
             for dt in (torch.int64,) * 4 + (torch.int32,)] for _ in range(2)]
    got = SD.selected_keys(cp, sel, w, s, max_out, sids, bufs[0], off)
    torch.cuda.synchronize()
    want = SD.selected_keys_plain(cp, sel, w, s, max_out, sids, bufs[1], off)
    same = int(got[0]) == int(want[0]) and all(torch.equal(a, b) for a, b in zip(*bufs))
    err = max(max_abs_err(a.long(), b.long()) for a, b in zip(*bufs))
    return same, err, int(got[0])


def phase_details(device, main_shape=(2048, 16384), small=SMALL_CASES, reps=10) -> dict:
    """The decode (K3d) and details (K4) kernels against their plain
    versions on the same card tensors, exactly over the whole output:
    the bench chunk (K1 between them on the kernel's output), the small
    cases, a forced overflow, a dense chunk (most positions select) and
    rows of odd length (not a multiple of 4 or of K4's tile), on K4's
    packed route and its key route (``keys_case``), then the rows route
    (``extract_hoco_rows``) and the ASCII route
    (``extract_syncmers_ascii``) against their CPU runs; median times by
    CUDA events beside each bound, the plain versions' times and
    ``torch.nonzero`` on the same ``sel``; the device events and K4
    launches of one loader chunk on either route."""
    import numpy as np
    import torch

    from oatk_tpu_torch.asm.reads import _capacity
    from oatk_tpu_torch.kernels import syncmer_details as SD
    from oatk_tpu_torch.kernels.syncmer import extract_hoco_rows, extract_syncmers_ascii
    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select

    ok, dec_err, det_err, res = True, 0, 0, {}
    cases = ([(K_MAIN, S_MAIN, *main_shape, 1e-3, False)]
             + [(w, s, B, L, min(1e-3, 0.3 / w), False) for w, s, B, L in small]
             + [(15, 5, 8, 12288, 1e-3, True)])  # dense: most positions select
    for i, (w, s, B, L, nr, dense) in enumerate(cases):
        Lp = -(-L // 16) * 16
        blob, n_cap = make_blob(np.random.default_rng((20261018, i)), B, Lp, w, nr, dense)
        bt = torch.from_numpy(blob).to(device)
        cp = SD.decode_blob(bt, B, Lp, n_cap, w)
        torch.cuda.synchronize()
        cp_ref = SD.decode_blob_plain(bt, B, Lp, n_cap, w)
        same_dec = torch.equal(cp, cp_ref)
        sel = syncmer_select(cp, w, s)
        n_sel = int((sel != 0).sum())
        max_out = _capacity(B, Lp, w, s)
        # the loader's capacity, and one that overflows
        outs = [(max_out, "")] + ([(n_sel // 2, " overflow")] if (i in (0, 1) or dense) and n_sel > 1 else [])
        for mo, tag in outs:
            got = SD.selected_details(cp, sel, w, s, mo)
            torch.cuda.synchronize()
            ref = SD.selected_details_plain(cp, sel, w, s, mo)
            err = max_abs_err(got, ref)
            same = torch.equal(got, ref) and int(got[0, mo]) == n_sel
            same_k, err_k, n_k = keys_case(cp, sel, w, s, mo)
            same_k &= n_k == n_sel
            ok &= same and same_k
            det_err = max(det_err, err, err_k)
            log(f"[details] w={w} s={s} B={B} Lp={Lp}{tag}{' dense' if dense else ''}: n_sel={n_sel} "
                f"max_out={mo} packed equal={same} max_abs_err={err}; keys equal={same_k} "
                f"max_abs_err={err_k}")
        ok &= same_dec and (n_sel >= MIN_SELECTED or Lp < 2 * w)
        dec_err = max(dec_err, int((cp.int() - cp_ref.int()).abs().max()))
        log(f"[details] w={w} s={s} B={B} Lp={Lp}: decode equal={same_dec} n_cap={n_cap}")
        if i == 0:
            res.update(details_timing(bt, cp, sel, B, Lp, n_cap, w, s, max_out, reps))
            res["chunk_events"] = chunk_events(blob, B, Lp, n_cap, w, s, max_out, device)
        del bt, cp, cp_ref, sel
    rows = rows_case(device, reps)
    ok &= rows["rows_equal"]
    res.update(rows)

    rng = np.random.default_rng(20261019)
    for w, s, B, L in ((51, 11, 6, 21501), (K_MAIN, S_MAIN, 8, 12347)):  # rows of odd length
        cp = make_select_input(rng, B, L, w, 1e-3, device)
        sel = syncmer_select(cp, w, s)
        n_sel = int((sel != 0).sum())
        for mo in (n_sel + 100, max(1, n_sel // 3)):
            got = SD.selected_details(cp, sel, w, s, mo)
            torch.cuda.synchronize()
            same = torch.equal(got, SD.selected_details_plain(cp, sel, w, s, mo))
            same_k, err_k, n_k = keys_case(cp, sel, w, s, mo)
            ok &= same and same_k and n_k == n_sel > 0
            det_err = max(det_err, err_k)
            log(f"[details] odd rows w={w} s={s} B={B} L={L}: n_sel={n_sel} max_out={mo} "
                f"packed equal={same}; keys equal={same_k}")

    x = make_select_input(rng, 64, 16384, K_MAIN, 1e-3, "cpu")
    rows = x[:, 1:1 + 16384].contiguous()
    mo = _capacity(64, 16384, K_MAIN, S_MAIN)
    a = extract_hoco_rows(rows.to(device), K_MAIN, S_MAIN, mo).cpu()
    b = extract_hoco_rows(rows, K_MAIN, S_MAIN, mo)
    same_rows = torch.equal(a, b) and int(b[0, mo]) > 0
    seq, lens = ascii_rows(rng, 64, 15000)
    a = extract_syncmers_ascii(torch.from_numpy(seq).to(device), torch.from_numpy(lens).to(device),
                               K_MAIN, S_MAIN, mo)["packed"].cpu()
    b = extract_syncmers_ascii(torch.from_numpy(seq), torch.from_numpy(lens), K_MAIN, S_MAIN, mo)["packed"]
    same_ascii = torch.equal(a, b) and int(b[0, mo]) > 0
    log(f"[details] rows route (extract_hoco_rows, 64 x 16384) card equals CPU: {same_rows}; "
        f"ASCII route (extract_syncmers_ascii, 64 x 15000) card equals CPU: {same_ascii}")
    ok &= same_rows and same_ascii
    res.update(ok=ok, dec_err=dec_err, max_abs_err=det_err)
    return res


def unit_stream(rng, n_pos: int, w: int, n_rate: float):
    """A unit of the loader's key route (``asm/reads.py:_pack_stream``,
    rows ordered by length bucket as ``_load_files`` orders them): reads
    of 12,000 +- 2,400 hoco bases (the wgs-1G cell's 15 +- 3 kbp reads)
    up to ``n_pos`` positions, Ns at ``n_rate``.  Returns (stream, row_off,
    hl, buckets, n_rows) as numpy arrays and a list."""
    import numpy as np

    from oatk_tpu_torch.asm.reads import _pack_stream

    lens = np.clip(rng.normal(12000, 2400, n_pos // 12000 + 1).astype(np.int64), w + 4, None)
    lens = lens[: int(np.searchsorted(np.cumsum(lens), n_pos)) + 1]
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    codes = rng.integers(0, 4, int(offs[-1])).astype(np.uint8)
    isn = np.flatnonzero(rng.random(len(codes)) < n_rate).astype(np.int64)
    sg = _pack_stream((None, None, offs, codes, None, isn), w)
    order = np.argsort(sg.lp, kind="stable")
    inv = np.empty(len(lens), np.int64)
    inv[order] = np.arange(len(lens))
    n_rows = (inv[sg.n_rows >> 32] << 32) | (sg.n_rows & 0xFFFFFFFF)
    lp = sg.lp[order]
    edges = np.flatnonzero(np.diff(lp)) + 1
    buckets = [(int(a), int(b - a), int(lp[a]))
               for a, b in zip(np.append(0, edges), np.append(edges, len(lens)))]
    return sg.stream, sg.row_off[order], sg.hl[order], buckets, n_rows


def rows_case(device, reps: int, n_pos: int = 32 << 20) -> dict:
    """K3d as the key route's row gather (``decode_rows``) at a unit's
    shape (``unit_stream``, k=1001): the kernel against its plain version
    on the same card tensors, exactly; its median time by CUDA events and
    its device time by launch beside its bound, the bytes it must move
    (the stream, 12 B of row table per row, 8 B per N, and every output
    byte once) over HBM_BPS."""
    import numpy as np
    import torch

    from oatk_tpu_torch.kernels import syncmer_details as SD

    w = K_MAIN
    stream, row_off, hl, buckets, n_rows = unit_stream(np.random.default_rng(20261020), n_pos, w, 1e-4)
    st, ro, h, nr = (torch.from_numpy(a).to(device) for a in (stream, row_off, hl, n_rows))
    got = SD.decode_rows(st, ro, h, buckets, nr, w)
    torch.cuda.synchronize()
    want = SD.decode_rows_plain(st, ro, h, buckets, nr, w)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    del want
    ms = median_ms(lambda: SD.decode_rows(st, ro, h, buckets, nr, w), reps)
    by = {}
    for name, us in profile_device(lambda: [SD.decode_rows(st, ro, h, buckets, nr, w) for _ in range(5)]):
        by[kernel_name(name)] = by.get(kernel_name(name), 0.0) + us / 5
    us = sum(v for k, v in by.items() if "blob_" in k)
    out_bytes = sum(B * (1 + Lp + w + 2) for _r, B, Lp in buckets)
    nbytes = len(stream) + 12 * len(hl) + 8 * len(n_rows) + out_bytes
    bound = 1000 * nbytes / HBM_BPS
    log(f"[details] row gather (decode_rows) at a unit: {len(hl)} reads, {int(hl.sum())} hoco "
        f"positions in {len(buckets)} buckets, {len(n_rows)} Ns, w={w}: equal={same}; kernel "
        f"{ms:.4f} ms (median, CUDA events), {us:.1f} us device ("
        + "; ".join(f"{k} {v:.1f}" for k, v in sorted(by.items()))
        + f"); bound {bound:.4f} ms by bytes ({nbytes} B), {100 * bound / ms:.1f}% of it by "
        f"events, {100000 * bound / us:.1f}% by device time")
    return dict(rows_equal=same, rows_ms=ms, rows_us=us, rows_bound_ms=bound, rows_reads=len(hl),
                rows_buckets=len(buckets))


# 32-bit operations of the details' own work, for K4's bound: the
# nonzero test of every selection code; per selected window the s-mer's
# codes (two shift-ors per base) and the payload (min, compare, select,
# shift-or: about 12); per 32-base Murmur block the 2-bit pack (per
# 4 bases a mask, a multiply, a shift and a 64-bit shift-or: 5) and the
# mix (three 64-bit multiplies as 4 IMAD each, two 64-bit shift-xors,
# the xor into h: 18)
K4_OPS = {"code": 1, "window": 12, "smer_base": 4, "block": 40 + 18}


def details_ops(n_codes: int, n_win: int, w: int, s: int) -> int:
    nblk = -(-((w - 1) // 4 + 1) // 8)
    return (n_codes * K4_OPS["code"]
            + n_win * (K4_OPS["window"] + s * K4_OPS["smer_base"] + nblk * K4_OPS["block"]))


def window_bytes(sel, Wd: int, w: int, max_out: int) -> int:
    """Bytes of codes_padded [B, Wd] that the details must read: the union
    of the first min(n_sel, max_out) selected windows (w codes from
    column 1 + p of row b; windows never cross a row, and overlapping
    ones count once)."""
    import torch

    flat = (sel.reshape(-1) != 0).nonzero()[:max_out, 0]
    if not flat.numel():
        return 0
    L = sel.shape[1]
    start = (flat // L) * Wd + flat % L  # ascending, as flat is
    return w + int(torch.diff(start).clamp(max=w).sum())


# The previous design's device times at the bench chunk (2048 x 16384,
# k=1001/s=31), measured by this script on an H100 80GB HBM3 at 700 W: the
# decode one byte load per output byte, the compaction and details four
# launches (tile counts, a one-block scan, the compaction, the details)
PREVIOUS_US = {"decode": 53.4, "details": 146.4}


def details_timing(bt, cp, sel, B, Lp, n_cap, w, s, max_out, reps) -> dict:
    """Median times (CUDA events) of the decode and details kernels at
    one chunk, K4 on both routes, of their plain versions and of
    ``torch.nonzero`` on the same ``sel``; each kernel's device time by
    launch (torch.profiler); bounds: the bytes each must move (each input
    once, each output once; for the details all of ``sel``, only the
    selected windows of ``codes_padded`` (``window_bytes``) and 24 B per
    packed lane or 36 B per key lane) over HBM_BPS, and the details'
    operations (``K4_OPS``) over ALU_OPS."""
    import torch

    from oatk_tpu_torch.kernels import syncmer_details as SD

    n_win = min(int((sel != 0).sum()), max_out)
    sids = torch.arange(B, dtype=torch.int64, device=sel.device)
    bufs = [torch.zeros(max_out, dtype=dt, device=sel.device) for dt in (torch.int64,) * 4 + (torch.int32,)]
    dec_ms = median_ms(lambda: SD.decode_blob(bt, B, Lp, n_cap, w), reps)
    dec_plain = median_ms(lambda: SD.decode_blob_plain(bt, B, Lp, n_cap, w), max(3, reps // 3))
    det_ms = median_ms(lambda: SD.selected_details(cp, sel, w, s, max_out), reps)
    det_plain = median_ms(lambda: SD.selected_details_plain(cp, sel, w, s, max_out), max(3, reps // 3))
    keys_ms = median_ms(lambda: SD.selected_keys(cp, sel, w, s, max_out, sids, bufs, 0), reps)
    keys_plain = median_ms(lambda: SD.selected_keys_plain(cp, sel, w, s, max_out, sids, bufs, 0),
                           max(3, reps // 3))
    nz_ms = median_ms(lambda: torch.nonzero(sel), reps)
    by, by_keys = {}, {}
    for into, fn in ((by, lambda: [SD.selected_details(cp, sel, w, s, max_out) for _ in range(5)]
                      + [SD.decode_blob(bt, B, Lp, n_cap, w) for _ in range(5)]),
                     (by_keys, lambda: [SD.selected_keys(cp, sel, w, s, max_out, sids, bufs, 0)
                                        for _ in range(5)])):
        for name, us in profile_device(fn):
            key = kernel_name(name)
            into[key] = into.get(key, 0.0) + us / 5
    dec_bytes = B * Lp // 4 + 4 * B + 4 * n_cap + cp.numel()
    win_bytes = window_bytes(sel, cp.shape[1], w, max_out)
    det_bytes = 4 * sel.numel() + win_bytes + 24 * (max_out + 1)
    keys_bytes = 4 * sel.numel() + win_bytes + 36 * max_out + 8 * B + 8
    det_ops = details_ops(sel.numel(), n_win, w, s)
    dec_bound = 1000 * dec_bytes / HBM_BPS
    det_bound = 1000 * max(det_bytes / HBM_BPS, det_ops / ALU_OPS)
    keys_bound = 1000 * max(keys_bytes / HBM_BPS, det_ops / ALU_OPS)
    det_by = "bytes" if det_bytes / HBM_BPS >= det_ops / ALU_OPS else "operations"
    k4 = ("sel_tiles_kernel", "sel_details_kernel")
    dec_us = sum(v for k, v in by.items() if "blob_" in k)
    det_us = sum(v for k, v in by.items() if any(n in k for n in k4))
    keys_us = sum(v for k, v in by_keys.items() if any(n in k for n in k4))
    log(f"[details] decode at {B} x {Lp} (w={w}, n_cap={n_cap}): kernel {dec_ms:.4f} ms plain "
        f"{dec_plain:.4f} ms (median, CUDA events), {dec_us:.1f} us device (previous design "
        f"{PREVIOUS_US['decode']} us); bound {dec_bound:.4f} ms by bytes ({dec_bytes} B), "
        f"{100 * dec_bound / dec_ms:.1f}% of it by events, {100000 * dec_bound / dec_us:.1f}% by "
        f"device time")
    log(f"[details] details at {B} x {Lp} (w={w} s={s}, {n_win} windows, max_out {max_out}): kernel "
        f"{det_ms:.4f} ms plain {det_plain:.4f} ms (median, CUDA events), {det_us:.1f} us device "
        f"(previous design {PREVIOUS_US['details']} us); bound {det_bound:.4f} ms "
        f"by {det_by} ({det_bytes} B, of them {win_bytes} B of selected windows, = "
        f"{1000 * det_bytes / HBM_BPS:.4f} ms; {det_ops} operations = "
        f"{1000 * det_ops / ALU_OPS:.4f} ms), {100 * det_bound / det_ms:.1f}% of it by events, "
        f"{100000 * det_bound / det_us:.1f}% by device time")
    log(f"[details] key route at the same chunk: kernel {keys_ms:.4f} ms plain {keys_plain:.4f} ms "
        f"(median, CUDA events), {keys_us:.1f} us device; bound {keys_bound:.4f} ms ({keys_bytes} B), "
        f"{100000 * keys_bound / keys_us:.1f}% of it by device time")
    log("[details] device us per call by launch (torch.profiler, mean of 5): " + "; ".join(
        f"{k} {v:.1f}" for k, v in sorted(by.items())) + "; key route: " + "; ".join(
        f"{k} {v:.1f}" for k, v in sorted(by_keys.items())))
    log(f"[details] K4 launches per call {SD.DETAILS_LAUNCHES}; torch.nonzero on the same sel "
        f"{nz_ms * 1000:.1f} us (median, CUDA events; a yardstick for the compaction alone: it "
        f"also synchronises with the host)")
    return dict(dec_ms=dec_ms, dec_plain_ms=dec_plain, dec_bound_ms=dec_bound, dec_us=dec_us,
                ms=det_ms, plain_ms=det_plain, bound_ms=det_bound, bound_by=det_by, device_us=det_us,
                keys_ms=keys_ms, keys_plain_ms=keys_plain, keys_bound_ms=keys_bound, keys_us=keys_us,
                nonzero_ms=nz_ms, by_launch=by, by_launch_keys=by_keys)


def chunk_events(blob, B, Lp, n_cap, w, s, max_out, device) -> dict:
    """The device events and K4 launches of one loader chunk on the card
    (upload, the extraction chain, the n_sel read), by torch.profiler: on
    the packed route (host counting: a pageable upload, the read per
    chunk) and on the key route as the loader queues it (blob and sids in
    one pinned upload on the copy stream, the append; the loader reads
    n_sel once per file, here once for the chunk)."""
    import numpy as np

    from oatk_tpu_torch.asm.reads import Uploads, extract_chunk
    from oatk_tpu_torch.index.devcount import DevCountState
    from oatk_tpu_torch.kernels import syncmer_details as SD

    st = DevCountState(device, cap_hint=8 * max_out)
    up = Uploads(device)
    sids = np.arange(B, dtype=np.int64)

    def key_chunk():
        blob_d, sids_d = up.put(blob, sids)
        _off, n_sel = st.append(blob_d, B, Lp, n_cap, w, s, max_out, sids_d)
        up.done()
        return int(n_sel[0])

    out = {}
    for route, fn in (("packed", lambda: extract_chunk(blob, B, Lp, n_cap, w, s, max_out, device)),
                      ("keys", key_chunk)):
        fn()  # warm
        k4 = SD.selected_details.launches + SD.selected_keys.launches
        ev = profile_device(fn)
        k4 = SD.selected_details.launches + SD.selected_keys.launches - k4
        log(f"[details] one loader chunk, {route} route ({B} x {Lp}, w={w}): {len(ev)} device events, "
            f"{k4} K4 launches: " + "; ".join(f"{kernel_name(n)[:48]} {us:.1f} us" for n, us in ev))
        out[route] = dict(events=len(ev), k4_launches=k4)
    return out


def details_loop() -> int:
    """The short card loop for the decode and details kernels: build
    them and the selection kernel, run their phase alone
    (``python3 -c 'import chip_smoke as c; c.details_loop()'``)."""
    from oatk_tpu_torch.kernels import syncmer_details as SD
    from oatk_tpu_torch.kernels import syncmer_select as SS

    build_kernels({"syncmer_select.cu": SS, "syncmer_details.cu": SD})
    r = phase_details("cuda")
    log(f"[details] ok={r['ok']} {json.dumps({k: v for k, v in r.items() if k != 'ok'})}")
    return 0 if r["ok"] else 1


def event_ms(fn) -> float:
    """Time of one fn() on the card, by CUDA events (fn ends in a
    read-back or is followed by the synchronise here)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def wf_case(rng):
    """One wavefront input shaped like EC's calls at k=1001 (tl p50 ~740
    up to 5,700, ql p50 ~1.15 tl up to 6,600, band max(ceil(0.02 tl), 6)):
    the query is the target mutated at 0.1-1% with indels (a right
    branch), in a third of the cases with a random tail from some point
    on (a wrong branch, which leaves the band); in a third of them the
    state restarts from the alignment of a prefix.  One case in twenty is
    a long block with dense errors (2.5%) restarted at 70% of its query,
    so that restarts start from waves of 100-200 diagonals."""
    import numpy as np

    dense = rng.random() < 0.05
    if dense:
        tl = int(rng.integers(3000, 5701))
        ql = int(tl * rng.uniform(1.0, 1.15))
    else:
        tl = int(np.clip(rng.lognormal(np.log(740), 0.7), 10, 5700))
        ql = int(np.clip(tl * rng.uniform(0.7, 1.6), 7, 6600))
    ts = rng.integers(0, 4, tl).astype(np.uint8)
    q = list(ts[: min(tl, ql)])
    rate = 0.025 if dense else rng.uniform(0.001, 0.01) if rng.random() < 0.8 else 0.03
    for p in sorted(rng.choice(len(q), max(1, int(len(q) * rate)), replace=False), reverse=True):
        r = rng.random()
        if r < 0.6:
            q[p] = (q[p] + 1) % 4
        elif r < 0.8:
            del q[p]
        else:
            q.insert(p, int(rng.integers(4)))
    q += list(rng.integers(0, 4, max(0, ql - len(q))))
    qs = np.asarray(q[:ql], np.uint8)
    if not dense and rng.random() < 1 / 3:
        cut = int(rng.integers(0, ql))
        qs[cut:] = rng.integers(0, 4, ql - cut)
    bw = max(int(np.ceil(tl * 0.02)), 6)
    if dense:
        restart = int(0.7 * ql)
    else:
        restart = int(rng.integers(1, ql)) if rng.random() < 1 / 3 and ql > 1 else 0
    return ts, qs, bw, restart


def wf_state(ts, qs, bw, restart, device):
    """The WfState of a case: fresh, or after aligning qs[:restart] on
    ``device`` (through ``wf_ed_core_device``), with the whole query set."""
    from oatk_tpu_torch.kernels.wavefront import WfState
    from oatk_tpu_torch.kernels.wf_ed import wf_ed_core_device

    st = WfState()
    st.reset(ts)
    st.is_ext = True
    st.bw = bw
    st.device = device
    if restart:
        st.qs = qs[:restart]
        wf_ed_core_device(st)
    st.qs = qs
    return st


def wf_tensors(states, device):
    """Batch tensors (ts, qs, meta, k) of WfStates, at widths of exactly
    the longest target and query (any width is allowed)."""
    import numpy as np
    import torch

    from oatk_tpu_torch.kernels.wf_ed import BIG, d_cap_for

    B = len(states)
    TL = max(1, max(len(s.ts) for s in states))
    QL = max(1, max(len(s.qs) for s in states))
    D_cap = max(d_cap_for(len(s.ts), len(s.qs), len(s.wk), s.bw, s.is_ext) for s in states)
    ts = np.zeros((B, TL), np.uint8)
    qs = np.zeros((B, QL), np.uint8)
    meta = np.zeros((B, 8), np.int32)
    k = np.full((B, D_cap), -BIG, np.int32)
    for b, s in enumerate(states):
        ts[b, : len(s.ts)] = s.ts
        qs[b, : len(s.qs)] = s.qs
        meta[b, :7] = (len(s.ts), len(s.qs), int(s.is_ext), s.bw, s.score, int(s.wd[0]), len(s.wk))
        k[b, : len(s.wk)] = s.wk
    return [torch.from_numpy(x).to(device) for x in (ts, qs, meta, k)]


def phase_wf(device, n_states=WF_STATES, batch=WF_BATCH, n_unbanded=WF_UNBANDED) -> dict:
    """The wavefront kernel against its plain version on the same card
    tensors, exactly over the full output state; per-call and kernel-only
    times by CUDA events."""
    import numpy as np
    import torch

    from oatk_tpu_torch.kernels import wf_ed as WE

    rng = np.random.default_rng(20261017)
    cases = [wf_case(rng) for _ in range(n_states)]
    states = [wf_state(*c, device) for c in cases]
    for _ in range(n_unbanded):
        tl = int(rng.integers(1, 300))
        ts = rng.integers(0, 4, tl).astype(np.uint8)
        qs = ts.copy()
        qs[rng.integers(0, tl, 1 + tl // 30)] = rng.integers(0, 4, 1 + tl // 30)
        st = wf_state(ts, qs[: int(rng.integers(1, tl + 1))], -1, 0, device)
        st.is_ext = bool(rng.integers(2))
        states.append(st)

    ok, worst, n_hit, n_max = True, 0, 0, 0
    k_ms, p_ms, d_ms, timed = [], [], [], []
    for i, st in enumerate(states):
        x = wf_tensors([st], device)
        om, okk = WE.wf_ed_core_batch(*x)
        torch.cuda.synchronize()
        om2, ok2 = WE.wf_ed_core_batch_plain(*x)
        err = max(int((om.long() - om2.long()).abs().max()), int((okk.long() - ok2.long()).abs().max()))
        same = torch.equal(om, om2) and torch.equal(okk, ok2) and int(om[0, 6]) == 0
        ok &= same
        worst = max(worst, err)
        n_hit += int(om2[0, 3])
        n_max = max(n_max, len(st.wk))
        if not same:
            log(f"[wf] MISMATCH state {i}: tl={len(st.ts)} ql={len(st.qs)} bw={st.bw} "
                f"n={len(st.wk)} kernel {om.tolist()} plain {om2.tolist()}")
        if 700 <= len(st.ts) <= 1000 and st.bw >= 0 and len(k_ms) < 200:
            timed.append(st)
            k_ms.append(event_ms(lambda: WE.wf_ed_core_batch(*x)))
            p_ms.append(event_ms(lambda: WE.wf_ed_core_batch_plain(*x)))
            snap = st.snapshot()
            d_ms.append(event_ms(lambda: WE.wf_ed_core_device(st)))
            st.restore(snap)
    log(f"[wf] {len(states)} single states ({n_states} with EC's distribution, "
        f"{n_unbanded} unbanded): equal={ok} max_abs_err={worst} hits={n_hit} "
        f"largest input wave n={n_max}")

    sel = states[:batch]
    xb = wf_tensors(sel, device)
    omb, okb = WE.wf_ed_core_batch(*xb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    omb2, okb2 = WE.wf_ed_core_batch_plain(*xb)
    torch.cuda.synchronize()
    plain_b = (time.perf_counter() - t0) * 1000
    omg, okg = WE.wf_ed_core_batch(*xb, force_global=True)
    torch.cuda.synchronize()
    same_b = torch.equal(omb, omb2) and torch.equal(okb, okb2)
    same_g = torch.equal(omg, omb2) and torch.equal(okg, okb2)
    ok &= same_b and same_g
    b_ms = median_ms(lambda: WE.wf_ed_core_batch(*xb), 10)
    g_ms = median_ms(lambda: WE.wf_ed_core_batch(*xb, force_global=True), 10)
    TL, QL, D_cap = xb[0].shape[1], xb[1].shape[1], xb[3].shape[1]
    log(f"[wf] batch B={len(sel)} TL={TL} QL={QL} D_cap={D_cap} "
        f"(smem {WE.smem_bytes(TL, QL, D_cap)} B): equal={same_b} global route equal={same_g}; "
        f"kernel {b_ms:.4f} ms (global route {g_ms:.4f} ms) plain {plain_b:.3f} ms (one run, host clock)")
    med = lambda v: sorted(v)[len(v) // 2] if v else float("nan")  # noqa: E731
    log(f"[wf] B=1 at tl 700-1000 ({len(k_ms)} states, median by CUDA events): kernel "
        f"{med(k_ms):.4f} ms, plain {med(p_ms):.4f} ms, wf_ed_core_device per call "
        f"(upload, launch, read-back) {med(d_ms):.4f} ms")
    rnd = phase_round(states[:n_states], device)
    ok &= rnd["ok"]
    profile_wf(timed, xb, rnd["args"])
    return dict(ok=ok, max_abs_err=max(worst, rnd["max_abs_err"]), ms=rnd["ms"],
                plain_ms=rnd["plain_ms"], bound_ms=rnd["bound_ms"], bound_by=rnd["bound_by"])


def clone_states(states):
    """Copies of WfStates that a call may advance without touching the
    originals."""
    import dataclasses

    return [dataclasses.replace(s, wd=s.wd.copy(), wk=s.wk.copy()) for s in states]


def phase_round(states, device) -> dict:
    """One ragged round of ``states`` (EC-shaped), as EC's lockstep
    scheduler launches it, against the ragged plain version on the same
    card buffer, exactly over the whole output, on the shared-memory
    route and with every item on the global route.  CUDA events time the
    kernel alone at 128 and 256 threads per block (in turns), the plain
    version once, the whole round (pack, upload, launch, read-back,
    unpack) and the same states as one B=1 call each.  The bound counts
    each item's ts, qs, meta and k[:n] read once and its out_meta and
    out_k[:S] written once, and four operations per wave cell of the
    steps the kernel ran plus one compare per target base."""
    import numpy as np
    import torch

    from oatk_tpu_torch.kernels import wf_ed as WE

    dev = torch.device(device)
    card = dev.type == "cuda"
    B = len(states)
    lim = WE._smem_limit_of(WE._load(), dev) if card else WE._I32_MAX
    inps, layouts = {}, {}
    for route, glob in (("shared", False), ("global", True)):
        lay = WE.round_layout(states, lim, glob)
        h = np.zeros(lay.in_words, np.int32)
        WE.pack_round(h, lay, states)
        inps[route], layouts[route] = torch.from_numpy(h).to(dev), lay
    lay, inp = layouts["shared"], inps["shared"]
    # (an item too large for shared memory keeps the global route here)
    scr_s = torch.empty(lay.scratch_words, dtype=torch.int32, device=dev) if lay.scratch_words else None
    out = torch.empty(lay.out_words, dtype=torch.int32, device=dev)
    WE.wf_ed_core_ragged(inp, out, B, lay.smem, scr_s)
    out_g = torch.empty_like(out)
    scratch = torch.empty(layouts["global"].scratch_words, dtype=torch.int32, device=dev)
    WE.wf_ed_core_ragged(inps["global"], out_g, B, 0, scratch)
    torch.cuda.synchronize()
    ref = torch.empty_like(out)
    plain_ms = event_ms(lambda: WE.wf_ed_core_ragged_plain(inp, ref, B))
    err = max(int((out.long() - ref.long()).abs().max()), int((out_g.long() - ref.long()).abs().max()))
    same, same_g = torch.equal(out, ref), torch.equal(out_g, ref)

    o = ref.cpu().numpy()
    om = o[lay.desc[:, 4, None] + np.arange(8)]
    tl, ql, n, score = lay.meta[:, 0], lay.meta[:, 1], lay.meta[:, 6], lay.meta[:, 4]
    S = lay.desc[:, 7]
    nbytes = int((tl + ql + 4 * n + 32 + 32 + 4 * S).sum())
    ops = int((4 * (om[:, 0] - score + 1) * om[:, 2] + tl).sum())
    bound_ms = 1000 * max(nbytes / HBM_BPS, ops / ALU_OPS)
    bound_by = "bytes" if nbytes / HBM_BPS >= ops / ALU_OPS else "operations"

    times = {128: [], 256: []}
    saved = WE.THREADS
    try:
        for t in (128, 256, 256, 128):
            WE.THREADS = t
            times[t].append(median_ms(lambda: WE.wf_ed_core_ragged(inp, out, B, lay.smem, scr_s), 10))
    finally:
        WE.THREADS = saved
    copies = [clone_states(states) for _ in range(3)]
    round_ms = sorted(event_ms(lambda c=c: WE.wf_ed_core_rounds(c, dev)) for c in copies)[1]
    one = clone_states(states)
    b1_ms = event_ms(lambda: [WE.wf_ed_core_device(st) for st in one])
    same_states = all(np.array_equal(a.wk, b.wk) and (a.score, a.t_end, a.q_end) == (b.score, b.t_end, b.q_end)
                      for a, b in zip(copies[0], one))
    ms = sorted(times[WE.THREADS])[0]
    log(f"[wf] ragged round of {B} EC-shaped states: in {4 * lay.in_words} B, out {4 * lay.out_words} B, "
        f"smem {lay.smem} B, widths S max {int(S.max())}, waves n max {int(n.max())}; "
        f"equal={same} global route equal={same_g} max_abs_err={err}; round states equal the B=1 "
        f"calls': {same_states}")
    log(f"[wf] ragged round kernel (median of 10 launches, CUDA events, in turns 128/256/256/128): "
        f"128 threads {times[128]} ms, 256 threads {times[256]} ms (THREADS={WE.THREADS}); "
        f"plain {plain_ms:.3f} ms (one run)")
    log(f"[wf] whole round (pack, upload, launch, read-back, unpack) {round_ms:.4f} ms vs the same "
        f"{B} states as B=1 wf_ed_core_device calls {b1_ms:.4f} ms (CUDA events); bound "
        f"{bound_ms * 1000:.3f} us by {bound_by} ({nbytes} B, {ops} operations)")
    return dict(ok=same and same_g and same_states, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, args=(inp, out, B, lay.smem, scr_s))


def profile_wf(states, xb, ragged) -> None:
    """torch.profiler over ``wf_ed_core_device`` on ``states`` (B=1 each),
    ten launches of the batch ``xb`` and five of the ragged round
    ``ragged`` (inp, out, B, smem): the kernel's own device time (these
    CUDA-event times above include the wrapper's host work, during
    which the card waits), and where one B=1 call's host time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from oatk_tpu_torch.kernels import wf_ed as WE

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for st in states:
            snap = st.snapshot()
            WE.wf_ed_core_device(st)
            st.restore(snap)
        torch.cuda.synchronize()
        for _ in range(10):
            WE.wf_ed_core_batch(*xb)
        torch.cuda.synchronize()
        for _ in range(5):
            WE.wf_ed_core_ragged(*ragged)
        torch.cuda.synchronize()
    ker = [e.time_range.elapsed_us() for e in prof.events()
           if "wf_ed_kernel" in e.name and e.device_type == torch.autograd.DeviceType.CUDA]
    med = lambda v: sorted(v)[len(v) // 2] if v else float("nan")  # noqa: E731
    b1, bb, br = ker[: len(states)], ker[len(states): len(states) + 10], ker[len(states) + 10:]
    log(f"[wf] profiler: wf_ed_kernel device time, median of {len(b1)} B=1 wf_ed_core_device calls "
        f"{med(b1):.1f} us, of {len(bb)} B={xb[0].shape[0]} launches {med(bb):.1f} us, of "
        f"{len(br)} ragged rounds of {ragged[2]} {med(br):.1f} us")
    rows = sorted(prof.key_averages(), key=lambda r: -r.self_cpu_time_total)[:8]
    n = max(1, len(states))
    log("[wf] profiler: host time per wf_ed_core_device call by op (self CPU us / call): " + "; ".join(
        f"{r.key} {r.self_cpu_time_total / n:.1f}" for r in rows))


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


@contextlib.contextmanager
def env_set(**kv):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def phase_parity(work: str) -> dict:
    """Card vs CPU (plain versions) GFAs, byte for byte.  Returns ok and,
    per set, its file, (k, s, c), the card GFAs' sha256 and the card
    run's stage split."""
    ok = True
    sets = [("1p2mbp", dataset_small(work), 151, 13, 3), ("10mbp", dataset_10mbp(work), K_MAIN, S_MAIN, 3)]
    info = {}
    for name, fa, k, s, c in sets:
        outs = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(work, f"{name}_{dev}")
            res, wall = run_syncasm(fa, k, s, c, out, dev)
            outs[dev] = out
            if dev == "cuda":
                info[name] = dict(fa=fa, ksc=(k, s, c), timings=res.timings or {}, sha={},
                                  load_counters=getattr(res.read_db, "load_counters", {}))
            log(f"[parity] {name} k={k} s={s} c={c} device={dev}: wall {wall:.3f} s")
        for suf in (".utg.gfa", ".utg.final.gfa"):
            a = gfa_summary(outs["cuda"] + suf)
            b = gfa_summary(outs["cpu"] + suf)
            same = a["sha256"] == b["sha256"]
            ok &= same and a["S"] > 0
            info[name]["sha"][suf] = a["sha256"]
            log(f"[parity] {name}{suf}: identical={same} S={a['S']} L={a['L']} "
                f"bytes={a['bytes']} (cpu S={b['S']} bytes={b['bytes']})")
    return dict(ok=ok, sets=info)


def reset_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from oatk_tpu_torch.kernels import syncmer_details as SD
    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select

    syncmer_select.launches = SD.decode_blob.launches = SD.decode_rows.launches = 0
    SD.selected_details.launches = SD.selected_keys.launches = 0


def read_counts() -> dict:
    """The launch counts of the selection, decode and details kernels
    (``decode``: K3d on a blob or as the key route's row gather;
    ``details``: K4 on either route; ``keys``: on the key route)."""
    from oatk_tpu_torch.kernels import syncmer_details as SD
    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select

    return dict(launches=syncmer_select.launches,
                decode=SD.decode_blob.launches + SD.decode_rows.launches,
                details=SD.selected_details.launches + SD.selected_keys.launches,
                keys=SD.selected_keys.launches)


@contextlib.contextmanager
def nonzero_counter():
    """Count calls of ``torch.nonzero`` and ``Tensor.nonzero`` for the
    block: ``box["n"]`` in all, ``box["load"]`` inside the loader
    (``asm.pipeline.load_and_extract``)."""
    import torch

    from oatk_tpu_torch.asm import pipeline as P

    box = {"n": 0, "load": 0}
    real_fn, real_m, real_load = torch.nonzero, torch.Tensor.nonzero, P.load_and_extract

    def fn(*a, **kw):
        box["n"] += 1
        return real_fn(*a, **kw)

    def method(self, *a, **kw):
        box["n"] += 1
        return real_m(self, *a, **kw)

    def load(*a, **kw):
        n0 = box["n"]
        try:
            return real_load(*a, **kw)
        finally:
            box["load"] += box["n"] - n0

    torch.nonzero, torch.Tensor.nonzero, P.load_and_extract = fn, method, load
    try:
        yield box
    finally:
        torch.nonzero, torch.Tensor.nonzero, P.load_and_extract = real_fn, real_m, real_load


@contextlib.contextmanager
def chunk_keys_counter():
    """Count calls of the device count's plain key decode
    (``index/devcount.py:chunk_keys``) for the block: ``box["n"]``."""
    from oatk_tpu_torch.index import devcount as DC

    box, real = {"n": 0}, DC.chunk_keys

    def counted(*a, **kw):
        box["n"] += 1
        return real(*a, **kw)

    DC.chunk_keys = counted
    try:
        yield box
    finally:
        DC.chunk_keys = real


# the extraction chain's kernels by their device names: K1, then the
# decode and details of csrc/syncmer_details.cu
DEVICE_KERNELS = ("syncmer_select_kernel", "blob_decode_kernel", "blob_n_scatter_kernel",
                  "sel_tiles_kernel", "sel_details_kernel")


def phase_full(work: str, parity: dict) -> dict:
    """The main path on the card at 110 Mbp, with the launch counts, the
    ``torch.nonzero`` calls inside the loader and the ``chunk_keys`` calls
    of the run (both must be 0: K4 writes the device count's keys), the
    loader's main-thread extraction time and its counters (one n_sel
    read per file and none per chunk, or the phase fails; regrows,
    pinned staging bytes beside the 10 Mbp run's, copy-stream uploads),
    one profiled run (each kernel's summed device time, all device
    events and their number per chunk, the host-to-device copies that
    overlap another chunk's K1 or K4) and a third run: the three GFAs
    must be byte-identical."""
    import torch

    from oatk_tpu_torch.asm.pipeline import resolve_device
    from oatk_tpu_torch.kernels import syncmer_details as SD

    fa, n_bp = dataset_110mbp(work)
    out = os.path.join(work, "full_110mbp")
    dev = resolve_device("cuda")
    with nonzero_counter() as probe:  # the counter sees the plain version's call
        x = torch.zeros((1, 64), dtype=torch.uint8, device=dev)
        SD.selected_details_plain(x, torch.ones((1, 64 - 18), dtype=torch.int32, device=dev), 15, 5, 8)
    with chunk_keys_counter() as kprobe:  # and the key route's plain version calls chunk_keys
        x = torch.zeros((1, 64), dtype=torch.uint8)
        bufs = [torch.zeros(8, dtype=dt) for dt in (torch.int64,) * 4 + (torch.int32,)]
        SD.selected_keys(x, torch.ones((1, 64 - 18), dtype=torch.int32), 15, 5, 8,
                         torch.zeros(1, dtype=torch.int64), bufs, 0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with nonzero_counter() as nz, chunk_keys_counter() as ck:
        res, wall = run_syncasm(fa, K_MAIN, S_MAIN, 30, out, "cuda", ec=True, unzip=3)
    cnt = read_counts()
    n_chunks = getattr(getattr(res.read_db, "_devcount_stats", None), "n_append", 0)
    peak = torch.cuda.max_memory_allocated()
    summ = gfa_summary(out + ".utg.final.gfa")
    stages = " ".join(f"{k}={v * 1000:.1f}ms" for k, v in (res.timings or {}).items())
    lt = getattr(res.read_db, "load_timings", None) or {}
    lc = getattr(res.read_db, "load_counters", None) or {}
    lc10 = parity["sets"]["10mbp"]["load_counters"]
    log(f"[full] 110 Mbp ({n_bp} bp) k={K_MAIN} s={S_MAIN} c=30 EC on, 3 unzip rounds: "
        f"wall {wall:.3f} s ({n_bp / 1e6 / wall:.3f} Mbp/s)")
    log(f"[full] [T::syncasm] {stages}")
    log("[full] load stage split: " + " ".join(f"load.{k}={v * 1000:.1f}ms" for k, v in lt.items()))
    log(f"[full] syncmer_select launches={cnt['launches']} decode launches={cnt['decode']} "
        f"details launches={cnt['details']} (key route {cnt['keys']}) over {n_chunks} appends "
        f"max_memory_allocated={peak} B")
    log(f"[full] torch.nonzero calls: {nz['load']} in the loader, {nz['n']} in the whole run "
        f"(the counter's self-check on the plain version: {probe['n']}); chunk_keys calls: "
        f"{ck['n']} (self-check on the key route's plain version: {kprobe['n']})")
    log(f"[full] .utg.final.gfa: S={summ['S']} L={summ['L']} seg_bp={summ['seg_bp']} "
        f"sha256={summ['sha256']}")
    one_read = (lc.get("files") == 1 and lc.get("nsel_reads", 0) - lc.get("regrows", 0) == 1
                and lc.get("chunk_reads") == 0
                and lc.get("copy_uploads") == lc.get("units", -1) + lc.get("regrows", 0)
                and lc.get("appends") == n_chunks
                and (lc.get("host_rows") == 0) == (lc.get("regrows") == 0))
    log(f"[full] loader counters: n_sel reads per file {lc.get('nsel_reads')}/{lc.get('files')} "
        f"(per chunk {lc.get('chunk_reads')}), regrows {lc.get('regrows')}, pinned bytes "
        f"{lc.get('pinned_bytes')} at 110 Mbp and {lc10.get('pinned_bytes')} at 9.9 Mbp, "
        f"copy-stream uploads {lc.get('copy_uploads')} for {lc.get('units')} units and "
        f"{n_chunks} appends, rows laid out on the card {lc.get('device_rows')}, on the host "
        f"{lc.get('host_rows')} (9.9 Mbp: {lc10.get('copy_uploads')} uploads); one read per file: "
        f"{one_read}")
    prof_out = os.path.join(work, "full_110mbp_prof")
    spans = profile_spans(lambda: run_syncasm(fa, K_MAIN, S_MAIN, 30, prof_out, "cuda", ec=True, unzip=3))
    ev = [(name, t1 - t0) for name, t0, t1 in spans]
    pinned, n_h2d, overlap = copy_overlaps(spans)
    by = {}
    for name, us in ev:
        key = next((k for k in DEVICE_KERNELS if k in name), "other")
        n, t = by.get(key, (0, 0.0))
        by[key] = (n + 1, t + us)
    same_prof = gfa_summary(prof_out + ".utg.final.gfa")["sha256"] == summ["sha256"]
    log(f"[full] profiled run: {len(ev)} device events, {sum(us for _, us in ev):.1f} us in all; "
        + "; ".join(f"{k} {n} x {t:.1f} us" for k, (n, t) in by.items())
        + f"; the chain without K1 {sum(by.get(k, (0, 0))[1] for k in DEVICE_KERNELS[1:]):.1f} us; "
        f"{len(ev) / max(1, n_chunks):.1f} device events per chunk; "
        f"GFA equal to the run above: {same_prof}")
    log(f"[full] profiled run: {n_h2d} host-to-device copies, {pinned} from pinned memory, "
        f"{overlap} overlapping a K1 or K4 launch of another chunk")
    third_out = os.path.join(work, "full_110mbp_3")
    _res3, wall3 = run_syncasm(fa, K_MAIN, S_MAIN, 30, third_out, "cuda", ec=True, unzip=3)
    sha3 = gfa_summary(third_out + ".utg.final.gfa")["sha256"]
    same_gfa = same_prof and sha3 == summ["sha256"]
    log(f"[full] third run: wall {wall3:.3f} s; .utg.final.gfa sha256 {sha3[:16]}; the 110 Mbp GFA "
        f"identical in all three runs: {same_gfa} (the hash on record: f00dc57aff042c80, "
        f"this run's {summ['sha256'][:16]})")
    ok = (cnt["launches"] > 0 and cnt["decode"] > 0 and cnt["details"] > 0
          and cnt["keys"] == cnt["details"] and nz["load"] == 0 and probe["n"] > 0
          and ck["n"] == 0 and kprobe["n"] > 0 and summ["S"] > 0 and res.scg is not None
          and same_gfa and one_read)
    return dict(ok=ok, fa=fa, n_bp=n_bp, sha256=summ["sha256"], read_db=res.read_db,
                timings=res.timings or {}, out=out, wall=wall, extract_s=lt.get("extract"),
                events=len(ev), chunks=n_chunks, chunk_keys_calls=ck["n"], load_counters=lc,
                copies_overlapping=overlap, **cnt)


FAKE_NHMMSCAN = """#!/bin/bash
# stub nhmmscan (HMMER is not a dependency of the smoke run):
# --noali --cpu 1 -o /dev/null --tblout OUT DB IN; one mito-like hit per sequence
out=""; db=""; fin=""
while [[ $# -gt 0 ]]; do
  case "$1" in
    --tblout) out="$2"; shift 2;;
    --noali|--cpu|-o) [[ "$1" == "--noali" ]] && shift || shift 2;;
    *) if [[ -z "$db" ]]; then db="$1"; else fin="$1"; fi; shift;;
  esac
done
: > "$out"
i=0
grep '^>' "$fin" | sed 's/>//' | while read -r name rest; do
  i=$((i+1))
  echo "nad$i - $name - 1 500 100 600 90 610 500 + 1e-30 450.0 0.5 -" >> "$out"
done
"""


def run_oatk(fa: str, out: str, device: str, backend: str, exe: str, db: str) -> dict:
    """``oatk`` through its CLI entry point at its defaults (k=1001, s=31,
    c=30, EC on, 3 unzip rounds), with EC's wavefront backend set; the
    stage split is read from OATK_TPU_TIMEIT's [T::syncasm] line and the
    EC summary from the log, both captured from stderr."""
    import contextlib
    import io

    import torch

    import oatk_tpu_torch.kernels.wavefront as TW
    from oatk_tpu_torch.cli import oatk as cli
    from oatk_tpu_torch.pathfind import driver as pf_mod

    spent = {}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return run

    saved = (TW.WF_BACKEND, cli.hmm_annotate, pf_mod.pathfinder, os.environ.get("OATK_TPU_TIMEIT"))
    TW.WF_BACKEND = backend
    cli.hmm_annotate = timed("annotation", cli.hmm_annotate)
    pf_mod.pathfinder = timed("pathfinder", pf_mod.pathfinder)
    os.environ["OATK_TPU_TIMEIT"] = "1"
    err = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["-m", db, "--nhmmscan", exe, "--device", device, "-o", out, fa])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TW.WF_BACKEND, cli.hmm_annotate, pf_mod.pathfinder, timeit = saved
        if timeit is None:
            os.environ.pop("OATK_TPU_TIMEIT", None)
        else:
            os.environ["OATK_TPU_TIMEIT"] = timeit
    text = err.getvalue()
    lines = text.splitlines()
    stages = next((ln for ln in lines if ln.startswith("[T::syncasm]")), "")
    ec = [ln.split("] ", 1)[1].strip() for ln in lines if ln.startswith("[M::read_error_correction]")]
    if rc != 0:
        sys.stderr.write(text[-4000:])
    return dict(rc=rc, wall=wall, stages=stages, ec=ec, spent=spent)


def ec_stage_ms(stages: str) -> float:
    """The ``ec`` stage of a [T::syncasm] line, in ms (nan if absent)."""
    return float(stages.split(" ec=")[1].split("ms")[0]) if " ec=" in stages else float("nan")


def ec_split_line(label: str, r: dict) -> str:
    """The ``ec`` stage of a C-driver run, split: the C driver's layout and
    pack (host), the round trip (upload, launch, read-back, synchronise;
    host clock) with its CUDA-event parts where they were recorded, the
    unpack, the rest of the stage; rounds, items, bytes, the card's idle
    share of the stage."""
    s = r["split"]
    items = sorted(s["items"])
    busy = s["upload_ms"] + s["kernel_ms"] + s["readback_ms"]
    host = {k: s[f"{k}_s"] * 1000 for k in ("layout", "pack", "trip", "unpack")}
    rest = r["ec_ms"] - r["driver_ms"]
    line = (f"[oatk] {label} ec split: {r['ec_ms']} ms = C driver {r['driver_ms']:.3f} ms (layout "
            f"{host['layout']:.3f} + pack {host['pack']:.3f} + round trip {host['trip']:.3f} + unpack "
            f"{host['unpack']:.3f} ms over {s['rounds']} rounds, "
            f"{(host['layout'] + host['pack'] + host['unpack']) * 1000 / max(1, s['rounds']):.1f} us "
            f"of host work per round; the EC inputs, finish and splice the rest) + "
            f"{rest:.3f} ms outside it (error syncmers, coverage rebuild); items {sum(items)}, per "
            f"round median {items[len(items) // 2] if items else 0} max {items[-1] if items else 0}; "
            f"uploaded {s['in_bytes']} B, read back {s['out_bytes']} B; global-route items "
            f"{s['n_global']}; pinned {r['pinned']} B")
    if busy:
        line += (f"; CUDA events: upload {s['upload_ms']:.3f} ms, kernel {s['kernel_ms']:.3f} ms, "
                 f"read-back {s['readback_ms']:.3f} ms: the card idles at least "
                 f"{100 * (1 - busy / r['ec_ms']):.2f}% of the stage")
    return line


def phase_oatk(work: str, fa: str, n_bp: int, syncasm_sha: str, card="cuda") -> dict:
    """This slice's main path: ``oatk`` on the 110 Mbp set, on the card
    with EC's wavefront kernel (OATK_TPU_WF_BACKEND=device: every read's
    DFS in lockstep, driven from C by ``csrc/ec_lockstep.c``), then with
    ``--device cpu`` and the default backend (native batch EC), then on
    the card with ``EC_INFLIGHT = 1`` (one launch per DFS extension),
    then in lockstep again, then with the DFS in Python (the native
    library hidden while EC runs: the route of a host without it).  Every
    output file byte-identical to the CPU run's, ``.utg.final.gfa`` the
    syncasm phase's, each card run on its route (the C driver, or the
    Python lockstep) and on no other, every EC extension a launched item,
    one launch per round, in lockstep fewer launches than one per 20
    extensions and an ``ec`` stage below the one-read run's, the Python
    lockstep's rounds, items and extensions the C driver's.  The ``ec``
    stage's split is printed for each C-driver run."""
    import glob

    import torch

    from oatk_tpu_torch import native
    from oatk_tpu_torch.asm import ec as EC
    from oatk_tpu_torch.kernels import wf_ed as WE
    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select

    exe = os.path.join(work, "fake_nhmmscan")
    with open(exe, "w") as f:
        f.write(FAKE_NHMMSCAN)
    os.chmod(exe, 0o755)
    db = os.path.join(work, "fake.hmm")
    with open(db, "w") as f:
        f.write("dummy\n")
    real = dict(ragged=WE.wf_ed_core_ragged, rounds=WE.wf_ed_core_rounds, ec=EC.read_error_correction,
                c=EC._correct_reads_lockstep_native, python=EC._correct_reads_lockstep)
    per_launch: list[int] = []
    events: list = []  # a CUDA event pair around each launch: its device time
    in_rounds = [0.0]  # host seconds inside wf_ed_core_rounds (the Python DFS's rounds)
    routes: dict = {}  # EC route -> [calls, host seconds]

    def recording(inp, out, B, *a):
        per_launch.append(B)
        if not inp.is_cuda:
            return real["ragged"](inp, out, B, *a)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        res = real["ragged"](inp, out, B, *a)
        ev[1].record()
        events.append(ev)
        return res

    def timed_rounds(states, device=None):
        t0 = time.perf_counter()
        try:
            return real["rounds"](states, device)
        finally:
            in_rounds[0] += time.perf_counter() - t0

    def route(name):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real[name](*a, **kw)
            finally:
                routes.setdefault(name, [0, 0.0])
                routes[name][0] += 1
                routes[name][1] += time.perf_counter() - t0
        return run

    def python_dfs(*a, **kw):
        """EC with the native library hidden: the device backend's DFS in Python."""
        saved = native.available
        native.available = lambda: False
        try:
            return real["ec"](*a, **kw)
        finally:
            native.available = saved

    # while they stand in for them, the real functions count their rounds
    # and extensions under their own names, that is, on the stand-ins

    outs, runs = {}, {}
    plan = (("card", card, "device", None, "c"), ("cpu", "cpu", "auto", None, None),
            ("card_one", card, "device", 1, "c"), ("card_again", card, "device", None, "c"),
            ("card_python", card, "device", None, "python"))
    for label, device, backend, inflight, dfs in plan:
        d = os.path.join(work, f"oatk_{label}")
        os.makedirs(d, exist_ok=True)
        for old in glob.glob(os.path.join(d, "o.asm.*")):
            os.remove(old)
        out = os.path.join(d, "o.asm")
        on_card = label != "cpu"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        syncmer_select.launches = 0
        WE.wf_ed_core_batch.launches = WE.wf_ed_core_batch.items = 0
        WE.wf_ed_lockstep.last = None
        # events only where the rounds are few: they would add to the
        # one-read run's 25k rounds
        WE.wf_ed_lockstep.events = inflight is None
        ec_fn = python_dfs if dfs == "python" else real["ec"]
        timed_rounds.rounds = 0
        ec_fn.wf_calls = 0
        per_launch.clear()
        events.clear()
        routes.clear()
        in_rounds[0] = 0.0
        saved = EC.EC_INFLIGHT
        EC.EC_INFLIGHT, WE.wf_ed_core_ragged, WE.wf_ed_core_rounds = inflight, recording, timed_rounds
        EC.read_error_correction = ec_fn
        EC._correct_reads_lockstep_native, EC._correct_reads_lockstep = route("c"), route("python")
        try:
            r = run_oatk(fa, out, device, backend, exe, db)
            wf_calls = ec_fn.wf_calls
        finally:
            EC.EC_INFLIGHT, WE.wf_ed_core_ragged, WE.wf_ed_core_rounds = saved, real["ragged"], real["rounds"]
            EC.read_error_correction = real["ec"]
            EC._correct_reads_lockstep_native, EC._correct_reads_lockstep = real["c"], real["python"]
            WE.wf_ed_lockstep.events = False
        buf = WE._bufs.get(torch.device("cuda", torch.cuda.current_device())) if on_card else None
        r.update(select=syncmer_select.launches, wf=WE.wf_ed_core_batch.launches,
                 items=WE.wf_ed_core_batch.items, rounds=timed_rounds.rounds,
                 wf_calls=wf_calls, per_launch=sorted(per_launch),
                 peak=torch.cuda.max_memory_allocated() if on_card else 0,
                 ec_ms=ec_stage_ms(r["stages"]), rounds_ms=in_rounds[0] * 1000,
                 kernel_ms=sum(a.elapsed_time(b) for a, b in events),
                 routes={k: v[0] for k, v in routes.items()},
                 driver_ms=routes.get("c", [0, 0.0])[1] * 1000, split=WE.wf_ed_lockstep.last,
                 pinned=sum(4 * t.numel() for t in (buf.h_in, buf.h_out) if t is not None) if buf else 0)
        runs[label], outs[label] = r, out
        sp = " ".join(f"{k}={v:.3f}s" for k, v in r["spent"].items())
        log(f"[oatk] {label} run, --device {device} OATK_TPU_WF_BACKEND={backend} "
            f"EC_INFLIGHT={inflight} DFS={dfs}: rc={r['rc']} wall {r['wall']:.3f} s "
            f"({n_bp / 1e6 / r['wall']:.3f} Mbp/s); {sp}")
        log(f"[oatk] {label} run {r['stages']}")
        log(f"[oatk] {label} run ec stage {r['ec_ms']} ms; EC: " + "; ".join(r["ec"][1:5]))
        if on_card:
            pl = r["per_launch"]
            log(f"[oatk] {label} run: EC routes {r['routes']}; syncmer_select launches={r['select']} "
                f"wf_ed launches={r['wf']} rounds={r['rounds']} items={r['items']} EC extensions="
                f"{r['wf_calls']}; items per launch median {pl[len(pl) // 2] if pl else 0} max "
                f"{pl[-1] if pl else 0}; max_memory_allocated={r['peak']} B")
            log(f"[oatk] {label} run: the kernels' device time at most {r['kernel_ms']:.3f} ms (CUDA "
                f"events around each launch, which also hold the host's launch work while the card "
                f"waits): the card idles at least {100 * (1 - r['kernel_ms'] / r['ec_ms']):.2f}% of "
                f"the stage")
        if dfs == "c" and r["split"] is not None:
            log(ec_split_line(label, r))
        elif dfs == "python":
            log(f"[oatk] {label} run: of the ec stage's {r['ec_ms']} ms, {r['rounds_ms']:.1f} ms "
                f"(host clock) inside wf_ed_core_rounds (pack, upload, launch, wait, read-back, "
                f"unpack), the rest the Python DFS, error syncmers and coverage rebuild")

    names = {lb: sorted(os.path.basename(p)[len("o.asm"):] for p in glob.glob(outs[lb] + ".*"))
             for lb in outs}
    ok = all(r["rc"] == 0 for r in runs.values())
    ok &= all(s in names["cpu"] for s in OATK_SUFFIXES)
    card_runs = ("card", "card_one", "card_again", "card_python")
    for lb in card_runs:
        ok &= names[lb] == names["cpu"]
        for suf in names["cpu"]:
            a = gfa_summary(outs[lb] + suf)
            b = gfa_summary(outs["cpu"] + suf)
            same = a["sha256"] == b["sha256"] and a["bytes"] > 0
            ok &= same
            log(f"[oatk] {lb} {suf}: identical to the CPU run's={same} bytes={a['bytes']} "
                f"sha256={a['sha256'][:16]}")
    final = gfa_summary(outs["card"] + ".utg.final.gfa")["sha256"]
    same_final = final == syncasm_sha
    log(f"[oatk] .utg.final.gfa equals the syncasm phase's: {same_final}")
    ok &= same_final
    c, one, again, py = (runs[lb] for lb in card_runs)
    on_route = all(runs[lb]["routes"] == {"c": 1} for lb in card_runs[:3]) and py["routes"] == {"python": 1}
    log(f"[oatk] every card run on its EC route (C driver x3, Python lockstep x1): {on_route}")
    ok &= on_route
    for r in (c, one, again, py):
        ok &= r["select"] > 0 and r["wf"] > 0 and r["items"] == r["wf_calls"] and r["wf"] == r["rounds"]
    ok &= c["wf"] * 20 < c["wf_calls"] and again["wf"] * 20 < again["wf_calls"]
    ok &= one["wf"] == one["wf_calls"] == c["wf_calls"]
    same_rounds = (py["rounds"], py["items"], py["wf_calls"]) == (c["rounds"], c["items"], c["wf_calls"])
    log(f"[oatk] Python lockstep: {py['rounds']} rounds, {py['items']} items, {py['wf_calls']} "
        f"extensions; the C driver's {c['rounds']}, {c['items']}, {c['wf_calls']}: same={same_rounds}")
    ok &= same_rounds
    faster = max(c["ec_ms"], again["ec_ms"]) < one["ec_ms"]
    log(f"[oatk] ec stage: C driver in lockstep {c['ec_ms']} / {again['ec_ms']} ms, EC_INFLIGHT=1 "
        f"{one['ec_ms']} ms, Python lockstep {py['ec_ms']} ms, native batch (CPU run) "
        f"{runs['cpu']['ec_ms']} ms; lockstep below the one-read run: {faster}; oatk wall C driver "
        f"{c['wall']:.3f} / {again['wall']:.3f} s, Python lockstep {py['wall']:.3f} s")
    ok &= faster
    return dict(ok=ok, launches=c["wf"], rounds=c["rounds"], items=c["items"], select=c["select"])


def run_cli(main, argv: list) -> dict:
    """A CLI entry point with OATK_TPU_TIMEIT on and stderr captured:
    exit code, wall time, the [T::syncasm] stage line, the read count
    from the log, and the whole stderr text."""
    import torch

    err = io.StringIO()
    with env_set(OATK_TPU_TIMEIT="1"), contextlib.redirect_stderr(err):
        t0 = time.perf_counter()
        rc = main(argv)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    text = err.getvalue()
    if rc != 0:
        sys.stderr.write(text[-4000:])
    lines = text.splitlines()
    stages = next((ln for ln in lines if ln.startswith("[T::syncasm]")), "")
    n_reads = next((int(ln.split(" from ")[1].split()[0]) for ln in lines
                    if ln.startswith("[M::syncasm] collected syncmers from")), -1)
    return dict(rc=rc, wall=wall, stages=stages, n_reads=n_reads, text=text)


def stage_ms(timings: dict, *names) -> str:
    return " ".join(f"{n}={timings.get(n, float('nan')) * 1000:.1f}ms" for n in names)


def same_gfas(tag: str, card_out: str, cpu_out: str) -> bool:
    """Both GFAs of a card run and its CPU twin byte-identical (and not
    empty), one log line each."""
    ok = True
    for suf in OATK_SUFFIXES:
        a, b = gfa_summary(card_out + suf), gfa_summary(cpu_out + suf)
        same = a["sha256"] == b["sha256"] and a["S"] > 0
        ok &= same
        log(f"[{tag}] {suf}: identical={same} S={a['S']} L={a['L']} sha256={a['sha256'][:16]}")
    return ok


def phase_capped(work: str, fa: str, n_reads_full: int, cap: str = "55M") -> dict:
    """``syncasm -D 55M`` through the CLI at 110 Mbp, on the card and with
    ``--device cpu``: byte-identical GFAs, the data-limit line, fewer
    reads than the uncapped run, and the selection kernel launched."""
    import torch

    from oatk_tpu_torch.cli._common import parse_data_size
    from oatk_tpu_torch.cli.syncasm import main as syncasm_main

    runs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(work, f"capped_{dev}")
        argv = [fa, "-k", str(K_MAIN), "-s", str(S_MAIN), "-c", "30", "-D", cap,
                "--device", dev, "-o", out]
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
        r = run_cli(syncasm_main, argv)
        if dev == "cuda":
            r.update(**read_counts(), peak=torch.cuda.max_memory_allocated())
        r["out"] = out
        runs[dev] = r
        log(f"[capped] -D {cap} --device {dev}: rc={r['rc']} wall {r['wall']:.3f} s, "
            f"{r['n_reads']} reads (uncapped {n_reads_full})")
        log(f"[capped] --device {dev} {r['stages']}")
    c = runs["cuda"]
    limit = (f"[M::sr_read] data limit ({parse_data_size(cap)}) reached. "
             "Discard the remaining sequences...")
    if any(r["rc"] != 0 for r in runs.values()):
        return dict(ok=False, launches=c["launches"], decode=c["decode"], details=c["details"])
    ok = all(limit in r["text"] for r in runs.values())
    ok &= 0 < c["n_reads"] < n_reads_full and c["n_reads"] == runs["cpu"]["n_reads"]
    ok &= same_gfas("capped", c["out"], runs["cpu"]["out"])
    log(f"[capped] card run: data-limit line={limit in c['text']} syncmer_select "
        f"launches={c['launches']} decode launches={c['decode']} details launches={c['details']} "
        f"max_memory_allocated={c['peak']} B")
    ok &= c["launches"] > 0 and c["decode"] > 0 and c["details"] > 0
    return dict(ok=ok, launches=c["launches"], decode=c["decode"], details=c["details"])


def phase_host_count(work: str, full: dict, parity: dict) -> dict:
    """OATK_TPU_COUNT=host on the card at 110 and 9.9 Mbp: the final GFA
    equals the device-count run's; load and collect_db beside it."""

    p10 = parity["sets"]["10mbp"]
    cases = [("110mbp", full["fa"], (K_MAIN, S_MAIN, 30), full["sha256"], full["timings"]),
             ("10mbp", p10["fa"], p10["ksc"], p10["sha"][".utg.final.gfa"], p10["timings"])]
    ok, launches, counts = True, {}, {}
    for name, fa, (k, s, c), ref_sha, ref_tm in cases:
        out = os.path.join(work, f"hostcount_{name}")
        reset_counts()
        with env_set(OATK_TPU_COUNT="host"):
            res, wall = run_syncasm(fa, k, s, c, out, "cuda")
        counts[name] = read_counts()
        launches[name] = counts[name]["launches"]
        sha = gfa_summary(out + ".utg.final.gfa")["sha256"]
        same = sha == ref_sha
        # collect_syncmer_db keeps the device count state it consumed
        ok &= same and launches[name] > 0 and not hasattr(res.read_db, "_devcount_stats")
        log(f"[hostcount] {name}: wall {wall:.3f} s; .utg.final.gfa equals the device-count "
            f"run's: {same} (sha256 {sha[:16]}); launches {counts[name]}")
        log(f"[hostcount] {name}: host count {stage_ms(res.timings or {}, 'load', 'collect_db')}; "
            f"device count {stage_ms(ref_tm, 'load', 'collect_db')}")
    return dict(ok=ok, **counts["110mbp"])


def phase_device_hoco(work: str, full: dict) -> dict:
    """OATK_TPU_DEVICE_HOCO=1 at 110 Mbp on the card: the final GFA
    equals phase 6's, every read's hoco arrays equal the native parse's."""
    import numpy as np
    import torch

    from oatk_tpu_torch.asm.consensus import _resolve_rl_m1
    from oatk_tpu_torch.kernels import syncmer as KS

    real_hoco, hoco_ms = KS.hoco_phase, []

    def timed_hoco(seq, lens):
        box = []
        hoco_ms.append((tuple(seq.shape), event_ms(lambda: box.append(real_hoco(seq, lens)))))
        return box[0]

    out = os.path.join(work, "devhoco_110mbp")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    KS.hoco_phase = timed_hoco
    try:
        with env_set(OATK_TPU_DEVICE_HOCO="1"):
            res, wall = run_syncasm(full["fa"], K_MAIN, S_MAIN, 30, out, "cuda")
    finally:
        KS.hoco_phase = real_hoco
    cnt = read_counts()
    launches = cnt["launches"]
    peak = torch.cuda.max_memory_allocated()
    sha = gfa_summary(out + ".utg.final.gfa")["sha256"]
    nat, dh = full["read_db"], res.read_db
    bad = 0
    for sid, (a, b) in enumerate(zip(nat.reads, dh.reads)):
        rl = a.ho_rl.astype(np.int64)
        if (rl == 255).any():
            rl = _resolve_rl_m1(nat, sid, 0, rl)
        same = (a.hoco_l == b.hoco_l and np.array_equal(a.hoco_code, b.hoco_code)
                and np.array_equal(rl, b.ho_rl.astype(np.int64)) and np.array_equal(a.is_n, b.is_n))
        bad += not same
    same_gfa = sha == full["sha256"]
    log(f"[devhoco] 110 Mbp: wall {wall:.3f} s, {stage_ms(res.timings or {}, 'load', 'collect_db')} "
        f"(native host hoco, phase 6: {stage_ms(full['timings'], 'load', 'collect_db')})")
    log(f"[devhoco] bytes uploaded {dh.upload_bytes} B; max_memory_allocated={peak} B; "
        f"syncmer_select launches={launches} details launches={cnt['details']}")
    log("[devhoco] hoco_phase per chunk (CUDA events): " + "; ".join(
        f"{b}x{n} {ms:.3f} ms" for (b, n), ms in hoco_ms))
    log(f"[devhoco] reads {dh.n} (native {nat.n}); reads whose hoco codes, run lengths or "
        f"N flags differ: {bad}; .utg.final.gfa equals phase 6's: {same_gfa}")
    ok = same_gfa and bad == 0 and dh.n == nat.n and launches > 0 and cnt["details"] > 0
    return dict(ok=ok, launches=launches, details=cnt["details"])


def write_mixed(src: str, dst: str) -> int:
    """The reads of ``src`` (single-line FASTA) with every other record
    written as FASTQ."""
    n = 0
    with open(src) as f, open(dst, "w") as g:
        lines = f.read().split("\n")
        for i in range(0, len(lines) - 1, 2):
            name, seq = lines[i][1:], lines[i + 1]
            if n % 2:
                g.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
            else:
                g.write(f">{name}\n{seq}\n")
            n += 1
    return n


def phase_mixed(work: str, parity: dict) -> dict:
    """A mixed FASTA/FASTQ file on the card and the CPU: the native
    loader returns None, the Python reader's route extracts, GFAs equal."""
    from oatk_tpu_torch.asm import pipeline as P

    p10 = parity["sets"]["10mbp"]
    fa = os.path.join(work, "set_10mbp_mixed.fa")
    n = write_mixed(p10["fa"], fa)
    k, s, c = p10["ksc"]
    seen = {}
    real_load, real_extract = P.load_and_extract, P.extract_all_syncmers

    def load(*a, **kw):
        db = real_load(*a, **kw)
        seen["loader"] = db
        return db

    def extract(*a, **kw):
        n0 = read_counts()
        db = real_extract(*a, **kw)
        seen["reader"] = {k: v - n0[k] for k, v in read_counts().items()}
        return db

    P.load_and_extract, P.extract_all_syncmers = load, extract
    outs, ok, cnt = {}, True, dict(launches=0, decode=0, details=0)
    try:
        for dev in ("cuda", "cpu"):
            seen.clear()
            reset_counts()
            outs[dev] = os.path.join(work, f"mixed_{dev}")
            _res, wall = run_syncasm(fa, k, s, c, outs[dev], dev)
            ok &= "loader" in seen and seen["loader"] is None and "reader" in seen
            if dev == "cuda":
                cnt = seen.get("reader", cnt)
            log(f"[mixed] {n} records, every other FASTQ, --device {dev}: wall {wall:.3f} s; "
                f"native loader returned None: {'loader' in seen and seen['loader'] is None}; "
                f"Python reader ran: {'reader' in seen}")
    finally:
        P.load_and_extract, P.extract_all_syncmers = real_load, real_extract
    ok &= same_gfas("mixed", outs["cuda"], outs["cpu"])
    log(f"[mixed] card run: launches in the Python reader's route {cnt}")
    ok &= cnt["launches"] > 0 and cnt["decode"] > 0 and cnt["details"] > 0
    return dict(ok=ok, **cnt)


CONSENSUS_STAGES = ("utg_gfa", "unzip_consensus", "final_gfa")


def phase_device_consensus(work: str, full: dict) -> dict:
    """OATK_TPU_DEVICE_CONSENSUS=1 at 110 Mbp on the card: the final GFA
    equals phase 6's exactly."""
    from oatk_tpu_torch.asm.consensus import _runlen_reps_device

    import numpy as np

    from oatk_tpu_torch.asm import consensus as CS

    per_call = []

    def timed_reps(rl_stack, m_seq, device):
        t0 = time.perf_counter()
        reps = _runlen_reps_device(rl_stack, m_seq, device)  # ends in a read-back
        t1 = time.perf_counter()
        host = 1 + np.floor(rl_stack[:m_seq].sum(0) / m_seq + 0.5).astype(np.int64)
        per_call.append((t1 - t0, time.perf_counter() - t1, rl_stack.shape, np.array_equal(reps, host)))
        return reps

    timed_reps.calls = 0  # the real function counts its calls under its own name
    out = os.path.join(work, "devcons_110mbp")
    CS._runlen_reps_device = timed_reps
    try:
        with env_set(OATK_TPU_DEVICE_CONSENSUS="1"):
            res, wall = run_syncasm(full["fa"], K_MAIN, S_MAIN, 30, out, "cuda")
    finally:
        CS._runlen_reps_device = _runlen_reps_device
    calls = len(per_call)
    sha = gfa_summary(out + ".utg.final.gfa")["sha256"]
    same = sha == full["sha256"]
    log(f"[devcons] 110 Mbp: wall {wall:.3f} s; device consensus calls={calls}; "
        f".utg.final.gfa equals phase 6's: {same}")
    log(f"[devcons] consensus stages, device {stage_ms(res.timings or {}, *CONSENSUS_STAGES)}; "
        f"host (phase 6) {stage_ms(full['timings'], *CONSENSUS_STAGES)}")
    med = lambda v: sorted(v)[len(v) // 2] * 1000 if v else float("nan")  # noqa: E731
    rows = sorted(sh[0] for _d, _h, sh, _e in per_call)
    n_bad = sum(not e for *_x, e in per_call)
    log(f"[devcons] per call (host clock, median of {len(per_call)}): device reduction with its "
        f"upload and read-back {med([c[0] for c in per_call]):.4f} ms, host numpy on the "
        f"same rows {med([c[1] for c in per_call]):.4f} ms (calls that differ: {n_bad}); "
        f"rows per call median {rows[len(rows) // 2] if rows else 0}, max {rows[-1] if rows else 0}")
    return dict(ok=same and calls > 0 and n_bad == 0)


def phase_device_em(work: str, full: dict) -> dict:
    """OATK_TPU_DEVICE_EM=1 at 110 Mbp on the card: every EM call held
    against the host loop on the same inputs (1e-9, iterations at most 2
    apart); the final GFA compared with phase 6's (reported only)."""
    import numpy as np

    from oatk_tpu_torch.asm import coverage as C

    real = C._em_device_run
    calls = []

    def checked(avg, u_flat, bid, nm_b, nlen, n_vtx, device):
        host = np.array(avg, np.float64)
        t0 = time.perf_counter()
        it_host = C._em_host_run(host, u_flat, bid, nm_b, nlen, n_vtx)
        t1 = time.perf_counter()
        dev, it = real(avg, u_flat, bid, nm_b, nlen, n_vtx, device)
        ms = (time.perf_counter() - t1) * 1000
        err = float((np.abs(dev - host) / np.maximum(1.0, np.abs(host))).max()) if n_vtx else 0.0
        calls.append((n_vtx, len(u_flat), it, it_host, err, ms, (t1 - t0) * 1000))
        return dev, it

    checked.calls = 0  # the real function counts its calls under its own name
    out = os.path.join(work, "devem_110mbp")
    C._em_device_run = checked
    try:
        with env_set(OATK_TPU_DEVICE_EM="1"):
            res, wall = run_syncasm(full["fa"], K_MAIN, S_MAIN, 30, out, "cuda")
    finally:
        C._em_device_run = real
    ok = bool(calls)
    for i, (n_vtx, n_mem, it, it_host, err, ms, host_ms) in enumerate(calls):
        good = err <= 1e-9 and abs(it - it_host) <= 2
        ok &= good
        log(f"[devem] EM call {i}: {n_vtx} unitigs, {n_mem} block members; iterations card {it} "
            f"host {it_host}; max |dev-host|/max(1,|host|) = {err:.3e}; card {ms:.3f} ms, "
            f"host loop {host_ms:.3f} ms (host clock); ok={good}")
    with open(out + ".utg.final.gfa", "rb") as f:
        got = f.read().split(b"\n")
    ref_path = os.path.join(work, "full_110mbp.utg.final.gfa")
    with open(ref_path, "rb") as f:
        ref = f.read().split(b"\n")
    sl = lambda ls: [ln for ln in ls if ln[:2] in (b"S\t", b"L\t")]  # noqa: E731
    a, b = sl(got), sl(ref)
    n_diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    log(f"[devem] 110 Mbp: wall {wall:.3f} s; {stage_ms(res.timings or {}, 'unzip_cov', 'final_cov')} "
        f"(host, phase 6: {stage_ms(full['timings'], 'unzip_cov', 'final_cov')})")
    log(f"[devem] .utg.final.gfa equals phase 6's: {got == ref}; S/L lines that differ: {n_diff}")
    return dict(ok=ok)


def phase_cpu_flag(work: str, parity: dict) -> dict:
    """``syncasm --cpu`` (host oracle extraction) through the CLI at
    1.2 Mbp with ``--device cuda``: GFAs equal phase 5's card GFAs."""
    from oatk_tpu_torch.cli.syncasm import main as syncasm_main

    p = parity["sets"]["1p2mbp"]
    k, s, c = p["ksc"]
    out = os.path.join(work, "cpuflag_1p2mbp")
    r = run_cli(syncasm_main, [p["fa"], "-k", str(k), "-s", str(s), "-c", str(c), "--cpu",
                               "--device", "cuda", "-o", out])
    if r["rc"] != 0:
        return dict(ok=False)
    ok = True
    for suf in OATK_SUFFIXES:
        sha = gfa_summary(out + suf)["sha256"]
        same = sha == p["sha"][suf]
        ok &= same
        log(f"[cpuflag] {suf}: equals phase 5's card GFA: {same} (sha256 {sha[:16]})")
    log(f"[cpuflag] --cpu --device cuda at 1.2 Mbp: rc={r['rc']} wall {r['wall']:.3f} s; {r['stages']}")
    return dict(ok=ok)


def same_as_full(tag: str, out: str, full: dict) -> bool:
    """Both GFAs of a run byte-identical to phase 6's, one log line each."""
    ok = True
    for suf in OATK_SUFFIXES:
        a, b = gfa_summary(out + suf), gfa_summary(full["out"] + suf)
        same = a["sha256"] == b["sha256"] and a["S"] > 0
        ok &= same
        log(f"[{tag}] {suf}: equals phase 6's: {same} S={a['S']} sha256={a['sha256'][:16]}")
    return ok


def phase_shards1(work: str, full: dict) -> dict:
    """``syncasm --shards 1`` through the CLI at 110 Mbp on the card (the
    sharded loader on a one-card mesh: device extraction, owner routing,
    the device sort) and with ``--device cpu``: both GFAs equal phase
    6's; wall, load and collect_db beside phase 6's, peak memory."""
    import torch

    from oatk_tpu_torch.cli.syncasm import main as syncasm_main

    ok, cnt = True, dict(launches=0, details=0)
    for dev in ("cuda", "cpu"):
        out = os.path.join(work, f"shards1_{dev}")
        argv = [full["fa"], "-k", str(K_MAIN), "-s", str(S_MAIN), "-c", "30", "--shards", "1",
                "--device", dev, "-o", out]
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
        r = run_cli(syncasm_main, argv)
        if dev == "cuda":
            cnt = read_counts()
            log(f"[shards1] card: syncmer_select launches={cnt['launches']} details launches="
                f"{cnt['details']} max_memory_allocated={torch.cuda.max_memory_allocated()} B")
        log(f"[shards1] --shards 1 --device {dev}: rc={r['rc']} wall {r['wall']:.3f} s "
            f"(phase 6, one device: {full['wall']:.3f} s)")
        log(f"[shards1] --device {dev} {r['stages']}")
        log(f"[shards1] phase 6: {stage_ms(full['timings'], 'load', 'collect_db')}")
        ok &= r["rc"] == 0 and same_as_full("shards1", out, full)
    return dict(ok=ok and cnt["launches"] > 0 and cnt["details"] > 0, launches=cnt["launches"],
                details=cnt["details"])


def phase_mesh(work: str, full: dict) -> dict:
    """In-process meshes of 4 and 5 shards on cuda:0 at 110 Mbp
    (load_and_extract_sharded + build): every read's m_pos, s_mer and
    k_mer, and the SyncmerDB's h, s, cov and position lists, equal to
    the single-device loader's (phase 6's loader, run again here);
    per-shard occurrence counts, exchange bytes, times, peak memory."""
    import numpy as np
    import torch

    from oatk_tpu_torch.asm.pipeline import load_reads
    from oatk_tpu_torch.dist.sharded_db import load_and_extract_sharded
    from oatk_tpu_torch.dist.sharding import Mesh
    from oatk_tpu_torch.index.syncmer_db import collect_syncmer_db
    from oatk_tpu_torch.kernels.syncmer_select import syncmer_select

    t0 = time.perf_counter()
    ref = load_reads([full["fa"]], K_MAIN, S_MAIN, device="cuda")
    ref_scm = collect_syncmer_db(ref)
    torch.cuda.synchronize()
    log(f"[mesh] single device: load + collect_db {time.perf_counter() - t0:.3f} s, "
        f"{ref_scm.n} syncmers over {ref.total_syncmers()} occurrences")
    ok, launches, details = True, {}, {}
    for n in (4, 5):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        db, coll = load_and_extract_sharded([full["fa"]], K_MAIN, S_MAIN, Mesh(["cuda:0"] * n))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scm = coll.build(db)
        t2 = time.perf_counter()
        launches[f"mesh{n}"] = syncmer_select.launches
        details[f"mesh{n}"] = read_counts()["details"]
        bad = [r1.sid for r1, r2 in zip(ref.reads, db.reads)
               if not all(np.array_equal(getattr(r1, f), getattr(r2, f))
                          for f in ("m_pos", "s_mer", "k_mer"))]
        same = (db.n == ref.n and not bad and scm.n == ref_scm.n and all(
            np.array_equal(getattr(scm, f), getattr(ref_scm, f))
            for f in ("h", "s", "cov", "mp_flat", "mp_off")))
        ok &= same and launches[f"mesh{n}"] > 0 and details[f"mesh{n}"] > 0
        log(f"[mesh] {n} shards on cuda:0: load+route {t1 - t0:.3f} s, build {t2 - t1:.3f} s, "
            f"{coll.n_steps} batches, syncmer_select launches={launches[f'mesh{n}']}, "
            f"details launches={details[f'mesh{n}']}, "
            f"max_memory_allocated={torch.cuda.max_memory_allocated()} B")
        log(f"[mesh] {n} shards: occurrences per shard {coll.occ_per_shard}, "
            f"exchange {coll.exchange_bytes} B of (hash, low) pairs off their shard")
        log(f"[mesh] {n} shards: ReadDB and SyncmerDB equal the single device's: {same} "
            f"(reads that differ: {len(bad)})")
    return dict(ok=ok, launches=launches, details=details)


def phase_stage_shards(work: str, full: dict) -> dict:
    """``--shards 1`` with OATK_TPU_STAGE_SHARDS=4 at 110 Mbp on the card:
    alignment and EC in 4 read blocks, merged; both GFAs equal phase 6's."""
    from oatk_tpu_torch.cli.syncasm import main as syncasm_main

    out = os.path.join(work, "stageshards_110mbp")
    reset_counts()
    with env_set(OATK_TPU_STAGE_SHARDS="4"):
        r = run_cli(syncasm_main, [full["fa"], "-k", str(K_MAIN), "-s", str(S_MAIN), "-c", "30",
                                   "--shards", "1", "--device", "cuda", "-o", out])
    cnt = read_counts()
    log(f"[stageshards] OATK_TPU_STAGE_SHARDS=4 --shards 1: rc={r['rc']} wall {r['wall']:.3f} s; "
        f"syncmer_select launches={cnt['launches']} details launches={cnt['details']}; {r['stages']}")
    ok = r["rc"] == 0 and same_as_full("stageshards", out, full)
    return dict(ok=ok and cnt["launches"] > 0 and cnt["details"] > 0, launches=cnt["launches"],
                details=cnt["details"])


def chunk_rows(fa: str, n_rows: int):
    """The first ``n_rows`` reads of a FASTA as ASCII rows [n_rows, L]
    (L the longest) and their lengths."""
    import numpy as np

    seqs = []
    with open(fa) as f:
        for ln in f:
            if not ln.startswith(">"):
                seqs.append(ln.strip())
                if len(seqs) == n_rows:
                    break
    seq = np.zeros((len(seqs), max(len(q) for q in seqs)), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, q in enumerate(seqs):
        seq[i, : len(q)] = np.frombuffer(q.encode(), np.uint8)
        lens[i] = len(q)
    return seq, lens


def phase_k11(work: str, full: dict, n_rows: int = 2048) -> dict:
    """K11 (sharded_extract_count_step) on a 4-shard cuda:0 mesh over one
    chunk of the 110 Mbp reads: n_sel, n_distinct and the histogram
    equal numpy's unique over the single-device extraction of the same
    rows; n_dropped all zero."""
    import numpy as np
    import torch

    from oatk_tpu_torch.asm.reads import _round_up
    from oatk_tpu_torch.dist.sharding import Mesh, sharded_extract_count_step
    from oatk_tpu_torch.kernels.syncmer import extract_syncmers_ascii

    seq, lens = chunk_rows(full["fa"], n_rows)
    max_out = _round_up(seq.size // 64, 1024)
    reset_counts()
    t0 = time.perf_counter()
    nd, hist, n_sel, ndrop = sharded_extract_count_step(
        seq, lens, K_MAIN, S_MAIN, max_out, Mesh(["cuda:0"] * 4))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cnt = read_counts()
    launches = cnt["launches"]
    pk = extract_syncmers_ascii(torch.from_numpy(seq).cuda(), torch.from_numpy(lens).cuda(),
                                K_MAIN, S_MAIN, max_out)["packed"]
    n = int(pk[0, max_out])
    _, counts = np.unique(pk[2, :n].cpu().numpy().view(np.uint64), return_counts=True)
    want = np.bincount(np.clip(counts, 0, 63), minlength=64)
    ok = (int(n_sel.sum()) == n <= max_out and int(nd.sum()) == len(counts)
          and (hist == want).all() and not ndrop.any() and launches > 0 and cnt["details"] > 0)
    log(f"[k11] {seq.shape[0]} x {seq.shape[1]} ASCII rows, 4 shards on cuda:0: {wall:.3f} s, "
        f"syncmer_select launches={launches} details launches={cnt['details']}; "
        f"n_sel per shard {n_sel.tolist()}, "
        f"n_distinct per shard {nd.tolist()}, n_dropped {ndrop.tolist()}")
    log(f"[k11] equal to numpy over the single-device extraction ({n} selections, "
        f"{len(counts)} distinct): {ok}")
    return dict(ok=ok, launches=launches, details=cnt["details"])


def build_kernels(mods: dict) -> None:
    """Build every kernel from the checkout's sources, one nvcc per
    source, all started together; print each build's seconds and the
    compiler's register, shared-memory and spill report."""
    from concurrent.futures import ThreadPoolExecutor

    def one(mod):
        t0 = time.perf_counter()
        report = mod.build()
        mod._load()
        return time.perf_counter() - t0, report

    with ThreadPoolExecutor(len(mods)) as ex:
        futs = {name: ex.submit(one, mod) for name, mod in mods.items()}
    for name, fut in futs.items():
        secs, report = fut.result()
        log(f"[build] {name} built in {secs:.3f} s")
        for ln in report.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                log(f"[build] {name}: {ln.strip()}")


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

        from oatk_tpu_torch.asm import ec_lockstep as ECL
        from oatk_tpu_torch.kernels import syncmer_details as SD
        from oatk_tpu_torch.kernels import syncmer_select as SS
        from oatk_tpu_torch.kernels import wf_ed as WE
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

    build_kernels({"syncmer_select.cu": SS, "wf_ed.cu": WE, "syncmer_details.cu": SD,
                   "ec_lockstep.c": ECL})

    kern = phase_kernel("cuda")
    ok &= kern["ok"]
    det = phase_details("cuda")
    ok &= det["ok"]
    wf = phase_wf("cuda")
    ok &= wf["ok"]
    parity = phase_parity(WORK)
    ok &= parity["ok"]
    full = phase_full(WORK, parity)
    ok &= full["ok"]
    oatk = phase_oatk(WORK, full["fa"], full["n_bp"], full["sha256"])
    ok &= oatk["ok"]
    routes = {"select": {}, "decode": {}, "details": {}}
    for name, fn in (
        ("capped", lambda: phase_capped(WORK, full["fa"], full["read_db"].n)),
        ("host_count", lambda: phase_host_count(WORK, full, parity)),
        ("device_hoco", lambda: phase_device_hoco(WORK, full)),
        ("python_reader", lambda: phase_mixed(WORK, parity)),
        ("device_consensus", lambda: phase_device_consensus(WORK, full)),
        ("device_em", lambda: phase_device_em(WORK, full)),
        ("cpu_flag", lambda: phase_cpu_flag(WORK, parity)),
        ("shards1", lambda: phase_shards1(WORK, full)),
        ("mesh", lambda: phase_mesh(WORK, full)),
        ("stage_shards4", lambda: phase_stage_shards(WORK, full)),
        ("k11", lambda: phase_k11(WORK, full)),
    ):
        t0 = time.perf_counter()
        r = fn()
        log(f"[phase] {name}: ok={r['ok']} in {time.perf_counter() - t0:.3f} s")
        ok &= r["ok"]
        for key, into in (("launches", routes["select"]), ("decode", routes["decode"]),
                          ("details", routes["details"])):
            if isinstance(r.get(key), dict):
                into.update(r[key])
            elif key in r:
                into[name] = r[key]

    # no single PyTorch call computes any of these functions: library_ms
    # is null (torch.nonzero's time on the same sel, a yardstick for the
    # details' compaction alone, is nonzero_ms)
    kernels = {"kernels": [{
        "name": "syncmer_select",
        "route": "cuda",
        "source": "oatk_tpu_torch/csrc/syncmer_select.cu",
        "replaces": "oatk_tpu/kernels/syncmer_pallas.py:401",
        "launches": full["launches"],
        "launches_by_route": routes["select"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,
    }, {
        "name": "wf_ed",
        "route": "cuda",
        "source": "oatk_tpu_torch/csrc/wf_ed.cu",
        "replaces": "oatk_tpu/kernels/wavefront_pallas.py:169",
        "launches": oatk["launches"],
        "rounds": oatk["rounds"],
        "items": oatk["items"],
        "max_abs_err": wf["max_abs_err"],
        "ms": wf["ms"],
        "plain_ms": wf["plain_ms"],
        "bound_ms": wf["bound_ms"],
        "bound_by": wf["bound_by"],
        "library_ms": None,
    }, {
        "name": "syncmer_decode",
        "route": "cuda",
        "source": "oatk_tpu_torch/csrc/syncmer_details.cu",
        "replaces": "oatk_tpu/kernels/syncmer.py:598",
        "launches": full["decode"],
        "launches_by_route": routes["decode"],
        "max_abs_err": det["dec_err"],
        "ms": det["dec_ms"],
        "plain_ms": det["dec_plain_ms"],
        "bound_ms": det["dec_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "device_us": det["dec_us"],
    }, {
        "name": "syncmer_details",
        "route": "cuda",
        "source": "oatk_tpu_torch/csrc/syncmer_details.cu",
        "replaces": "oatk_tpu/kernels/syncmer.py:419",
        "launches": full["details"],
        "launches_key_route": full["keys"],
        "launches_per_chunk": det["chunk_events"]["keys"]["k4_launches"],
        "launches_by_route": routes["details"],
        "max_abs_err": det["max_abs_err"],
        "ms": det["ms"],
        "plain_ms": det["plain_ms"],
        "bound_ms": det["bound_ms"],
        "bound_by": det["bound_by"],
        "library_ms": None,
        "device_us": det["device_us"],
        "keys_ms": det["keys_ms"],
        "keys_plain_ms": det["keys_plain_ms"],
        "keys_bound_ms": det["keys_bound_ms"],
        "nonzero_ms": det["nonzero_ms"],
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
