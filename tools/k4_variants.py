#!/usr/bin/env python3
"""Variants of the compaction and details kernel K4
(``oatk_tpu_torch/csrc/syncmer_details.cu``, ``sel_tiles_kernel``) timed
on a CUDA card at the bench chunk (2048 rows x 16384 positions,
k=1001/s=31, as ``chip_smoke.py`` phase 3b makes it), each held exactly
against the plain versions on both routes.

Run from the repository root on a machine with a card:

    python3 tools/k4_variants.py

Each variant is the checked-in source with its tile size (``kRounds``),
its register cap (``kTileBlocks`` blocks per SM) or a part of the block's
path left out (``-DNO_LB``: no look-back, every tile takes prefix 0;
``-DNO_DET``: no per-window details), compiled with nvcc into
``build/k4_variants/`` and loaded with ctypes.  A variant that leaves a
part out computes a wrong result on purpose: its time says what that
part costs.  Prints, per variant, blocks per SM, exactness, the median
time by CUDA events and the device time by torch.profiler, the
compiler's register report, and a copy of ``sel`` as a yardstick of the
card's memory rate.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "k4_variants")

# (name, kRounds, kTileBlocks, macros)
VARIANTS = [
    ("as built", 8, 4, []),
    ("tiles of 4,096", 4, 4, []),
    ("tiles of 16,384", 16, 4, []),
    ("5 blocks/SM", 8, 5, []),
    ("no look-back", 8, 4, ["NO_LB"]),
    ("no details", 8, 4, ["NO_DET"]),
    ("neither", 8, 4, ["NO_LB", "NO_DET"]),
]

EDITS = [  # (text of the source, its replacement)
    ("constexpr int kRounds = 8;", "constexpr int kRounds = K4_ROUNDS;"),
    ("constexpr int kTileBlocks = 4;", "constexpr int kTileBlocks = K4_BLOCKS;"),
    ("    if (t > 0) look_back(status, t, row_first, g, r);",
     "#ifndef NO_LB\n    if (t > 0) look_back(status, t, row_first, g, r);\n#endif"),
    ("    for (int k = wid - 1; k < n_early; k += kTileWarps - 1) {",
     "#ifdef NO_DET\n    if (0)\n#endif\n    for (int k = wid - 1; k < n_early; k += kTileWarps - 1) {"),
    ("  for (long long k = n_early + wid; k < n_loc; k += kTileWarps) {",
     "#ifdef NO_DET\n  if (0)\n#endif\n  for (long long k = n_early + wid; k < n_loc; k += kTileWarps) {"),
]
OCCUPANCY = r'''
extern "C" int k4_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, sel_tiles_kernel<true>, kThreads, 0);
}
'''


def variant_source() -> str:
    with open(os.path.join(ROOT, "oatk_tpu_torch", "csrc", "syncmer_details.cu")) as f:
        src = f.read()
    for old, new in EDITS:
        if old not in src:
            raise SystemExit(f"k4_variants: the source no longer holds {old!r}; update EDITS")
        src = src.replace(old, new)
    return src + OCCUPANCY


def build(nvcc: str, src: str, i: int, rounds: int, blocks: int, macros: list) -> tuple[str, str]:
    so = os.path.join(OUT, f"libk4_{i}.so")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DK4_ROUNDS={rounds}", f"-DK4_BLOCKS={blocks}",
           *[f"-D{m}" for m in macros], "-o", so, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for variant {i}:\n{r.stderr}")
    # the first two register lines are the two sel_tiles_kernel instances
    report = [ln.strip() for ln in (r.stdout + r.stderr).splitlines() if "registers" in ln]
    return so, " | ".join(report[:2])


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from oatk_tpu_torch.asm.reads import _capacity
    from oatk_tpu_torch.kernels import cuda_build
    from oatk_tpu_torch.kernels import syncmer_details as SD
    from oatk_tpu_torch.kernels import syncmer_select as SS

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "variants.cu")
    with open(src, "w") as f:
        f.write(variant_source())
    nvcc = cuda_build.nvcc()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(lambda a: build(nvcc, src, *a),
                            [(i, r, b, m) for i, (_, r, b, m) in enumerate(VARIANTS)]))
    print(f"[k4var] {smoke.card_line()}", flush=True)

    B, Lp, w, s = 2048, 16384, smoke.K_MAIN, smoke.S_MAIN
    blob, n_cap = smoke.make_blob(np.random.default_rng((20261018, 0)), B, Lp, w, 1e-3)
    cp = SD.decode_blob(torch.from_numpy(blob).cuda(), B, Lp, n_cap, w)
    sel = SS.syncmer_select(cp, w, s)
    mo = _capacity(B, Lp, w, s)
    sids = torch.arange(B, dtype=torch.int64, device="cuda")
    ref = SD.selected_details_plain(cp, sel, w, s, mo)
    kref = [torch.zeros(mo, dtype=dt, device="cuda") for dt in (torch.int64,) * 4 + (torch.int32,)]
    nref = int(SD.selected_keys_plain(cp, sel, w, s, mo, sids, kref, 0)[0])
    argtypes = SD._load().syncmer_details_launch.argtypes
    for (name, rounds, blocks, macros), (so, report) in zip(VARIANTS, built):
        lib = ctypes.CDLL(so)
        lib.syncmer_details_launch.argtypes = argtypes
        lib.syncmer_details_tiles.restype = ctypes.c_longlong
        lib.syncmer_details_tiles.argtypes = [ctypes.c_longlong, ctypes.c_int]
        n_tiles = lib.syncmer_details_tiles(B, Lp)
        status = torch.zeros(n_tiles, dtype=torch.int64, device="cuda")
        ctr = torch.zeros(4, dtype=torch.int32, device="cuda")
        per_sm = ctypes.c_int(0)
        lib.k4_blocks_per_sm(ctypes.byref(per_sm))
        packed = torch.empty((3, mo + 1), dtype=torch.int64, device="cuda")
        keys = [torch.zeros(mo, dtype=dt, device="cuda") for dt in (torch.int64,) * 4 + (torch.int32,)]
        n_sel = torch.zeros(1, dtype=torch.int64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run_packed():
            rc = lib.syncmer_details_launch(cp.data_ptr(), sel.data_ptr(), B, Lp, w, s, mo,
                                            packed.data_ptr(), *[0] * 7, 0, status.data_ptr(),
                                            ctr.data_ptr(), stream)
            assert rc == 0, rc

        def run_keys():
            rc = lib.syncmer_details_launch(cp.data_ptr(), sel.data_ptr(), B, Lp, w, s, mo, 0,
                                            *[k.data_ptr() for k in keys], n_sel.data_ptr(),
                                            sids.data_ptr(), B, status.data_ptr(), ctr.data_ptr(),
                                            stream)
            assert rc == 0, rc

        run_packed()
        run_keys()
        torch.cuda.synchronize()
        exact = (torch.equal(packed, ref),
                 all(torch.equal(a, b) for a, b in zip(keys, kref)) and int(n_sel[0]) == nref)
        times = []
        for fn in (run_packed, run_keys):
            ev = smoke.median_ms(fn, 20)
            dev = sum(us for _, us in smoke.profile_device(lambda: [fn() for _ in range(10)])) / 10
            times.append(f"{ev * 1000:.1f} us by events, {dev:.1f} us device")
        print(f"[k4var] {name} (kRounds {rounds}, {per_sm.value} blocks/SM, {' '.join(macros) or '-'}): "
              f"exact packed={exact[0]} keys={exact[1]}; packed {times[0]}; keys {times[1]}; "
              f"{report}", flush=True)
    copy = torch.empty_like(sel)
    print(f"[k4var] a copy of sel ({2 * sel.numel() * 4} B moved): "
          f"{smoke.median_ms(lambda: copy.copy_(sel), 20) * 1000:.1f} us by events", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
