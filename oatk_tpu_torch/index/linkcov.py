"""Link-coverage regression analysis (reference syncmer.c:1520-1755
analogue; a copy of ``oatk_tpu/index/linkcov.py``).

For each syncmer gap distance d, fits N_LINK = beta * N_COV over pairs
of syncmers d apart on reads (copy-number normalized, middle 90% by
link/cov ratio), reporting (beta, bse, r2) per distance.  Unused by the
reference's main path (call commented out at run_syncasm.c:105) but
part of the public surface.
"""
from __future__ import annotations

import numpy as np

from ..asm.reads import ReadDB
from ..index.syncmer_db import SyncmerDB
from ..utils import log_info


def syncmer_link_coverage_analysis(
    read_db: ReadDB,
    scm_db: SyncmerDB,
    min_k_cov: int,
    min_n_seq: int,
    min_pt: int,
    min_f: float,
    verbose: int = 0,
):
    """Returns (n, beta[], bse[], r2[]) for gap distances 0..n-1."""
    min_pt = max(min_pt, 30)
    min_f = max(min_f, 0.0)
    cov = scm_db.cov.astype(np.int64)

    ns = np.array([len(r.m_pos) for r in read_db.reads], np.int64)
    if len(ns) == 0 or ns.max() == 0:
        return 0, None, None, None
    max_n = int(ns.max())
    # rl_cnts[i] = number of reads with >= i syncmers
    rl_hist = np.bincount(ns, minlength=max_n + 1)
    rl_cnts = np.cumsum(rl_hist[::-1])[::-1]

    beta = np.zeros(max_n)
    bse = np.zeros(max_n)
    r2 = np.zeros(max_n)
    pt_n = np.zeros(max_n, np.int64)
    rd_cnts = np.zeros(max_n + 1, np.int64)
    k_cn: dict[int, int] = {}
    n1 = 0
    for i in range(2, max_n):
        if rl_cnts[i] < min_n_seq:
            break
        a_cov: dict[tuple[int, int], int] = {}
        for r in read_db.reads:
            if r.n < i:
                continue
            sid = (r.k_mer >> np.uint64(1)).astype(np.int64)
            ok = (cov[sid[: r.n - i + 1]] >= min_k_cov) & (cov[sid[i - 1 :]] >= min_k_cov)
            v0s = (sid[: r.n - i + 1] << 1) | (r.m_pos[: r.n - i + 1].astype(np.int64) & 1)
            v1s = (sid[i - 1 :] << 1) | (r.m_pos[i - 1 :].astype(np.int64) & 1)
            for v0, v1 in zip(v0s[ok], v1s[ok]):
                key = (int(v0), int(v1)) if v0 <= v1 else (int(v1) ^ 1, int(v0) ^ 1)
                a_cov[key] = a_cov.get(key, 0) + 1
                rd_cnts[i] += 1
        if i == 2:
            for (v0, v1) in a_cov:
                k_cn[v0 >> 1] = k_cn.get(v0 >> 1, 0) + 1
                k_cn[v1 >> 1] = k_cn.get(v1 >> 1, 0) + 1

        pts = []
        for (v0, v1), v_v in a_cov.items():
            c0 = max(2, k_cn.get(v0 >> 1, 0)) / 2.0
            c1 = max(2, k_cn.get(v1 >> 1, 0)) / 2.0
            c = int(min(cov[v0 >> 1] / c0, cov[v1 >> 1] / c1))
            l = min(v_v, c)
            pts.append((c, l, l / c if c else 0.0))
        beg = int(np.floor(len(pts) * 0.05))
        end = int(np.ceil(len(pts) * 0.95))
        pts.sort(key=lambda p: (p[2], p[0]))
        while beg < end and pts[beg][2] < min_f:
            beg += 1
        if end - beg < min_pt:
            break
        sel = pts[beg:end]
        c = np.array([p[0] for p in sel], float)
        l = np.array([p[1] for p in sel], float)
        xy = float((c * l).sum())
        x2 = float((c * c).sum())
        beta[i] = xy / x2
        ybar = l.mean()
        res = float(((l - beta[i] * c) ** 2).sum())
        tot = float(((l - ybar) ** 2).sum())
        bse[i] = np.sqrt(res / x2 / (len(sel) - 1))
        r2[i] = 1 - (0.0 if tot == 0.0 else res / tot)
        pt_n[i] = len(sel)
        n1 = i

    if verbose > 0:
        for i in range(2, n1):
            log_info(
                f"G: {i-2} N: {pt_n[i]} D: {rd_cnts[i]} coeff: {beta[i]:.6f} "
                f"bse: {bse[i]:.6f} R2: {r2[i]:.6f}",
                func="syncmer_link_coverage_analysis",
            )
    if n1 == 0:
        return 0, None, None, None
    return n1 - 1, beta[2 : n1 + 1], bse[2 : n1 + 1], r2[2 : n1 + 1]
