"""The host around a run: the cores it is granted, its thread pools, and
the steal and load it saw.

Every host pool takes the configuration's ``threads``: the port's native
pools through ``syncasm(threads=...)``, OpenMP and the BLAS libraries
through their variables (set here before torch is imported), torch's
intra-op and inter-op pools after.  Nothing here adapts to the machine:
a configuration that needs fewer threads says so in its own file."""
from __future__ import annotations

import os

POOL_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def set_pool_env(threads: int, env: dict) -> None:
    """Before torch is imported: the pools' variables and the
    configuration's own environment."""
    for v in POOL_VARS:
        os.environ[v] = str(threads)
    for k, v in env.items():
        os.environ[k] = str(v)


def set_torch_pools(threads: int) -> None:
    import torch

    torch.set_num_threads(threads)
    try:
        torch.set_num_interop_threads(threads)
    except RuntimeError:  # already started: it keeps its first size
        pass


def grant() -> dict:
    """Cores this process may use: its affinity, the cgroup's quota (in
    cores, None without one) and ``os.cpu_count()``."""
    quota = None
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            q, period = f.read().split()
        if q != "max":
            quota = int(q) / int(period)
    except (OSError, ValueError):
        pass
    return {"affinity": len(os.sched_getaffinity(0)), "cgroup_cores": quota,
            "cpu_count": os.cpu_count()}


def cpu_times() -> list:
    """The aggregate line of /proc/stat: user, nice, system, idle,
    iowait, irq, softirq, steal (jiffies)."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except OSError:
        return []


def loadavg() -> float | None:
    try:
        with open("/proc/loadavg") as f:
            return float(f.read().split()[0])
    except OSError:
        return None


def steal_pct(before: list, after: list) -> float | None:
    """Share of the host's CPU time stolen between two readings."""
    if len(before) < 8 or len(after) < 8:
        return None
    d = [b - a for a, b in zip(before, after)]
    tot = sum(d)
    return 100.0 * d[7] / tot if tot else None
