"""Device meshes and the hash-owner exchange (PyTorch port of
``oatk_tpu/dist/sharding.py``).

The reference's parallelism is over reads (pthreads); the port scales
out on two axes:
  - reads -> data parallelism: each shard extracts the syncmers of its
    block of rows, and
  - k-mer hash space -> ownership: every extracted hash goes to its
    owner shard (the top bits of the hash), so each shard counts or
    sorts one slice of hash space.

A :class:`Mesh` is the ordered list of the shards' devices.  In one
process every shard is local (several shards may share one device);
across processes (:mod:`.comm`) each rank owns the one shard of its
rank, and the exchange is an ``all_to_all`` between the ranks.
"""
from __future__ import annotations

import numpy as np
import torch

from . import comm


class Mesh:
    """Shard d runs on ``devices[d]``; across processes ``ranks[d]`` is
    the rank that owns it (None: every shard is in this process)."""

    def __init__(self, devices, ranks=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.ranks = None if ranks is None else tuple(ranks)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        if self.ranks is not None and len(self.ranks) != len(self.devices):
            raise ValueError("one owning rank per shard")

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_shards(self) -> list[int]:
        """The shards this process runs, ascending."""
        if self.ranks is None:
            return list(range(self.size))
        me = comm.process_index()
        return [d for d, r in enumerate(self.ranks) if r == me]


def make_mesh(n: int, device="cuda") -> Mesh:
    """A mesh of ``n`` shards on ``device`` ("cuda" or "cpu").

    In one process: "cuda" takes ``cuda:0..n-1`` and raises when fewer
    cards are visible; "cpu" gives n logical CPU shards.  Across
    processes each rank owns one shard, so ``n`` must equal the world
    size; rank r runs on ``cuda:(r % device_count)`` (or the CPU)."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    n_cards = torch.cuda.device_count() if kind == "cuda" and torch.cuda.is_available() else 0
    if comm.process_count() > 1:
        world = comm.process_count()
        if n != world:
            raise ValueError(f"requested {n} shards across {world} processes: one shard per rank")
        if kind == "cuda" and not n_cards:
            raise ValueError("requested a CUDA mesh but no CUDA device is visible")
        devs = [f"cuda:{r % n_cards}" if kind == "cuda" else "cpu" for r in range(n)]
        return Mesh(devs, ranks=range(n))
    if kind == "cuda":
        if n > n_cards:
            raise ValueError(
                f"requested {n} shards but only {n_cards} CUDA device(s) are visible "
                "(make_mesh(n, 'cpu') gives n logical CPU shards)"
            )
        return Mesh([f"cuda:{d}" for d in range(n)])
    return Mesh(["cpu"] * n)


def exchange(mesh: Mesh, sends: dict) -> tuple[dict, int]:
    """Route rows to their owner shards.

    ``sends`` maps each local shard to (rows ``[n, c]``, owner ``[n]``)
    on its device.  Returns ({local shard: the rows it owns ``[m, c]`` on
    its device}, bytes of rows that left their shard).  In one process
    the rows are copied between the shards' devices; across processes
    the ranks exchange exact counts, then the rows (``comm.all_to_all``).
    Rows arrive in source-shard order, each source's rows in their order.
    """
    D = mesh.size
    moved = 0
    got: dict[int, list] = {d: [] for d in mesh.local_shards()}
    for src, (rows, owner) in sends.items():
        order = torch.argsort(owner, stable=True)
        counts = torch.bincount(owner, minlength=D).tolist()
        rows = rows[order]
        moved += (len(rows) - counts[src]) * rows[:1].numel() * rows.element_size()
        if mesh.ranks is not None:
            got[src].append(comm.all_to_all(rows, counts))
            continue
        for dst, part in enumerate(torch.split(rows, counts)):
            got[dst].append(part.to(mesh.devices[dst]))
    return {d: torch.cat(p) if len(p) > 1 else p[0] for d, p in got.items()}, moved


def sharded_extract_count_step(seq, lens, w: int, s: int, max_out: int, mesh: Mesh):
    """One sharded extract + count step over ASCII rows ``seq`` [B, L]
    uint8 with lengths ``lens`` [B]; shard d takes the d-th contiguous
    block of rows.

    Each shard extracts through the selection kernel
    (:func:`~oatk_tpu_torch.kernels.syncmer.extract_syncmers_ascii`,
    regrowing ``max_out`` until it holds every selection), sends each
    hash to its owner, and each owner counts its hashes by sort and run
    length into a multiplicity histogram clipped at 63; the histograms
    sum over the shards.  Returns numpy (n_distinct[D], hist[D, 64] (one
    summed histogram per shard), n_sel[D], n_dropped[D]).  Routing is
    exact, so ``n_dropped`` is all zeros."""
    from ..asm.reads import _round_up
    from ..kernels.syncmer import extract_syncmers_ascii
    from .sharded_db import owner_of
    from .stages import shard_ranges

    D = mesh.size
    seq = torch.as_tensor(np.asarray(seq, np.uint8))
    lens = torch.as_tensor(np.asarray(lens, np.int32))
    ranges = shard_ranges(seq.shape[0], D)
    n_sel = np.zeros(D, np.int64)
    sends = {}
    for d in mesh.local_shards():
        lo, hi = ranges[d]
        dev = mesh.devices[d]
        rows, rl = seq[lo:hi].to(dev), lens[lo:hi].to(dev)
        kh = torch.empty(0, dtype=torch.int64, device=dev)
        mo = max_out
        while hi > lo:  # fewer rows than shards: nothing to launch
            packed = extract_syncmers_ascii(rows, rl, w, s, mo)["packed"]
            n = int(packed[0, mo])
            if n <= mo:
                kh = packed[2, :n]
                break
            mo = _round_up(n + 1024, 1024)
        n_sel[d] = len(kh)
        sends[d] = (kh.unsqueeze(1), owner_of(kh, D))
    owned, _ = exchange(mesh, sends)
    n_distinct = np.zeros(D, np.int64)
    hist = np.zeros(64, np.int64)
    for d, h in owned.items():
        counts = torch.unique_consecutive(torch.sort(h[:, 0]).values, return_counts=True)[1]
        n_distinct[d] = len(counts)
        hist += torch.bincount(torch.clamp(counts, max=63), minlength=64).cpu().numpy()
    if mesh.ranks is not None:
        hist = np.sum(comm.allgather_var(hist[None]), axis=0)[0]
        n_distinct = np.sum(comm.allgather_var(n_distinct), axis=0)
        n_sel = np.sum(comm.allgather_var(n_sel), axis=0)
    return (n_distinct.astype(np.int32), np.tile(hist.astype(np.int32), (D, 1)),
            n_sel.astype(np.int32), np.zeros(D, np.int32))
