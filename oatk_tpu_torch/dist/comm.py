"""The one module of the port that touches ``torch.distributed``.

Across processes each rank owns one shard of the mesh (one card per rank
under NCCL, or the CPU under gloo).  Host arrays (alignment flats, EC
parts, DB build results) travel over a gloo group: the default group
when it is gloo, else a gloo group made beside the NCCL one at first
use.  Device tensors (the routed syncmer occurrences) travel with
``all_to_all_single`` on the rank's card under NCCL and on the CPU under
gloo.

Every function here is a collective: every rank must call it at the same
point, in the same order.  Without an initialised process group the
process is rank 0 of 1 and no collective is made.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

_host_group = None


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """World size of the initialised process group, else 1."""
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    """Rank of this process in the initialised process group, else 0."""
    return dist.get_rank() if initialized() else 0


def initialize(rank: int, world_size: int, init_method: str, backend: str | None = None) -> None:
    """Join the process group (``init_method`` such as
    ``tcp://localhost:29500``).  ``backend`` defaults to NCCL where a
    card is visible, else gloo; under NCCL the rank takes card
    ``rank % device_count`` as its current device."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)


def shutdown() -> None:
    """Leave the process group (and drop the host group made beside it)."""
    global _host_group
    if initialized():
        dist.destroy_process_group()
    _host_group = None


def _hosts():
    """The gloo group host arrays travel over (None: the default group)."""
    global _host_group
    if dist.get_backend() == "gloo":
        return None
    if _host_group is None:
        _host_group = dist.new_group(backend="gloo")
    return _host_group


def allgather_var(arr: np.ndarray) -> list[np.ndarray]:
    """Every rank's array, in rank order.  Arrays may differ in their
    first dimension (the rest of the shape and the dtype must agree):
    the ranks exchange their byte lengths first, then gather exactly
    that many bytes, padded only to the longest."""
    arr = np.ascontiguousarray(arr)
    if not initialized():
        return [arr]
    grp = _hosts()
    raw = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    n = torch.tensor([raw.numel()], dtype=torch.int64)
    sizes = [torch.zeros_like(n) for _ in range(process_count())]
    dist.all_gather(sizes, n, group=grp)
    sizes = [int(x) for x in sizes]
    m = max(1, max(sizes))  # a collective of empty tensors is not sent
    pad = torch.zeros(m, dtype=torch.uint8)
    pad[: raw.numel()] = raw
    bufs = [torch.empty(m, dtype=torch.uint8) for _ in sizes]
    dist.all_gather(bufs, pad, group=grp)
    tail = arr.shape[1:]
    return [
        b[:sz].numpy().view(arr.dtype).reshape((-1,) + tail) for b, sz in zip(bufs, sizes)
    ]


def all_ranks_ok(local_ok: bool) -> bool:
    """True iff every rank reports ok.  Ranks agree on a capability (or
    a check) with it before a data collective, so that one rank's
    failure sends every rank down the same branch instead of leaving
    the others waiting in a gather."""
    if not initialized():
        return bool(local_ok)
    flag = torch.tensor([1 if local_ok else 0], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=_hosts())
    return bool(flag.item() == 1)


def all_to_all(x: torch.Tensor, split_sizes: list[int]) -> torch.Tensor:
    """Send rows ``[sum(split_sizes[:r]), +split_sizes[r])`` of ``x`` to
    rank r; returns what every rank sent here, concatenated in rank
    order, on ``x``'s device.  The ranks exchange their counts first, so
    each receive is exactly sized."""
    if not initialized():
        return x
    on_card = x.is_cuda and dist.get_backend() == "nccl"
    dev = x.device
    y = x if on_card or not x.is_cuda else x.cpu()
    grp = None if on_card else _hosts()
    cdev = dev if on_card else torch.device("cpu")
    send = torch.tensor(split_sizes, dtype=torch.int64, device=cdev)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=grp)
    rs = [int(v) for v in recv.tolist()]
    out = torch.empty((sum(rs),) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
    dist.all_to_all_single(out, y.contiguous(), output_split_sizes=rs,
                           input_split_sizes=list(split_sizes), group=grp)
    return out.to(dev)
