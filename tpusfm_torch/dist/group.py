"""Process groups and collectives: the port's counterpart of tpusfm's device
mesh (tpusfm/dist/mesh.py).

tpusfm runs one SPMD program over a jax mesh and lets XLA move the data
(psum, all_gather, ppermute). Here every device is one process of a
``torch.distributed`` group, started by ``torch.distributed.run``; each
rank takes the full, replicated inputs, works on its shard and returns the
full, replicated result, so a sharded function compares one for one with
its single-process twin.

Backends:
  * ``nccl`` when every rank has a card of its own: collectives run on the
    device;
  * ``gloo`` on the CPU, and for ranks that share one card (NCCL refuses
    two ranks on one device). gloo moves host memory only, so the helpers
    below stage CUDA operands through the host: one copy out and one copy
    back per collective, by design of that backend.

Every ``init_process_group`` gets a timeout, and the point-to-point and
broadcast helpers wait under it: a dead peer ends the run with an error
instead of hanging it. ``group=None`` means one process: the collectives
return their inputs, and ``shard`` the whole axis (the point-to-point
helpers serve pipeline stages on ranks, and take a group).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import sys

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the default process group."""

    rank: int
    size: int
    device: torch.device
    backend: str
    timeout: datetime.timedelta = DEFAULT_TIMEOUT

    @property
    def staged(self) -> bool:
        """True where collectives copy CUDA operands through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"


def init_group(rank: int, size: int, device, backend: str | None = None,
               init_method: str = "env://",
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Group:
    """Initialise the default process group for this process and return its
    Group. ``backend`` defaults to nccl for a CUDA device, gloo otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                            timeout=timeout)
    return Group(rank=rank, size=size, device=device, backend=backend, timeout=timeout)


def make_group(n: int, device="cuda", timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """The group of ``--devices n``, or None when n <= 1.

    The world comes from ``torch.distributed.run``'s environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT) and must
    have n processes. On ``device="cuda"`` rank r takes card
    LOCAL_RANK % device_count, over nccl when every local rank has its own
    card and over gloo otherwise; ``device="cpu"`` takes gloo."""
    if not n or n <= 1:
        return None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n:
        sys.exit(f"--devices {n} but the world has {world} process(es): run it as "
                 f"python -m torch.distributed.run --standalone --nproc-per-node {n} "
                 f"-m tpusfm_torch.cli ...")
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("--devices needs CUDA devices (or TPUSFM_PLATFORM=cpu): none is visible")
        count = torch.cuda.device_count()
        device = torch.device("cuda", local % count)
        backend = "nccl" if count >= local_world else "gloo"
    else:
        backend = "gloo"
    group = init_group(rank, n, device, backend, timeout=timeout)
    if rank == 0:
        shared = " (ranks share cards: operands staged through the host)" if group.staged else ""
        print(f"process group: {n} ranks over {backend} on {device.type}{shared}", flush=True)
    return group


def close(group: Group | None) -> None:
    """Destroy the default process group, if ``group`` opened one."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


def is_root(group: Group | None) -> bool:
    """True on the rank that prints and writes files (rank 0, or no group)."""
    return group is None or group.rank == 0


def shard(group: Group | None, n: int) -> slice:
    """This rank's contiguous block of an axis of length n (a multiple of
    the group size)."""
    if group is None:
        return slice(0, n)
    if n % group.size:
        raise ValueError(f"an axis of {n} does not split over {group.size} ranks: pad upstream")
    k = n // group.size
    return slice(group.rank * k, (group.rank + 1) * k)


def _wire(group: Group, t: torch.Tensor) -> torch.Tensor:
    """The tensor as the backend moves it: on the host for staged gloo,
    bool as uint8 and uint32 words viewed as int32 (types the backends
    take), contiguous."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    elif t.dtype == torch.uint32:
        t = t.view(torch.int32)
    if group.staged:
        t = t.cpu()
    return t.contiguous()


def _empty_wire(group: Group, shape, dtype) -> torch.Tensor:
    """A buffer that takes a tensor of ``shape`` and ``dtype`` as ``_wire``
    sends it."""
    wire = {torch.bool: torch.uint8, torch.uint32: torch.int32}.get(dtype, dtype)
    return torch.empty(shape, dtype=wire, device="cpu" if group.staged else group.device)


def _back(t: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    t = t.to(device)
    return t.view(torch.uint32) if dtype == torch.uint32 else t.to(dtype)


def all_reduce_sum(group: Group | None, *tensors: torch.Tensor) -> tuple:
    """The element-wise sums of each tensor over the ranks, on every rank
    (psum). Tensors of one dtype travel packed in one collective."""
    if group is None:
        return tensors
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = _wire(group, torch.cat([tensors[i].reshape(-1) for i in idx]))
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        parts = flat.split([tensors[i].numel() for i in idx])
        for i, p in zip(idx, parts):
            out[i] = _back(p, tensors[i].dtype, tensors[i].device).reshape(tensors[i].shape)
    return tuple(out)


def all_gather_cat(group: Group | None, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in rank
    order, on every rank (all_gather)."""
    if group is None:
        return t
    w = _wire(group, t)
    parts = [torch.empty_like(w) for _ in range(group.size)]
    dist.all_gather(parts, w)
    return _back(torch.cat(parts, dim), t.dtype, t.device)


def ring_shift(group: Group | None, t: torch.Tensor) -> torch.Tensor:
    """Send ``t`` to rank + 1 and return what rank - 1 sent (ppermute over
    the ring i -> i + 1)."""
    if group is None or group.size == 1:
        return t
    w = _wire(group, t)
    recv = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, (group.rank + 1) % group.size),
           dist.P2POp(dist.irecv, recv, (group.rank - 1) % group.size)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _back(recv, t.dtype, t.device)


def send_next(group: Group, tensors) -> list:
    """Start sending ``tensors`` to rank + 1, in order (isend); returns the
    pending sends for ``wait``, which hold the tensors as they travel. A
    staged send has copied its operands to the host when this returns;
    otherwise the caller's tensors are sent as they are, and must not be
    written before ``wait``."""
    return [(dist.isend(w, group.rank + 1), w) for w in (_wire(group, t) for t in tensors)]


def wait(group: Group, pending: list) -> None:
    """Complete the sends ``send_next`` started, each within the group's
    timeout."""
    for work, _ in pending:
        work.wait(group.timeout)


def recv_prev(group: Group, specs) -> list:
    """Receive from rank - 1 the tensors its ``send_next`` sent, one for
    each (shape, dtype) of ``specs``, on this rank's device."""
    bufs = [_empty_wire(group, shape, dtype) for shape, dtype in specs]
    for work in [dist.irecv(b, group.rank - 1) for b in bufs]:
        work.wait(group.timeout)
    return [_back(b, dtype, group.device) for b, (_, dtype) in zip(bufs, specs)]


def broadcast_from(group: Group, src: int, specs, tensors=None) -> list:
    """Rank ``src``'s ``tensors`` on every rank, on this rank's device
    (broadcast). Every rank passes their (shape, dtype) ``specs``; only
    ``src`` passes ``tensors``."""
    if group.rank == src:
        bufs = [_wire(group, t) for t in tensors]
    else:
        bufs = [_empty_wire(group, shape, dtype) for shape, dtype in specs]
    for b in bufs:
        dist.broadcast(b, src, async_op=True).wait(group.timeout)
    return [_back(b, dtype, group.device) for b, (_, dtype) in zip(bufs, specs)]
