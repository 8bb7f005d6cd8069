"""Process groups, sharding and the reductions of a data-parallel step
(counterpart of coin_tpu/parallel/mesh_utils.py).

The JAX package trains on a 1-D ``data`` mesh: the batch is sharded over
the devices, the parameters are replicated, and the step is one program
over the global batch, so sharding does not change its numbers. Here each
rank is a process holding B / W images of the global batch of B. A step
gives the single-process step's numbers on those B images when every
batch-wide quantity is global:
- a loss divides its rank's numerator by the global count
  (:func:`global_sum`, :func:`global_batch`), so the sum of the ranks'
  gradients (:func:`sum_gradients`, the mesh's psum) is the gradient of
  the global loss; a term that does not depend on the batch (the text
  alignment, the CKG's gradient discrepancy) counts 1 / W on each rank;
- gates over the batch (any foreground row, any B row) are global
  (:func:`global_any`);
- the int8 res5 scale is the all-reduced maximum of the ranks' abs-maxima
  (:func:`global_max_`);
- a gradient that enters a loss (the CKG's second-order term) is summed
  differentiably (:func:`differentiable_sum`).
The step functions turn these on inside :func:`data_parallel`; outside it,
and over a world of one, every helper returns its input.

``init_distributed`` starts the process group (NCCL on the card, gloo on
the CPU) from torchrun's environment or from arguments, and ``launch``
starts one process per card, as detectron2's ``launch`` does.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import logging
import os
import socket
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the group that the enclosing step's batch-wide reductions span
_ACTIVE = contextvars.ContextVar("coin_tpu_torch_step_group", default=None)


# ------------------------------------------------------------ processes
def init_distributed(rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     local_rank: Optional[int] = None, device="cuda",
                     timeout_s: float = 1800.0) -> Tuple[int, int]:
    """Join the default process group: NCCL when ``device`` is a card,
    gloo on the CPU. Rank, world size and local rank come from the
    arguments, else from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``). On the card the
    process takes card ``local_rank`` (modulo the visible cards: ranks may
    share one). Returns (rank, world size); a group that exists is kept."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
                  else local_rank)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
        init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("process group: rank %d of %d (%s)", rank, world_size,
                dist.get_backend())
    return rank, world_size


def free_port() -> int:
    """A free TCP port on this host, for a ``tcp://localhost`` URL."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launched(local_rank: int, fn: Callable, num_gpus: int,
              machine_rank: int, world: int, dist_url: str, args,
              device) -> None:
    init_distributed(rank=machine_rank * num_gpus + local_rank,
                     world_size=world, init_method=dist_url,
                     local_rank=local_rank, device=device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, num_gpus: int, num_machines: int = 1,
           machine_rank: int = 0, dist_url: Optional[str] = None,
           args: Sequence = (), device="cuda") -> None:
    """Run ``fn(*args)`` in ``num_gpus`` new processes on this machine, one
    per card, each in the default process group of ``num_gpus x
    num_machines`` ranks (detectron2's ``launch``). One process in all
    runs ``fn`` here, without a group. ``dist_url`` is the rendezvous
    (``tcp://host:port``); on one machine a free local port by default.
    ``fn`` and ``args`` must pickle."""
    world = num_gpus * num_machines
    if world <= 1:
        fn(*args)
        return
    if not dist_url or dist_url == "auto":
        if num_machines != 1:
            raise ValueError("launch: several machines need a --dist-url")
        dist_url = f"tcp://127.0.0.1:{free_port()}"
    torch.multiprocessing.start_processes(
        _launched, args=(fn, num_gpus, machine_rank, world, dist_url,
                         tuple(args), str(device)),
        nprocs=num_gpus, join=True, start_method="spawn")


def train_group():
    """The group a trainer's step reduces over: the default group when it
    spans more than one process, else None (no reduction)."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def world_size(group=None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group=None) -> int:
    return 0 if group is None else dist.get_rank(group)


def check_batch(batch: int, world: int) -> None:
    """Every rank must hold a shard: raise when ``world`` does not divide
    the global ``batch``. The JAX mesh would take the largest divisor of
    the batch that is at most the device count; the message names it."""
    if world > 1 and batch % world:
        n = max(d for d in range(1, world + 1) if batch % d == 0)
        raise ValueError(
            f"a world of {world} ranks does not divide the batch of "
            f"{batch} images (SOLVER.IMG_PER_BATCH_UNLABEL); the JAX "
            f"package's mesh would train on {n} devices. Run {n} ranks, or "
            f"set the batch (or SOLVER.REFERENCE_WORLD_SIZE to scale it) "
            f"to a multiple of {world}")


# ------------------------------------------------------------ sharding
def shard_rows(n: int, rank_: int, world: int, views: int = 1):
    """The rows of rank ``rank_``'s shard of ``views`` stacked copies of a
    batch of ``n`` (view v's rows are v n .. (v + 1) n - 1)."""
    check_batch(n, world)
    b = n // world
    return np.concatenate([np.arange(v * n + rank_ * b,
                                     v * n + (rank_ + 1) * b)
                           for v in range(views)])


def shard_batch(x: torch.Tensor, rank_: int, world: int,
                views: int = 1) -> torch.Tensor:
    """Rank ``rank_``'s rows of a batch-leading tensor: images
    rank_ B / W .. (rank_ + 1) B / W - 1 of the global batch of B, of each
    of ``views`` stacked copies."""
    if world == 1:
        return x
    rows = shard_rows(x.shape[0] // views, rank_, world, views)
    return x[torch.as_tensor(rows, device=x.device)]


@torch.no_grad()
def replicate(module: torch.nn.Module, group=None, src: int = 0) -> None:
    """Broadcast ``module``'s parameters and buffers from rank ``src``, in
    place."""
    if world_size(group) == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src, group=group)


def broadcast_tensors(tensors: Iterable[torch.Tensor], group=None,
                      src: int = 0) -> None:
    if world_size(group) == 1:
        return
    for t in tensors:
        dist.broadcast(t, src, group=group)


# ------------------------------------------------------------ reductions
@contextlib.contextmanager
def data_parallel(group):
    """Turn a step's batch-wide reductions on over ``group`` (None: off).
    Every rank must run the same reductions in the same order inside."""
    token = _ACTIVE.set(group if world_size(group) > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_group():
    """The group of the enclosing :func:`data_parallel`, or None."""
    return _ACTIVE.get()


def active_world() -> int:
    return world_size(_ACTIVE.get())


def global_batch(n: int) -> int:
    """The global count of a per-rank batch dimension of ``n``."""
    return n * active_world()


def global_sum(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The sums over the active group's ranks of ``xs`` (counts or sums,
    any shapes, one device), in one all-reduce; without a group, ``xs``.
    Bool tensors sum as int64 counts; the others keep their dtype (the sum
    is taken in f64, exact for counts)."""
    group = _ACTIVE.get()
    if group is None:
        return tuple(xs)
    flat = torch.cat([x.detach().reshape(-1).to(torch.float64)
                      for x in xs])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for x in xs:
        part = flat[at:at + x.numel()].reshape(x.shape)
        at += x.numel()
        out.append(part.to(torch.int64 if x.dtype == torch.bool
                           else x.dtype))
    return tuple(out)


def global_any(mask: torch.Tensor) -> torch.Tensor:
    """``mask.any()`` over the active group's ranks (0-d bool)."""
    if _ACTIVE.get() is None:
        return mask.any()
    return global_sum(mask.sum())[0] > 0


def global_max_(x: torch.Tensor, group=None) -> torch.Tensor:
    """In place: the maximum over ``group``'s ranks (the active group when
    None) of a non-negative f32 tensor (the abs-maxima of int8 scales),
    taken on its bits as int32, which order non-negative floats as the
    floats do, a NaN above every number."""
    group = _ACTIVE.get() if group is None else group
    if world_size(group) > 1:
        dist.all_reduce(x.view(torch.int32), op=dist.ReduceOp.MAX,
                        group=group)
    return x


def differentiable_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the active group's ranks, differentiable: its
    backward sums the incoming gradients over the ranks again."""
    group = _ACTIVE.get()
    if group is None:
        return x
    import warnings
    from torch.distributed.nn.functional import all_reduce
    with warnings.catch_warnings():
        # deprecated in favour of _functional_collectives, whose
        # all_reduce has no backward
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(x, group=group)


@torch.no_grad()
def sum_gradients(params: Iterable[torch.Tensor], group=None) -> None:
    """In place: each ``.grad`` becomes its sum over ``group``'s ranks,
    one all-reduce per dtype (the mesh's psum of the gradients). A
    parameter without a gradient keeps None: the step's graph, and so
    which parameters have one, is the same on every rank."""
    if world_size(group) == 1:
        return
    buckets = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault(p.grad.dtype, []).append(p.grad)
    for dtype in sorted(buckets, key=str):
        grads = buckets[dtype]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
