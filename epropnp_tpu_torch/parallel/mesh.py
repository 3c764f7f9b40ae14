"""Data parallelism of the PyTorch port: ``torch.distributed`` for the JAX
package's 1-D device mesh (``epropnp_tpu/parallel/mesh.py``).

JAX shards the global batch along its leading axis over a mesh axis
``'data'`` (``P('data')``: contiguous blocks), replicates the state and
the rng, and averages the gradients, the BatchNorm statistics and every
loss normaliser with ``lax.pmean`` inside ``shard_map``. Here each
replica is a process of a ``torch.distributed`` group:

* :func:`init_data_parallel` joins (or starts) the group from the
  ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); without it, a
  group of one. The backend follows from where the ranks are placed:
  NCCL when every rank of the host has a card of its own
  (``cuda:LOCAL_RANK``), gloo when ranks share a card (NCCL refuses two
  ranks on one device) and on the CPU.
* :func:`rank_rows` is the rank's block of rows of a global batch, as
  ``P('data')`` places it; :func:`take_rows` slices a batch by it.
* :func:`replica_mean` is ``lax.pmean`` of a loss normaliser, and is
  differentiable: its backward sums the cotangents of all replicas, the
  transpose of ``pmean`` under ``shard_map(check_vma=False)``. An
  in-place ``dist.all_reduce`` would drop that term.
* :func:`mean_gradients` and :func:`mean_buffers` are the step's
  ``pmean(grads)`` and ``pmean(new_batch_stats)``, each one coalesced
  all-reduce, called after ``backward()``. The step does not wrap the model
  in ``DistributedDataParallel``: it averages exactly what JAX averages,
  it works with the remat of ``models.norm.checkpoint`` and with
  parameters a step leaves unused, and DDP's ``broadcast_buffers`` would
  copy rank 0's BatchNorm statistics where JAX averages them.

Every function is the identity (or rank 0 of 1) when no group is up.
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Any, Iterable, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

_logger = logging.getLogger('epropnp_tpu_torch.parallel')


class Replica(NamedTuple):
    """This process's place in the group: its rank, the world size, its
    device and the group's backend."""
    rank: int
    world: int
    device: torch.device
    backend: str


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """True on rank 0 (and without a group): the rank that logs, writes
    checkpoints and evaluates."""
    return rank() == 0


def replica_logger(name: str, save_dir: Optional[str] = None
                   ) -> logging.Logger:
    """Rank 0's logger (the console and ``save_dir/log.txt``,
    ``utils.logging.get_logger``); on another rank one of warnings only."""
    if is_main():
        from ..utils.logging import get_logger
        return get_logger(name, save_dir)
    logger = logging.getLogger(f'{name}.rank{rank()}')
    logger.setLevel(logging.WARNING)
    return logger


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def placement(device_type: str, local_rank: int, local_world: int):
    """``(backend, device)`` for a rank of a host: NCCL on ``cuda:local``
    when the host has a card for every local rank, gloo on a shared card
    (``cuda:local % cards``) when it has fewer, gloo on the CPU."""
    if device_type != 'cuda':
        return 'gloo', torch.device('cpu')
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError('init_data_parallel: no CUDA device')
    if local_world <= cards:
        return 'nccl', torch.device('cuda', local_rank)
    return 'gloo', torch.device('cuda', local_rank % cards)


def init_data_parallel(device=None) -> Replica:
    """Join the process group of the ``torchrun`` environment, or start a
    group of one without it, and return this rank's :class:`Replica`.

    ``device`` names the device type (the CUDA card unless given); the
    backend and the rank's device follow from :func:`placement`. If a group
    is already up (a caller's own ``init_process_group``), it is kept and
    its backend reported. The choice is logged."""
    device_type = torch.device('cuda' if device is None else device).type
    env = os.environ
    up = dist.is_initialized()
    world = dist.get_world_size() if up else int(env.get('WORLD_SIZE', 1))
    rank_ = dist.get_rank() if up else int(env.get('RANK', 0))
    local_rank = int(env.get('LOCAL_RANK', rank_))
    local_world = int(env.get('LOCAL_WORLD_SIZE', world))
    backend, dev = placement(device_type, local_rank, local_world)
    if up:
        backend = dist.get_backend()
    else:
        if 'MASTER_ADDR' in env and 'MASTER_PORT' in env:
            init_method = 'env://'
        elif world == 1:
            init_method = f'tcp://localhost:{_free_port()}'
        else:
            raise RuntimeError(
                f'init_data_parallel: WORLD_SIZE={world} without '
                'MASTER_ADDR/MASTER_PORT; launch with torchrun')
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank_)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    _logger.info('data parallel: rank %d of %d on %s, backend %s (%s)',
                 rank_, world, dev, backend,
                 'one card per rank' if backend == 'nccl' else
                 'ranks share a card' if dev.type == 'cuda' else 'CPU')
    return Replica(rank_, world, dev, backend)


def rank_rows(n: int, rank_: Optional[int] = None,
              world: Optional[int] = None) -> slice:
    """Rows ``[r n / w, (r + 1) n / w)`` of a global batch of ``n``: rank
    ``r``'s block of ``P('data')``. ``n`` must divide by the world size, as
    ``shard_map`` requires."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    if n % world:
        raise ValueError(f'a global batch of {n} does not divide over '
                         f'{world} replicas')
    per = n // world
    return slice(rank_ * per, (rank_ + 1) * per)


def take_rows(batch, rows: slice):
    """A (named) tuple of arrays or tensors (None for an absent field) with
    every field cut to ``rows`` of its leading axis."""
    out = [None if a is None else a[rows] for a in batch]
    return type(batch)(*out) if hasattr(batch, '_fields') \
        else type(batch)(out)


def replica_mean(x: torch.Tensor) -> torch.Tensor:
    """``lax.pmean(x, 'data')``: the mean of ``x`` over the replicas,
    differentiable (the backward all-reduces the cotangent, as JAX's
    transpose of ``pmean`` does); ``x`` itself without a group."""
    if not dist.is_initialized():
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x) / dist.get_world_size()


def _mean_in_place(tensors: List[torch.Tensor]) -> None:
    """One all-reduce per dtype of the flattened ``tensors``, divided by the
    world size and written back."""
    n = dist.get_world_size()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch._utils._flatten_dense_tensors(group)
        dist.all_reduce(flat)
        flat.div_(n)
        for t, m in zip(group, torch._utils._unflatten_dense_tensors(
                flat, group)):
            t.copy_(m)


@torch.no_grad()
def mean_gradients(params: Iterable[nn.Parameter]) -> None:
    """``pmean(grads)`` after ``backward()``: every parameter's gradient
    (zeros where a step left it unused, as JAX's are) averaged over the
    replicas in one coalesced all-reduce."""
    if not dist.is_initialized():
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _mean_in_place([p.grad for p in params])


@torch.no_grad()
def mean_buffers(module: nn.Module) -> None:
    """``pmean(new_batch_stats)``: the running means and variances of
    ``module``'s BatchNorm layers averaged over the replicas (one coalesced
    all-reduce)."""
    if not dist.is_initialized():
        return
    bufs = [b for m in module.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats
            for b in (m.running_mean, m.running_var)]
    if bufs:
        _mean_in_place(bufs)


@torch.no_grad()
def broadcast_state(module: nn.Module) -> None:
    """Every parameter and buffer from rank 0, so the replicas start from
    one state, as JAX replicates it."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t, 0)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def gather_to_main(obj: Any) -> Optional[List[Any]]:
    """Every rank's ``obj`` in rank order on rank 0 (None on the others);
    ``[obj]`` without a group."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size() if is_main() else None
    dist.gather_object(obj, out, dst=0)
    return out
