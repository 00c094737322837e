"""Multi-process data parallelism over `torch.distributed` (counterpart of
`mo_yolo_tpu/parallel/distributed.py`).

The JAX package brings up several hosts with `jax.distributed.initialize`
and runs one SPMD program whose mesh spans every process's devices; XLA
inserts the collectives. Here each process is one rank of a process group
(NCCL between cards, gloo on the CPU) and the collectives are written out:
`initialize` joins the group from the torchrun variables, `global_mesh`
describes the world (its size and this process's rank) and
`shard_host_batch` takes this rank's slice of a batch. A caller that
built its group itself (gloo over CUDA tensors, say) is taken as it is:
`initialize` joins nothing where a group exists.

The training step is data-parallel only inside `data_parallel()`
(`parallel/mesh.make_sharded_train_step` enters it): there BatchNorm takes
its batch statistics over every rank (`models/layers.BatchNorm2d`), the
clip loss divides by the global object count, and the gradients are summed
over the ranks once a step, so that each rank's step is the JAX step on
the global batch. Outside it nothing changes, with or without a group.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class World(NamedTuple):
    """The processes of a data-parallel run: how many, and which this is."""
    size: int
    rank: int


def _env_spec() -> Optional[Tuple[str, int, int]]:
    """("addr:port", world size, rank) from the torchrun variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), or None for one
    process."""
    addr = os.environ.get("MASTER_ADDR")
    world = os.environ.get("WORLD_SIZE")
    rank = os.environ.get("RANK")
    if addr and world and rank and int(world) > 1:
        port = os.environ.get("MASTER_PORT", "1234")
        return f"{addr}:{port}", int(world), int(rank)
    return None


def initialize(address: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> bool:
    """Join the process group, once. `address` ("host:port"), `world_size`
    and `rank` default to the torchrun variables (`_env_spec`). NCCL where
    there is a card (each rank on card LOCAL_RANK, else rank modulo the
    cards), gloo on the CPU. Returns True when the run has more than one
    process, False for a single process (a no-op)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if address is None:
        spec = _env_spec()
        if spec is None:
            return False
        address, world_size, rank = spec
    if world_size is None or rank is None:
        raise ValueError("initialize needs world_size and rank with an "
                         "address")
    if world_size <= 1:
        return False
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world_size, rank=rank)
    return True


def global_mesh() -> World:
    """The world of this process: (1, 0) without a process group."""
    if not dist.is_initialized():
        return World(1, 0)
    return World(dist.get_world_size(), dist.get_rank())


def process_rank() -> int:
    """This process's rank: the process group's, else the torchrun
    variables' (a rank that has not joined its group yet), else 0."""
    if dist.is_initialized():
        return dist.get_rank()
    spec = _env_spec()
    return 0 if spec is None else spec[2]


def barrier() -> None:
    """Wait for every rank; nothing without a group of more than one."""
    if global_mesh().size > 1:
        dist.barrier()


def min_over_ranks(n: int) -> int:
    """The smallest of the ranks' `n`; `n` itself without a group."""
    if global_mesh().size == 1:
        return n
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([n], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t)


def shard_host_batch(world: World, batch, batch_axis_index: int = 0):
    """This rank's slice of a host batch (a tensor, an array, or a dict,
    list or tuple of them): the batch axis cut into `world.size` equal
    parts, part `world.rank`."""
    if isinstance(batch, dict):
        return {k: shard_host_batch(world, v, batch_axis_index)
                for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_host_batch(world, v, batch_axis_index)
                           for v in batch)
    n = batch.shape[batch_axis_index]
    if n % world.size:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{world.size} processes")
    part = n // world.size
    index = [slice(None)] * batch.ndim
    index[batch_axis_index] = slice(world.rank * part,
                                    (world.rank + 1) * part)
    return batch[tuple(index)]


# ----------------------------------------------------- the sharded step

_active: Optional[World] = None


@contextlib.contextmanager
def data_parallel() -> Iterator[World]:
    """Inside the block, the training step is one rank's part of a step on
    the global batch (see the module docstring). Needs a process group of
    more than one process."""
    global _active
    world = global_mesh()
    if world.size < 2:
        raise RuntimeError("data_parallel needs an initialised process "
                           "group of more than one process")
    prev, _active = _active, world
    try:
        yield world
    finally:
        _active = prev


def active_world() -> Optional[World]:
    """The world inside `data_parallel()`, else None."""
    return _active


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, a new tensor, outside autograd."""
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class _SumOverRanks(torch.autograd.Function):
    """The sum over the ranks; each rank's loss depends on the sum, so the
    gradient of a rank's input is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return _SumOverRanks.apply(grad)


def all_reduce_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, differentiable (`_SumOverRanks`)."""
    return _SumOverRanks.apply(t)


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the ranks, in one collective
    over a flat buffer; a missing gradient takes part as zeros (the JAX
    gradient tree's zero leaf) and is set."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g).to(g.dtype)
        offset += n


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` from rank `src`, so that all
    ranks start a run from the same state."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)
