"""Streams and clips over the batch and over processes (counterpart of
`mo_yolo_tpu/parallel/mesh.py`).

The JAX package jits its steps over a `Mesh` with a `data` axis that the
batch (streams, clips) is sharded over, and XLA adds the gradient
all-reduce. What replaced the mesh here: on one card the `data` axis is
the batch dimension itself (B streams in one batched `stream_step`, B clips
in one training step); across cards it is the ranks of a
`torch.distributed` process group (`parallel/distributed.py`), each rank
taking its slice of the batch, with the collectives written out.
"""

from __future__ import annotations

from typing import Optional

import torch

from mo_yolo_tpu_torch.parallel import distributed
from mo_yolo_tpu_torch.train import train_step


def make_sharded_stream_step(model):
    """The batched inference step: `step(state, frames) -> (state,
    packed)` with state from `model.init_state(B)` and frames [B, H, W, 3].
    Streams never exchange data, so across processes each rank steps its
    own streams with the same function."""
    return model.stream_step


def make_sharded_train_step(model, lcfg, tcfg,
                            compute_dtype: Optional[torch.dtype] = None):
    """(init_fn, step_fn) of `train.train_step.make_train_step`, taking
    the global clip ([T, B, ...], B the batch). Without a process group of
    more than one process they are that step as it is. Under one,
    `init_fn` first makes every rank's module equal to rank 0's, and
    `step_fn(ts, clip, generator)` takes this rank's slice of the clip's
    batch and runs the step inside `distributed.data_parallel()`: BatchNorm
    statistics and the object count over every rank, the gradients summed
    over the ranks once a step. Every rank passes the same clip and a
    generator in the same state, and gets the step of the global batch."""
    init_fn, step_fn = train_step.make_train_step(model, lcfg, tcfg,
                                                  compute_dtype)
    world = distributed.global_mesh()
    if world.size == 1:
        return init_fn, step_fn

    def sharded_init():
        distributed.broadcast_module(model)
        return init_fn()

    def sharded_step(ts, clip, generator):
        local = distributed.shard_host_batch(world, clip, batch_axis_index=1)
        with distributed.data_parallel():
            return step_fn(ts, local, generator)

    return sharded_init, sharded_step
