"""Batch data parallelism over a mesh (counterpart of
birefnet_tpu/parallel/sharding.py).

The JAX layouts become what the two entry points need: a batch split into
the mesh's data groups (`split_batch`, the JAX P(DATA_AXIS) layout: group
d takes rows [d B / dp, (d + 1) B / dp)), a parameter tree placed on each
group's device (`replicate`), and the rows a training rank takes of each
microbatch (`rank_rows`). Data-parallel inference needs no collective (the
JAX DP units lower with none), so each group runs on its own device and
the masks are concatenated in order. The spatial layouts
(batch_spatial_sharded, halo.py) and fsdp_specs are not ported
(mesh.SPATIAL_CUT, train.make_train_step); a mesh comes from
mesh.make_mesh, whose spatial axis is 1.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from .. import pipeline
from ..configs import BiRefNetConfig, ComputeConfig
from ..models import birefnet
from ..params import cast_matmul_weights, to_device
from .mesh import Mesh


def split_batch(x, groups: int) -> List:
    """x's leading axis in `groups` equal contiguous parts (views); raises
    unless it divides."""
    if x.shape[0] % groups:
        raise ValueError(f"batch {x.shape[0]} not divisible by {groups} data "
                         f"groups")
    n = x.shape[0] // groups
    return [x[i * n:(i + 1) * n] for i in range(groups)]


def replicate(tree: Dict, mesh: Mesh) -> List[Dict]:
    """The tree on each data group's device, one copy per distinct
    device."""
    copies = {}
    return [copies.setdefault(d, to_device(tree, d))
            for d in mesh.data_devices]


def rank_rows(batch: int, accum_steps: int, rank: int,
              world: int) -> np.ndarray:
    """The rows of a global batch that training rank `rank` of `world`
    takes, in microbatch order: microbatch i is global rows [i mb, (i + 1)
    mb), mb = batch / accum_steps, and the rank takes the rank-th 1/world
    of each, as the JAX step shards each microbatch over the data axis."""
    if batch % accum_steps or (batch // accum_steps) % world:
        raise ValueError(f"microbatch {batch} / {accum_steps} not divisible "
                         f"by {world} ranks")
    mb, share = batch // accum_steps, batch // accum_steps // world
    return np.concatenate([np.arange(i * mb + rank * share,
                                     i * mb + (rank + 1) * share)
                           for i in range(accum_steps)])


class _Events:
    """The CUDA events of one sharded submit: `synchronize` waits on each."""

    def __init__(self, events):
        self.events = events

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()


class ShardedInfer:
    """make_sharded_infer_fn's function: one make_infer_fn function per
    data group (`groups`: a pipeline.GraphedInfer per card, or CPU
    functions), the batch split over them. A call submits every group's
    rows on its device before it waits on any, and returns the masks
    concatenated in order on the first group's device. Where every group
    has `submit` (on the cards), so does this: GraphedInfer.submit over the
    groups (each copies its rows of the pinned frames in and its masks into
    its rows of `out`), whose handle's `synchronize` waits on every group's
    event; serve.InFlight keeps batches in flight through it. `launches`
    and `pool_bytes` are each group's."""

    def __init__(self, groups):
        self.groups = groups
        if all(hasattr(g, "submit") for g in groups):
            self.submit = self._submit

    @property
    def launches(self):
        return [g.launches for g in self.groups]

    @property
    def pool_bytes(self):
        return [g.pool_bytes for g in self.groups]

    def __call__(self, frames_u8) -> torch.Tensor:
        parts = split_batch(frames_u8, len(self.groups))
        masks = [g(f) for g, f in zip(self.groups, parts)]
        return torch.cat([m.to(masks[0].device) for m in masks])

    def _submit(self, frames: torch.Tensor, out: torch.Tensor) -> _Events:
        n = len(self.groups)
        return _Events([g.submit(f, o) for g, f, o in zip(
            self.groups, split_batch(frames, n), split_batch(out, n))])


def make_sharded_infer_fn(mesh: Mesh, params, cfg: BiRefNetConfig,
                          compute: ComputeConfig = ComputeConfig(),
                          spatial: bool = True, as_uint8: bool = True,
                          out_size=None) -> ShardedInfer:
    """uint8-in -> mask-out inference over the mesh's data groups, as a
    ShardedInfer: one pipeline.make_infer_fn per group's device (each
    prepares its own tree and, on a card, captures its own graph per input
    shape), the batch split into equal contiguous groups (a batch not
    divisible by their count raises). `spatial` is the JAX signature's: a
    mesh here has a spatial axis of 1 (make_mesh refuses more), on which
    spatial=True is plain batch sharding, as in the JAX package."""
    groups = [pipeline.make_infer_fn(params, cfg, compute, d,
                                     out_size=out_size, as_uint8=as_uint8)
              for d in mesh.data_devices]
    return ShardedInfer(groups)


def make_data_parallel_forward(mesh: Mesh, cfg: BiRefNetConfig,
                               compute: ComputeConfig = ComputeConfig(),
                               logits: bool = False):
    """forward(params, x) over the mesh's data groups: the normalized
    [B, H, W, 3] batch split into equal contiguous groups, each run through
    the model on its device, the outputs ([B, H, W, 1] logits, or their
    sigmoid in f32) concatenated on the first group's device. `params` is
    a tree (placed on every device at each call, as the JAX step's
    replicated device_put) or replicate(tree, mesh)'s list; its matmul
    weights are cast to compute.dtype."""
    devices = mesh.data_devices

    def forward(params, x: torch.Tensor) -> torch.Tensor:
        trees = params if isinstance(params, list) else replicate(params, mesh)
        outs = []
        for tree, part, dev in zip(trees, split_batch(x, len(devices)),
                                   devices):
            # The kernels' C entries launch on the current CUDA device.
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()), (
                    pipeline.full_f32() if compute.dtype == torch.float32
                    else contextlib.nullcontext()):
                y = birefnet.forward_logits(
                    cast_matmul_weights(tree, compute.dtype), cfg,
                    part.to(dev).to(compute.dtype), compute)
                outs.append(y if logits else torch.sigmoid(y.float()))
        return torch.cat([o.to(devices[0]) for o in outs])

    return forward
