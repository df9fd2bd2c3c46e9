"""The device mesh (counterpart of birefnet_tpu/parallel/mesh.py).

A mesh is a (data, spatial) grid of torch devices. The data axis splits a
batch into equal groups, one per device (sharding.py); the spatial axis,
which the JAX package shards along image height for its 2048^2 HR
configuration, is not ported (SPATIAL_CUT says why). A device may appear
more than once: two groups on one card run as two separate graphs, which
is how a machine with one card exercises the multi-card path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

# Why the spatial axis (--spatial > 1, halo.py's exchanges,
# batch_spatial_sharded) is not ported. The JAX package shards the 2048^2
# HR configuration's activations over a v5e-8 mesh because one v5e chip
# holds 16 GB.
SPATIAL_CUT = (
    "spatial sharding is not ported: Swin-L at 2048^2 batch 2 runs on one "
    "H100 80GB, its graph holding 6.12 GiB on the main path's flags (bf16, "
    "int8, regular) and 8.57 GiB on serve's default (bf16, deformable), the "
    "whole process at most 9.11 GiB (chip_smoke.py phase 10; PERF.md "
    "section 2); the port serves 2048^2 on one card per data group instead "
    "of splitting an image's rows across cards")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices: `devices[d, s]` is the device of data group d and
    spatial shard s (s is always 0 in the port)."""

    devices: np.ndarray  # [data, spatial] of torch.device
    axis_names: Tuple[str, str] = (DATA_AXIS, SPATIAL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The device of each data group, in order."""
        return tuple(self.devices[:, 0])


def make_mesh(n_devices: Optional[int] = None, spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, spatial) mesh: over `devices` (torch devices or
    their names, repeats allowed) or, by default, every CUDA device of the
    machine, cut to the first `n_devices`.

    Raises where the JAX make_mesh does, and also where it would silently
    take fewer devices than asked: more devices asked for than there are,
    or a count not divisible by `spatial`. spatial > 1 is refused
    (SPATIAL_CUT). Without `devices` and without a CUDA device it raises:
    there is no CPU fallback (pass devices=["cpu"] * n for CPU groups)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh defaults to the CUDA devices and "
                               "none is available; pass devices= for CPU "
                               "groups")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if any(d.type == "cuda" and d.index is None for d in devs):
        raise ValueError(f"give each CUDA device its index: {devs}")
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"{n_devices} devices asked for, {len(devs)} "
                             f"available")
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0 or spatial < 1 or n % spatial != 0:
        raise ValueError(f"{n} devices not divisible by spatial={spatial}")
    if spatial > 1:
        raise NotImplementedError(SPATIAL_CUT)
    grid = np.empty((n // spatial, spatial), dtype=object)
    for i, d in enumerate(devs):
        grid[i // spatial, i % spatial] = d
    return Mesh(grid)
