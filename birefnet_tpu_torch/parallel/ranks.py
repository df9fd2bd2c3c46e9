"""Process groups for data-parallel training: one process (rank) per device.

`spawn(fn, devices, args)` starts len(devices) processes with
torch.multiprocessing's spawn method (never fork: a caller may run threads,
JAX's among them in the tests), and in each:

- one intra-op thread on the CPU (ranks share the host's cores), or
  torch.cuda.set_device before the first kernel on a card;
- `torch.distributed.init_process_group` with a rendezvous in a file of a
  temporary directory (no port, no network), the backend by the devices'
  type: NCCL for CUDA, gloo for the CPU, never one as a fallback for the
  other. `backend="gloo"` may be asked for CUDA devices: NCCL refuses two
  ranks on one card, and gloo all-reduces CUDA tensors through the host;
- a timeout on every collective (TIMEOUT), so a rank that dies fails the
  others instead of hanging them;
- fn(rank, world, device, *args), then destroy_process_group.

`fn` is pickled by its import path, so a child imports fn's module and
nothing of the parent's: the rank functions live in the port
(finetune.rank_main, train.rank_step). A rank that raises raises in the
parent after every rank has ended. The run as a whole has no deadline
unless the caller gives one (`timeout`): a training run may take hours,
and a rank that hangs already fails at its next collective.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# Each collective's timeout: a rank that waits longer for its peers fails.
TIMEOUT = datetime.timedelta(minutes=10)


@contextlib.contextmanager
def process_group(rank: int, world: int, device, store: str,
                  backend: Optional[str] = None, timeout=TIMEOUT):
    """This process as rank `rank` of `world` in the default group, on
    `device`, rendezvous at the file `store` (absent or empty before the
    first rank starts), over `backend` (default: NCCL on a CUDA device,
    gloo on the CPU); yields the group, destroys it on the way out."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    default = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend or default,
                            init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timeout)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _entry(rank: int, fn: Callable, devices, store: str,
           backend: Optional[str], args: tuple) -> None:
    device = torch.device(devices[rank])
    if device.type == "cpu":
        torch.set_num_threads(1)
    with process_group(rank, len(devices), device, store, backend):
        fn(rank, len(devices), device, *args)


def spawn(fn: Callable, devices: Sequence, args: tuple = (),
          backend: Optional[str] = None,
          timeout: Optional[float] = None) -> None:
    """Run fn(rank, world, device, *args) on one spawned rank per entry of
    `devices`, in one process group (see the module docstring). Returns
    when every rank has returned; raises if one failed or, when `timeout`
    is given, if the ranks outlast `timeout` seconds (they are then
    terminated)."""
    devices = [str(torch.device(d)) for d in devices]
    with tempfile.TemporaryDirectory(prefix="birefnet_ranks_") as tmp:
        store = os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(_entry, args=(fn, devices, store, backend,
                                               tuple(args)),
                                 nprocs=len(devices), join=False,
                                 start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=None if deadline is None else max(
                    0.0, min(5.0, deadline - time.monotonic()))):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{len(devices)} ranks did not finish within "
                        f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
