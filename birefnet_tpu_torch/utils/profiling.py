"""Profiling and observability helpers.

Counterpart of birefnet_tpu/utils/profiling.py. The reference's
observability is wall-clock spans behind a read-back and min/max/mean
printouts (reference: examples/bench_inference.rs:9-12,
examples/infer_image.rs:79-90). Here: `tensor_stats` (the same printout),
`span` (a wall-clock span fenced on the card by a synchronize where the
JAX version reads back), `device_trace` (a `torch.profiler` trace written
to a directory) and `device_op_profile` (milliseconds per call by kernel),
on the helpers tools/gpu_profile.py and chip_smoke.py measure with:
`profiled`, `kernel_events` and `device_ms_per_call`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("birefnet_tpu_torch")


def _activities(cuda: Optional[bool] = None):
    from torch.profiler import ProfilerActivity

    if cuda is None:
        cuda = torch.cuda.is_available()
    return ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if cuda
            else [ProfilerActivity.CPU])


def _fence() -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def tensor_stats(x, name: str = "tensor") -> Dict[str, float]:
    """min/max/mean health-check stats of a tensor or array, in f32
    (reference: examples/infer_image.rs:79-90)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    xf = np.asarray(x, dtype=np.float32)
    stats = {"min": float(xf.min()), "max": float(xf.max()),
             "mean": float(xf.mean())}
    log.info("%s stats - min: %.4f, max: %.4f, mean: %.4f",
             name, stats["min"], stats["max"], stats["mean"])
    return stats


@contextlib.contextmanager
def span(name: str, result_holder: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock span with a device fence on exit: on the card the span
    ends after the work queued inside it (torch.cuda.synchronize), the
    counterpart of the JAX version's read-back. The seconds go into
    `result_holder["seconds"]`."""
    t0 = time.perf_counter()
    holder = result_holder if result_holder is not None else {}
    yield
    _fence()
    dt = time.perf_counter() - t0
    log.info("%s: %.1f ms", name, dt * 1e3)
    holder["seconds"] = dt


@contextlib.contextmanager
def device_trace(logdir: str = "birefnet_trace") -> Iterator[str]:
    """torch.profiler trace of the block (CPU, and CUDA where there is a
    card), written as `trace.json` (Chrome trace format) into `logdir`."""
    from torch.profiler import profile

    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield logdir
        _fence()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def profiled(fn: Callable[[], object], activities=None,
             margin_s: float = 0.02):
    """Run fn() under the profiler twice, a warm-up step and a recorded
    one, with `margin_s` of idle host time at both ends of the recorded
    step; returns (profiler, wall ms of fn in that step). The profiler
    keeps the kernels whose device timestamps fall inside the step's host
    time: without the margins it dropped the first kernels of a recorded
    forward in some runs on the H100 (one K4, one K1, three convolutions),
    and every kernel of a short call in others."""
    from torch.profiler import profile, schedule

    with profile(activities=activities or _activities(),
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        _fence()
        prof.step()
        time.sleep(margin_s)
        t0 = time.perf_counter()
        fn()
        _fence()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(margin_s)
        prof.step()
    return prof, wall_ms


def kernel_events(prof, device_type=None):
    """The device-side kernel entries of prof.key_averages(): not the CPU
    ops (whose entries repeat the device time of the kernels they
    launched) and not the step annotations that the profiler also puts on
    the device's timeline ("ProfilerStep*", spanning the whole step).
    `device_type=DeviceType.CPU` gives the CPU ops instead."""
    from torch.autograd import DeviceType

    device_type = DeviceType.CUDA if device_type is None else device_type
    return [a for a in prof.key_averages()
            if a.device_type == device_type
            and not getattr(a, "is_user_annotation", False)
            and not a.key.startswith("ProfilerStep")]


def device_ms_per_call(fn: Callable[[], object], reps: int,
                       name_key: Callable[[str], bool], activities=None
                       ) -> float:
    """The profiler's device time per call of the kernels whose name holds
    name_key, over `reps` calls of fn."""
    def calls():
        for _ in range(reps):
            fn()

    prof, _ = profiled(calls, activities)
    return sum(a.self_device_time_total for a in kernel_events(prof)
               if name_key(a.key)) / (1e3 * reps)


def device_op_profile(fn: Callable, *args, iters: int = 6
                      ) -> List[Tuple[float, float, str]]:
    """[(ms per call, launches per call, kernel name)] of `iters` calls of
    fn(*args), costliest first: the card's kernels by device time where
    there is a card, else the CPU's ops by their own CPU time (the CPU is
    then the device)."""
    from torch.autograd import DeviceType

    cuda = torch.cuda.is_available()

    def calls():
        for _ in range(iters):
            fn(*args)

    prof, _ = profiled(calls, _activities(cuda))
    if cuda:
        rows = [(a.self_device_time_total, a.count, a.key)
                for a in kernel_events(prof)]
    else:
        rows = [(a.self_cpu_time_total, a.count, a.key)
                for a in kernel_events(prof, DeviceType.CPU)]
    return sorted(((us / 1e3 / iters, n / iters, key)
                   for us, n, key in rows if us > 0), reverse=True)
