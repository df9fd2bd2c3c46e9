"""uint8 frames -> masks inference pipeline on one device.

Counterpart of birefnet_tpu/pipeline.py: antialiased triangle resize to the
model size, /255 and ImageNet normalization, the model, sigmoid, and the
Lanczos3 resize back, all on the device; only uint8 frames go in and
masks come out. The JAX package compiles that body once per input shape
(one `jax.jit`); on the CUDA device `make_infer_fn` captures it once per
input shape as one CUDA graph and replays it (`GraphedInfer`). On the CPU
it runs the body eagerly. (The JAX package's staged executables were a TPU
compile-size workaround and are not ported.)
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .configs import IMAGENET_MEAN, IMAGENET_STD, BiRefNetConfig, ComputeConfig
from .models import birefnet
from .ops import device_cache
from .ops.kernels import (bf16_gemm, deform_im2col, f32_gemm,
                          flash_window_attn, fused_block_attn, fused_mlp,
                          int8_gemm, row_ln, tap_conv)
from .ops.resize import resize_bilinear_half_pixel, resize_lanczos3
from .params import (cast_matmul_weights, quantize_attn_int8,
                     quantize_mlp_int8, split_tf32_weights, to_device)


@device_cache.device_cache(maxsize=None)
def _imagenet_stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet mean and std as f32 tensors on `device`, copied there
    once: a host-to-device copy inside the body is what CUDA graph capture
    refuses. Built outside inference mode, as every cached device tensor
    is (ops/window.py, ops/resize.py), so that training after serving may
    use them."""
    with torch.inference_mode(False):
        return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                             device=device),
                torch.tensor(IMAGENET_STD, dtype=torch.float32,
                             device=device))


def preprocess(frames_u8: torch.Tensor, size: Tuple[int, int] = (1024, 1024),
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> normalized [B, size[0], size[1], 3]."""
    x = frames_u8.float() / 255.0
    x = resize_bilinear_half_pixel(x, size[1], size[0])
    mean, std = _imagenet_stats(x.device)
    return ((x - mean) / std).to(dtype)


def postprocess(mask: torch.Tensor, out_h: int, out_w: int,
                as_uint8: bool = True) -> torch.Tensor:
    """[B, h, w, 1] or [B, h, w] mask -> [B, out_h, out_w], Lanczos3
    resized, optionally quantized to uint8."""
    if mask.ndim == 4:
        mask = mask[..., 0]
    m = resize_lanczos3(mask.float(), out_h, out_w)
    if as_uint8:
        m = torch.clamp(torch.round(m * 255.0), 0.0, 255.0).to(torch.uint8)
    return m


@contextlib.contextmanager
def full_f32():
    """Both of PyTorch's TF32 flags off inside, the caller's values back
    after. cuDNN's flag defaults to True, which runs every f32 convolution
    in TF32 (about three decimal digits); the JAX package's f32 contract
    is precision=HIGHEST at every conv and dot."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def kernel_counters() -> Dict[str, object]:
    """{"module.wrapper": wrapper} of every kernel wrapper that counts its
    launches (a `.launches` attribute it raises by one where it launches)."""
    return {f"{m.__name__.rsplit('.', 1)[-1]}.{name}": fn
            for m in (bf16_gemm, deform_im2col, f32_gemm, flash_window_attn,
                      fused_block_attn, fused_mlp, int8_gemm, row_ln, tap_conv)
            for name, fn in vars(m).items()
            if callable(fn) and hasattr(fn, "launches")}


def _as_tensor(frames_u8) -> torch.Tensor:
    """[B, H, W, 3] frames as a tensor (numpy arrays are wrapped, not
    copied)."""
    if isinstance(frames_u8, np.ndarray):
        frames_u8 = torch.from_numpy(frames_u8)
    if frames_u8.ndim != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(f"want [B, H, W, 3] frames, got "
                         f"{tuple(frames_u8.shape)}")
    return frames_u8


class GraphedInfer:
    """make_infer_fn's function on a CUDA device: one captured CUDA graph
    per (shape, dtype) of the frames, the counterpart of the JAX function's
    `jax.jit`, which compiles one executable per input shape.

    Per key it keeps a static input buffer, the graph of the whole body
    (preprocess -> forward_logits -> sigmoid -> postprocess) and the graph's
    static output. A call copies the frames into the buffer, replays the
    graph and returns a clone of the static output, so a later call never
    overwrites a mask the caller holds. The first call of a key warms the
    body on a side stream (the nvcc build, the kernels' one-time attributes,
    the caches), then captures it. A capture that fails raises; there is no
    eager fallback. `eager` runs the body uncaptured: what the graph is
    checked against.

    What a replay reads outside the graph's own pool is owned here: the
    prepared parameter tree, and every tensor the device caches
    (ops/device_cache.py: resize matrices, SW-MSA ids and masks, the
    ImageNet statistics) returned during warm-up and capture. The wgmma
    GEMMs and K3 encode their TMA descriptors on the host at each launch, so
    the capture freezes the addresses of the weights (owned), the
    intermediates (the graph's pool) and the frames (the static input).

    `launches[key]` holds, per kernel wrapper (`kernel_counters`), the
    launches the captured body made: a replay runs no Python, so the
    wrappers' counters do not move. `pool_bytes[key]` is the device memory
    reserved by the capture. One lock, and one stream of its own (its
    graphs' capture stream too), serialize copy -> replay -> clone, so
    threads that share the function never interleave on one graph's static
    buffers. `submit` enqueues the same
    copy -> replay with the read-back into the caller's pinned buffer and
    returns at once, so a server keeps batches in flight (serve.main).
    """

    def __init__(self, body, device: torch.device, params):
        self._body = body
        self._params = params  # read by every replay
        self.device = device
        self._graphs = {}
        self._lock = threading.Lock()
        self._stream = None  # made at the first capture, on the card
        self.launches: Dict[tuple, Dict[str, int]] = {}
        self.pool_bytes: Dict[tuple, int] = {}

    @torch.inference_mode()
    def eager(self, frames_u8) -> torch.Tensor:
        """The body uncaptured, on the device's current stream."""
        with torch.cuda.device(self.device):
            return self._body(_as_tensor(frames_u8).to(self.device))

    def _capture(self, key, frames: torch.Tensor):
        dev = self.device
        static_in = frames.to(dev, copy=True)
        counters = kernel_counters()
        with device_cache.retained() as held:
            # Warm-up on a side stream, as torch.cuda.graphs requires: it
            # also builds the kernels, sets their one-time attributes and
            # fills the caches, none of which a capture may do.
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._body(static_in)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            before = {name: fn.launches for name, fn in counters.items()}
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            # Every kernel wrapper launches on the stream current at its call
            # (ops/kernels/build.py: stream), here the capture stream: this
            # function's own, on its device. torch.cuda.graph's default is
            # one stream for the whole process, made on whichever device was
            # current at the first capture, and cuBLAS keeps its workspace
            # per stream: graphs of two functions captured on it share that
            # workspace, and replays of both at once (two data groups on one
            # card, sharding.ShardedInfer.submit) wrote over each other's.
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                static_out = self._body(static_in)
        self.pool_bytes[key] = torch.cuda.memory_reserved(dev) - reserved
        self.launches[key] = {name: fn.launches - before[name]
                              for name, fn in counters.items()
                              if fn.launches != before[name]}
        owned = tuple({id(t): t for t in held}.values())
        return static_in, graph, static_out, owned

    def _entry(self, frames: torch.Tensor):
        """(static input, graph, static output) of the frames' key, captured
        at its first call; the caller holds the lock."""
        key = (tuple(frames.shape), frames.dtype)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(key, frames)
        return entry[:3]

    @torch.inference_mode()
    def __call__(self, frames_u8) -> torch.Tensor:
        frames = _as_tensor(frames_u8)
        with self._lock, torch.cuda.device(self.device):
            static_in, graph, static_out = self._entry(frames)
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                static_in.copy_(frames)
                graph.replay()
                mask = static_out.clone()
            current.wait_stream(self._stream)
            mask.record_stream(current)
            return mask

    @torch.inference_mode()
    def submit(self, frames: torch.Tensor,
               out: torch.Tensor) -> torch.cuda.Event:
        """Enqueue one call without waiting for it: copy `frames` (a CPU
        tensor, pinned for the copy to be asynchronous) to the static
        input, replay, and copy the masks into `out` (pinned CPU memory of
        the masks' shape and dtype), all on this function's stream. Returns
        a CUDA event that fires once `out` holds the masks: the caller
        waits on it, not on the device, and reuses neither buffer before
        it has fired. The masks are the replay's, bitwise those __call__
        returns."""
        frames = _as_tensor(frames)
        with self._lock, torch.cuda.device(self.device):
            static_in, graph, static_out = self._entry(frames)
            if out.shape != static_out.shape or out.dtype != static_out.dtype:
                raise ValueError(f"out is {tuple(out.shape)} {out.dtype}, "
                                 f"the masks {tuple(static_out.shape)} "
                                 f"{static_out.dtype}")
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            done = torch.cuda.Event()
            with torch.cuda.stream(self._stream):
                static_in.copy_(frames, non_blocking=True)
                graph.replay()
                out.copy_(static_out, non_blocking=True)
                done.record()
            return done


def make_infer_fn(params, cfg: BiRefNetConfig,
                  compute: ComputeConfig = ComputeConfig(), device=None,
                  out_size: Optional[Tuple[int, int]] = None,
                  as_uint8: bool = True):
    """Build the uint8-in -> mask-out inference function on `device`.

    `device` defaults to the CUDA device; pass "cpu" to run the plain
    PyTorch versions on the CPU. The tree is moved to `device` once, here;
    under `compute.int8_mlp` / `int8_attn` the wide Swin blocks' weights
    are quantized from the f32 values (params.quantize_*_int8) before the
    matmul and conv weights are cast to `compute.dtype`, as the JAX
    package does; on the f32 kernel tier on the card the Swin blocks'
    f32 GEMM weights are split into their TF32 parts once
    (params.split_tf32_weights). The returned function takes [B, H, W, 3]
    uint8 frames (numpy or tensor) and returns [B, out_h, out_w] masks on
    the device, out_size defaulting to the frame size. With an f32
    `compute` its body runs with PyTorch's TF32 flags off (`full_f32`), the
    int8 flags included. On a CUDA device it is a `GraphedInfer`: one CUDA
    graph per input shape, its `.eager` the uncaptured body; on the CPU the
    body itself.
    """
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_infer_fn runs on the CUDA device unless "
                           "device='cpu' is given, and no CUDA device is "
                           "available")
    # f32 runs every convolution and product in full f32, whatever TF32
    # flags the caller has set; bf16 leaves them alone.
    precision = (full_f32 if compute.dtype == torch.float32
                 else contextlib.nullcontext)
    params = to_device(params, device)
    if compute.int8_mlp:
        params = quantize_mlp_int8(params)
    if compute.int8_attn:
        params = quantize_attn_int8(params)
    params = cast_matmul_weights(params, compute.dtype)
    if (device.type == "cuda" and compute.dtype == torch.float32
            and compute.use_flash_attention):
        # The f32 GEMM reads each weight's TF32 hi and lo parts: split once,
        # so no call splits a weight (and no graph reads a split of its own).
        params = split_tf32_weights(params)

    def body(frames_u8: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = frames_u8.shape
        oh, ow = out_size if out_size is not None else (h, w)
        with precision():
            x = preprocess(frames_u8, cfg.size, dtype=compute.dtype)
            # Sigmoid in f32 on the logits: a bf16 mask would round every
            # value near 0.5 by up to 2e-3 (measured on the card: mask MAE
            # 8.5e-4 against the f32 pipeline with bf16 masks, with logits
            # off by only 5e-4).
            logits = birefnet.forward_logits(params, cfg, x, compute)
            return postprocess(torch.sigmoid(logits.float()), oh, ow,
                               as_uint8=as_uint8)

    if device.type == "cuda":
        return GraphedInfer(body, device, params)

    @torch.inference_mode()
    def infer(frames_u8) -> torch.Tensor:
        return body(_as_tensor(frames_u8).to(device))

    return infer
