#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (birefnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
2. build the CUDA kernels from birefnet_tpu_torch/csrc with nvcc (one nvcc
   process per source, all in parallel);
3. check each hand-written kernel against its plain PyTorch version on the
   same inputs (bound max|kernel - plain| <= 2e-2 * max|plain|) at every
   shape the 1024^2 batch-2 forwards give it: Swin-L (K1, K1-int8, K2, K3,
   K4, K5) and swin_t (K6 masked and unmasked at every stage of both
   backbone passes, K2 including C = 96, K3 at stage 3, K4 at the swin_t
   widths); K7 and
   K8, which no forward calls, at the JAX package's test shapes. bf16
   kernels run on bf16 weights, the W8A8 kernels (K1-int8, K3) on weights
   quantized from f32 by params.quantize_*_int8; those two and K6-K8 also
   hold a bound on mean|kernel - plain| / mean|plain|. Time each kernel,
   its plain version and, where one PyTorch call computes the same
   function, that call (for K4, F.layer_norm with the f32 affine where
   PyTorch takes it beside a bf16 input, else the affine cast to bf16; the
   log says which); compute each call's bound (the larger of its bytes
   over 3.35 TB/s and the operations its real tokens need over the H100's
   published peak for their type); K5's device time alone by the
   profiler beside its event time. Check that K1, K1-int8 and K6 take the
   rel-pos bias rounded to bf16: a bias B and bf16(B) give bitwise the
   same output. K3 (csrc/fused_mlp_i8.cu: the LN2 row pass, then one
   thread-block-cluster kernel that keeps the [T, 4C] hidden in shared
   memory) is also run alone from the row pass's LN2 codes at each of its
   shapes ("cluster" under K3's entry), held bitwise to the plain chain
   int8_linear -> gelu_erf3 -> quantize_rows -> int8_linear -> + x, and
   timed beside torch._int_mm for its two products ("int_mm_ms": two
   calls, the s32 products only, so no library_ms). The int8 row pass's LN
   codes are counted against the plain model's (F.layer_norm, then
   quantize_rows) at every K1-int8 LN1 and K3 LN2 shape: how many flip, by
   at most one step ("ln_code_flips" under both entries). The window-attention core that K1 shares with K6-K8
   (csrc/window_core.cuh) is also timed alone at every Swin-L stage shape
   of both passes (B_ = 2 (Hp/12)^2 windows, 6-48 heads, N = 144, d = 32,
   unmasked and with the offset mask's region ids) through
   flash_window_attention, against its plain version and SDPA; its sums
   per forward go under K1's entry as "core". The int8 GEMM of K1-int8
   (csrc/int8_gemm.cu) is checked bitwise against its plain version and
   timed alone at K1-int8's eight Swin-L shapes (qkv and proj of stages
   2-3, both passes), against torch._int_mm (the s32 product only, without
   the dequant epilogue); its sums go under K1-int8's entry as
   "int8_gemm". The
   bf16 GEMM that K1 and K2 share (csrc/bf16_gemm.cu, the same machinery
   in csrc/wgmma_ring.cuh) is checked against its plain version (F.linear
   in f32 of the bf16 operands plus the epilogue; sums in another order,
   so max and mean bounds, not bitwise) and timed alone at every K1 and K2
   shape of Swin-L and at swin_t's K2 shapes, against F.linear on the same
   bf16 operands (the product and bias, no GELU or residual); so is the
   bf16 row pass (csrc/row_ln.cu: LN1 rows with the pads zeroed on K1's
   canvases, LN2 rows for K2), against F.layer_norm. Their sums go under
   K2's entry as "bf16_gemm" and "ln_rows" (K1's under their key "k1",
   swin_t's under "swin_t"). Last, every int8 GEMM, K1-int8, K3 (whole and
   from codes), bf16 GEMM and K6 shape and one K1 call per Swin-L stage
   runs REPEATS times back to back, and the last output must be bitwise
   the first (or the bitwise plain one): a fault that shows only
   sometimes, such as a lost barrier phase or a cluster race, fails here.
   The f32 tier: K1, K2 and K4 on f32 activations at every Swin-L shape,
   the f32 core at K1's 16 shapes (through flash_window_attention), the
   3xTF32 f32 GEMM and the f32 row pass alone at every K1 and K2 shape of
   Swin-L and swin_t, K6 and K2 at every swin_t shape (C = 96 included),
   K7 and K8 at the JAX test shapes, each against its plain version with
   TF32 off (max <= BOUND_F32 x max|plain|, mean ratio <= MEAN_BOUND_F32)
   and timed against F.linear / F.layer_norm / SDPA in f32; at every GEMM
   and core shape the plain version in TF32 (operands rounded to TF32,
   flags on) must break the mean bound. The f32 GEMM and core take each
   f32 product as three TF32 products on the tensor cores, so their
   operations count three times against the TF32 peak in the bound. The W8A8 kernels' f32 branches
   (K1-int8 and K3 on f32 activations, entries "*_int8_f32") at every
   Swin-L shape (and K3 at swin_t's stage 3), held to the int8 bounds
   (BOUND, MEAN_BOUND_K1_I8, MEAN_BOUND_K3: the LN sums' order can flip a
   code), K3 f32 also from given codes and the int8 GEMM's f32 epilogues
   (the f32 store and the f32 residual) at K1-int8's eight shapes, both
   bitwise and timed against torch._int_mm; their LN1 and LN2 code flips,
   and on each f32 canvas a control whose plain LN1 rows are rounded to
   bf16 must flip more than FLIP_CONTROL of the codes. The f32 GEMM, core
   and one K1 call per stage, and every K1-int8 f32, K3 f32 (whole and
   from codes) and f32-epilogue int8 GEMM shape, join the repeat check
   (REPEATS_F32 calls). D1 (csrc/deform_im2col.cu, the deformable-im2col
   kernel of the decoder's 20 ASPP sites, which has no Pallas
   original: the JAX package samples with an XLA gather) at the 12
   distinct site shapes of the forward (C = 64 at 32^2, 64^2, 128^2 and
   256^2, each with k = 1, 3 and 7), in bf16 and f32, offsets of a few
   pixels and masks across (0, 2): its columns bitwise the plain
   version's, timed against it (no one PyTorch call computes them), and
   in the repeat checks. Phase 3 runs with PyTorch's TF32 flags off;
   the later phases find them as a user does (make_infer_fn turns them off
   for an f32 forward itself);
4. drive pipeline.make_infer_fn at 1024^2, batch 2, bf16, kernel tier,
   regular deform mode, random_checkpoint(cfg, 0) (swin_t's rel-pos bias
   tables scaled to std 1, REL_POS_BIAS_SCALE), on uint8 frames, for
   four paths, each with every launch count set to 0 just before it and
   read just after. On the card make_infer_fn replays one CUDA graph per
   input shape: its first call warms the body up and captures it (each
   runs the body once, so the counts read after it are twice a call's),
   and the launches the capture made are recorded by the function and
   held to the counts below; a second call (a replay) must move no count,
   and the graphed masks must be bitwise the eager body's (`.eager`) for
   two different frame batches. Every gate below reads the graphed call:
   its masks, and the backbone features of the captured body, which hold
   the replay's values. The paths: Swin-L on the bf16 tier (K1 / K1-int8 /
   K2 / K3 / row_ln / tap_conv / K6 / K7 / K8: 48/0/48/0/16/1/0/0/0) and
   its int8
   main path, int8_mlp and int8_attn on (8/40/8/40/16/1/0/0/0); swin_t
   (the ws=7 middle tier) on the bf16 tier (0/0/24/0/16/1/24/0/0) and with
   both int8 flags (0/0/20/4/16/1/24/0/0: int8_attn is inert at ws=7).
   Each mask is held to the f32 plain pipeline of its model on the card
   (mask MAE < 1e-3, TF32 off) and each call's backbone features to the
   f32 pipeline's: Swin-L's int8 path's error at most FEATURE_RATIO times
   its bf16 tier's, swin_t's bf16 tier's at most FEATURE_RATIO_T times the
   plain bf16 pipeline's at every stage (and a tree whose rel-pos bias is
   rolled by one head must break that), swin_t's int8 path's at most
   FEATURE_RATIO times its bf16 tier's; the masks of a random checkpoint
   barely see the backbone. Two more paths run the f32 kernel tier
   (ComputeConfig(use_flash_attention=True)): Swin-L (48/0/48/0/16/0/0/0/0)
   and swin_t (0/0/24/0/16/0/24/0/0), each held to its f32 plain pipeline
   (mask MAE < MASK_MAE_F32, every stage's feature error <= FEATURE_F32);
   Swin-L's f32 plain pipeline with cuDNN's TF32 forced on inside the
   forward must break that feature gate. Two more run the f32 kernel tier
   with both int8 flags (what `serve --dtype float32 --int8-mlp
   --int8-attn` runs): Swin-L (8/40/8/40/16/0/0/0/0) and swin_t
   (0/0/20/4/16/0/24/0/0), each held to mask MAE < 1e-3 against its f32
   plain pipeline and its worst stage feature error to at most its bf16
   int8 path's; Swin-L's int8 scales rolled by one channel, on f32
   activations, must break that gate. Also the f32 plain forward and
   the f32 kernel tier at 64^2 against the JAX package's committed golden
   logits (in regular mode within 5e-4, as before; in deformable mode,
   the golden's own, within the JAX package's 5e-5). All of the above run
   deform_mode="regular" (ComputeConfig's default is "deformable") and
   count no D1 launch. Then Swin-L in deformable mode on a tree whose
   offset convs are scaled by OFFSET_SCALE (offsets of several pixels):
   its int8 main path, bf16 kernel tier and f32 kernel tier, each with 20
   D1 launches captured per call (and the counts above), graphed masks
   bitwise the eager body's, and the output of each of the 20 deformable
   sites held to the same tree's f32 plain deformable pipeline on the
   card: the f32 tier's mean|s - ref| / mean|ref| <= DEFORM_F32 at every
   site, the bf16 and int8 paths' at most DEFORM_RATIO x the plain bf16
   deformable pipeline's at every site; regular mode on the same tree
   must break each of those gates;
5. serve 4 in-memory requests of different sizes through serve.segment on
   every path, and on Swin-L's deformable int8 path;
6. time the pipeline with CUDA events, each tier's graphed function and
   its eager body in turns, 5 calls each after warm-up, one function at a
   time (each graph keeps its own memory pool), the tiers in order and
   then in reverse: Swin-L int8 path, bf16 kernel tier, plain bf16, f32
   kernel tier, plain f32, f32 int8 path, and the deformable int8 path and
   f32 kernel tier; swin_t int8 path, bf16 kernel tier, plain bf16;
   medians and spreads, and each graph's pool;
7. profile one replay of the Swin-L int8 path's graph and one eager call
   (tools/gpu_profile.py on birefnet_tpu_torch/utils/profiling.py: wall,
   device time, idle share, kernels by group); where the profiler resolves
   the graph's kernels, their launches per group must be what the capture
   counted; then the replay's costliest kernels by
   utils/profiling.device_op_profile;
8. train (train.py, finetune.py, the export), f32, deformable: D1b
   (csrc/deform_col2im.cu, D1's backward, f32 atomics) at the inputs of
   the 20 deformable sites of one eager f32 forward of the offset-scaled
   Swin-L tree, with a seeded column gradient, against autograd through
   D1's plain version (each gradient within D1B_BOUND x max|plain|, mean
   ratio within D1B_MEAN; (dx, dy) read for (dy, dx) must break the max
   bound), timed by CUDA events, by device time and against its bound;
   Swin-L's gradients at GRAD_SIZE^2, batch 2, on that tree through D1/D1b
   (20 launches each) against the plain route (every leaf within
   GRAD_LEAF_BOUND, relative L2 within GRAD_L2_BOUND, TF32 off), the same
   route twice for the noise, regular mode as the control that must break
   the offset-conv leaves; finetune.main at Swin-L 1024^2, batch 2, 3
   steps, on 4 image/mask pairs written from a seed into a temp dir, and
   again with --accum-steps 2, each with every launch count set to 0 just
   before it and read just after (D1 and D1b 20 per microbatch, nothing
   else), the loss and ms per step and the peak memory (--remat only if
   batch 2 does not fit, and the log says so); the written checkpoint
   loaded and served through make_infer_fn; tests/test_train.py's overfit
   check (disk masks, lr 1e-4, no decay, 3 steps at GRAD_SIZE^2: the loss
   falls, decoder_block1's offset convs move); one profiled train step at
   1024^2;
9. the entry points a user starts the port with, at Swin-L 1024^2 batch 2
   on seed-0 weights saved to a temporary safetensors file: the native
   host-image library must build and load (utils/native.require; its
   path is printed); 16 seeded images of mixed sizes (ENTRY_SIZES,
   1440x1080 among them) as PNG and JPEG; serve.main on its default flags
   (bf16, deformable: K1 / K2 / K4 / K5 / D1 48/48/16/1/20) and on the main
   path's (--int8-mlp --int8-attn --deform-mode regular: K1 / K1-int8 / K2
   / K3 / K4 / K5 8/40/8/40/16/1), ENTRY_RUNS runs each, the first of the
   default flags without --checkpoint (the checkpoint from an HF cache
   under a $HOME of its own), each with every launch count set to 0 just
   before it and read just after: one graph captured, holding those
   launches (counted twice by its first call, none by a replay), every
   written mask bitwise the sequential path's (serve.main's loop before
   it overlapped: decode, serve.segment, write, in series, on the same
   function), img/s including IO of both loops, medians; cli.main on the
   1440x1080 image with its defaults (f32 kernel tier, deformable: K1 / K2
   / K4 / D1 48/48/16/20 captured), its mask bitwise make_infer_fn's for
   the same frame and flags and its stats line printed; evaluate.main on
   the served masks of the small images against seeded disks: seven
   scores, each in [0, 1].

The line before the last is the nvidia-smi name/power line, the one
before it the JSON kernel report: per kernel `launches` from its main path
(Swin-L int8 for K1-K5, swin_t bf16 for K6-K8, the f32 paths for the
"_f32" entries, Swin-L f32 int8 for the "_int8_f32" ones, Swin-L's
deformable int8 path for D1 and its deformable f32 tier for D1 f32): the
launches
captured in one call's graph, which every replay runs (D1b: the launches
of phase 8's first finetune.main run, its times per step of one
microbatch, its errors relative to max|plain|);
`launches_by_path` from all eleven, `launches_counted_by_path` the counts
read after each path's first call (warm-up and capture), and the times and bound
of its main model's forward (one call at each checked shape for K7 and
K8), with each model's under `by_model`. The
last line is `{"ok": true, "device": {...}}`. Without a CUDA device, or
without the package beside this file, it exits 1 and prints no result.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, SIZE = 2, 1024
# Stage geometry per model and backbone pass: (H of the stage, C, heads,
# depth); window 12 for Swin-L, 7 for swin_t.
MODELS = {
    "swin_l": (12, {"full": [(256, 192, 6, 2), (128, 384, 12, 2),
                             (64, 768, 24, 18), (32, 1536, 48, 2)],
                    "half": [(128, 192, 6, 2), (64, 384, 12, 2),
                             (32, 768, 24, 18), (16, 1536, 48, 2)]}),
    "swin_t": (7, {"full": [(256, 96, 3, 2), (128, 192, 6, 2),
                            (64, 384, 12, 6), (32, 768, 24, 2)],
                   "half": [(128, 96, 3, 2), (64, 192, 6, 2),
                            (32, 384, 12, 6), (16, 768, 24, 2)]}),
}
BOUND = 2e-2
# The int8 kernels also hold mean|kernel - plain| / mean|plain| to a bound.
# Both sides sum exactly in integers, so they differ only where a LayerNorm
# or softmax sum in another order flips an int8 code: on the H100 at most
# 3.2e-4 for K1-int8 (its bf16 attention core feeds the proj quantization)
# and 1.0e-5 for K3. A copy of K1-int8 that skipped the bf16 rounding of
# the normed rows broke its bound at every shape, and copies of both that
# dequantized every 64th channel with its neighbour's scale broke theirs.
MEAN_BOUND_K1_I8, MEAN_BOUND_K3 = 1e-3, 1e-4
# The int8 row pass's LN1 codes on an f32 canvas against the plain model's:
# a plain model that rounds the normed rows to bf16 (the rounding the f32
# branch must skip) must differ in more than this share of the codes, and
# the real flips must not.
FLIP_CONTROL = 1e-3
# The window-attention kernel (K6-K8) rounds at the plain version's points,
# so only f32 sums in another order differ: mean|k - p| / mean|p| read at
# most 3.6e-7 on the H100 over every K6-K8 shape, and is bounded at 1e-5.
MEAN_BOUND_FWA = 1e-5
# Backbone features against the f32 plain pipeline's, mean|f - f32| /
# mean|f32| per stage tensor: an int8 path's worst at most FEATURE_RATIO
# times its bf16 kernel tier's in the same run (Swin-L read 2.4x), and a
# Swin-L tree whose int8 scales are rolled by one channel must break that.
FEATURE_RATIO = 4.0
# swin_t's bf16 kernel tier against the plain bf16 pipeline, stage by stage:
# err(kernel tier) <= FEATURE_RATIO_T * err(plain bf16).
FEATURE_RATIO_T = 2.0
# random_checkpoint draws every tensor at std 0.05, at which the rel-pos
# bias barely moves the scores: a bias rolled by one head read 1.002x the
# plain bf16 error on the H100, so the gate could not see it. swin_t's
# tables are scaled to std 1, a factor chosen so that the rolled-bias
# control breaks the gate (it read 5.50x); no trained table sets it. The
# bias path itself is held by the K6 checks and the bitwise B-vs-bf16(B)
# checks of phase 3.
REL_POS_BIAS_SCALE = 20.0
# The bf16 GEMM and row pass round at their plain versions' points and sum
# in f32 in another order: mean|kernel - plain| / mean|plain| is bounded.
MEAN_BOUND_BF16 = 1e-4
# The f32 tier (K1, K2, K4 and K6-K8 on f32 activations, the f32 GEMM and
# window-attention core, three TF32 products per f32 product) is held to its plain versions, run with TF32
# off: max|kernel - plain| <= BOUND_F32 * max|plain| and mean|kernel -
# plain| / mean|plain| <= MEAN_BOUND_F32, the f32 bar of ROADMAP.md. The
# same plain versions in TF32 (their operands rounded to TF32 and the flags
# on: cuBLAS keeps the small batched products of K6-K8 in f32 even with
# TF32 allowed) must break the mean bound at every GEMM and core shape, or
# the bound could not tell f32 from TF32.
BOUND_F32, MEAN_BOUND_F32 = 1e-4, 1e-5
# The f32 kernel tier's pipeline against the f32 plain pipeline: mask MAE
# and the backbone features' mean|f - f32| / mean|f32| per stage tensor.
MASK_MAE_F32, FEATURE_F32 = 1e-5, 1e-5
# Swin-L's deformable paths: the offset convs (weights and biases) of
# random_checkpoint(cfg, 0) scaled by OFFSET_SCALE, so that the offsets
# reach several pixels (unscaled, most sites sample within a fraction of
# a pixel of the regular grid, and regular mode passes for deformable).
# Each deformable site's output is held to the f32 plain deformable
# pipeline's, mean|s - ref| / mean|ref|: the f32 tier within DEFORM_F32,
# the bf16 and int8 paths within DEFORM_RATIO x the plain bf16 deformable
# pipeline's error at the same site.
OFFSET_SCALE = 10.0
DEFORM_F32, DEFORM_RATIO = 1e-5, 2.0
# D1's calls per forward at each (side, k) of the 1024^2 batch-2 forward:
# every ASPP runs k = 1 twice (aspp1 and aspp_deforms_0), k = 3 and 7 once;
# the squeeze block and decoder_block4 both run at 32^2.
DEFORM_SITES = [(side, k, (2 if k == 1 else 1) * (2 if side == 32 else 1))
                for side in (32, 64, 128, 256) for k in (1, 3, 7)]
# Phase 8 (training). D1b against autograd through D1's plain version at
# the 20 deformable sites' inputs of the offset-scaled Swin-L forward, f32:
# each gradient within D1B_BOUND x max|plain|, mean ratio within D1B_MEAN,
# the f32 tier's mean bound (tests/test_torch_cuda.py holds the same): the
# sums run in another order (grad_x by atomic adds, the offsets' and the
# masks' over the channels in a tree), and the offsets' gradients are
# differences of corner terms; a first bound of 1e-6 read 1.14e-6 on
# grad_offset at the first site. (dx, dy) read for (dy, dx) must break
# the max bound. The whole model's gradients through D1/D1b against the
# plain route (autograd through the plain columns), TF32 off: every leaf
# within GRAD_LEAF_BOUND x its max |plain grad|, the relative L2 of all
# within GRAD_L2_BOUND (the CPU tests hold the port to JAX's gradients
# with the same two bounds); regular mode must break the offset-conv
# leaves' bound. TRAIN_STEPS steps of finetune.main at SIZE, batch BATCH.
D1B_BOUND, D1B_MEAN = 1e-5, 1e-5
GRAD_LEAF_BOUND, GRAD_L2_BOUND = 1e-3, 1e-4
GRAD_SIZE, TRAIN_STEPS = 256, 3
# Phase 9 (entry points). The images serve.main and cli.main read, (height,
# width), PNG at even indices and JPEG at odd ones; evaluate.main scores
# the masks of those of at most ENTRY_EVAL_PIXELS (its E-measure loops 256
# thresholds over every pixel: about 13 s a 1440x1080 mask on one core).
ENTRY_SIZES = [(1080, 1440), (1440, 1080), (1024, 1024), (720, 1280),
               (480, 640), (300, 400), (1500, 900), (256, 320)] * 2
ENTRY_EVAL_PIXELS = 300 * 400
ENTRY_RUNS = 3
# Launches per call captured in serve.main's graph, by its flags (the
# default: bf16, deformable; the main path's), and in cli.main's (f32,
# deformable).
K1, K1Q = ("fused_block_attn.fused_window_block_attention",
           "fused_block_attn.fused_window_block_attention_int8")
K2, K3 = "fused_mlp.fused_mlp_residual", "fused_mlp.fused_mlp_residual_int8"
K4, K5, D1 = ("row_ln.layer_norm_rows", "tap_conv.tap_conv_same",
              "deform_im2col.deform_im2col")
SERVE_FLAGS = {
    "serve.main default": ([], {K1: 48, K2: 48, K4: 16, K5: 1, D1: 20}),
    "serve.main main path": (["--int8-mlp", "--int8-attn", "--deform-mode",
                              "regular"],
                             {K1: 8, K1Q: 40, K2: 8, K3: 40, K4: 16, K5: 1}),
}
CLI_LAUNCHES = {K1: 48, K2: 48, K4: 16, D1: 20}
# Calls of each shape in phase 3's repeat check (the f32 shapes: fewer).
REPEATS, REPEATS_F32 = 200, 100
# Published H100 SXM peaks (dense): memory bytes/s and operations/s by type.
MEM_RATE = 3.35e12
# Dense peaks of the H100 SXM; "tf32" is the tensor cores' TF32 rate, on
# which the f32 GEMM and core run three TF32 products per f32 one.
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 494.7e12}


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def tf32(torch, t):
    """f32 t rounded to TF32 (10 mantissa bits, to nearest even), as the
    tensor cores take f32 operands under TF32."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & -8192).view(torch.float32)


@contextlib.contextmanager
def tf32_on(torch):
    """Both of PyTorch's TF32 flags on inside, their values back after."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = True
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


class KernelReport:
    """Per-kernel max and mean error, and per model's forward (sum over
    shapes of the calls per forward times the per-call value): kernel,
    plain and library time, and the bound."""

    def __init__(self, name, route, source, replaces, wrapper, main_path,
                 mean_bound=None, bitwise=False, max_bound=BOUND):
        self.wrapper = wrapper
        self.main_path = main_path
        self.mean_bound = mean_bound
        self.bitwise = bitwise
        self.max_bound = max_bound
        self.entry = {"name": name, "route": route, "source": source,
                      "replaces": replaces, "launches": None,
                      "launches_by_path": {}, "max_abs_err": 0.0,
                      "mean_rel_err": 0.0, "ms": None, "plain_ms": None,
                      "bound_ms": None, "bound_by": None, "library_ms": None,
                      "by_model": {}}
        self.sums = {}

    def check(self, torch, model, label, calls, kernel_fn, plain_fn, work,
              crop=None, library_fn=None, control_fn=None):
        """work = (bytes moved, {type: operations}) of one call. control_fn,
        the plain version on operands rounded to TF32, run with TF32 on,
        must break the mean bound. Returns the kernel's time in ms."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if crop is not None:
            got, want = crop(got), crop(want)
        if self.bitwise and not torch.equal(got, want):
            fail(f"{self.entry['name']} {label}: not bitwise equal to its "
                 f"plain version")
        got, want = got.float(), want.float()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{self.entry['name']} {label}: shape {tuple(got.shape)} vs "
                 f"{tuple(want.shape)} or non-finite output")
        err = float((got - want).abs().max())
        bound = self.max_bound * float(want.abs().max())
        mean_rel = float((got - want).abs().mean() / want.abs().mean())
        del want
        if control_fn is not None:
            with tf32_on(torch):
                ctl = control_fn()
            if crop is not None:
                ctl = crop(ctl)
            ctl = ctl.float()
            ctl_rel = float((got - ctl).abs().mean() / ctl.abs().mean())
            del ctl
            log(f"{self.entry['name']:<21} {model} {label:<34} control: plain "
                f"in TF32, mean|k-p|/mean|p| {ctl_rel:.3e} (must exceed "
                f"{self.mean_bound})")
            if not ctl_rel > self.mean_bound:
                fail(f"{self.entry['name']} {label}: the plain version in "
                     f"TF32 is within the mean bound ({ctl_rel})")
            e = self.entry
            e["tf32_control_min"] = min(e.get("tf32_control_min", ctl_rel),
                                        ctl_rel)
        del got
        ms, plain_ms = cuda_ms(torch, kernel_fn), cuda_ms(torch, plain_fn)
        byte_ms = work[0] / MEM_RATE * 1e3
        op_ms = sum(n / PEAK[kind] for kind, n in work[1].items()) * 1e3
        lib_ms = cuda_ms(torch, library_fn) if library_fn is not None else None
        lib = "" if lib_ms is None else f"  library {lib_ms:.4f} ms"
        log(f"{self.entry['name']:<21} {model} {label:<34} max|k-p| {err:.3e} "
            f"(bound {bound:.3e})  mean|k-p|/mean|p| {mean_rel:.3e}  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms{lib}  least "
            f"{max(byte_ms, op_ms):.4f} ms  x{calls}/forward")
        if not err <= bound:
            fail(f"{self.entry['name']} {label}: max|k-p| {err} > {bound}")
        if self.mean_bound is not None and not mean_rel <= self.mean_bound:
            fail(f"{self.entry['name']} {label}: mean|k-p|/mean|p| {mean_rel} "
                 f"> {self.mean_bound}")
        e = self.entry
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["mean_rel_err"] = max(e["mean_rel_err"], mean_rel)
        m = self.sums.setdefault(model, {"ms": 0.0, "plain_ms": 0.0,
                                         "bound_ms": 0.0, "library_ms": None,
                                         "bytes_ms": 0.0, "ops_ms": 0.0})
        m["ms"] += calls * ms
        m["plain_ms"] += calls * plain_ms
        m["bound_ms"] += calls * max(byte_ms, op_ms)
        m["bytes_ms"] += calls * byte_ms
        m["ops_ms"] += calls * op_ms
        if lib_ms is not None:
            m["library_ms"] = (m["library_ms"] or 0.0) + calls * lib_ms
        return ms

    def by_model(self):
        """The per-forward sums of each model, with what bounds them."""
        for model, m in self.sums.items():
            if "bytes_ms" in m:
                m["bound_by"] = ("bytes" if m.pop("bytes_ms") >= m.pop("ops_ms")
                                 else "operations")
            self.entry["by_model"][model] = m
        return self.entry["by_model"]

    def finish(self, main_model):
        """Fill the report's times from its main model's sums."""
        e = self.entry
        m = self.by_model()[main_model]
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by"):
            e[key] = m[key]
        e["launches"] = e["launches_by_path"][self.main_path]


def make_reports():
    from birefnet_tpu_torch.ops.kernels import (flash_window_attn,
                                                fused_block_attn, fused_mlp,
                                                row_ln, tap_conv)
    csrc, pallas = "birefnet_tpu_torch/csrc/", "birefnet_tpu/ops/pallas/"
    fwa = csrc + "flash_window_attn.cu"
    rows = [
        ("fused_block_attn", "cuda", csrc + "fused_block_attn.cu",
         pallas + "fused_block_attn.py:250",
         fused_block_attn.fused_window_block_attention, "swin_l int8", None),
        ("fused_block_attn_int8", "cuda", csrc + "fused_block_attn.cu",
         pallas + "fused_block_attn.py:100",
         fused_block_attn.fused_window_block_attention_int8, "swin_l int8",
         MEAN_BOUND_K1_I8),
        ("fused_mlp", "cuda", csrc + "fused_mlp.cu",
         pallas + "fused_mlp.py:166", fused_mlp.fused_mlp_residual,
         "swin_l int8", None),
        ("fused_mlp_int8", "cuda", csrc + "fused_mlp_i8.cu",
         pallas + "fused_mlp.py:186", fused_mlp.fused_mlp_residual_int8,
         "swin_l int8", MEAN_BOUND_K3),
        ("row_ln", "cuda", csrc + "row_ln.cu", pallas + "row_ln.py:43",
         row_ln.layer_norm_rows, "swin_l int8", None),
        ("tap_conv", "cuda", csrc + "tap_conv.cu", pallas + "tap_conv.py:55",
         tap_conv.tap_conv_same, "swin_l int8", None),
        ("flash_window_attn_qkv", "cuda", fwa,
         pallas + "flash_window_attn.py:163",
         flash_window_attn.flash_window_attention_qkv, "swin_t bf16",
         MEAN_BOUND_FWA),
        ("flash_window_attn_masked", "cuda", fwa,
         pallas + "flash_window_attn.py:91",
         flash_window_attn.flash_window_attention, "swin_t bf16",
         MEAN_BOUND_FWA),
        ("flash_window_attn_plain", "cuda", fwa,
         pallas + "flash_window_attn.py:119", flash_window_attn.flash_attention,
         "swin_t bf16", MEAN_BOUND_FWA),
    ]
    reports = {r[0]: KernelReport(*r) for r in rows}
    reports["deform_im2col"] = make_deform_report("swin_l int8 deformable")
    return reports


def make_deform_report(main_path, suffix=""):
    """D1, bitwise against its plain version. It has no Pallas original:
    `replaces` names the JAX function whose XLA gather it ports."""
    from birefnet_tpu_torch.ops.kernels import deform_im2col
    r = KernelReport(
        "deform_im2col" + suffix, "cuda",
        "birefnet_tpu_torch/csrc/deform_im2col.cu",
        "birefnet_tpu/ops/deform_conv.py:35", deform_im2col.deform_im2col,
        main_path, bitwise=True)
    r.entry["note"] = ("no TPU kernel: the JAX package samples with an XLA "
                       "gather and einsum (deform_conv.py:68-139)")
    r.entry["library"] = "none: no one PyTorch call computes the columns"
    return r


def make_f32_reports():
    """The f32 tier's entries: K1, K2, K4 and K6-K8 on f32 activations
    (main paths "swin_l f32" and "swin_t f32"; K7/K8 at the JAX test
    shapes), and the 3xTF32 f32 GEMM, f32 row pass and f32 core alone, whose
    sums go under the f32 K1's and K2's entries; then the W8A8 kernels' f32
    branches, K1-int8 and K3 on f32 activations (main path "swin_l f32
    int8", the int8 bounds), with the int8 GEMM's f32 epilogues and K3's
    cluster kernel alone from codes (bitwise), whose sums go under them."""
    from birefnet_tpu_torch.ops.kernels import (f32_gemm, flash_window_attn,
                                                fused_block_attn, fused_mlp,
                                                int8_gemm, row_ln)
    csrc, pallas = "birefnet_tpu_torch/csrc/", "birefnet_tpu/ops/pallas/"
    fwa = csrc + "flash_window_attn.cu"
    rows = [
        ("fused_block_attn_f32", csrc + "fused_block_attn.cu",
         pallas + "fused_block_attn.py:250",
         fused_block_attn.fused_window_block_attention, "swin_l f32"),
        ("fused_mlp_f32", csrc + "fused_mlp.cu", pallas + "fused_mlp.py:166",
         fused_mlp.fused_mlp_residual, "swin_l f32"),
        ("row_ln_f32", csrc + "row_ln.cu", pallas + "row_ln.py:43",
         row_ln.layer_norm_rows, "swin_l f32"),
        ("flash_window_attn_qkv_f32", fwa, pallas + "flash_window_attn.py:163",
         flash_window_attn.flash_window_attention_qkv, "swin_t f32"),
        ("flash_window_attn_masked_f32", fwa, pallas + "flash_window_attn.py:91",
         flash_window_attn.flash_window_attention, "swin_t f32"),
        ("flash_window_attn_plain_f32", fwa,
         pallas + "flash_window_attn.py:119", flash_window_attn.flash_attention,
         "swin_t f32"),
        ("f32_gemm", csrc + "f32_gemm.cu", pallas + "fused_mlp.py:166",
         f32_gemm.f32_gemm, None),
        ("ln_rows_f32", csrc + "row_ln.cu", pallas + "fused_mlp.py:166",
         f32_gemm.ln_rows_f32, None),
        ("window_core_f32", csrc + "window_core_f32.cuh",
         pallas + "fused_block_attn.py:250",
         flash_window_attn.flash_window_attention, None),
    ]
    reports = {name: KernelReport(name, "cuda", src, rep, fn, path,
                                  MEAN_BOUND_F32, max_bound=BOUND_F32)
               for name, src, rep, fn, path in rows}
    for name, src, rep, fn, path, mean_bound, bitwise in (
            ("fused_block_attn_int8_f32", csrc + "fused_block_attn.cu",
             pallas + "fused_block_attn.py:100",
             fused_block_attn.fused_window_block_attention_int8,
             "swin_l f32 int8", MEAN_BOUND_K1_I8, False),
            ("fused_mlp_int8_f32", csrc + "fused_mlp_i8.cu",
             pallas + "fused_mlp.py:186", fused_mlp.fused_mlp_residual_int8,
             "swin_l f32 int8", MEAN_BOUND_K3, False),
            ("int8_gemm_f32", csrc + "int8_gemm.cu",
             pallas + "fused_block_attn.py:208", int8_gemm.int8_gemm, None,
             None, True),
            ("fused_mlp_int8_cluster_f32", csrc + "fused_mlp_i8.cu",
             pallas + "fused_mlp.py:186",
             fused_mlp.fused_mlp_residual_int8_codes, None, None, True)):
        reports[name] = KernelReport(name, "cuda", src, rep, fn, path,
                                     mean_bound, bitwise)
    reports["deform_im2col_f32"] = make_deform_report("swin_l f32 deformable",
                                                      "_f32")
    return reports


def make_core_report():
    """The window-attention core alone (csrc/window_core.cuh) at the Swin-L
    stage shapes, reported under K1's entry as "core"."""
    from birefnet_tpu_torch.ops.kernels import flash_window_attn
    return KernelReport(
        "window_core", "cuda", "birefnet_tpu_torch/csrc/window_core.cuh",
        "birefnet_tpu/ops/pallas/fused_block_attn.py:250",
        flash_window_attn.flash_window_attention, None, MEAN_BOUND_FWA)


def make_gemm_report():
    """The int8 GEMM of csrc/int8_gemm.cu alone at K1-int8's eight Swin-L
    shapes, reported under K1-int8's entry as "int8_gemm"; held bit for bit
    to its plain version."""
    from birefnet_tpu_torch.ops.kernels import int8_gemm
    return KernelReport(
        "int8_gemm", "cuda", "birefnet_tpu_torch/csrc/int8_gemm.cu",
        "birefnet_tpu/ops/pallas/fused_block_attn.py:208",
        int8_gemm.int8_gemm, None, None, bitwise=True)


def make_cluster_report():
    """K3's cluster kernel alone (csrc/fused_mlp_i8.cu from the row pass's
    LN2 codes) at K3's shapes, reported under K3's entry as "cluster"; held
    bit for bit to the plain chain from the same codes."""
    from birefnet_tpu_torch.ops.kernels import fused_mlp
    return KernelReport(
        "fused_mlp_int8_cluster", "cuda",
        "birefnet_tpu_torch/csrc/fused_mlp_i8.cu",
        "birefnet_tpu/ops/pallas/fused_mlp.py:186",
        fused_mlp.fused_mlp_residual_int8_codes, None, None, bitwise=True)


def make_bf16_reports():
    """The bf16 GEMM (csrc/bf16_gemm.cu) and the bf16 row pass
    (csrc/row_ln.cu) alone at K1's and K2's shapes (models "swin_l k1",
    "swin_l k2", "swin_t k2"), reported under K2's entry."""
    from birefnet_tpu_torch.ops.kernels import bf16_gemm
    csrc, pallas = "birefnet_tpu_torch/csrc/", "birefnet_tpu/ops/pallas/"
    return (KernelReport("bf16_gemm", "cuda", csrc + "bf16_gemm.cu",
                         pallas + "fused_mlp.py:166", bf16_gemm.bf16_gemm,
                         None, MEAN_BOUND_BF16),
            KernelReport("ln_rows", "cuda", csrc + "row_ln.cu",
                         pallas + "fused_mlp.py:166", bf16_gemm.ln_rows, None,
                         MEAN_BOUND_BF16))


def int_mm(torch, q, w):
    """torch._int_mm(q, w^T), the library yardstick of the int8 GEMM (the s32
    product only, without the dequant epilogue), or None where this PyTorch
    refuses the operands."""
    try:
        torch._int_mm(q, w.t())
    except RuntimeError as e:
        log(f"torch._int_mm refused [{q.shape[0]},{q.shape[1]}] x "
            f"[{w.shape[1]},{w.shape[0]}]: {str(e).splitlines()[0]}")
        return None
    return partial(torch._int_mm, q, w.t())


def repeat_check(torch, calls, reps=REPEATS):
    """Launch each (label, fn, want) `reps` times back to back, synchronize
    once, and hold the last output bitwise to `want`: an intermittent fault
    (a lost barrier phase, a race) shows as an error or a wrong output."""
    t0 = time.perf_counter()
    for label, fn, want in calls:
        for _ in range(reps):
            got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"repeat check {label}: call {reps} differs from the first "
                 f"(or plain) output")
    log(f"phase 3: repeat check: {len(calls)} shapes x {reps} calls each, "
        f"outputs bitwise as expected ({time.perf_counter() - t0:.1f} s)")


def check_kernels(torch, dev, reports, core, gemm, gemm16, rows16, cluster,
                  extra, f32r):
    """Phase 3. `extra` collects K3's torch._int_mm sums per model and the
    LN code-flip counts; `f32r` holds the f32 tier's reports. Runs with
    PyTorch's TF32 flags off (the plain versions' f32 products in full f32),
    except the TF32 controls."""
    import torch.nn.functional as F

    from birefnet_tpu_torch import params as P
    from birefnet_tpu_torch.models import swin
    from birefnet_tpu_torch.ops import window as W
    from birefnet_tpu_torch.ops.kernels import (bf16_gemm, deform_im2col,
                                                f32_gemm, flash_window_attn,
                                                fused_block_attn, fused_mlp,
                                                int8_gemm, row_ln, tap_conv)
    from birefnet_tpu_torch.ops.kernels import tf32 as tf32_split

    gen = torch.Generator(dev).manual_seed(0)
    repeats = []  # (label, fn, expected output) for the repeat check
    repeats_f32 = []  # the same for the f32 GEMM, core and K1 shapes
    bf = torch.bfloat16

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def ln_params(c):
        return {"scale": 1 + 0.1 * randn((c,)), "bias": 0.1 * randn((c,))}

    def lin(i, o):
        return {"weight": randn((o, i), 0.05), "bias": 0.1 * randn((o,))}

    def sdpa(q, k, v, bias, mask):
        """The library yardstick of K6-K8: one SDPA call on q, k, v
        [B_, heads, N, d], with the bias (rounded as the kernel takes it:
        to bf16 for bf16 q) and mask[w % nW] prebuilt here as one additive
        [B_, heads, N, N] tensor of q's dtype, outside the timed calls."""
        b_, heads, n, _ = q.shape
        addend = (bias.to(bf) if q.dtype == bf else bias).float()[None]
        if mask is not None:
            addend = addend + mask.repeat(b_ // mask.shape[0], 1, 1)[:, None]
        return partial(F.scaled_dot_product_attention, q, k, v,
                       attn_mask=addend.expand(b_, heads, n, n).to(q.dtype)
                       .contiguous())

    f32 = torch.float32
    k5 = reports["tap_conv"]
    # Each dtype's reports, repeat list, operation type and kernel entries:
    # the bf16 kernels, and the f32 tier's f32 branches of the same ones.
    by_dtype = {
        bf: dict(k1=reports["fused_block_attn"], k2=reports["fused_mlp"],
                 k4=reports["row_ln"], k6=reports["flash_window_attn_qkv"],
                 k7=reports["flash_window_attn_masked"],
                 k8=reports["flash_window_attn_plain"], core=core,
                 gemm=gemm16, rows=rows16, repeats=repeats, kind="bf16",
                 mm=lambda ops: {"bf16": ops}, mm_peak=PEAK["bf16"],
                 gemm_fns=(bf16_gemm.bf16_gemm, bf16_gemm.bf16_gemm_plain),
                 rows_fns=(bf16_gemm.ln_rows, bf16_gemm.ln_rows_plain),
                 k1q=reports["fused_block_attn_int8"],
                 k3=reports["fused_mlp_int8"], gemm8=gemm, cluster=cluster,
                 store="bf16", int_mm=extra["int_mm_ms"],
                 d1=reports["deform_im2col"]),
        f32: dict(k1=f32r["fused_block_attn_f32"], k2=f32r["fused_mlp_f32"],
                  k4=f32r["row_ln_f32"], k6=f32r["flash_window_attn_qkv_f32"],
                  k7=f32r["flash_window_attn_masked_f32"],
                  k8=f32r["flash_window_attn_plain_f32"],
                  core=f32r["window_core_f32"], gemm=f32r["f32_gemm"],
                  rows=f32r["ln_rows_f32"], repeats=repeats_f32, kind="f32",
                  mm=lambda ops: {"tf32": 3 * ops}, mm_peak=PEAK["tf32"] / 3,
                  gemm_fns=(f32_gemm.f32_gemm, f32_gemm.f32_gemm_plain),
                  rows_fns=(f32_gemm.ln_rows_f32, f32_gemm.ln_rows_f32_plain),
                  k1q=f32r["fused_block_attn_int8_f32"],
                  k3=f32r["fused_mlp_int8_f32"], gemm8=f32r["int8_gemm_f32"],
                  cluster=f32r["fused_mlp_int8_cluster_f32"], store="f32",
                  int_mm=extra["int_mm_ms_f32"], d1=f32r["deform_im2col_f32"]),
    }

    def kernel_tree(tree, dtype):
        """The tree as make_infer_fn prepares it for `dtype`'s kernel tier:
        the weights cast to the dtype, and in f32 the f32 GEMM's weights
        split into their TF32 parts once (not per timed call)."""
        tree = P.cast_matmul_weights(tree, dtype)
        return P.split_tf32_weights(tree) if dtype == f32 else tree

    def tf32_control(plain, dtype, operands, *rest):
        """For f32, the plain version in TF32: its `operands` rounded to
        TF32 (the check runs it with the TF32 flags on too); None for
        bf16."""
        if dtype == bf:
            return None
        return partial(plain, *(tf32(torch, t) for t in operands), *rest)

    def affine_of(x, ln):
        """F.layer_norm's affine beside x: the kernel's f32 one, unless x is
        bf16 and PyTorch takes only a bf16 affine beside it."""
        if x.dtype == bf and not ln_f32_affine:
            return {k: v.to(bf) for k, v in ln.items()}
        return ln

    def check_k1(model, label, depth, x, h, c, heads, ws, hp):
        """K1 in x's dtype at one Swin-L stage, unshifted and shifted, with
        its LN1 row pass alone on each canvas; at C >= 768 also K1-int8 in
        x's dtype and its LN1 code flips (in f32 with the bf16-rounding
        control)."""
        r = by_dtype[x.dtype]
        norm1 = ln_params(c)
        attn32 = {"qkv": lin(c, 3 * c), "proj": lin(c, c),
                  "cached_bias": randn((heads, ws * ws, ws * ws))}
        attn = kernel_tree({"attn": attn32}, x.dtype)["attn"]
        int8 = c >= P.INT8_MLP_MIN_CHANNELS
        if int8:
            attn_q = P.cast_matmul_weights(
                P.quantize_attn_int8({"attn": attn32}, 0)["attn"], x.dtype)
        # The mask as the model passes it: region ids, cached per geometry.
        cyclic_mask = W.sw_msa_region_ids(hp, hp, ws, ws // 2, dev)
        for shift in (0, ws // 2):
            canvas, k_shift, mask, origin = swin.fused_block_canvas(
                x, ws, shift, cyclic_mask)
            route = ("offset" if origin else "roll") if shift else "unshifted"
            # Operations the function needs: qkv and proj (8 C^2) and
            # q k^T and P v over the window's ws^2 keys (4 ws^2 C) for
            # each real token. A pad token's normed row is zero, so its
            # k and v are the qkv bias and need no product, and its
            # output is cropped. Bytes stay those of the whole canvas.
            t = BATCH * h * h
            core_ops = 4 * ws * ws * c * t
            side = nbytes(canvas, norm1["scale"], norm1["bias"],
                          attn["cached_bias"], mask) + nbytes(canvas)

            def crop(y, k_shift=k_shift, origin=origin):
                if k_shift:
                    y = W.roll_2d(y, k_shift, k_shift)
                return y[:, origin:origin + h, origin:origin + h]

            # K1's LN1 row pass on this canvas, pads zeroed.
            check_ln_rows(f"{model} k1", f"{label} {route}", depth // 2,
                          canvas.reshape(-1, c), norm1,
                          (hp, hp, k_shift, origin, h, h))
            runs = [(r["k1"], attn,
                     fused_block_attn.fused_window_block_attention,
                     fused_block_attn.fused_window_block_attention_plain,
                     (attn["qkv"]["weight"], attn["qkv"]["bias"],
                      attn["proj"]["weight"], attn["proj"]["bias"]),
                     r["mm"](8 * c * c * t + core_ops))]
            if int8:
                # K1-int8's LN1 codes against the plain model's.
                count_flips(r["k1q"].entry["name"], f"{label} {route}",
                            canvas.reshape(-1, c), norm1,
                            (hp, hp, k_shift, origin, h, h))
                runs.append(
                    (r["k1q"], attn_q,
                     fused_block_attn.fused_window_block_attention_int8,
                     fused_block_attn.fused_window_block_attention_int8_plain,
                     tuple(attn_q[n][k] for n in ("qkv", "proj")
                           for k in ("weight_q8", "scale_q8", "bias")),
                     {"int8": 8 * c * c * t, **r["mm"](core_ops)}))
            for rep, p, kernel, plain, weights, ops in runs:
                args = (canvas, norm1, p, ws, k_shift, heads, mask, h, h,
                        origin)
                fn = partial(kernel, *args)
                rep.check(torch, model, f"{label} {route}", depth // 2, fn,
                          partial(plain, *args),
                          (side + nbytes(*weights), ops), crop)
                if rep is r["k1q"] or not shift:  # K1: one call per stage
                    r["repeats"].append(
                        (f"{rep.entry['name']} {label} {route}", fn, fn()))

    def check_k6(label, depth, h, c, heads, hp, dtype):
        """K6 in `dtype` at one swin_t stage: B_ = BATCH * (hp / 7)^2
        windows of the packed projection, unmasked and masked blocks."""
        r = by_dtype[dtype]
        b_, d = BATCH * (hp // 7) ** 2, c // heads
        qkv = randn((b_, 49, 3 * c), 1.0, dtype)
        bias = randn((heads, 49, 49))
        # The library call's operands, prebuilt outside its time: q, k, v
        # as contiguous [B_, heads, N, d] and the additive bias + mask.
        q, k, v = qkv.view(b_, 49, 3, heads, d).permute(
            2, 0, 3, 1, 4).contiguous()
        plain = flash_window_attn.flash_window_attention_qkv_plain
        for mask in (None, W.sw_msa_region_ids(hp, hp, 7, 3, dev)):
            args = (qkv, bias, mask, heads)
            fn = partial(flash_window_attn.flash_window_attention_qkv, *args)
            # Queries of real tokens only (2 h^2 of them); every window
            # token counts as a key and value, and in the bytes.
            r["k6"].check(
                torch, "swin_t",
                f"{label} B_={b_} C={c}{'' if mask is None else ' masked'}",
                depth // 2, fn, partial(plain, *args),
                (nbytes(qkv, bias, mask) + b_ * 49 * c * qkv.element_size(),
                 r["mm"](4 * 49 * c * BATCH * h * h)),
                library_fn=sdpa(q, k, v, bias, W.dense_mask(mask)),
                control_fn=tf32_control(plain, dtype, (qkv,), bias, mask,
                                        heads))
            r["repeats"].append((f"K6 {r['kind']} {label} C={c} "
                                 f"mask={mask is not None}", fn, fn()))

    def check_core(label, depth, c, heads, hp, dtype):
        """The attention core alone in `dtype` at one Swin-L stage, through
        flash_window_attention on [B_, heads, 144, 32] views of a packed
        [B_, 144, 3C] projection (the rows K1 reads): unmasked and with the
        offset mask's region ids, depth / 2 calls of each per forward."""
        r = by_dtype[dtype]
        b_ = BATCH * (hp // 12) ** 2
        qkv = randn((b_, 144, 3 * c), 1.0, dtype)
        q, k, v = qkv.view(b_, 144, 3, heads, 32).permute(2, 0, 3, 1, 4)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        bias = randn((heads, 144, 144))
        plain = flash_window_attn.flash_window_attention_plain
        for mask in (None, W.sw_msa_region_ids(hp, hp, 12, 6, dev,
                                               offset=True)):
            args = (q, k, v, bias, mask)
            fn = partial(flash_window_attn.flash_window_attention, *args)
            r["core"].check(
                torch, "swin_l", f"{label} B_={b_} heads={heads}"
                f"{'' if mask is None else ' offset mask'}", depth // 2, fn,
                partial(plain, *args),
                (nbytes(qkv, bias, mask) + b_ * 144 * c * qkv.element_size(),
                 r["mm"](4 * 144 * 144 * c * b_)),
                library_fn=sdpa(qc, kc, vc, bias, W.dense_mask(mask)),
                control_fn=tf32_control(plain, dtype, (q, k, v), bias, mask))
            r["repeats"].append((f"core {r['kind']} {label} "
                                 f"mask={mask is not None}", fn, fn()))

    def check_gemm(label, depth, m, n, k, epilogue, model, dtype):
        """The int8 GEMM alone at one shape with the epilogues of `dtype`'s
        K1-int8 ("bf16" or "f32" stores, "residual" with a res of the
        dtype), bitwise against its plain version and timed against
        torch._int_mm; then kept for the repeat check."""
        r = by_dtype[dtype]
        gen_q = torch.Generator(dev).manual_seed(m + n + k)
        q = torch.randint(-127, 128, (m, k), generator=gen_q, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen_q, device=dev,
                          dtype=torch.int8)
        sx = (0.5 + torch.rand((m, 1), generator=gen_q, device=dev)) / 127
        sw = (0.5 + torch.rand((n,), generator=gen_q, device=dev)) / (
            127 * k ** 0.5)
        lin = {"weight_q8": w, "scale_q8": sw, "bias": randn((n,), 0.5)}
        res = randn((m, n), 1.0, dtype) if epilogue == "residual" else None
        args = (q, sx, lin, epilogue, res)
        out = m * n * torch.empty((), dtype=dtype).element_size()
        name = r["gemm8"].entry["name"]
        ms = r["gemm8"].check(
            torch, model, f"{label} {epilogue} [{m},{k}]x[{n},{k}]", depth,
            partial(int8_gemm.int8_gemm, *args),
            partial(int8_gemm.int8_gemm_plain, *args),
            (nbytes(q, sx, w, sw, lin["bias"], res) + out,
             {"int8": 2 * m * n * k}),
            library_fn=int_mm(torch, q, w))
        log(f"{name:<21} {model} {label} {epilogue}: "
            f"{2 * m * n * k / ms / 1e9:.1f} TOP/s "
            f"({2 * m * n * k / ms / 1e9 / PEAK['int8'] * 1e12:.3f} of peak)")
        r["repeats"].append((f"{name} {label} {epilogue}",
                             partial(int8_gemm.int8_gemm, *args),
                             int8_gemm.int8_gemm_plain(*args)))

    def check_float_gemm(model, label, calls, m, n, k, epilogue, dtype):
        """The bf16 or f32 GEMM alone at one shape against its plain
        version, timed against F.linear on the same operands; then kept for
        the repeat check."""
        r = by_dtype[dtype]
        kernel, plain = r["gemm_fns"]
        a = randn((m, k), 1.0, dtype)
        lin = {"weight": randn((n, k), k ** -0.5, dtype),
               "bias": randn((n,), 0.5)}
        if dtype == f32:  # the weight's TF32 parts, split once as in a forward
            lin["weight_tf32"] = tf32_split.split_weight(lin["weight"])
        res = randn((m, n), 1.0, dtype) if epilogue == "residual" else None
        args = (a, lin, epilogue, res)
        ops = 2 * m * n * k
        ms = r["gemm"].check(
            torch, model, f"{label} {epilogue} [{m},{k}]x[{n},{k}]", calls,
            partial(kernel, *args), partial(plain, *args),
            (nbytes(a, lin["weight"], lin["bias"], res) + m * n * a.element_size(),
             r["mm"](ops)),
            library_fn=partial(F.linear, a, lin["weight"],
                               lin["bias"].to(dtype)),
            control_fn=tf32_control(plain, dtype, (a,), dict(
                lin, weight=tf32(torch, lin["weight"])), epilogue, res))
        rate = ops / ms * 1e3
        name = r["gemm"].entry["name"]
        log(f"{name:<21} {model} {label} {epilogue}: "
            f"{rate / 1e12:.1f} TFLOP/s ({rate / r['mm_peak']:.3f} of peak)")
        fn = partial(kernel, *args)
        r["repeats"].append((f"{name} {model} {label} {epilogue}", fn, fn()))

    def check_ln_rows(model, label, calls, x, ln, canvas=None):
        """The bf16 or f32 row pass alone on rows x [T, C] (a canvas's, with
        its pads zeroed, or K2's), timed against F.layer_norm (no pads)."""
        r = by_dtype[x.dtype]
        kernel, plain = r["rows_fns"]
        t, cc = x.shape
        affine = affine_of(x, ln)
        r["rows"].check(torch, model, f"{label} [{t},{cc}]", calls,
                        partial(kernel, x, ln, canvas),
                        partial(plain, x, ln, canvas),
                        (2 * nbytes(x) + nbytes(ln["scale"], ln["bias"]),
                         {"f32": 8 * t * cc}),
                        library_fn=partial(F.layer_norm, x, (cc,),
                                           affine["scale"], affine["bias"],
                                           1e-5))
    def count_flips(name, label, x, ln, canvas=None):
        """The int8 row pass's LN codes against the plain model's: codes
        that differ and the largest step (at most 1). On an f32 canvas
        also the control: the same codes against a plain model that rounds
        the LN1 rows to bf16 (what the f32 row pass must not do) must
        differ in more than FLIP_CONTROL of them, and the real flips stay
        below that."""
        flips, worst, n = int8_gemm.ln_code_flips(x, ln, canvas)
        log(f"{name:<21} {label}: LN codes vs plain model {flips} of {n} "
            f"differ, by at most {worst}")
        if worst > 1:
            fail(f"{name} {label}: an LN code differs by {worst} > 1 step")
        tally = extra["ln_code_flips"].setdefault(
            name, {"flipped": 0, "codes": 0, "max_step": 0})
        tally["flipped"] += flips
        tally["codes"] += n
        tally["max_step"] = max(tally["max_step"], worst)
        if x.dtype == f32 and canvas is not None:
            ctl, _, _ = int8_gemm.ln_code_flips(x, ln, canvas, bf)
            log(f"{name:<21} {label}: control, plain LN1 rows rounded to "
                f"bf16: {ctl} of {n} codes differ (must exceed "
                f"{FLIP_CONTROL} of them; the real flips {flips} must not)")
            if not (ctl > FLIP_CONTROL * n >= flips):
                fail(f"{name} {label}: LN code flips {flips}, bf16-rounded "
                     f"control {ctl}, of {n}: the control does not stand "
                     f"apart")
            tally["bf16_control_flipped"] = (
                tally.get("bf16_control_flipped", 0) + ctl)

    def check_k3(model, label, depth, x2, norm2, mlp_q, side):
        """K3 in x2's dtype whole against its plain version; its cluster
        kernel alone from the row pass's codes, bitwise against the plain
        chain; the two products' torch._int_mm time; the LN2 code flips;
        the repeats."""
        r = by_dtype[x2.dtype]
        k3, cluster = r["k3"], r["cluster"]
        t, c = x2.shape
        weights = nbytes(*(mlp_q[n][k] for n in ("fc1", "fc2")
                           for k in ("weight_q8", "scale_q8", "bias")))
        work = (side + weights, {"int8": 16 * c * c * t})
        whole = partial(fused_mlp.fused_mlp_residual_int8, x2, norm2, mlp_q)
        k3.check(torch, model, f"{label} T={t} C={c}", depth, whole,
                 partial(fused_mlp.fused_mlp_residual_int8_plain, x2, norm2,
                         mlp_q), work)
        codes, scales = int8_gemm.quantize_rows(x2, norm2)
        args = (x2, codes, scales, mlp_q)
        alone = partial(fused_mlp.fused_mlp_residual_int8_codes, *args)
        cluster.check(torch, model, f"{label} T={t} C={c} from codes", depth,
                      alone,
                      partial(fused_mlp.fused_mlp_residual_int8_codes_plain,
                              *args),
                      (nbytes(codes, scales) + 2 * nbytes(x2) + weights,
                       work[1]))
        q1 = torch.randint(-127, 128, (t, c), generator=gen, device=dev,
                           dtype=torch.int8)
        q2 = torch.randint(-127, 128, (t, 4 * c), generator=gen, device=dev,
                           dtype=torch.int8)
        mms = [int_mm(torch, q1, mlp_q["fc1"]["weight_q8"]),
               int_mm(torch, q2, mlp_q["fc2"]["weight_q8"])]
        name = k3.entry["name"]
        if None not in mms:
            ms = cuda_ms(torch, lambda: [f() for f in mms])
            sums = r["int_mm"]
            sums[model] = sums.get(model, 0.0) + depth * ms
            log(f"{name:<21} {model} {label}: torch._int_mm of its two "
                f"products {ms:.4f} ms x{depth}/forward")
        count_flips(name, f"{model} {label} T={t} C={c}", x2, norm2)
        r["repeats"].append((f"{name} {model} {label}", whole, whole()))
        r["repeats"].append((f"{name} codes {model} {label}", alone,
                             fused_mlp.fused_mlp_residual_int8_codes_plain(
                                 *args)))

    def check_k2_k3_k4(model, label, i, depth, h, c, dtype):
        """K2 in `dtype` at one stage with its parts alone (LN2 rows, fc1
        with the GELU, fc2 with the residual), at C >= 768 also K3 in
        `dtype`, and K4 on `dtype` rows at the stage's row-LN sites."""
        r = by_dtype[dtype]
        x2 = randn((BATCH * h * h, c), 1.0, dtype)
        norm2 = ln_params(c)
        mlp32 = {"fc1": lin(c, 4 * c), "fc2": lin(4 * c, c)}
        mlp = kernel_tree({"mlp": mlp32}, dtype)["mlp"]
        t = x2.shape[0]
        # K2's parts alone: its LN2 rows, fc1 with the GELU, fc2 with the
        # residual.
        check_ln_rows(f"{model} k2", label, depth, x2, norm2)
        for n, k, epilogue in ((4 * c, c, "gelu"), (c, 4 * c, "residual")):
            check_float_gemm(f"{model} k2", label, depth, t, n, k, epilogue,
                             dtype)
        side = 2 * nbytes(x2) + nbytes(norm2["scale"], norm2["bias"])
        r["k2"].check(torch, model, f"{label} T={t} C={c}", depth,
                      partial(fused_mlp.fused_mlp_residual, x2, norm2, mlp),
                      partial(fused_mlp.fused_mlp_residual_plain, x2, norm2,
                              mlp),
                      (side + nbytes(*(mlp[n][k] for n in ("fc1", "fc2")
                                       for k in ("weight", "bias"))),
                       r["mm"](16 * c * c * t)))
        if c >= P.INT8_MLP_MIN_CHANNELS:
            # Every K3 site of the int8 paths: Swin-L's stages 2-3 and
            # swin_t's stage 3 (C = 768, T = 2048 and 512).
            mlp_q = P.cast_matmul_weights(
                P.quantize_mlp_int8({"mlp": mlp32}, 0)["mlp"], dtype)
            check_k3(model, label, depth, x2, norm2, mlp_q, side)
        # Row-LN sites: the stage-output norm, plus the patch-embed norm
        # before stage 0 and the patch-merge norm after stages 0-2.
        sites = [("stage norm", BATCH * h * h, c)]
        if i == 0:
            sites.append(("patch-embed norm", BATCH * h * h, c))
        if i < 3:
            sites.append(("patch-merge norm", BATCH * h * h // 4, 4 * c))
        for site, n, cc in sites:
            xr = randn((n, cc), 3.0, dtype)
            p = ln_params(cc)
            affine = affine_of(xr, p)
            r["k4"].check(torch, model, f"{label} {site} [{n},{cc}]", 1,
                          partial(row_ln.layer_norm_rows, p, xr),
                          partial(row_ln.layer_norm_rows_plain, p, xr),
                          (2 * nbytes(xr) + nbytes(p["scale"], p["bias"]),
                           {"f32": 8 * n * cc}),
                          library_fn=partial(F.layer_norm, xr, (cc,),
                                             affine["scale"], affine["bias"],
                                             1e-5))

    try:
        F.layer_norm(randn((4, 64), 1.0, bf), (64,), randn((64,)),
                     randn((64,)), 1e-5)
        ln_f32_affine = True
    except RuntimeError:
        ln_f32_affine = False
    log(f"phase 3: K4's library call F.layer_norm takes the "
        f"{'f32' if ln_f32_affine else 'bf16'} affine beside bf16 input")

    for model, (ws, stages) in MODELS.items():
        for pass_name, geometry in stages.items():
            for i, (h, c, heads, depth) in enumerate(geometry):
                hp = -(-h // ws) * ws
                label = f"{pass_name} st{i} Hp={hp}"
                for dtype in (bf, f32):
                    if model == "swin_l" and c >= P.INT8_MLP_MIN_CHANNELS:
                        # K1-int8's qkv and proj on the canvas, one of each
                        # per block, with the dtype's epilogues.
                        t_canvas = BATCH * hp * hp
                        for m, n, k, epilogue in (
                                (t_canvas, 3 * c, c, by_dtype[dtype]["store"]),
                                (t_canvas, c, c, "residual")):
                            check_gemm(label, depth, m, n, k, epilogue,
                                       "swin_l", dtype)
                    if model == "swin_l":
                        # K1's qkv and proj on the canvas, one of each per
                        # block.
                        for n, epilogue in ((3 * c, "store"), (c, "residual")):
                            check_float_gemm("swin_l k1", label, depth,
                                             BATCH * hp * hp, n, c, epilogue,
                                             dtype)
                        check_k1(model, f"{label} C={c}", depth,
                                 randn((BATCH, h, h, c), 1.0, dtype), h, c,
                                 heads, ws, hp)
                        check_core(label, depth, c, heads, hp, dtype)
                    else:
                        check_k6(label, depth, h, c, heads, hp, dtype)
                    check_k2_k3_k4(model, f"{pass_name} st{i}", i, depth, h,
                                   c, dtype)

    def check_api(key, label, b_, heads, n, d, nw, causal, dtype):
        """K7 or K8 at one JAX test shape in `dtype`."""
        r = by_dtype[dtype]
        q, k, v = (randn((b_, heads, n, d), 1.0, dtype) for _ in range(3))
        if causal is None:
            bias = randn((heads, n, n))
            mask = None if nw is None else torch.where(
                torch.rand((nw, n, n), generator=gen, device=dev) < 0.3,
                -100.0, 0.0)
            kernel = flash_window_attn.flash_window_attention
            plain = flash_window_attn.flash_window_attention_plain
            tail = (bias, mask)
        else:
            bias = flash_window_attn.causal_bias(q, causal)
            mask = None
            kernel = flash_window_attn.flash_attention
            plain = flash_window_attn.flash_attention_plain
            tail = (causal,)
        # flash_attention's kernel reads no bias (a causal flag or none).
        r[key].check(torch, "api", f"{label} ({b_},{heads},{n},{d})", 1,
                     partial(kernel, q, k, v, *tail),
                     partial(plain, q, k, v, *tail),
                     (nbytes(q, k, v, None if causal is not None else bias,
                             mask) + nbytes(q),
                      r["mm"](4 * n * n * d * b_ * heads)),
                     library_fn=sdpa(q, k, v, bias, mask),
                     control_fn=tf32_control(plain, dtype, (q, k, v), *tail))

    # K7 and K8 at the JAX package's test shapes (no forward calls them):
    # (B_, heads, N, d, nW or None); one call at each shape, in bf16 and in
    # f32 (the f32 causal addend is -1e9 unrounded).
    for key, label, b_, heads, n, d, nw, causal in (
            ("k7", "shifted mask", 36, 4, 144, 32, 9, None),
            ("k7", "mask period", 8, 2, 16, 8, 4, None),
            ("k8", "simple bias", 4, 2, 16, 8, None, None),
            ("k8", "flash_attention", 4, 2, 16, 8, None, False),
            ("k8", "flash_attention causal", 4, 2, 16, 8, None, True)):
        for dtype in (bf, f32):
            check_api(key, label, b_, heads, n, d, nw, causal, dtype)

    def check_deform(side, k, calls, dtype):
        """D1 in `dtype` at one ASPP site shape of the forward (C = 64),
        offsets of a few pixels and masks across (0, 2), bitwise against
        its plain version; then kept for the repeat check. Work: the
        columns written once, x, the offsets and the mask read once; 7 f32
        operations (4 products, 3 sums) per column value."""
        r = by_dtype[dtype]
        x = randn((BATCH, side, side, 64), 1.0, dtype)
        offset = randn((BATCH, side, side, 2 * k * k), 3.0)
        mask = (2 * torch.rand((BATCH, side, side, k * k), generator=gen,
                               device=dev)).to(dtype)
        args = (x, offset, mask, k, k, 1, k // 2)
        fn = partial(deform_im2col.deform_im2col, *args)
        n_cols = BATCH * side * side * k * k * 64
        r["d1"].check(torch, "swin_l", f"[{BATCH},{side},{side},64] k={k}",
                      calls, fn, partial(deform_im2col.deform_im2col_plain,
                                         *args),
                      (nbytes(x, offset, mask) + n_cols * x.element_size(),
                       {"f32": 7 * n_cols}))
        r["repeats"].append((f"D1 {r['kind']} {side}^2 k={k}", fn, fn()))

    for side, k, calls in DEFORM_SITES:
        for dtype in (bf, f32):
            check_deform(side, k, calls, dtype)

    xi = randn((BATCH, SIZE, SIZE, 3), 1.0, bf)
    kk, kb = randn((5, 5, 3, 1), 0.2), randn((1,))
    xc = xi.permute(0, 3, 1, 2)  # channels-last NCHW view
    wc, bc = kk[..., 0].permute(2, 0, 1)[None].to(bf), kb.to(bf)
    for model in MODELS:  # the same head call in both models
        k5.check(torch, model, f"[{BATCH},{SIZE},{SIZE},3]", 1,
                 lambda: tap_conv.tap_conv_same(xi, kk, kb),
                 lambda: tap_conv.tap_conv_same_plain(xi, kk, kb),
                 (nbytes(xi, kk, kb) + BATCH * SIZE * SIZE * 2,
                  {"f32": 2 * 75 * BATCH * SIZE * SIZE}),
                 library_fn=lambda: F.conv2d(xc, wc, bc, padding=2))
    # K5's device time alone (the profiler's kernel time per call), beside
    # its event time above, which also holds the launch path.
    import gpu_profile
    k5.entry["device_ms"] = gpu_profile.device_ms_per_call(
        lambda: tap_conv.tap_conv_same(xi, kk, kb), 20,
        lambda name: "tap_conv5_kernel" in name)
    m = k5.sums["swin_l"]
    log(f"phase 3: K5 tap_conv [{BATCH},{SIZE},{SIZE},3] per call: kernel "
        f"{m['ms']:.5f} ms by events, device {k5.entry['device_ms']:.5f} ms; "
        f"F.conv2d {m['library_ms']:.5f} ms; bound {m['bound_ms']:.5f} ms "
        f"(bytes {m['bytes_ms']:.5f}, f32 FMAs {m['ops_ms']:.5f})")

    # The kernel tier takes the rel-pos bias rounded to bf16 (as the JAX
    # kernels do): a bias B and bf16(B) give bitwise the same K1, K1-int8
    # and K6 outputs.
    c, heads = 768, 24
    x = randn((BATCH, 24, 24, c), 1.0, bf)
    norm1 = ln_params(c)
    attn32 = {"qkv": lin(c, 3 * c), "proj": lin(c, c)}
    trees = {"fused_block_attn": P.cast_matmul_weights(attn32, bf),
             "fused_block_attn_int8": P.cast_matmul_weights(
                 P.quantize_attn_int8({"attn": attn32}, 0)["attn"], bf)}
    qkv = randn((BATCH * 25, 49, 3 * 96), 1.0, bf)
    mask7 = W.sw_msa_mask(35, 35, 7, 3, dev)
    for name in (*trees, "flash_window_attn_qkv"):
        if name in trees:
            bias = randn((heads, 144, 144), 3.0)

            def run(b, tree=trees[name]):
                return fused_block_attn.fused_window_block_attention(
                    x, norm1, dict(tree, cached_bias=b), 12, 0, heads, None,
                    24, 24)
        else:
            bias = randn((3, 49, 49), 3.0)

            def run(b):
                return flash_window_attn.flash_window_attention_qkv(
                    qkv, b, mask7, 3)
        rounded = bias.to(bf).float()
        same = torch.equal(run(bias), run(rounded))
        log(f"{name}: bias B and bf16(B) give bitwise-equal outputs: {same}")
        if torch.equal(bias, rounded) or not same:
            fail(f"{name} does not take the rel-pos bias rounded to bf16")

    repeat_check(torch, repeats)
    repeat_check(torch, repeats_f32, REPEATS_F32)


def with_features(bmodel, infer, frames, sites=False):
    """infer(frames), and the backbone stage features of the last body run
    in that call (both passes), caught where models/birefnet.py calls
    swin_forward. A graphed function's first call runs its body twice, to
    warm it up and to capture it; the captured features are tensors of the
    graph, which hold the replay's values when the call returns and are
    overwritten by the next replay: they are copied out here. With
    `sites`, also the outputs of the last body run's 20 deformable sites
    (models/aspp.py::deform_conv_aspp_forward, in forward order), copied
    out the same way: returns (mask, features, sites)."""
    from birefnet_tpu_torch.models import aspp

    feats, swin_forward = [], bmodel.swin_forward
    outs, site_forward = [], aspp.deform_conv_aspp_forward

    def caught(*args, **kw):
        out = swin_forward(*args, **kw)
        feats.append(out)
        return out

    def site(*args, **kw):
        out = site_forward(*args, **kw)
        outs.append(out)
        return out

    bmodel.swin_forward = caught
    if sites:
        aspp.deform_conv_aspp_forward = site
    try:
        mask = infer(frames)
    finally:
        bmodel.swin_forward = swin_forward
        aspp.deform_conv_aspp_forward = site_forward
    feats = [f.clone() for out in feats[-2:] for f in out]
    if not sites:
        return mask, feats
    if len(outs) < 20:
        fail(f"{len(outs)} deformable site outputs, want 20")
    return mask, feats, [o.clone() for o in outs[-20:]]


def feature_errors(path, feats, ref_feats):
    """mean|f - ref| / mean|ref| per stage tensor (full pass, half pass),
    logged."""
    if len(feats) != len(ref_feats):
        fail(f"{path}: {len(feats)} backbone features, want {len(ref_feats)}")
    rel = [float((f.float() - r).abs().mean() / r.abs().mean())
           for f, r in zip(feats, ref_feats)]
    log(f"phase 4: {path}: backbone features vs f32 plain pipeline, "
        f"mean|f - f32| / mean|f32| per stage (full pass, half pass): "
        + " ".join(f"{e:.3e}" for e in rel))
    return rel


def kernel_names(pipeline):
    """{id(wrapper): the name pipeline.kernel_counters gives it}."""
    return {id(fn): name for name, fn in pipeline.kernel_counters().items()}


def drive(torch, bmodel, pipeline, reports, infer, frames, frames2, want,
          path, sites=False):
    """The first call of a graphed make_infer_fn with every count set to 0
    just before it; the counts read just after hold the warm-up's and the
    capture's launches (each runs the body once), and the capture's own,
    recorded by the function, must equal `want`. Then: a replay moves no
    count; the graphed masks are bitwise the eager body's for `frames` and
    for `frames2`. Returns the mask and the backbone features of the
    graphed call (and, with `sites`, its 20 deformable sites' outputs)."""
    for r in reports.values():
        r.wrapper.launches = 0
    mask, feats, *site_outs = with_features(bmodel, infer, frames, sites)
    torch.cuda.synchronize()
    counts = {name: r.wrapper.launches for name, r in reports.items()}
    names = kernel_names(pipeline)
    key = (tuple(frames.shape), frames.dtype)
    captured = {name: infer.launches[key].get(names[id(r.wrapper)], 0)
                for name, r in reports.items()}
    log(f"phase 4: {path}: launches captured in the graph of one "
        f"make_infer_fn call: {captured}; counted over its warm-up and "
        f"capture: {counts}; graph pool {infer.pool_bytes[key] / 2**30:.2f} "
        f"GiB, max allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    if captured != want:
        fail(f"{path} captured launch counts {captured} != {want}")
    if counts != {name: 2 * n for name, n in want.items()}:
        fail(f"{path} launch counts over warm-up and capture {counts} != "
             f"twice {want}")
    for name, r in reports.items():
        r.entry["launches_by_path"][path] = captured[name]
        r.entry.setdefault("launches_counted_by_path", {})[path] = counts[name]
    for r in reports.values():
        r.wrapper.launches = 0
    again = infer(frames)
    replay_counts = {n: r.wrapper.launches for n, r in reports.items()}
    if any(replay_counts.values()):
        fail(f"{path}: a replay ran kernel wrappers: {replay_counts}")
    second = infer(frames2)
    for label, got, fr in (("frames", again, frames),
                           ("second frames", second, frames2)):
        eager = infer.eager(fr)
        if not torch.equal(got, eager) or not torch.equal(mask, again):
            d = (got.float() - eager.float()).abs()
            fail(f"{path}: graphed mask differs from the eager body's on "
                 f"{label}: max |diff| {float(d.max())}")
        del eager
    log(f"phase 4: {path}: graphed masks bitwise equal to the eager body's "
        f"on two frame batches; a replay moves no launch count")
    if tuple(mask.shape) != (BATCH, SIZE, SIZE) or not bool(
            torch.isfinite(mask).all()) or float(mask.min()) < 0 or float(
            mask.max()) > 1:
        fail(f"{path}: bad mask: shape {tuple(mask.shape)}, range "
             f"[{float(mask.min())}, {float(mask.max())}]")
    return (mask, feats, *site_outs)


@contextlib.contextmanager
def cudnn_tf32_forced(torch, bmodel):
    """models/birefnet.forward_logits run with cudnn.allow_tf32 set True
    inside it, past make_infer_fn's own setting: the TF32 fault that
    make_infer_fn repairs, as a control."""
    forward = bmodel.forward_logits

    def forced(*args, **kw):
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return forward(*args, **kw)
        finally:
            torch.backends.cudnn.allow_tf32 = saved

    bmodel.forward_logits = forced
    try:
        yield
    finally:
        bmodel.forward_logits = forward


def drive_model(torch, bmodel, pipeline, reports, cfg, params, frames, frames2,
                tiers, plain_bf16, tf32_control=False):
    """Phase 4 for one model: its f32 plain reference, then each path (an
    f32 path held to MASK_MAE_F32 and FEATURE_F32; with tf32_control, the
    f32 plain pipeline with cuDNN's TF32 forced on must break FEATURE_F32).
    Returns {path: max feature error} and the reference features."""
    from birefnet_tpu_torch.configs import ComputeConfig

    dev = frames.device
    f32_plain = ComputeConfig(deform_mode="regular")
    ref, ref_feats = with_features(bmodel, pipeline.make_infer_fn(
        params, cfg, f32_plain, dev, as_uint8=False), frames)
    if tf32_control:
        with cudnn_tf32_forced(torch, bmodel):
            _, feats = with_features(bmodel, pipeline.make_infer_fn(
                params, cfg, f32_plain, dev, as_uint8=False), frames)
        worst = max(feature_errors(f"{cfg.backbone} f32 plain, cuDNN TF32 "
                                   f"forced on", feats, ref_feats))
        log(f"phase 4: {cfg.backbone} f32 plain pipeline with cuDNN TF32 "
            f"forced on: worst feature error {worst:.3e} (must exceed "
            f"{FEATURE_F32})")
        if not worst > FEATURE_F32:
            fail("the f32 feature gate does not see cuDNN's TF32")
        del feats
    errs, masks = {}, {}
    if plain_bf16:
        _, feats = with_features(bmodel, pipeline.make_infer_fn(
            params, cfg, ComputeConfig(dtype=torch.bfloat16,
                                       deform_mode="regular"), dev,
            as_uint8=False), frames)
        errs["plain bf16"] = feature_errors(f"{cfg.backbone} plain bf16", feats,
                                            ref_feats)
        del feats
    for path, (compute, want) in tiers.items():
        infer = pipeline.make_infer_fn(params, cfg, compute, dev,
                                       as_uint8=False)
        masks[path], feats = drive(torch, bmodel, pipeline, reports, infer,
                                   frames, frames2, want, path)
        del infer
        # The f32 kernel tier is held to the f32 bar; the int8 paths, f32
        # or bf16, to the int8 one.
        f32 = compute.dtype == torch.float32 and not (compute.int8_mlp or
                                                      compute.int8_attn)
        gate = MASK_MAE_F32 if f32 else 1e-3
        mae = float((masks[path] - ref).abs().mean())
        log(f"phase 4: {path}: mask MAE vs f32 plain pipeline = {mae:.3e} "
            f"(gate < {gate})")
        if not mae < gate:
            fail(f"{path} mask MAE {mae} >= {gate}")
        errs[path] = feature_errors(path, feats, ref_feats)
        del feats
        if f32:
            log(f"phase 4: {path}: worst feature error {max(errs[path]):.3e} "
                f"(gate <= {FEATURE_F32})")
            if not max(errs[path]) <= FEATURE_F32:
                fail(f"{path} backbone features off by {max(errs[path])} > "
                     f"{FEATURE_F32}")
    paths = list(tiers)
    d = (masks[paths[1]] - masks[paths[0]]).abs()
    log(f"phase 4: {paths[1]} vs {paths[0]} masks: mean |diff| "
        f"{float(d.mean()):.3e}, max {float(d.max()):.3e} (not gated)")
    return errs, ref_feats


def scale_offset_convs(tree, scale):
    """The tree with every offset_conv's weight and bias multiplied by
    `scale`; the other leaves are shared, not copied."""
    return {k: ({n: t * scale for n, t in v.items()} if k == "offset_conv"
                else scale_offset_convs(v, scale)) if isinstance(v, dict)
            else v for k, v in tree.items()}


def site_errors(path, outs, ref_outs):
    """mean|s - ref| / mean|ref| at each of the 20 deformable sites, in
    forward order (the squeeze block, then decoder_block4..1; per block
    aspp1, then k = 1, 3, 7), logged."""
    rel = [float((o.float() - r).abs().mean() / r.abs().mean())
           for o, r in zip(outs, ref_outs)]
    log(f"phase 4: {path}: deformable site outputs vs f32 plain deformable "
        f"pipeline, mean|s - ref| / mean|ref| per site: "
        + " ".join(f"{e:.3e}" for e in rel))
    return rel


def offset_stats(aspp, infer, frames):
    """One eager call of `infer` with the offsets of each deformable site
    caught where models/aspp.py calls deform_conv2d: per site (side, k,
    mean |offset|, max |offset|) in pixels."""
    stats, deform = [], aspp.deform_conv2d

    def caught(x, offset, mask, weight, *args, **kw):
        a = offset.abs()
        stats.append((x.shape[1], weight.shape[-1], a.mean(), a.amax()))
        return deform(x, offset, mask, weight, *args, **kw)

    aspp.deform_conv2d = caught
    try:
        infer.eager(frames)
    finally:
        aspp.deform_conv2d = deform
    return [(side, k, float(m), float(x)) for side, k, m, x in stats]


def drive_deformable(torch, bmodel, pipeline, reports, cfg, tree, frames,
                     frames2, paths):
    """Phase 4's deformable paths on one tree: the f32 plain deformable
    pipeline as the reference (and its offsets per site), the plain bf16
    deformable pipeline's site errors, then each path through drive() with
    its site gate, then each path in regular mode (eager) as the control
    that must break its gate."""
    from birefnet_tpu_torch.configs import ComputeConfig
    from birefnet_tpu_torch.models import aspp

    dev = frames.device
    ref_fn = pipeline.make_infer_fn(tree, cfg, ComputeConfig(), dev,
                                    as_uint8=False)
    ref, _, ref_sites = with_features(bmodel, ref_fn, frames, True)
    stats = offset_stats(aspp, ref_fn, frames)
    del ref_fn
    log("phase 4: swin_l deformable tree: |offset| per site, mean / max px: "
        + " ".join(f"{side}^2k{k} {m:.2f}/{x:.1f}" for side, k, m, x in stats))
    _, _, plain = with_features(bmodel, pipeline.make_infer_fn(
        tree, cfg, ComputeConfig(dtype=torch.bfloat16), dev,
        as_uint8=False), frames, True)
    plain_errs = site_errors("swin_l plain bf16 deformable", plain, ref_sites)
    del plain

    def gate(path, compute, errs):
        """(value, limit, what): the f32 tier's worst site error against
        DEFORM_F32, a bf16 path's worst ratio to the plain bf16 error."""
        if compute.dtype == torch.float32:
            return max(errs), DEFORM_F32, "worst site error"
        return (max(e / p for e, p in zip(errs, plain_errs)), DEFORM_RATIO,
                "worst site ratio to plain bf16 deformable")

    results = {}
    for path, (compute, want) in paths.items():
        infer = pipeline.make_infer_fn(tree, cfg, compute, dev,
                                       as_uint8=False)
        mask, _, outs = drive(torch, bmodel, pipeline, reports, infer, frames,
                              frames2, want, path, sites=True)
        del infer
        f32 = compute.dtype == torch.float32 and not compute.int8_mlp
        limit_mae = MASK_MAE_F32 if f32 else 1e-3
        mae = float((mask - ref).abs().mean())
        log(f"phase 4: {path}: mask MAE vs f32 plain deformable pipeline = "
            f"{mae:.3e} (gate < {limit_mae})")
        if not mae < limit_mae:
            fail(f"{path} mask MAE {mae} >= {limit_mae}")
        value, limit, what = gate(path, compute, site_errors(path, outs,
                                                             ref_sites))
        log(f"phase 4: {path}: {what} {value:.3e} (gate <= {limit})")
        if not value <= limit:
            fail(f"{path}: {what} {value} > {limit}")
        results[path] = value
        del outs
    for path, (compute, _) in paths.items():
        regular = compute.with_overrides(deform_mode="regular")
        fn = pipeline.make_infer_fn(tree, cfg, regular, dev, as_uint8=False)
        _, _, outs = with_features(bmodel, fn.eager, frames, True)
        del fn
        value, limit, what = gate(path, regular, site_errors(
            f"{path} in regular mode", outs, ref_sites))
        log(f"phase 4: {path} in regular mode (control): {what} {value:.3e} "
            f"(must break the gate {limit})")
        if not value > limit:
            fail(f"{path}: regular mode passes the deformable gate "
                 f"({value} <= {limit})")
        results[f"{path} regular control"] = value
        del outs
    return results


def int8_gate(path, errs, bf16_path):
    limit = FEATURE_RATIO * max(errs[bf16_path])
    log(f"phase 4: {path} features' largest relative error "
        f"{max(errs[path]):.3e} (gate <= {FEATURE_RATIO} x {bf16_path}'s "
        f"{max(errs[bf16_path]):.3e} = {limit:.3e})")
    if not max(errs[path]) <= limit:
        fail(f"{path} backbone features off by {max(errs[path])} > {limit}")
    return limit


def f32_int8_gate(path, errs, int8_path):
    """An f32 int8 path drops every bf16 rounding of its model's bf16 int8
    path: its worst stage feature error is at most that path's."""
    limit = max(errs[int8_path])
    log(f"phase 4: {path} features' largest relative error "
        f"{max(errs[path]):.3e} (gate <= {int8_path}'s {limit:.3e})")
    if not max(errs[path]) <= limit:
        fail(f"{path} backbone features off by {max(errs[path])} > {limit}")
    return limit


def stage_ratio(errs, plain):
    """The largest stage-by-stage ratio of a path's feature error to the
    plain bf16 pipeline's."""
    return max(e / p for e, p in zip(errs, plain))


def site_inputs(infer, frames):
    """(x, offset, mask, k) of the 20 deformable sites, in forward order,
    as one eager call of `infer` gives them to models/aspp.py's
    deform_conv2d (copies)."""
    from birefnet_tpu_torch.models import aspp

    caught, deform = [], aspp.deform_conv2d

    def catch(x, offset, mask, weight, *args, **kw):
        caught.append((x, offset, mask, weight.shape[-1]))
        return deform(x, offset, mask, weight, *args, **kw)

    aspp.deform_conv2d = catch
    try:
        infer.eager(frames)
    finally:
        aspp.deform_conv2d = deform
    if len(caught) != 20:
        fail(f"{len(caught)} deformable sites, want 20")
    # Copied outside inference mode: autograd takes no inference tensor.
    return [(x.clone(), offset.float().contiguous().clone(), mask.clone(), k)
            for x, offset, mask, k in caught]


def check_d1b(torch, dev, sites, smi):
    """Phase 8: D1b at each site's inputs with a seeded column gradient,
    against deform_col2im_plain (autograd through D1's plain version); the
    (dy, dx) swap control; CUDA-event time of kernel and plain version,
    device time of the kernel (with the memset of grad_x) from the
    profiler, and the bound: G, x, the offsets and the mask read once, the
    three gradients written once, over 3.35 TB/s, against 36 f32
    operations per column value (per corner: the G x product, three
    multiply-adds, the masked weight and the atomic add) over the f32
    peak. Returns the kernel report entry (times summed per train step of
    one microbatch: the 20 calls)."""

    import gpu_profile
    from birefnet_tpu_torch.ops.kernels import deform_im2col as d1

    gen = torch.Generator(dev).manual_seed(8)
    sums = dict.fromkeys(("ms", "plain_ms", "device_ms", "bound_ms",
                          "bytes_ms", "ops_ms"), 0.0)
    worst = {"abs": 0.0, "max": 0.0, "mean": 0.0,
             "control_min": float("inf")}
    for i, (x, offset, mask, k) in enumerate(sites):
        b, h, w, c = x.shape
        g = torch.randn((b * h * w, k * k * c), generator=gen, device=dev)
        args = (g, x, offset, mask, k, k, 1, k // 2)
        got = d1.deform_col2im(*args)
        want = d1.deform_col2im_plain(*args)
        swapped = offset.reshape(b, h, w, k * k, 2).flip(-1).reshape(
            offset.shape).contiguous()
        ctl = d1.deform_col2im(g, x, swapped, mask, k, k, 1, k // 2)
        errs = []
        for name, gv, wv, cv in zip(("grad_x", "grad_offset", "grad_mask"),
                                    got, want, ctl):
            if not bool(torch.isfinite(gv).all()):
                fail(f"D1b site {i}: non-finite {name}")
            scale = float(wv.abs().max())
            abs_err = float((gv - wv).abs().max())
            worst["abs"] = max(worst["abs"], abs_err)
            err = abs_err / scale
            mean = float((gv - wv).abs().mean() / wv.abs().mean())
            errs.append((name, err, mean, float((cv - wv).abs().max()) / scale))
            if not (err <= D1B_BOUND and mean <= D1B_MEAN):
                fail(f"D1b site {i} [{b},{h},{w},{c}] k={k} {name}: max ratio "
                     f"{err} (bound {D1B_BOUND}), mean ratio {mean} (bound "
                     f"{D1B_MEAN})")
        control = max(e[3] for e in errs)
        if not control > D1B_BOUND:
            fail(f"D1b site {i}: swapped (dy, dx) within the bound "
                 f"({control})")
        worst["max"] = max(worst["max"], max(e[1] for e in errs))
        worst["mean"] = max(worst["mean"], max(e[2] for e in errs))
        worst["control_min"] = min(worst["control_min"], control)
        del got, want, ctl
        kernel_fn = partial(d1.deform_col2im, *args)
        ms = cuda_ms(torch, kernel_fn)
        plain_ms = cuda_ms(torch, partial(d1.deform_col2im_plain, *args),
                           reps=3)
        dev_ms = gpu_profile.device_ms_per_call(kernel_fn, 10, lambda n: True)
        n_cols = g.numel()
        byte_ms = nbytes(g, x, offset, mask, x, offset, mask) / MEM_RATE * 1e3
        op_ms = 36 * n_cols / PEAK["f32"] * 1e3
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("device_ms", dev_ms), ("bound_ms", max(byte_ms, op_ms)),
                       ("bytes_ms", byte_ms), ("ops_ms", op_ms)):
            sums[key] += v
        log(f"phase 8: D1b site {i:2d} [{b},{h},{w},{c}] k={k}: "
            + ", ".join(f"{n} max {e:.2e} mean {m:.2e} swapped {cl:.2e}"
                        for n, e, m, cl in errs)
            + f"; kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, least {max(byte_ms, op_ms):.4f} ms")
    bound_by = "bytes" if sums["bytes_ms"] >= sums["ops_ms"] else "operations"
    log(f"phase 8: D1b per train step (20 sites, one microbatch of {BATCH}): "
        f"kernel {sums['ms']:.4f} ms by events, {sums['device_ms']:.4f} ms "
        f"device; plain {sums['plain_ms']:.4f} ms; bound "
        f"{sums['bound_ms']:.4f} ms ({bound_by}); worst max ratio "
        f"{worst['max']:.3e} (bound {D1B_BOUND}), mean {worst['mean']:.3e} "
        f"(bound {D1B_MEAN}); the swap control's smallest "
        f"{worst['control_min']:.3e} ({smi})")
    return {"name": "deform_col2im", "route": "cuda",
            "source": "birefnet_tpu_torch/csrc/deform_col2im.cu",
            "replaces": "birefnet_tpu/ops/deform_conv.py:35",
            "note": ("no TPU kernel: D1's backward, the counterpart of the VJP "
                     "JAX forms for its gather (deform_conv.py:68-158); times "
                     "per train step of one microbatch (20 calls); "
                     "max_rel_err is max|k - p| / max|p| at the worst site"),
            "launches": None, "launches_by_path": {},
            "max_abs_err": worst["abs"], "max_rel_err": worst["max"],
            "mean_rel_err": worst["mean"],
            "swap_control_min": worst["control_min"], "ms": sums["ms"],
            "device_ms": sums["device_ms"], "plain_ms": sums["plain_ms"],
            "bound_ms": sums["bound_ms"], "bound_by": bound_by,
            "library_ms": None,
            "library": "none: no one PyTorch call computes these gradients"}


def model_grads(torch, cfg, tree, x, y, compute):
    """(loss, {path: gradient}) of the structure loss of one forward, as
    train.make_train_step computes them, TF32 off."""
    from birefnet_tpu_torch import pipeline, train
    from birefnet_tpu_torch.models import birefnet as bmodel

    keys, leaves = zip(*train.flatten(tree))
    live = [t.detach().requires_grad_(True) for t in leaves]
    compute = train.validate_train_compute(compute)
    with pipeline.full_f32():
        logits = bmodel.forward_logits(train.unflatten(zip(keys, live)), cfg,
                                       x, compute)
        loss = train.structure_loss(logits, y)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return float(loss.detach()), {k: torch.zeros_like(t) if g is None else g
                                  for k, t, g in zip(keys, live, grads)}


def grad_errors(want, got):
    """({path: max|got - want| / max|want|}, relative L2 of the whole)."""
    errs, num, den = {}, 0.0, 0.0
    for k, w in want.items():
        d = (got[k] - w).double()
        scale = float(w.abs().max())
        errs[k] = float(d.abs().max()) / scale if scale else float(
            got[k].abs().max())
        num += float((d * d).sum())
        den += float((w.double() ** 2).sum())
    return errs, (num / den) ** 0.5


def check_model_grads(torch, dev, cfg, tree, smi):
    """Phase 8: Swin-L's gradients at GRAD_SIZE^2, batch BATCH, on the
    offset-scaled tree: through D1/D1b, against the plain route; the same
    route twice (not gated: what the nondeterministic atomics and cuDNN
    backward algorithms leave); regular mode as the control."""
    import dataclasses

    from birefnet_tpu_torch.configs import ComputeConfig
    from birefnet_tpu_torch.ops import deform_conv
    from birefnet_tpu_torch.ops.kernels import deform_im2col as d1
    from birefnet_tpu_torch.params import to_device

    cfg = dataclasses.replace(cfg, size=(GRAD_SIZE, GRAD_SIZE))
    tree = to_device(tree, dev)
    gen = torch.Generator(dev).manual_seed(9)
    x = torch.randn((BATCH, GRAD_SIZE, GRAD_SIZE, 3), generator=gen,
                    device=dev)
    yy, xx = torch.meshgrid(torch.arange(GRAD_SIZE, device=dev),
                            torch.arange(GRAD_SIZE, device=dev),
                            indexing="ij")
    disk = (((yy - 120) ** 2 + (xx - 136) ** 2) < 70 ** 2).float()
    y = torch.stack([disk, disk.flip(1)])
    d1.deform_im2col.launches = d1.deform_col2im.launches = 0
    loss, kern = model_grads(torch, cfg, tree, x, y, ComputeConfig())
    launches = (d1.deform_im2col.launches, d1.deform_col2im.launches)
    if launches != (20, 20):
        fail(f"phase 8: the gradient through D1/D1b launched (D1, D1b) = "
             f"{launches}, want (20, 20)")
    _, again = model_grads(torch, cfg, tree, x, y, ComputeConfig())
    route = deform_conv.im2col
    deform_conv.im2col = d1.deform_im2col_plain
    try:
        plain_loss, plain = model_grads(torch, cfg, tree, x, y,
                                        ComputeConfig())
    finally:
        deform_conv.im2col = route
    _, regular = model_grads(torch, cfg, tree, x, y,
                             ComputeConfig(deform_mode="regular"))
    errs, rel_l2 = grad_errors(plain, kern)
    twice, twice_l2 = grad_errors(kern, again)
    ctl, ctl_l2 = grad_errors(plain, regular)
    worst = max(errs, key=errs.get)
    offsets = [k for k in errs if "offset_conv" in k]
    ctl_off = min(ctl[k] for k in offsets)
    log(f"phase 8: swin_l gradients at {GRAD_SIZE}^2 batch {BATCH}, offset "
        f"convs x{OFFSET_SCALE}: loss {loss:.6f} via D1/D1b, {plain_loss:.6f} "
        f"plain route; worst leaf {errs[worst]:.3e} ({worst}; gate "
        f"{GRAD_LEAF_BOUND}), relative L2 {rel_l2:.3e} (gate {GRAD_L2_BOUND}); "
        f"the D1/D1b route twice: worst leaf {max(twice.values()):.3e}, "
        f"relative L2 {twice_l2:.3e}; regular mode (control): offset-conv "
        f"leaves at least {ctl_off:.3e}, relative L2 {ctl_l2:.3e} ({smi})")
    if not (errs[worst] <= GRAD_LEAF_BOUND and rel_l2 <= GRAD_L2_BOUND):
        fail(f"phase 8: gradients through D1/D1b off the plain route: "
             f"{worst} {errs[worst]}, relative L2 {rel_l2}")
    if len(offsets) != 40 or not ctl_off > GRAD_LEAF_BOUND:
        fail(f"phase 8: regular mode passes the offset-conv gradient gate "
             f"({ctl_off}, {len(offsets)} leaves)")
    return {"worst_leaf": errs[worst], "rel_l2": rel_l2,
            "twice_worst_leaf": max(twice.values()), "twice_rel_l2": twice_l2,
            "regular_offset_min": ctl_off, "regular_rel_l2": ctl_l2}


def write_pairs(root, seed=5):
    """Four image/mask pairs made from `seed` in root/imgs and root/masks:
    noise images and disk masks at the model's size. (At other sizes the
    loader resizes them on the host: where the native library does not
    build, its NumPy fallback took 57 s per batch of 2 on the GPU machine's
    host; the CPU tests hold the resize to the JAX package's.)"""
    from PIL import Image

    rng = np.random.default_rng(seed)
    imgs, masks = os.path.join(root, "imgs"), os.path.join(root, "masks")
    os.makedirs(imgs), os.makedirs(masks)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3),
                                     dtype=np.uint8)).save(
            os.path.join(imgs, f"im{i}.png"))
        cy, cx = SIZE * rng.uniform(0.3, 0.7, size=2)
        r = SIZE * rng.uniform(0.2, 0.35)
        disk = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.uint8)
        Image.fromarray(disk * 255).save(os.path.join(masks, f"im{i}.png"))
    return imgs, masks


def run_finetune(torch, pipeline, finetune, label, argv, microbatches, smi):
    """finetune.main(argv) with every launch count set to 0 just before it
    and read just after: D1 and D1b 20 times per microbatch, no other
    kernel. Logs the loss per step, the median ms per step, the peak
    memory. With no room for batch 2, reruns with --remat and says so."""
    counters = pipeline.kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    history = []
    try:
        finetune.main(argv, history=history)
    except torch.cuda.OutOfMemoryError:
        log(f"phase 8: {label}: out of memory without --remat; running "
            f"again with --remat")
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        history, argv = [], argv + ["--remat"]
        finetune.main(argv, history=history)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = {n: fn.launches for n, fn in counters.items() if fn.launches}
    want = {"deform_im2col.deform_im2col": 20 * microbatches,
            "deform_im2col.deform_col2im": 20 * microbatches}
    ms = sorted(h["ms"] for h in history)
    load_ms = sorted(h["load_ms"] for h in history)
    losses = [h["loss"] for h in history]
    log(f"phase 8: {label}: loss per step "
        + " ".join(f"{v:.5f}" for v in losses) + "; ms per step "
        + " ".join(f"{h['ms']:.1f}" for h in history)
        + f" (median {ms[len(ms) // 2]:.1f}; host loading median "
        f"{load_ms[len(ms) // 2]:.1f}); max allocated {peak / 2**30:.2f} GiB; "
        f"launches {counts} ({smi})")
    if counts != want:
        fail(f"phase 8: {label}: launches {counts} != {want}")
    if len(history) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"phase 8: {label}: bad history {history}")
    return {"losses": losses, "ms": [h["ms"] for h in history],
            "median_ms": ms[len(ms) // 2], "peak_gib": peak / 2**30,
            "launches": counts, "remat": "--remat" in argv}


def check_overfit(torch, dev, cfg, smi):
    """Phase 8: tests/test_train.py's overfit check on the card: Swin-L at
    GRAD_SIZE^2, batch BATCH, disk masks, lr 1e-4, weight decay 0, 3 steps.
    The loss must fall over the steps, and the offset convs must move: all
    of decoder_block1's (the sites next to the head) and at least as many
    as there are. Deeper sites may not: random weights at std 0.05 shrink
    the gradient by about 1e-5 per decoder block (the CPU at 64^2 and
    128^2 read max |grad| about 1e-8 at decoder_block1's offset convs,
    1e-12 at decoder_block2's, 1e-16, 1e-21 and 1e-28 deeper), and Adam's
    step g / (|g| + 1e-8) of such a gradient is below one f32 ulp of the
    weight."""
    import dataclasses

    from birefnet_tpu_torch import params as P
    from birefnet_tpu_torch import train
    from birefnet_tpu_torch.configs import ComputeConfig

    cfg = dataclasses.replace(cfg, size=(GRAD_SIZE, GRAD_SIZE))
    tcfg = train.TrainConfig(learning_rate=1e-4, weight_decay=0.0)
    state = train.init_train_state(P.init_params(cfg, 0, device=dev), tcfg)
    before = {k: v.clone() for k, v in train.flatten(state.params)
              if "offset_conv" in k}
    step = train.make_train_step(cfg, ComputeConfig(), tcfg)
    gen = torch.Generator(dev).manual_seed(10)
    x = torch.randn((BATCH, GRAD_SIZE, GRAD_SIZE, 3), generator=gen,
                    device=dev)
    yy, xx = torch.meshgrid(torch.arange(GRAD_SIZE, device=dev),
                            torch.arange(GRAD_SIZE, device=dev),
                            indexing="ij")
    y = ((yy - 128) ** 2 + (xx - 128) ** 2 < 80 ** 2).float().expand(
        BATCH, -1, -1).contiguous()
    losses = []
    for _ in range(3):
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))
    after = dict(train.flatten(state.params))
    moved = [k for k, v in before.items() if not torch.equal(v, after[k])]
    head = [k for k in before if k.startswith("decoder/decoder_block1/")]
    log(f"phase 8: overfit, swin_l {GRAD_SIZE}^2 batch {BATCH}, disk masks, "
        f"lr 1e-4, no decay: loss {' -> '.join(f'{v:.5f}' for v in losses)}; "
        f"offset-conv leaves moved {len(moved)} of {len(before)}, by block: "
        f"{sorted({k.split('/dec_att/')[0] for k in moved})} ({smi})")
    if (not losses[-1] < losses[0] or len(before) != 40 or len(head) != 8
            or not set(head) <= set(moved)):
        fail(f"phase 8: overfit check: losses {losses}, moved {moved}")
    return {"losses": losses, "offset_leaves_moved": len(moved)}


def train_phase(torch, dev, pipeline, cfg, def_tree, frames, smi):
    """Phase 8: training on the card (see the module docstring)."""
    import tempfile

    import gpu_profile
    from birefnet_tpu_torch import finetune
    from birefnet_tpu_torch import params as P
    from birefnet_tpu_torch import train
    from birefnet_tpu_torch.configs import ComputeConfig

    ref = pipeline.make_infer_fn(def_tree, cfg, ComputeConfig(), dev)
    d1b = check_d1b(torch, dev, site_inputs(ref, frames), smi)
    del ref
    torch.cuda.empty_cache()
    results = {"gradients": check_model_grads(torch, dev, cfg, def_tree, smi)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        imgs, masks = write_pairs(tmp)
        out = os.path.join(tmp, "trained.safetensors")
        argv = [imgs, masks, "--out", out, "--size", str(SIZE), "--batch",
                str(BATCH), "--steps", str(TRAIN_STEPS), "--lr", "1e-5"]
        results["finetune"] = run_finetune(
            torch, pipeline, finetune, f"finetune.main swin_l {SIZE}^2 batch "
            f"{BATCH}, {TRAIN_STEPS} steps", argv, TRAIN_STEPS, smi)
        results["finetune accum 2"] = run_finetune(
            torch, pipeline, finetune, f"finetune.main swin_l {SIZE}^2 batch "
            f"{BATCH}, --accum-steps 2", argv + ["--accum-steps", "2"],
            2 * TRAIN_STEPS, smi)
        # The written checkpoint loads and serves on the card.
        trained = P.load_checkpoint(out, cfg)
        infer = pipeline.make_infer_fn(trained, cfg, ComputeConfig(), dev)
        mask = infer(frames)
        if (tuple(mask.shape) != (BATCH, SIZE, SIZE)
                or mask.dtype != torch.uint8):
            fail(f"phase 8: the trained checkpoint's masks {mask.shape}")
        log(f"phase 8: the written checkpoint loads and runs through "
            f"make_infer_fn on the card: masks {tuple(mask.shape)}, mean "
            f"{float(mask.float().mean()):.2f}")
        del infer, trained
    results["overfit"] = check_overfit(torch, dev, cfg, smi)
    # One profiled train step at SIZE^2, batch BATCH: where its time goes.
    torch.cuda.empty_cache()
    tcfg = train.TrainConfig()
    state = [train.init_train_state(P.init_params(cfg, 0, device=dev), tcfg)]
    step = train.make_train_step(cfg, ComputeConfig(), tcfg)
    x = pipeline.preprocess(frames, cfg.size)
    y = (x[..., 0] > 0).float()

    def one_step(x):
        state[0], m = step(state[0], x, y)
        return m["loss"]

    prof = gpu_profile.profile_call(torch, one_step, x,
                                    f"swin_l train step {SIZE}^2", smi, top=12)
    results["profiled_step"] = {k: prof[k] for k in ("wall_ms", "device_ms",
                                                     "idle")}
    log(f"phase 8: one profiled train step: wall {prof['wall_ms']:.1f} ms, "
        f"device {prof['device_ms']:.1f} ms, idle share {prof['idle']:.3f} "
        f"({smi})")
    del state
    d1b["launches"] = results["finetune"]["launches"][
        "deform_im2col.deform_col2im"]
    d1b["launches_by_path"] = {
        "finetune": d1b["launches"],
        "finetune accum 2": results["finetune accum 2"]["launches"][
            "deform_im2col.deform_col2im"],
        "gradient check": 20}
    log(f"phase 8: D1b launches: {d1b['launches_by_path']}; per step of one "
        f"microbatch {d1b['ms']:.4f} ms by events, {d1b['device_ms']:.4f} ms "
        f"device, bound {d1b['bound_ms']:.4f} ms ({smi})")
    return d1b, results


def write_entry_inputs(root, seed=9):
    """The ENTRY_SIZES images from a seed (smooth gradients with noise, so
    that PNG and JPEG sizes are an image's, not noise's), with a seeded
    ground-truth disk per image; returns (image paths, masks dir)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    imgs, masks = os.path.join(root, "entry_imgs"), os.path.join(root, "gt")
    os.makedirs(imgs), os.makedirs(masks)
    paths = []
    for i, (h, w) in enumerate(ENTRY_SIZES):
        yy, xx = np.mgrid[:h, :w]
        base = np.stack([xx * (255 / w), yy * (255 / h),
                         np.full((h, w), 128.0)], -1)
        img = np.clip(base + rng.normal(0, 24, (h, w, 3)), 0, 255)
        path = os.path.join(imgs, f"im{i:02d}.{'png' if i % 2 == 0 else 'jpg'}")
        Image.fromarray(img.astype(np.uint8)).save(path)
        paths.append(path)
        cy, cx, r = h * rng.uniform(0.3, 0.7), w * rng.uniform(0.3, 0.7), \
            min(h, w) * rng.uniform(0.2, 0.35)
        disk = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        Image.fromarray(disk.astype(np.uint8) * 255).save(
            os.path.join(masks, f"im{i:02d}_mask.png"))
    return paths, masks


def run_entry(torch, pipeline, label, entry, argv):
    """entry(argv) (serve.main or cli.main) with every launch count set to 0
    just before it and read just after, and the function it builds kept
    (make_infer_fn wrapped for the call). Its standard output is logged and
    returned. Fails unless it returns 0 having built one function that
    captured one graph. Returns (stdout, function, launches captured in its
    graph, launches counted)."""
    counters = pipeline.kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    made, make = [], pipeline.make_infer_fn

    def keep(*args, **kw):
        made.append(make(*args, **kw))
        return made[-1]

    pipeline.make_infer_fn = keep
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = entry(argv)
    finally:
        pipeline.make_infer_fn = make
    counted = {n: fn.launches for n, fn in counters.items() if fn.launches}
    for line in out.getvalue().splitlines():
        log(f"phase 9: {label}: {line}")
    if rc != 0 or len(made) != 1:
        fail(f"phase 9: {label} returned {rc} having built {len(made)} "
             f"functions")
    graphs = made[0].launches
    if len(graphs) != 1:
        fail(f"phase 9: {label} captured {len(graphs)} graphs, not one: "
             f"{list(graphs)}")
    return out.getvalue(), made[0], next(iter(graphs.values())), counted


def check_launches(label, captured, counted, want):
    """The launches captured in the graph are `want`; each kernel of the
    path was launched in the run: twice a call's by the first call (the
    warm-up and the capture), none by a replay."""
    log(f"phase 9: {label}: launches captured in its graph {captured}; "
        f"counted in the run {counted}")
    if captured != want:
        fail(f"phase 9: {label}: captured launches {captured} != {want}")
    if counted != {k: 2 * v for k, v in want.items()}:
        fail(f"phase 9: {label}: launches counted in the run {counted} != "
             f"twice {want}")


def serve_sequential(serve, infer, paths, size, batch, out_dir):
    """serve.main's loop before it overlapped, on the same function:
    decode a chunk, serve.segment it, write its masks, each in series.
    Returns img/s including IO."""
    from PIL import Image

    from birefnet_tpu_torch import loader

    os.makedirs(out_dir)
    t0 = time.perf_counter()
    for start in range(0, len(paths), batch):
        chunk = paths[start:start + batch]
        images = [loader._decode(p) for p in chunk]
        for p, m in zip(chunk, serve.segment(infer, images, size, batch)):
            name = os.path.splitext(os.path.basename(p))[0] + "_mask.png"
            Image.fromarray(m).save(os.path.join(out_dir, name))
    return len(paths) / (time.perf_counter() - t0)


def same_masks(a_dir, b_dir, paths):
    """Whether every image's mask PNG in the two directories holds the same
    pixels."""
    from PIL import Image

    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0] + "_mask.png"
        a = np.asarray(Image.open(os.path.join(a_dir, name)))
        b = np.asarray(Image.open(os.path.join(b_dir, name)))
        if a.shape != b.shape or not np.array_equal(a, b):
            return False
    return True


def entry_points_phase(torch, dev, smi):
    """Phase 9: the entry points a user starts the port with, at Swin-L
    1024^2 on seed-0 weights saved to a temporary safetensors file (see
    the module docstring)."""
    import re
    import shutil
    import tempfile

    from PIL import Image
    from safetensors.numpy import save_file

    from birefnet_tpu_torch import cli, evaluate, pipeline, serve
    from birefnet_tpu_torch.configs import BiRefNetConfig, ComputeConfig
    from birefnet_tpu_torch.params import load_checkpoint, random_checkpoint
    from birefnet_tpu_torch.utils import native

    t_phase = time.perf_counter()
    try:
        lib = native.require()
    except native.NativeLibraryError as e:
        fail(f"phase 9: the host-image library: {e}")
    log(f"phase 9: host-image library loaded from {lib}")
    results = {"native_library": os.path.relpath(lib, ROOT)}
    cfg = BiRefNetConfig.swin_l()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model.safetensors")
        save_file(random_checkpoint(cfg, 0), ckpt)
        paths, gt_dir = write_entry_inputs(tmp)
        # An HF cache under a $HOME of its own: serve.main's first run takes
        # its checkpoint from there, as a user's without --checkpoint does.
        home = os.path.join(tmp, "home")
        snap = os.path.join(home, ".cache", "huggingface", "hub",
                            "models--ZhengPeng7--BiRefNet", "snapshots", "s0")
        os.makedirs(snap)
        cached = os.path.join(snap, "model.safetensors")
        os.symlink(ckpt, cached)
        for label, (flags, want) in SERVE_FLAGS.items():
            rates = {"overlapped": [], "sequential": []}
            for run in range(ENTRY_RUNS):
                out = os.path.join(tmp, f"{label} {run}".replace(" ", "_"))
                argv = [*paths, "--out", out, "--batch", str(BATCH), *flags]
                from_cache = run == 0 and not flags
                saved_home = os.environ.get("HOME")
                if from_cache:
                    os.environ["HOME"] = home
                else:
                    argv += ["--checkpoint", ckpt]
                try:
                    stdout, infer, captured, counted = run_entry(
                        torch, pipeline, f"{label} run {run}", serve.main,
                        argv)
                finally:
                    if saved_home is None:
                        os.environ.pop("HOME", None)
                    else:
                        os.environ["HOME"] = saved_home
                if from_cache and f"Loading {cached} " not in stdout:
                    fail(f"phase 9: {label} did not take its checkpoint "
                         f"from the HF cache at {cached}")
                check_launches(f"{label} run {run}", captured, counted, want)
                rate = re.search(r"\(([0-9.]+) img/s incl\. IO\)", stdout)
                if rate is None:
                    fail(f"phase 9: {label} printed no img/s")
                rates["overlapped"].append(float(rate.group(1)))
                rates["sequential"].append(serve_sequential(
                    serve, infer, paths, SIZE, BATCH, out + "_sequential"))
                if not same_masks(out, out + "_sequential", paths):
                    fail(f"phase 9: {label} run {run}: the masks differ from "
                         f"the sequential path's")
                log(f"phase 9: {label} run {run}: {len(paths)} masks bitwise "
                    f"the sequential path's (serve.segment on the same "
                    f"decoded images, the same function)")
                if run < ENTRY_RUNS - 1:
                    shutil.rmtree(out + "_sequential")
                del infer
                torch.cuda.empty_cache()
            med = {k: sorted(v)[len(v) // 2] for k, v in rates.items()}
            log(f"phase 9: {label} ({' '.join(flags) or 'bf16, deformable'}): "
                f"img/s incl. IO, {len(paths)} images, batch {BATCH}, median "
                f"of {ENTRY_RUNS}: overlapped {med['overlapped']:.2f} "
                f"{rates['overlapped']}, sequential {med['sequential']:.2f} "
                f"{[round(r, 2) for r in rates['sequential']]} ({smi})")
            results[label] = {"img_s_overlapped": rates["overlapped"],
                              "img_s_sequential": rates["sequential"],
                              "launches": want}

        # cli.main on the 1440x1080 image with its defaults: the f32 kernel
        # tier, deformable, at the frame's own size.
        img = paths[0]
        out_png = os.path.join(tmp, "cli_mask.png")
        stdout, infer, captured, counted = run_entry(
            torch, pipeline, "cli.main", cli.main,
            [img, out_png, "--checkpoint", ckpt])
        check_launches("cli.main", captured, counted, CLI_LAUNCHES)
        stats = re.search(r"Mask stats - min: ([0-9.]+), max: ([0-9.]+), "
                          r"mean: ([0-9.]+)", stdout)
        if stats is None:
            fail("phase 9: cli.main printed no mask stats")
        times = re.findall(r"Inference time \([^)]*\): ([0-9.]+)s", stdout)
        del infer
        torch.cuda.empty_cache()
        ref = pipeline.make_infer_fn(load_checkpoint(ckpt, cfg), cfg,
                                     ComputeConfig(use_flash_attention=True),
                                     dev)
        with Image.open(img) as im:
            frame = np.array(im.convert("RGB"), np.uint8)
        want_mask = ref(frame[None]).cpu().numpy()[0]
        got = np.asarray(Image.open(out_png))
        if got.shape != frame.shape[:2] or not np.array_equal(got, want_mask):
            fail(f"phase 9: cli.main's mask {got.shape} is not make_infer_fn's "
                 f"for the same frame and flags")
        log(f"phase 9: cli.main's {got.shape[1]}x{got.shape[0]} mask bitwise "
            f"make_infer_fn's (f32 kernel tier, deformable); first call "
            f"{times[0]} s, steady state {times[1]} s ({smi})")
        results["cli.main"] = {"launches": CLI_LAUNCHES,
                               "seconds_first_steady": [float(t) for t in times],
                               "mask_stats": [float(v) for v in stats.groups()]}
        del ref
        torch.cuda.empty_cache()

        # evaluate.main on the served masks of the small images against
        # their seeded disks.
        pred_dir, gts = os.path.join(tmp, "eval_pred"), os.path.join(tmp,
                                                                     "eval_gt")
        os.makedirs(pred_dir), os.makedirs(gts)
        served = os.path.join(tmp, "serve.main_default_0")
        for p, (h, w) in zip(paths, ENTRY_SIZES):
            if h * w <= ENTRY_EVAL_PIXELS:
                name = os.path.splitext(os.path.basename(p))[0] + "_mask.png"
                shutil.copy(os.path.join(served, name), pred_dir)
                shutil.copy(os.path.join(gt_dir, name), gts)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = evaluate.main([pred_dir, gts])
        scores = {k: float(v) for k, v in (
            line.split() for line in buf.getvalue().splitlines())}
        log(f"phase 9: evaluate.main on {len(os.listdir(pred_dir))} served "
            f"masks against seeded disks: {scores}")
        if rc != 0 or len(scores) != 7 or not all(
                0.0 <= v <= 1.0 for v in scores.values()):
            fail(f"phase 9: evaluate.main returned {rc}, scores {scores}")
        results["evaluate.main"] = scores
    results["seconds"] = time.perf_counter() - t_phase
    log(f"phase 9: entry points done in {results['seconds']:.1f} s")
    return results


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "birefnet_tpu_torch")):
        fail(f"birefnet_tpu_torch/ not found beside {__file__}")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.modules["jax"] = None  # the port must not reach for JAX
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))  # gpu_profile
    dev = torch.device("cuda")
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"phase 1: {device_name}, {torch.cuda.device_count()} device(s); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    from birefnet_tpu_torch import pipeline, serve
    from birefnet_tpu_torch.configs import BiRefNetConfig, ComputeConfig
    from birefnet_tpu_torch.models import birefnet as bmodel
    from birefnet_tpu_torch.ops.kernels import build
    from birefnet_tpu_torch.params import (build_param_tree, quantize_attn_int8,
                                           quantize_mlp_int8, random_checkpoint,
                                           to_device, tree_map)

    t0 = time.perf_counter()
    build.build(verbose=True)
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s")

    # PyTorch's TF32 flags stay as a user finds them (cuDNN's on): phase 3
    # sets them off for its plain versions, and phase 4 runs make_infer_fn,
    # which sets them for an f32 forward itself.
    log(f"phase 3: TF32 flags as found: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    reports, core = make_reports(), make_core_report()
    gemm = make_gemm_report()
    gemm16, rows16 = make_bf16_reports()
    cluster = make_cluster_report()
    f32r = make_f32_reports()
    extra = {"int_mm_ms": {}, "int_mm_ms_f32": {}, "ln_code_flips": {}}
    with torch.inference_mode(), pipeline.full_f32():
        check_kernels(torch, dev, reports, core, gemm, gemm16, rows16, cluster,
                      extra, f32r)
    log("phase 3: every kernel within its bound at every slice shape")
    # The f32 tier's building blocks under its K1 and K2 entries.
    f32_sums = {n: f32r[n].by_model()
                for n in ("f32_gemm", "ln_rows_f32", "window_core_f32")}
    for key, name, k1_model, k2_model, lib in (
            ("f32_gemm", "f32_gemm", "swin_l k1", "swin_l k2",
             "F.linear in f32, TF32 off: the product and bias"),
            ("ln_rows", "ln_rows_f32", "swin_l k1", "swin_l k2",
             "F.layer_norm in f32: no pad zeroing"),
            ("core", "window_core_f32", "swin_l", None,
             "SDPA in f32, bias and mask as one prebuilt f32 addend")):
        src = f32r[name].entry
        common = dict(source=src["source"], max_abs_err=src["max_abs_err"],
                      mean_rel_err=src["mean_rel_err"], library=lib)
        if "tf32_control_min" in src:
            common["tf32_control_min"] = src["tf32_control_min"]
        f32r["fused_block_attn_f32"].entry[key] = dict(
            f32_sums[name][k1_model], **common)
        if k2_model is not None:
            f32r["fused_mlp_f32"].entry[key] = dict(
                f32_sums[name][k2_model], swin_t=f32_sums[name]["swin_t k2"],
                **common)
    for name in (*f32_sums, "fused_block_attn_f32", "fused_mlp_f32",
                 "row_ln_f32", "flash_window_attn_qkv_f32"):
        for model, m in f32r[name].by_model().items():
            lib = ("n/a" if m["library_ms"] is None
                   else f"{m['library_ms']:.4f} ms")
            log(f"phase 3: {name} at {model}'s shapes per forward: kernel "
                f"{m['ms']:.4f} ms, library {lib}, plain {m['plain_ms']:.4f} "
                f"ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']}); "
                f"{m['bound_ms'] / m['ms']:.3f} of the bound ({smi})")
    sums = core.by_model()["swin_l"]
    reports["fused_block_attn"].entry["core"] = dict(
        sums, source=core.entry["source"],
        max_abs_err=core.entry["max_abs_err"],
        mean_rel_err=core.entry["mean_rel_err"])
    gemm_sums = gemm.by_model()
    reports["fused_block_attn_int8"].entry["int8_gemm"] = dict(
        gemm_sums["swin_l"], source=gemm.entry["source"],
        max_abs_err=gemm.entry["max_abs_err"],
        mean_rel_err=gemm.entry["mean_rel_err"],
        library="torch._int_mm: the s32 product only, no dequant epilogue")
    # K3: the route, its cluster kernel alone, torch._int_mm of its two
    # products (two calls, so not a library_ms), the LN code flips.
    k3 = reports["fused_mlp_int8"]
    k3_sums = cluster.by_model()
    k3.entry["design"] = ("the LN2 row pass of csrc/int8_gemm.cu, then one "
                          "thread-block-cluster kernel (ceil(C/96) CTAs, the "
                          "hidden in shared memory): 2 device launches a call")
    k3.entry["cluster"] = dict(
        k3_sums["swin_l"], source=cluster.entry["source"],
        max_abs_err=cluster.entry["max_abs_err"], bitwise=True,
        swin_t=k3_sums["swin_t"])
    k3.entry["int_mm_ms"] = extra["int_mm_ms"].get("swin_l")
    k3.entry["int_mm_ms_by_model"] = extra["int_mm_ms"]
    for name, tally in extra["ln_code_flips"].items():
        (reports.get(name) or f32r[name]).entry["ln_code_flips"] = tally
        log(f"phase 3: {name}: LN codes vs the plain model's: "
            f"{tally['flipped']} of {tally['codes']} differ, by at most "
            f"{tally['max_step']}")
    k3m = k3.by_model()
    for model in ("swin_l", "swin_t"):
        m, cm = k3m[model], k3_sums[model]
        mm = extra["int_mm_ms"].get(model)
        log(f"phase 3: K3 at {model}'s shapes per forward: kernel "
            f"{m['ms']:.4f} ms (its cluster kernel alone {cm['ms']:.4f}), "
            f"torch._int_mm of the two products "
            f"{'n/a' if mm is None else f'{mm:.4f}'} ms, plain "
            f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']}); {m['bound_ms'] / m['ms']:.3f} of the bound "
            f"({smi})")
    # The W8A8 kernels' f32 branches: the int8 GEMM's f32 epilogues under
    # K1-int8 f32, the cluster kernel from codes and torch._int_mm under K3
    # f32.
    k1q32, k332 = f32r["fused_block_attn_int8_f32"], f32r["fused_mlp_int8_f32"]
    g32 = f32r["int8_gemm_f32"]
    k1q32.entry["int8_gemm"] = dict(
        g32.by_model()["swin_l"], source=g32.entry["source"],
        max_abs_err=g32.entry["max_abs_err"],
        mean_rel_err=g32.entry["mean_rel_err"], bitwise=True,
        library="torch._int_mm: the s32 product only, no dequant epilogue")
    cl32 = f32r["fused_mlp_int8_cluster_f32"]
    cl32_sums = cl32.by_model()
    k332.entry["cluster"] = dict(
        cl32_sums["swin_l"], source=cl32.entry["source"],
        max_abs_err=cl32.entry["max_abs_err"], bitwise=True,
        swin_t=cl32_sums["swin_t"])
    k332.entry["int_mm_ms"] = extra["int_mm_ms_f32"].get("swin_l")
    k332.entry["int_mm_ms_by_model"] = extra["int_mm_ms_f32"]
    for name, model, m, mm in (
            ("K1-int8 f32", "Swin-L", k1q32.by_model()["swin_l"],
             g32.by_model()["swin_l"]["library_ms"]),
            ("K1-int8 f32's int8 GEMMs", "Swin-L", g32.by_model()["swin_l"],
             g32.by_model()["swin_l"]["library_ms"]),
            ("K3 f32", "Swin-L", k332.by_model()["swin_l"],
             extra["int_mm_ms_f32"].get("swin_l")),
            ("K3 f32's cluster kernel", "Swin-L", cl32_sums["swin_l"],
             extra["int_mm_ms_f32"].get("swin_l")),
            ("K3 f32", "swin_t", k332.by_model()["swin_t"],
             extra["int_mm_ms_f32"].get("swin_t"))):
        log(f"phase 3: {name} per {model} forward: kernel {m['ms']:.4f} ms, "
            f"torch._int_mm of its products "
            f"{'n/a' if mm is None else f'{mm:.4f}'} ms, plain "
            f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']}); {m['bound_ms'] / m['ms']:.3f} of the bound "
            f"({smi})")
    for key, rep, lib in (
            ("bf16_gemm", gemm16,
             "F.linear: the bf16 product and bias, no GELU or residual"),
            ("ln_rows", rows16, "F.layer_norm: no pad zeroing")):
        rsums = rep.by_model()
        reports["fused_mlp"].entry[key] = dict(
            rsums["swin_l k2"], source=rep.entry["source"],
            max_abs_err=rep.entry["max_abs_err"],
            mean_rel_err=rep.entry["mean_rel_err"], library=lib,
            k1=rsums["swin_l k1"], swin_t=rsums["swin_t k2"])
        for model in ("swin_l k1", "swin_l k2", "swin_t k2"):
            m = rsums[model]
            log(f"phase 3: {key} at {model}'s shapes per forward: kernel "
                f"{m['ms']:.4f} ms, library {m['library_ms']:.4f} ms, plain "
                f"{m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
                f"({m['bound_by']}); {m['bound_ms'] / m['ms']:.3f} of the "
                f"bound ({smi})")
    for name, m in (("Swin-L attention core", sums),
                    ("swin_t K6", reports["flash_window_attn_qkv"].by_model()
                     ["swin_t"])):
        log(f"phase 3: {name} per forward: kernel {m['ms']:.4f} ms, SDPA "
            f"{m['library_ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms ({m['bound_by']}); kernel / SDPA "
            f"{m['ms'] / m['library_ms']:.3f} ({smi})")
    for name, r in (("D1 deform_im2col bf16", reports["deform_im2col"]),
                    ("D1 deform_im2col f32", f32r["deform_im2col_f32"])):
        m = r.by_model()["swin_l"]
        log(f"phase 3: {name} per Swin-L forward (20 sites): kernel "
            f"{m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms ({m['bound_by']}); "
            f"{m['bound_ms'] / m['ms']:.3f} of the bound; columns bitwise "
            f"the plain version's at every shape ({smi})")
    for name, m in (("K1-int8's int8 GEMMs", gemm_sums["swin_l"]),):
        lib = ("n/a" if m["library_ms"] is None
               else f"{m['library_ms']:.4f} ms")
        log(f"phase 3: {name} per forward: kernel {m['ms']:.4f} ms, "
            f"torch._int_mm (no epilogue) {lib}, plain {m['plain_ms']:.4f} "
            f"ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']}); "
            f"{m['bound_ms'] / m['ms']:.3f} of the bound ({smi})")

    frames = np.random.default_rng(42).integers(
        0, 256, size=(BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    frames_dev = torch.from_numpy(frames).to(dev)
    frames2_dev = torch.from_numpy(np.random.default_rng(43).integers(
        0, 256, size=(BATCH, SIZE, SIZE, 3), dtype=np.uint8)).to(dev)
    # The paths of earlier slices run regular mode, as bench.py's main path
    # does; ComputeConfig's default is deformable.
    bf16 = ComputeConfig(dtype=torch.bfloat16, use_flash_attention=True,
                         deform_mode="regular")
    int8 = bf16.with_overrides(int8_mlp=True, int8_attn=True)
    f32_tier = ComputeConfig(use_flash_attention=True, deform_mode="regular")
    f32_int8 = f32_tier.with_overrides(int8_mlp=True, int8_attn=True)
    names = list(reports)
    # Launches per make_infer_fn call, in the order of `reports` (K1,
    # K1-int8, K2, K3, row_ln, tap_conv, K6, K7, K8, D1). The f32 tier runs
    # the f32 kernels behind the same wrappers (no tap_conv: the decoder
    # runs it for bf16 only); regular mode runs no D1.
    paths = {
        "swin_l": {"swin_l bf16": (bf16, (48, 0, 48, 0, 16, 1, 0, 0, 0, 0)),
                   "swin_l int8": (int8, (8, 40, 8, 40, 16, 1, 0, 0, 0, 0)),
                   "swin_l f32": (f32_tier,
                                  (48, 0, 48, 0, 16, 0, 0, 0, 0, 0)),
                   "swin_l f32 int8": (f32_int8,
                                       (8, 40, 8, 40, 16, 0, 0, 0, 0, 0))},
        "swin_t": {"swin_t bf16": (bf16, (0, 0, 24, 0, 16, 1, 24, 0, 0, 0)),
                   "swin_t int8": (int8, (0, 0, 20, 4, 16, 1, 24, 0, 0, 0)),
                   "swin_t f32": (f32_tier,
                                  (0, 0, 24, 0, 16, 0, 24, 0, 0, 0)),
                   "swin_t f32 int8": (f32_int8,
                                       (0, 0, 20, 4, 16, 0, 24, 0, 0, 0))},
    }
    # Swin-L's deformable paths: the same kernels and D1 at its 20 sites.
    int8_def = int8.with_overrides(deform_mode="deformable")
    bf16_def = bf16.with_overrides(deform_mode="deformable")
    f32_def = f32_tier.with_overrides(deform_mode="deformable")
    deform_paths = {
        "swin_l int8 deformable": (int8_def,
                                   (8, 40, 8, 40, 16, 1, 0, 0, 0, 20)),
        "swin_l bf16 deformable": (bf16_def,
                                   (48, 0, 48, 0, 16, 1, 0, 0, 0, 20)),
        "swin_l f32 deformable": (f32_def,
                                  (48, 0, 48, 0, 16, 0, 0, 0, 0, 20))}
    cfgs = {"swin_l": BiRefNetConfig.swin_l(),
            "swin_t": BiRefNetConfig.for_backbone("swin_v1_t")}
    flat = {m: random_checkpoint(cfg, 0) for m, cfg in cfgs.items()}
    flat["swin_t"] = {k: v * REL_POS_BIAS_SCALE if k.endswith(
        "relative_position_bias_table") else v for k, v in flat["swin_t"].items()}
    params = {m: build_param_tree(flat[m], cfg) for m, cfg in cfgs.items()}
    del flat
    tiers = {m: {p: (c, dict(zip(names, w))) for p, (c, w) in ps.items()}
             for m, ps in paths.items()}
    deform_tiers = {p: (c, dict(zip(names, w)))
                    for p, (c, w) in deform_paths.items()}
    if any(len(w) != len(names) for ps in (*paths.values(), deform_paths)
           for _, w in ps.values()):
        fail(f"a path's launch counts do not name every kernel of {names}")

    # Swin-L: the int8 path against its bf16 tier, and the rolled-scale
    # negative control.
    errs, ref_feats = drive_model(torch, bmodel, pipeline, reports,
                                  cfgs["swin_l"], params["swin_l"], frames_dev,
                                  frames2_dev, tiers["swin_l"],
                                  plain_bf16=False,
                                  tf32_control=True)
    limit = int8_gate("swin_l int8", errs, "swin_l bf16")
    # Negative control: int8 scales rolled by one channel (every channel
    # dequantized with its neighbour's scale) must break the feature gate.
    rolled = tree_map(lambda k, v: torch.roll(v, 1) if k == "scale_q8" else v,
                      quantize_attn_int8(quantize_mlp_int8(params["swin_l"])))
    _, feats = with_features(bmodel, pipeline.make_infer_fn(
        rolled, cfgs["swin_l"], bf16, dev, as_uint8=False), frames_dev)
    if not max(feature_errors("swin_l rolled int8 scales", feats,
                              ref_feats)) > limit:
        fail("the feature gate does not see int8 scales rolled by one channel")
    # The f32 int8 path against the bf16 one, and the same rolled scales
    # on f32 activations as its control.
    limit = f32_int8_gate("swin_l f32 int8", errs, "swin_l int8")
    _, feats = with_features(bmodel, pipeline.make_infer_fn(
        rolled, cfgs["swin_l"], f32_tier, dev, as_uint8=False), frames_dev)
    worst = max(feature_errors("swin_l f32 rolled int8 scales", feats,
                               ref_feats))
    log(f"phase 4: swin_l f32 int8 with rolled int8 scales: worst feature "
        f"error {worst:.3e} (must break the gate {limit:.3e})")
    if not worst > limit:
        fail("the f32 int8 feature gate does not see int8 scales rolled by "
             "one channel")
    del rolled, feats, ref_feats

    # swin_t: the bf16 kernel tier against the plain bf16 pipeline stage by
    # stage, the int8 flags against the bf16 tier, and a rel-pos bias
    # rolled by one head as the negative control.
    errs, ref_feats = drive_model(torch, bmodel, pipeline, reports,
                                  cfgs["swin_t"], params["swin_t"], frames_dev,
                                  frames2_dev, tiers["swin_t"], plain_bf16=True)
    ratio = stage_ratio(errs["swin_t bf16"], errs["plain bf16"])
    log(f"phase 4: swin_t bf16 kernel tier's feature error, stage by stage, at "
        f"most {ratio:.3f} x the plain bf16 pipeline's (gate <= "
        f"{FEATURE_RATIO_T})")
    if not ratio <= FEATURE_RATIO_T:
        fail(f"swin_t kernel-tier features {ratio} x the plain bf16 error")
    int8_gate("swin_t int8", errs, "swin_t bf16")
    f32_int8_gate("swin_t f32 int8", errs, "swin_t int8")
    rolled = tree_map(lambda k, v: torch.roll(v, 1, 0) if k == "cached_bias"
                      else v, params["swin_t"])
    _, feats = with_features(bmodel, pipeline.make_infer_fn(
        rolled, cfgs["swin_t"], bf16, dev, as_uint8=False), frames_dev)
    bad = stage_ratio(feature_errors("swin_t rolled rel-pos bias", feats,
                                     ref_feats), errs["plain bf16"])
    log(f"phase 4: swin_t with the rel-pos bias rolled by one head: {bad:.3f} x "
        f"the plain bf16 error (must break the gate {FEATURE_RATIO_T})")
    if not bad > FEATURE_RATIO_T:
        fail("the feature gate does not see a rel-pos bias rolled by one head")
    del rolled, feats, ref_feats

    # Swin-L in deformable mode, offset convs scaled: each path's 20 site
    # outputs against the f32 plain deformable pipeline's, regular mode as
    # the control.
    def_tree = scale_offset_convs(params["swin_l"], OFFSET_SCALE)
    deform_results = drive_deformable(torch, bmodel, pipeline, reports,
                                      cfgs["swin_l"], def_tree, frames_dev,
                                      frames2_dev, deform_tiers)
    for r in reports.values():
        r.finish("api" if r in (reports["flash_window_attn_masked"],
                                reports["flash_window_attn_plain"])
                 else r.main_path.split()[0])
    # The f32 entries count the launches of the wrapper they share with
    # their bf16 entry, on every path (their own: "swin_l f32", "swin_t f32").
    for name, r in f32r.items():
        if r.main_path is None:
            continue
        base = reports[name[:-len("_f32")]]
        r.entry["launches_by_path"] = dict(base.entry["launches_by_path"])
        r.finish("api" if "masked" in name or "plain" in name
                 else r.main_path.split()[0])

    golden = os.path.join(ROOT, "tests", "goldens", "logits_jax.npy")
    golden_cfg = BiRefNetConfig.swin_l()
    params_golden = to_device(build_param_tree(random_checkpoint(golden_cfg, 7),
                                               golden_cfg), dev)
    xg = (np.random.default_rng(0).normal(size=(1, 64, 64, 3)) * 0.5).astype(
        np.float32)
    # The golden is the JAX package's deformable forward: regular mode
    # holds 5e-4 as before, deformable mode the JAX package's own 5e-5.
    for name, compute, bound in (
            ("plain", ComputeConfig(deform_mode="regular"), 5e-4),
            ("kernel tier", f32_tier, 5e-4),
            ("plain deformable", ComputeConfig(), 5e-5),
            ("kernel tier deformable", f32_def, 5e-5)):
        with torch.inference_mode(), pipeline.full_f32():
            logits = bmodel.forward_logits(params_golden, golden_cfg,
                                           torch.from_numpy(xg).to(dev),
                                           compute)
        diff = np.abs(logits.cpu().numpy() - np.load(golden))
        log(f"phase 4: f32 {name} 64^2 logits vs JAX golden: max|diff| "
            f"{diff.max():.3e} (bound {bound})")
        if not diff.max() < bound:
            fail(f"f32 {name} golden logits differ by {diff.max()}")
    del params_golden

    rng = np.random.default_rng(7)
    sizes = [(720, 1280), (1024, 1024), (480, 640), (1500, 900)]
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    serve_paths = [(model, path, compute, params[model])
                   for model, model_tiers in tiers.items()
                   for path, (compute, _) in model_tiers.items()]
    serve_paths.append(("swin_l", "swin_l int8 deformable", int8_def,
                        def_tree))
    for model, path, compute, tree in serve_paths:
        serve_infer = pipeline.make_infer_fn(tree, cfgs[model], compute, dev,
                                             out_size=(SIZE, SIZE))
        served = serve.segment(serve_infer, images, SIZE, BATCH)
        got = [m.shape for m in served]
        log(f"phase 5: {path}: served {len(served)} requests, mask shapes "
            f"{got}")
        if got != sizes or any(m.dtype != np.uint8 for m in served):
            fail(f"{path}: served mask shapes {got} != {sizes}")
        del serve_infer

    # Each tier's function graphed and its eager body, 5 calls each in
    # turns, one function at a time (each graph keeps its own memory pool),
    # the tiers in order and then in reverse.
    plain_bf16 = ComputeConfig(dtype=torch.bfloat16, deform_mode="regular")
    summary = {}
    for model in MODELS:
        tiers6 = {f"{model} int8 path": int8,
                  f"{model} bf16 kernel tier": bf16,
                  f"{model} plain bf16": plain_bf16}
        if model == "swin_l":
            tiers6.update({f"{model} f32 kernel tier": f32_tier,
                           f"{model} plain f32": ComputeConfig(
                               deform_mode="regular"),
                           f"{model} f32 int8 path": f32_int8,
                           f"{model} int8 path deformable": int8_def,
                           f"{model} f32 kernel tier deformable": f32_def})
        for name in list(tiers6) + list(tiers6)[::-1]:
            fn = pipeline.make_infer_fn(params[model], cfgs[model],
                                        tiers6[name], dev)
            fn(frames_dev)
            fn.eager(frames_dev)
            torch.cuda.synchronize()
            ms = {"graphed": [], "eager": []}
            for _ in range(5):
                for how, call in (("graphed", fn), ("eager", fn.eager)):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    call(frames_dev)
                    end.record()
                    torch.cuda.synchronize()
                    ms[how].append(start.elapsed_time(end))
            key = (tuple(frames_dev.shape), frames_dev.dtype)
            parts = []
            for how, v in ms.items():
                summary.setdefault(name, {}).setdefault(how, []).extend(v)
                med = sorted(v)[len(v) // 2]
                parts.append(f"{how} median {med:.2f} ms "
                             f"({BATCH / med * 1e3:.2f} img/s), spread "
                             f"{min(v):.2f}-{max(v):.2f}")
            log(f"phase 6: {name}: {'; '.join(parts)} per batch of {BATCH}; "
                f"graph pool {fn.pool_bytes[key] / 2**30:.2f} GiB ({smi})")
            del fn
    for name, by_how in summary.items():
        log(f"phase 6: {name} over both turns (10 calls each): " + "; ".join(
            f"{how} median {sorted(v)[len(v) // 2]:.2f} ms, spread "
            f"{(max(v) - min(v)) / sorted(v)[len(v) // 2]:.3f}"
            for how, v in by_how.items()) + f" ({smi})")
    log(f"phase 6: max allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # Phase 7: one profiled replay of the Swin-L int8 path's graph and one
    # profiled eager call (tools/gpu_profile.py). Where the profiler resolves
    # the graph's kernels, their launches per group must match what the
    # capture counted.
    import gpu_profile
    from birefnet_tpu_torch.utils import profiling
    fn = pipeline.make_infer_fn(params["swin_l"], cfgs["swin_l"], int8, dev)
    fn(frames_dev)
    cap = fn.launches[(tuple(frames_dev.shape), frames_dev.dtype)]
    got = gpu_profile.profile_call(torch, fn, frames_dev, "swin_l int8 graphed",
                                   smi, top=12)
    eager = gpu_profile.profile_call(torch, fn.eager, frames_dev,
                                     "swin_l int8 eager", smi, top=0)
    log(f"phase 7: swin_l int8 path, one profiled call: graphed wall "
        f"{got['wall_ms']:.2f} ms, device {got['device_ms']:.2f} ms, idle "
        f"share {got['idle']:.3f}; eager wall {eager['wall_ms']:.2f} ms, "
        f"device {eager['device_ms']:.2f} ms, idle share {eager['idle']:.3f} "
        f"({smi})")
    top = profiling.device_op_profile(fn, frames_dev, iters=2)
    if not top:
        fail("phase 7: utils/profiling.device_op_profile found no kernel")
    log(f"phase 7: utils/profiling.device_op_profile of the replay, device "
        f"ms per call of the 5 costliest of {len(top)} kernels: " + "; ".join(
            f"{ms:.3f} x{n:g} {name[:60]}" for ms, n, name in top[:5]))
    k1 = cap.get("fused_block_attn.fused_window_block_attention", 0)
    k1q = cap.get("fused_block_attn.fused_window_block_attention_int8", 0)
    k2 = cap.get("fused_mlp.fused_mlp_residual", 0)
    k3 = cap.get("fused_mlp.fused_mlp_residual_int8", 0)
    want_groups = {
        "K1 attention core (bf16 and int8 routes)": k1 + k1q,
        "K1-int8 int8 GEMM, bf16 out (qkv)": k1q,
        "K1-int8 int8 GEMM + residual (proj)": k1q,
        "K1-int8 row quantization": 2 * k1q,
        "K3 cluster kernel (fc1, GELU, int8 hidden, fc2)": k3,
        "K3 LN2 row quantization": k3,
        "K1 bf16 GEMM (qkv)": k1,
        "K1/K2 bf16 GEMM + residual (proj, fc2)": k1 + k2,
        "K2 bf16 GEMM + GELU (fc1)": k2,
        "K1 bf16 LN1 rows (pads zeroed)": k1,
        "K2 bf16 LN2 rows": k2,
        "K4 row_ln": cap.get("row_ln.layer_norm_rows", 0),
        "K5 tap_conv": cap.get("tap_conv.tap_conv_same", 0)}
    if got["device_ms"] == 0:
        log("phase 7: the profiler resolved no kernel of the replayed graph; "
            "its counts per group are not checked")
    else:
        seen = {g: got["groups"].get(g, [0.0, 0])[1] for g in want_groups}
        log(f"phase 7: launches per group in the replay: {seen}")
        if seen != want_groups:
            fail(f"the replay's kernels per group {seen} != the capture's "
                 f"{want_groups}")
        eager_seen = {g: eager["groups"].get(g, [0.0, 0])[1]
                      for g in want_groups}
        if eager_seen != want_groups:
            fail(f"the eager call's kernels per group {eager_seen} != "
                 f"{want_groups}")
    del fn

    # Phase 8: training (train.py, finetune.py, D1b).
    d1b, train_results = train_phase(torch, dev, pipeline, cfgs["swin_l"],
                                     def_tree, frames_dev, smi)
    log(f"phase 8: train results {json.dumps(train_results)}")

    # Phase 9: the entry points (serve.main, cli.main, evaluate.main).
    torch.cuda.empty_cache()
    log(f"phase 9: results {json.dumps(entry_points_phase(torch, dev, smi))}")

    reports["deform_im2col"].entry["deformable_gates"] = deform_results
    f32_entries = [r.entry for r in f32r.values() if r.main_path is not None]
    print(json.dumps({"kernels": [r.entry for r in reports.values()]
                      + f32_entries + [d1b]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
