"""Training step for the PyTorch port: structure loss, AdamW, one device.

Counterpart of birefnet_tpu/train.py. It trains the inference tree (folded
BatchNorm `scale`/`shift` and the windows' `cached_bias` are leaves, as in
the JAX package) with the upstream BiRefNet objective, the F3Net
"structure loss" (edge-weighted BCE plus weighted soft IoU), through the
same forward the pipeline runs, in f32:

- `validate_train_compute` refuses the kernel flags (the hand-written
  kernels compute forward values only), forces f32 activations and sets
  `differentiable`, which keeps the decoder head off the tap-conv kernel.
  Deformable mode stays: its sampling has a backward kernel of its own on
  the card (D1b, ops/deform_conv.py), and autograd differentiates its
  plain version on the CPU;
- the optimizer is optax's arithmetic written on the tree of tensors, not
  torch.optim's: clip_by_global_norm, then AdamW (eps 1e-8, eps_root 0,
  bias correction with count + 1, decoupled decay on every leaf) at the
  learning rate schedule(count) of the update's count before it, so a
  warmup's first update is zero; `backbone_lr_scale` gives the "bb"
  subtree its own AdamW at the scaled rate, and 0 sets its updates to zero
  and keeps no moments for it (optax.set_to_zero);
- `accum_steps` runs that many microbatches in turn and applies one update
  on the mean loss and the mean gradients;
- the forward and the backward run with PyTorch's TF32 flags off
  (`pipeline.full_f32`), the JAX package's precision=HIGHEST.

Data parallelism: with `process_group` the step runs as one rank of a
torch.distributed group (parallel/ranks.py): each rank runs its rows of
each microbatch, one all-reduce averages the gradients and the loss, and
every rank applies the same update to its replicated state. The JAX step's
sharding arguments (`in_sharding`, `param_sharding`: FSDP over a TPU mesh)
and `split_update` (two programs, a workaround for the TPU's
remote-compile memory cap) are not ported: a value other than the default
raises. `donate` keeps its meaning: with donate=True the step updates the
state's tensors in place.

Loss reference (behavioral): ZhengPeng7/BiRefNet `loss.py` structure_loss,
weit = 1 + 5*|avg_pool31(gt) - gt| with torch's avg_pool2d default
count_include_pad=True.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .configs import BiRefNetConfig, ComputeConfig
from .models import birefnet
from .pipeline import full_f32

_NOT_PORTED = {
    "in_sharding": "FSDP over a TPU mesh is not ported: pass process_group= "
                   "for data-parallel training (replicated state, all-reduced "
                   "gradients)",
    "param_sharding": "FSDP over a TPU mesh is not ported: pass "
                      "process_group= for data-parallel training (replicated "
                      "state, all-reduced gradients)",
    "split_update": "the two-program step, a workaround for the TPU's "
                    "remote-compile memory cap, is not ported",
}


def validate_train_compute(compute: ComputeConfig) -> ComputeConfig:
    """Refuse forward-only compute paths; force f32 and `differentiable`.

    The hand-written kernels of the kernel tier and of the int8 path have
    no backward; training runs their plain versions. bf16 requests are
    demoted to f32 (the JAX package trains f32: its bf16 path's mixed
    precision has no transpose)."""
    bad = [name for name in ("use_flash_attention", "int8_mlp", "int8_attn")
           if getattr(compute, name)]
    if bad:
        raise ValueError(
            f"ComputeConfig flags {bad} select forward-only kernels (no "
            f"backward); turn them off for training. The plain PyTorch "
            f"paths they replace are differentiable.")
    if compute.dtype != torch.float32:
        compute = compute.with_overrides(dtype=torch.float32)
    return compute.with_overrides(differentiable=True)


def structure_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Edge-weighted BCE + soft IoU (upstream structure_loss), mean over B.

    logits: [B, H, W] or [B, H, W, 1] raw logits; labels: the same shape,
    float masks in [0, 1]."""
    if logits.ndim == 4:
        logits = logits[..., 0]
    if labels.ndim == 4:
        labels = labels[..., 0]
    logits, labels = logits.float(), labels.float()
    pooled = F.avg_pool2d(labels[:, None], 31, stride=1, padding=15,
                          count_include_pad=True)[:, 0]
    weit = 1.0 + 5.0 * torch.abs(pooled - labels)
    # Stable BCE-with-logits: max(x, 0) - x z + log1p(exp(-|x|)).
    bce = (torch.clamp_min(logits, 0.0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    wbce = (weit * bce).sum(dim=(1, 2)) / weit.sum(dim=(1, 2))
    pred = torch.sigmoid(logits)
    inter = (pred * labels * weit).sum(dim=(1, 2))
    union = ((pred + labels) * weit).sum(dim=(1, 2))
    wiou = 1.0 - (inter + 1.0) / (union - inter + 1.0)
    return (wbce + wiou).mean()


# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------

def flatten(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) of every tensor of a nested dict, paths joined by "/",
    in the dict's order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += flatten(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def unflatten(items) -> Dict:
    """The nested dict of (path, leaf) pairs."""
    tree: Dict = {}
    for path, leaf in items:
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


# ---------------------------------------------------------------------------
# Configuration, schedule, optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5      # upstream BiRefNet finetune lr
    weight_decay: float = 1e-2
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 10.0          # global-norm clip
    # "constant" (a linear warmup over warmup_steps if set), or "cosine":
    # linear warmup, then cosine decay to 0 at total_steps.
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0
    # Microbatches per update: a batch of accum_steps * B frames runs as
    # accum_steps forward and backward passes of B frames in turn (the
    # activations of one microbatch live at a time) and one update on the
    # mean gradients.
    accum_steps: int = 1
    # Learning-rate multiplier of the Swin backbone (params["bb"]): 1.0 one
    # AdamW for all; 0.0 freezes the backbone (no updates, no moments).
    backbone_lr_scale: float = 1.0


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _linear_schedule(init: float, end: float, steps: int):
    """optax.linear_schedule, in f32."""
    def fn(count: int):
        frac = 1 - _f32(min(max(count, 0), steps)) / _f32(steps)
        return _f32(init - end) * frac + _f32(end)
    return fn


def _cosine_decay(peak: float, steps: int):
    """optax.cosine_decay_schedule with alpha 0 and exponent 1, in f32."""
    def fn(count: int):
        c = _f32(min(count, steps))
        decay = 0.5 * (1 + torch.cos(_f32(math.pi) * c / _f32(steps)))
        return _f32(peak) * decay
    return fn


def lr_schedule(tcfg: TrainConfig) -> Callable[[int], object]:
    """The learning rate of an update, by the count of updates before it,
    as optax computes it (a Python float for the constant schedule, else an
    f32 scalar tensor)."""
    if tcfg.schedule == "constant":
        if tcfg.warmup_steps:
            return _linear_schedule(0.0, tcfg.learning_rate,
                                    tcfg.warmup_steps)
        return lambda count: tcfg.learning_rate
    if tcfg.schedule == "cosine":
        if tcfg.total_steps <= tcfg.warmup_steps:
            raise ValueError(
                f"cosine schedule needs total_steps > warmup_steps; got "
                f"{tcfg.total_steps} <= {tcfg.warmup_steps}")
        warm = _linear_schedule(0.0, tcfg.learning_rate, tcfg.warmup_steps)
        decay = _cosine_decay(tcfg.learning_rate,
                              tcfg.total_steps - tcfg.warmup_steps)
        return lambda count: (warm(count) if count < tcfg.warmup_steps
                              else decay(count - tcfg.warmup_steps))
    raise ValueError(f"unknown schedule: {tcfg.schedule!r}")


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule)) on
    trees of tensors, with the backbone's own AdamW (or none) under
    `backbone_lr_scale`; see the module docstring.

    State: {"count": int32 scalar, "mu": tree, "nu": tree}; mu and nu lack
    "bb" when the backbone is frozen. `update` updates the moments in
    place and returns the updates and the state with the new count."""

    def __init__(self, tcfg: TrainConfig):
        self.tcfg = tcfg
        self.schedule = lr_schedule(tcfg)
        self.scale = tcfg.backbone_lr_scale

    def _trained(self, path: str) -> bool:
        return self.scale != 0.0 or path.split("/", 1)[0] != "bb"

    def init(self, params) -> Dict:
        leaves = [(k, v) for k, v in flatten(params) if self._trained(k)]
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": unflatten((k, torch.zeros_like(v)) for k, v in leaves),
                "nu": unflatten((k, torch.zeros_like(v)) for k, v in leaves)}

    def _step_size(self, count: int, scale: float) -> float:
        lr = self.schedule(count)
        if scale != 1.0:
            lr = lr * scale
        # optax: jnp.array(-lr, dtype=f32) * update.
        lr = lr if isinstance(lr, torch.Tensor) else _f32(lr)
        return float(-lr)

    def update(self, grads, opt_state, params):
        """(updates, opt_state) for the gradient tree `grads` (unclipped)."""
        t = self.tcfg
        keys, g = zip(*flatten(grads))
        g = list(g)
        g_norm = global_norm(g)
        if not bool(g_norm < t.grad_clip):
            g = [(x / g_norm) * t.grad_clip for x in g]
        count = int(opt_state["count"])
        p = dict(flatten(params))
        mu, nu = dict(flatten(opt_state["mu"])), dict(flatten(opt_state["nu"]))
        dev = g[0].device
        # 1 - b**(count + 1) in f32, as optax's bias correction.
        bc1 = (1 - _f32(t.b1) ** (count + 1)).to(dev)
        bc2 = (1 - _f32(t.b2) ** (count + 1)).to(dev)
        updates = {}
        groups = {}
        for k, x in zip(keys, g):
            if not self._trained(k):
                updates[k] = torch.zeros_like(x)
                continue
            scale = self.scale if k.split("/", 1)[0] == "bb" else 1.0
            groups.setdefault(scale, []).append((k, x))
        for scale, items in groups.items():
            ks = [k for k, _ in items]
            gs = [x for _, x in items]
            m_, v_ = [mu[k] for k in ks], [nu[k] for k in ks]
            torch._foreach_mul_(m_, t.b1)
            torch._foreach_add_(m_, torch._foreach_mul(gs, 1 - t.b1))
            torch._foreach_mul_(v_, t.b2)
            torch._foreach_add_(v_, torch._foreach_mul(
                torch._foreach_mul(gs, gs), 1 - t.b2))
            denom = torch._foreach_div(v_, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, 1e-8)
            u = torch._foreach_div(m_, bc1)
            torch._foreach_div_(u, denom)
            if t.weight_decay:
                torch._foreach_add_(u, torch._foreach_mul(
                    [p[k] for k in ks], t.weight_decay))
            torch._foreach_mul_(u, self._step_size(count, scale))
            updates.update(zip(ks, u))
        new_state = dict(opt_state, count=opt_state["count"] + 1)
        return unflatten((k, updates[k]) for k in keys), new_state


def make_optimizer(tcfg: TrainConfig) -> AdamW:
    return AdamW(tcfg)


def apply_updates(params, updates) -> None:
    """params += updates, leaf by leaf, in place."""
    p = [v for _, v in flatten(params)]
    torch._foreach_add_(p, [v for _, v in flatten(updates)])


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """Parameters, optimizer state (moments and count) and step count."""
    params: Dict
    opt_state: Dict
    step: torch.Tensor


def init_train_state(params, tcfg: TrainConfig = TrainConfig()) -> TrainState:
    opt = make_optimizer(tcfg)
    return TrainState(params=params, opt_state=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32))


def _state_items(state: TrainState):
    return (flatten(state.params, "params/")
            + flatten(state.opt_state, "opt_state/") + [("step", state.step)])


def save_train_state(path: str, state: TrainState) -> None:
    """Write a TrainState (params, AdamW moments and count, step) to one
    safetensors file keyed by tree path; a load gives it back bit for
    bit."""
    from safetensors.numpy import save_file

    save_file({k: v.detach().cpu().contiguous().numpy()
               for k, v in _state_items(state)}, path)


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Load a TrainState written by save_train_state. `template` (e.g.
    init_train_state(init_params(cfg), tcfg)) gives the structure, the
    dtypes and the devices; keys must match both ways and shapes exactly."""
    from safetensors.numpy import load_file

    tensors = load_file(path)
    items = _state_items(template)
    names = [k for k, _ in items]
    missing = [k for k in names if k not in tensors]
    extra = sorted(set(tensors) - set(names))
    if missing or extra:
        raise ValueError(
            f"train state mismatch: {len(missing)} missing (first: "
            f"{missing[:3]}), {len(extra)} extra (first: {extra[:3]})")
    loaded = []
    for k, tmpl in items:
        arr = tensors[k]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{k}: shape {tuple(arr.shape)} != template "
                             f"{tuple(tmpl.shape)}")
        loaded.append((k, torch.from_numpy(arr).to(tmpl.device, tmpl.dtype)))
    tree = unflatten(loaded)
    return TrainState(params=tree["params"], opt_state=tree["opt_state"],
                      step=tree["step"])


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def all_reduce_mean(loss: torch.Tensor, grads: List[torch.Tensor],
                    group) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The mean of (loss, grads) over the ranks of `group`: one all-reduce
    (sum) of one flat f32 bucket holding every gradient and the loss, then
    a divide by the world size. The returned gradients are views of the
    bucket."""
    import torch.distributed as dist

    bucket = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
    bucket.div_(dist.get_world_size(group))
    parts = bucket.split([g.numel() for g in grads] + [1])
    return parts[-1].reshape(()), [p.view_as(g) for p, g in zip(parts, grads)]


def make_train_step(
    cfg: BiRefNetConfig,
    compute: ComputeConfig = ComputeConfig(),
    tcfg: TrainConfig = TrainConfig(),
    in_sharding=None,
    donate: bool = True,
    param_sharding=None,
    split_update: Optional[bool] = None,
    process_group=None,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], tuple]:
    """step(state, x, labels) -> (state', {"loss", "grad_norm"}), where x is
    the normalized [B, H, W, 3] image (pipeline.preprocess) and labels the
    [B, H, W] masks in [0, 1], on the state's device. With accum_steps = k,
    B is k microbatches. donate=True updates the state's tensors in place
    (the state passed in is then the state returned); donate=False leaves
    them untouched.

    With `process_group` (a torch.distributed group of W ranks) x and
    labels are this rank's rows, sharding.rank_rows of the global batch:
    the rank-th 1/W of each microbatch, in microbatch order. After the
    microbatches, one all-reduce sums the rank's mean gradients and loss
    over the ranks in one flat f32 bucket, divided by W; only then come the
    clip and AdamW, so every rank sees the global norm and applies the same
    update to its replicated state. A group of one rank gives bitwise the
    step without one. State is replicated, not FSDP-sharded as in the JAX
    package: Swin-L's parameters, gradients and two AdamW moments are 3.5
    GB in f32, beside 80 GB on an H100."""
    for name, value in (("in_sharding", in_sharding),
                        ("param_sharding", param_sharding),
                        ("split_update", split_update)):
        if value is not None:
            raise NotImplementedError(f"make_train_step({name}=...): "
                                      f"{_NOT_PORTED[name]}")
    compute = validate_train_compute(compute)
    opt = make_optimizer(tcfg)
    accum = tcfg.accum_steps
    if accum < 1:
        raise ValueError(f"accum_steps must be >= 1; got {accum}")

    def loss_and_grads(params, x, labels):
        keys, leaves = zip(*flatten(params))
        with torch.enable_grad():
            live = [t.detach().requires_grad_(True) for t in leaves]
            logits = birefnet.forward_logits(unflatten(zip(keys, live)), cfg,
                                             x, compute)
            loss = structure_loss(logits, labels)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        # Leaves the forward never reads (the gdt_convs_pred convs, kept for
        # the checkpoint's schema) get zeros, as jax.grad gives them.
        grads = [torch.zeros_like(t) if gr is None else gr
                 for t, gr in zip(leaves, grads)]
        return loss.detach(), list(grads), keys

    def step(state: TrainState, x: torch.Tensor, labels: torch.Tensor):
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"accum_steps {accum}")
        if not donate:
            state = TrainState(*(
                unflatten((k, v.clone()) for k, v in flatten(t))
                if isinstance(t, dict) else t.clone() for t in state))
        with full_f32():
            if accum == 1:
                loss, grads, keys = loss_and_grads(state.params, x, labels)
            else:
                xm = x.reshape(accum, x.shape[0] // accum, *x.shape[1:])
                ym = labels.reshape(accum, labels.shape[0] // accum,
                                    *labels.shape[1:])
                loss, grads = None, None
                for i in range(accum):
                    li, gi, keys = loss_and_grads(state.params, xm[i], ym[i])
                    loss = li if loss is None else loss + li
                    grads = gi if grads is None else torch._foreach_add(
                        grads, gi)
                inv = 1.0 / accum
                loss = loss * inv
                grads = torch._foreach_mul(grads, inv)
            if process_group is not None:
                loss, grads = all_reduce_mean(loss, grads, process_group)
            with torch.no_grad():
                grad_tree = unflatten(zip(keys, grads))
                updates, opt_state = opt.update(grad_tree, state.opt_state,
                                                state.params)
                apply_updates(state.params, updates)
                gnorm = global_norm(grads)
        new_state = TrainState(params=state.params, opt_state=opt_state,
                               step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


def rank_step(rank: int, world: int, device: torch.device,
              cfg: BiRefNetConfig, compute: ComputeConfig, tcfg: TrainConfig,
              checkpoint: str, x, labels, out: str) -> None:
    """One data-parallel step as rank `rank` of `world`, a
    parallel.ranks.spawn rank function: the tree of the safetensors
    `checkpoint` on `device`, a fresh train state, and one make_train_step
    call in the default group on the rank's rows (sharding.rank_rows) of
    the global batch, x the normalized [B, H, W, 3] and labels the
    [B, H, W] masks (numpy). Rank 0 saves the new state to `out`
    (save_train_state); every rank writes its loss, grad norm and peak
    device memory (CUDA only, else null) to `out`.rank<r>.json."""
    import json

    import numpy as np
    import torch.distributed as dist

    from .params import load_checkpoint
    from .parallel.sharding import rank_rows

    rows = rank_rows(x.shape[0], tcfg.accum_steps, rank, world)
    state = init_train_state(load_checkpoint(checkpoint, cfg, device=device),
                             tcfg)
    step = make_train_step(cfg, compute, tcfg, process_group=dist.group.WORLD)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, metrics = step(state, torch.from_numpy(np.ascontiguousarray(
        x[rows])).to(device), torch.from_numpy(np.ascontiguousarray(
            labels[rows])).to(device))
    if rank == 0:
        save_train_state(out, state)
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump({"loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "peak_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None)}, f)
