"""Training in the port (birefnet_tpu_torch/train.py) against the JAX package.

The same inputs, made from a seed with numpy, go through the JAX package
(birefnet_tpu/train.py, optax) and the port, on the CPU:

- structure_loss on odd shapes: |port - jax| <= 1e-5 * |jax|;
- the learning-rate schedules over 50 counts (constant, warmup, cosine):
  |port - optax| <= 1e-6 * the peak rate (f32 cos and divisions may round
  apart by an ulp);
- three optimizer updates on a small tree, clip on and off,
  backbone_lr_scale 1, 0.5 and 0: every leaf within OPT_BOUND x its max
  |optax| after each update (read at most 1.1e-7: the global norms sum in
  another order);
- the gradients of the whole model, swin_v1_t at 64^2, batch 2, f32,
  deformable, offset convs scaled x20 (as tests/test_torch_deform.py) so
  that offsets reach several pixels: the loss within LOSS_BOUND relative,
  every leaf within LEAF_BOUND x its max |JAX grad|, the whole gradient's
  relative L2 within L2_BOUND. Regular mode and a (dy, dx) swap in the
  sampling must break the offset-conv leaves' bound. JAX's gradients come
  from one jit of jax.value_and_grad, shared by the module;
- one make_train_step with accum_steps=2 against JAX's: every leaf of the
  params after the step within STEP_BOUND x the learning rate plus one f32
  ulp of the leaf's largest value of JAX's (Adam's first step moves every
  leaf by about the rate, so this bounds the step's error relative to its
  size);
- D1b's plain version (autograd through the plain columns) against JAX's
  VJP of its columns, at tests/test_ops.py's shapes;
- the train state's save and load, the refusals, serving then training
  in one process, and `remat_blocks`.
The measured values are in CHANGES.md.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import birefnet_tpu as bt
from birefnet_tpu import train as jtrain
from birefnet_tpu.ops import deform_conv as jdeform
import birefnet_tpu_torch as pt
from birefnet_tpu_torch import pipeline, train
from birefnet_tpu_torch.models import aspp as paspp
from birefnet_tpu_torch.models import birefnet as pmodel
from birefnet_tpu_torch.models import decoder as pdec
from birefnet_tpu_torch.ops.kernels import build
from birefnet_tpu_torch.ops.kernels import deform_im2col as d1

OFFSET_SCALE = 20.0
OPT_BOUND = 1e-6
LOSS_BOUND = 1e-5
LEAF_BOUND = 1e-3
L2_BOUND = 1e-4
STEP_BOUND = 1e-3
COL2IM_BOUND = 1e-5
F32_EPS = float(np.finfo(np.float32).eps)
LR = 1e-4
CFG_J = dataclasses.replace(bt.BiRefNetConfig.for_backbone("swin_v1_t"),
                            size=(64, 64))
CFG_P = dataclasses.replace(pt.BiRefNetConfig.for_backbone("swin_v1_t"),
                            size=(64, 64))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch CPU work, restored
    after it. The suite runs in several worker processes at once, and the
    default (one thread per core in each) oversubscribes the cores: these
    small forwards and backwards then ran 50x slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    """The offset-scaled flat checkpoint, a batch of 2 frames and masks (a
    disk and noise)."""
    flat = {k: v * OFFSET_SCALE if ".offset_conv." in k else v
            for k, v in bt.random_checkpoint(CFG_J, 0).items()}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    yy, xx = np.mgrid[:64, :64]
    y = np.stack([(yy - 30) ** 2 + (xx - 34) ** 2 < 18 ** 2,
                  rng.random((64, 64)) > 0.5]).astype(np.float32)
    return flat, x, y


@pytest.fixture(scope="module")
def jax_grads(case):
    """JAX's loss and gradients (as a port tree of tensors)."""
    flat, x, y = case
    compute = jtrain.validate_train_compute(bt.ComputeConfig())

    def loss_fn(p, x, y):
        return jtrain.structure_loss(
            bt.birefnet.forward_logits(p, CFG_J, x, compute), y)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        bt.params.build_param_tree(flat, CFG_J), jnp.asarray(x),
        jnp.asarray(y))
    return float(loss), pt.from_jax_params(jax.tree.map(np.asarray, grads))


def _port_grads(flat, x, y, compute=pt.ComputeConfig()):
    params = pt.build_param_tree(flat, CFG_P)
    keys, leaves = zip(*train.flatten(params))
    live = [t.requires_grad_(True) for t in leaves]
    compute = train.validate_train_compute(compute)
    with pipeline.full_f32():
        logits = pmodel.forward_logits(
            train.unflatten(zip(keys, live)), CFG_P, torch.from_numpy(x),
            compute)
        loss = train.structure_loss(logits, torch.from_numpy(y))
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return float(loss.detach()), {k: torch.zeros_like(t) if g is None else g
                                  for k, t, g in zip(keys, live, grads)}


def _leaf_errors(want_tree, got):
    """{path: max|got - want| / max|want|} and the relative L2 of all."""
    errs, num, den = {}, 0.0, 0.0
    for k, want in train.flatten(want_tree):
        w, g = want.double(), got[k].double()
        scale = float(w.abs().max())
        errs[k] = float((g - w).abs().max()) / scale if scale else float(
            g.abs().max())
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return errs, (num / den) ** 0.5


# ---------------------------------------------------------------------------
# Loss, schedule, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 40, 44), (1, 33, 57, 1)])
def test_structure_loss_matches_jax(shape):
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=shape) * 3.0).astype(np.float32)
    mask = (rng.random(size=shape) > 0.5).astype(np.float32)
    want = float(jtrain.structure_loss(jnp.asarray(logits), jnp.asarray(mask)))
    got = float(train.structure_loss(torch.from_numpy(logits),
                                     torch.from_numpy(mask)))
    assert abs(got - want) <= LOSS_BOUND * abs(want), (got, want)


@pytest.mark.parametrize("kind", [
    dict(),
    dict(warmup_steps=10),
    dict(schedule="cosine", warmup_steps=10, total_steps=40),
])
def test_lr_schedule_matches_optax(kind):
    want = jtrain.lr_schedule(jtrain.TrainConfig(learning_rate=1e-4, **kind))
    got = train.lr_schedule(train.TrainConfig(learning_rate=1e-4, **kind))
    for count in range(50):
        w = float(want(jnp.asarray(count, jnp.int32)))
        g = float(got(count))
        assert abs(g - w) <= OPT_BOUND * 1e-4, (count, g, w)
    if kind.get("warmup_steps"):
        assert float(got(0)) == 0.0  # a warmup's first update is zero


def _toy_tree(rng):
    return {"bb": {"a": rng.normal(size=(4, 3)).astype(np.float32),
                   "b": rng.normal(size=(5,)).astype(np.float32)},
            "decoder": {"w": rng.normal(size=(2, 3, 3)).astype(np.float32)}}


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("clip", [10.0, 0.5])
def test_optimizer_matches_optax(clip, scale):
    """Three updates, the second with gradients 30x larger (the clip at 10
    acts there only, at 0.5 on every update)."""
    rng = np.random.default_rng(3)
    tree = _toy_tree(rng)
    grads = [jax.tree.map(lambda v: (rng.normal(size=v.shape) * s).astype(
        np.float32), tree) for s in (1.0, 30.0, 0.1)]
    kw = dict(learning_rate=1e-2, grad_clip=clip, backbone_lr_scale=scale,
              schedule="cosine", warmup_steps=1, total_steps=5)
    jopt = jtrain.make_optimizer(jtrain.TrainConfig(**kw))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    popt = train.make_optimizer(train.TrainConfig(**kw))
    pp = jax.tree.map(lambda v: torch.from_numpy(v.copy()), tree)
    ps = popt.init(pp)
    for g in grads:
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        upd, ps = popt.update(jax.tree.map(torch.from_numpy, g), ps, pp)
        train.apply_updates(pp, upd)
        for k, got in train.flatten(pp):
            top, name = k.split("/")
            want = np.asarray(jp[top][name])
            err = np.abs(got.numpy() - want).max()
            assert err <= OPT_BOUND * np.abs(want).max(), (k, err)
    assert int(ps["count"]) == 3
    if scale == 0.0:  # frozen: no update, no moments
        for k, got in train.flatten(pp["bb"]):
            assert torch.equal(got, torch.from_numpy(tree["bb"][k]))
        assert "bb" not in ps["mu"] and "bb" not in ps["nu"]


@pytest.mark.parametrize("flag", ["use_flash_attention", "int8_mlp",
                                  "int8_attn"])
def test_validate_train_compute_refuses_kernel_flags(flag):
    with pytest.raises(ValueError, match="forward-only"):
        train.validate_train_compute(pt.ComputeConfig(**{flag: True}))
    out = train.validate_train_compute(
        pt.ComputeConfig(dtype=torch.bfloat16, remat_blocks=True))
    assert out.dtype == torch.float32 and out.differentiable
    assert out.remat_blocks and out.deform_mode == "deformable"


@pytest.mark.parametrize("arg", ["in_sharding", "param_sharding",
                                 "split_update"])
def test_unported_step_arguments_raise(arg):
    """FSDP's arguments point to process_group, data parallelism's port."""
    with pytest.raises(NotImplementedError, match="not ported") as exc:
        train.make_train_step(CFG_P, **{arg: True})
    assert ("process_group=" in str(exc.value)) == (arg != "split_update")


# ---------------------------------------------------------------------------
# Gradients of the whole model against jax.value_and_grad
# ---------------------------------------------------------------------------

def test_gradients_match_jax(case, jax_grads):
    want_loss, want = jax_grads
    loss, got = _port_grads(*case)
    assert abs(loss - want_loss) <= LOSS_BOUND * abs(want_loss)
    errs, rel_l2 = _leaf_errors(want, got)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= LEAF_BOUND, (worst, errs[worst])
    assert rel_l2 <= L2_BOUND, rel_l2
    offsets = [k for k in errs if "offset_conv" in k]
    assert len(offsets) == 40  # 20 sites, weight and bias


def test_regular_mode_breaks_the_gradient_bounds(case, jax_grads):
    _, got = _port_grads(*case, pt.ComputeConfig(deform_mode="regular"))
    errs, rel_l2 = _leaf_errors(jax_grads[1], got)
    offsets = [errs[k] for k in errs if "offset_conv" in k]
    assert min(offsets) > 10 * LEAF_BOUND and rel_l2 > L2_BOUND


def test_swapped_offsets_break_the_gradient_bounds(case, jax_grads,
                                                   monkeypatch):
    """Control: the sampling reads (dx, dy) where it should read (dy, dx)."""
    deform = paspp.deform_conv2d

    def swapped(x, offset, mask, *args, **kw):
        off = offset.reshape(*offset.shape[:-1], -1, 2).flip(-1)
        return deform(x, off.reshape(offset.shape), mask, *args, **kw)

    monkeypatch.setattr(paspp, "deform_conv2d", swapped)
    _, got = _port_grads(*case)
    errs, _ = _leaf_errors(jax_grads[1], got)
    offsets = [errs[k] for k in errs if "offset_conv" in k]
    assert max(offsets) > 10 * LEAF_BOUND


def test_remat_blocks_gives_the_same_gradients(case):
    flat, x, y = case
    x, y = x[:1], y[:1]
    _, plain = _port_grads(flat, x, y, pt.ComputeConfig(deform_mode="regular"))
    _, remat = _port_grads(flat, x, y, pt.ComputeConfig(
        deform_mode="regular", remat_blocks=True))
    assert all(torch.equal(plain[k], remat[k]) for k in plain)


# ---------------------------------------------------------------------------
# The step, the state
# ---------------------------------------------------------------------------

def test_train_step_with_accum_matches_jax(case):
    flat, x, y = case
    kw = dict(learning_rate=LR, accum_steps=2)
    jstep = jtrain.make_train_step(CFG_J, bt.ComputeConfig(),
                                   jtrain.TrainConfig(**kw), donate=False,
                                   split_update=False)
    jstate = jtrain.init_train_state(bt.params.build_param_tree(flat, CFG_J),
                                     jtrain.TrainConfig(**kw))
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    want = pt.from_jax_params(jax.tree.map(np.asarray, jstate.params))

    tcfg = train.TrainConfig(**kw)
    state = train.init_train_state(pt.build_param_tree(flat, CFG_P), tcfg)
    step = train.make_train_step(CFG_P, pt.ComputeConfig(), tcfg)
    state, m = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert int(state.step) == 1 and int(state.opt_state["count"]) == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_BOUND * abs(
        float(jm["loss"]))
    got = dict(train.flatten(state.params))
    before = dict(train.flatten(pt.build_param_tree(flat, CFG_P)))
    # The leaf's own f32 rounding (one ulp of its largest value) beside the
    # step's error.
    worst = max(((float((got[k] - w).abs().max())
                  - F32_EPS * float(before[k].abs().max())) / LR, k)
                for k, w in train.flatten(want))
    assert worst[0] <= STEP_BOUND, worst


def _toy_state():
    params = {"bb": {"w": torch.arange(12.0).reshape(3, 4)},
              "decoder": {"b": torch.ones(4)}}
    state = train.init_train_state(params, train.TrainConfig())
    upd, opt = train.make_optimizer(train.TrainConfig()).update(
        {"bb": {"w": torch.ones(3, 4)}, "decoder": {"b": torch.full((4,), 2.)}},
        state.opt_state, params)
    train.apply_updates(params, upd)
    return train.TrainState(params, opt, torch.tensor(17, dtype=torch.int32))


def test_train_state_round_trip_is_bitwise(tmp_path):
    state = _toy_state()
    path = str(tmp_path / "state.safetensors")
    train.save_train_state(path, state)
    zeros = train.TrainState(*(
        train.unflatten((k, torch.zeros_like(v)) for k, v in train.flatten(t))
        if isinstance(t, dict) else torch.zeros_like(t) for t in state))
    loaded = train.load_train_state(path, zeros)
    assert int(loaded.step) == 17 and loaded.step.dtype == torch.int32
    want, got = train._state_items(state), train._state_items(loaded)
    assert [k for k, _ in want] == [k for k, _ in got]
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for (_, a), (_, b) in zip(want, got))


@pytest.mark.parametrize("change", ["missing", "extra", "shape"])
def test_train_state_mismatch_raises(tmp_path, change):
    state = _toy_state()
    path = str(tmp_path / "state.safetensors")
    train.save_train_state(path, state)
    params = {"bb": {"w": torch.zeros(3, 4)}, "decoder": {"b": torch.zeros(4)}}
    if change == "missing":
        params["decoder"]["c"] = torch.zeros(2)
    elif change == "extra":
        del params["decoder"]
    else:
        params["bb"]["w"] = torch.zeros(4, 3)
    template = train.init_train_state(params, train.TrainConfig())
    with pytest.raises(ValueError, match="mismatch" if change != "shape"
                       else "shape"):
        train.load_train_state(path, template)


def test_serve_then_train_in_one_process(case):
    """make_infer_fn's forward runs under torch.inference_mode and fills the
    device caches (resize matrices, ImageNet statistics, SW-MSA masks); a
    train step after it reads the same caches with autograd recording,
    which refuses inference tensors."""
    flat, x, y = case
    params = pt.build_param_tree(flat, CFG_P)
    infer = pipeline.make_infer_fn(params, CFG_P, pt.ComputeConfig(), "cpu")
    infer(np.zeros((1, 64, 64, 3), np.uint8))
    tcfg = train.TrainConfig(learning_rate=LR)
    state = train.init_train_state(params, tcfg)
    with torch.no_grad():
        frames = pipeline.preprocess(torch.zeros((1, 64, 64, 3),
                                                 dtype=torch.uint8), (64, 64))
    state, m = train.make_train_step(CFG_P, pt.ComputeConfig(), tcfg)(
        state, frames + torch.from_numpy(x[:1]), torch.from_numpy(y[:1]))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_differentiable_keeps_the_head_off_tap_conv():
    tier = pt.ComputeConfig(dtype=torch.bfloat16, use_flash_attention=True)
    cuda = torch.device("cuda")
    assert pdec.use_tap_conv(torch.bfloat16, cuda, tier)
    assert not pdec.use_tap_conv(torch.bfloat16, cuda,
                                 tier.with_overrides(differentiable=True))
    assert not pdec.use_tap_conv(torch.float32, cuda, tier)
    assert not pdec.use_tap_conv(torch.bfloat16, torch.device("cpu"), tier)


def test_refuse_grad_sees_tensors_in_parameter_trees():
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="computes no gradient"):
        build.refuse_grad("k", torch.ones(2), {"fc": {"weight": w}})
    with torch.no_grad():
        build.refuse_grad("k", torch.ones(2), {"fc": {"weight": w}})
    build.refuse_grad("k", torch.ones(2), {"fc": {"weight": w.detach()}}, None)


# ---------------------------------------------------------------------------
# D1b's plain version against JAX's VJP of the sampling
# ---------------------------------------------------------------------------

_jax_deform = jax.jit(jdeform.deform_conv2d,
                      static_argnames=("stride", "padding"))


@pytest.mark.parametrize("k,pad,stride", [(1, 0, 1), (3, 1, 1), (7, 3, 1),
                                          (3, 1, 2)])
def test_deform_col2im_matches_jax_vjp(k, pad, stride):
    """JAX's columns are its deform_conv2d with an identity weight; their
    VJP with the cotangent G against deform_col2im(G) on the CPU."""
    rng = np.random.default_rng(5)
    b, h, w, c = 2, 9, 11, 6
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    off = (rng.normal(size=(b, oh, ow, 2 * k * k)) * 2).astype(np.float32)
    mask = rng.uniform(0, 2, size=(b, oh, ow, k * k)).astype(np.float32)
    g = rng.normal(size=(b * oh * ow, k * k * c)).astype(np.float32)
    eye = jnp.eye(k * k * c, dtype=jnp.float32).reshape(k, k, c, -1)

    def cols(x, off, mask):
        return _jax_deform(x, off, mask, eye, None, stride=stride,
                           padding=pad).reshape(-1, k * k * c)

    _, vjp = jax.vjp(cols, jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    before = d1.deform_col2im.launches
    got = d1.deform_col2im(torch.from_numpy(g), torch.from_numpy(x),
                           torch.from_numpy(off), torch.from_numpy(mask), k, k,
                           stride, pad)
    assert d1.deform_col2im.launches == before  # CPU: the plain version
    for name, gw, gg in zip(("x", "offset", "mask"), want, got):
        assert gg.shape == gw.shape, name
        err = np.abs(gg.numpy() - gw).max()
        assert err <= COL2IM_BOUND * np.abs(gw).max(), (name, err)
