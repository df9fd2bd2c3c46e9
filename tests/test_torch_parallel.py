"""Data parallelism in the port (birefnet_tpu_torch/parallel/, serve.main
--dp, finetune.main --dp) against the JAX package's, on the CPU.

- make_sharded_infer_fn over two CPU groups at batch 4 against the JAX
  make_sharded_infer_fn on a 2-device virtual mesh: masks within one uint8
  step; make_data_parallel_forward against one forward of the batch and
  against the JAX make_data_parallel_forward on that mesh;
- one make_train_step over two spawned gloo ranks (train.rank_step, global
  batch 2, one row each) against the JAX step with fsdp_specs and
  batch_leading on a 2-device mesh: the loss within LOSS_BOUND relative,
  every leaf within STEP_BOUND x the learning rate plus one f32 ulp of its
  largest value, as tests/test_torch_train.py holds the single-device step.
  Both run regular deform mode: this test holds the reduction over ranks,
  tests/test_torch_train.py the deformable sampling's gradients, and
  JAX's compile of the deformable step takes 20 s more;
- a one-rank gloo group: the step bitwise the step without a group;
- finetune.main --dp 2 --device cpu: 2 steps, --out loads in both
  packages, --resume reaches step 3; a failing rank makes main return 1;
  the ranks get no deadline for the whole run;
- serve.main --dp 2 --cpu on five odd-sized images (a padded last batch of
  4): the same files and shapes as serve.main without --dp, masks within
  one uint8 step;
- make_mesh and the refusals: --spatial without --dp, --spatial 2, --batch
  3 --dp 2, a microbatch not divisible by --dp, more ranks than cards.
"""

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import save_file

import jax
import jax.numpy as jnp

import birefnet_tpu as bt
from birefnet_tpu import train as jtrain
from birefnet_tpu.parallel import mesh as jmesh
from birefnet_tpu.parallel import sharding as jshard
import birefnet_tpu_torch as pt
from birefnet_tpu_torch import finetune, pipeline, serve, train
from birefnet_tpu_torch.parallel import mesh, ranks, sharding

LOSS_BOUND = 1e-5
STEP_BOUND = 1e-3
F32_EPS = float(np.finfo(np.float32).eps)
LR = 1e-4
OFFSET_SCALE = 20.0
CFG_J = dataclasses.replace(bt.BiRefNetConfig.for_backbone("swin_v1_t"),
                            size=(64, 64))
CFG_P = dataclasses.replace(pt.BiRefNetConfig.for_backbone("swin_v1_t"),
                            size=(64, 64))
REGULAR_J = bt.ComputeConfig(deform_mode="regular")
REGULAR_P = pt.ComputeConfig(deform_mode="regular")
# Each spawned run of ranks must end well inside the suite's time limit.
RANKS_TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch CPU work (the spawned
    ranks set their own), restored after it: the suite runs in several
    worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def tmp_path(tmp_path):
    """pytest's tmp_path, emptied when the test ends: the checkpoints and
    training states written here are hundreds of MB each, and a parallel
    run of the suite that kept them all would fill a small disk."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The offset-scaled flat checkpoint (offsets of several pixels, as in
    tests/test_torch_train.py), saved for the ranks, and a batch of 2
    normalized frames and masks."""
    flat = {k: v * OFFSET_SCALE if ".offset_conv." in k else v
            for k, v in bt.random_checkpoint(CFG_J, 0).items()}
    folder = tmp_path_factory.mktemp("dp")
    path = str(folder / "model.safetensors")
    save_file(flat, path)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    yy, xx = np.mgrid[:64, :64]
    y = np.stack([(yy - 30) ** 2 + (xx - 34) ** 2 < 18 ** 2,
                  rng.random((64, 64)) > 0.5]).astype(np.float32)
    yield flat, path, x, y
    shutil.rmtree(folder, ignore_errors=True)


# ---------------------------------------------------------------------------
# The mesh and inference
# ---------------------------------------------------------------------------

def test_make_mesh_and_its_refusals(monkeypatch):
    m = mesh.make_mesh(devices=["cpu"] * 3)
    assert m.axis_names == (mesh.DATA_AXIS, mesh.SPATIAL_AXIS)
    assert m.shape == {"data": 3, "spatial": 1} and m.devices.shape == (3, 1)
    assert mesh.make_mesh(2, devices=["cpu"] * 3).shape["data"] == 2
    with pytest.raises(ValueError, match="asked for"):
        mesh.make_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible by spatial"):
        mesh.make_mesh(devices=["cpu"] * 3, spatial=2)
    with pytest.raises(NotImplementedError, match="2048"):
        mesh.make_mesh(devices=["cpu"] * 2, spatial=2)
    with pytest.raises(ValueError, match="index"):
        mesh.make_mesh(devices=["cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()


def test_split_batch_and_rank_rows():
    x = np.arange(8)
    assert [list(p) for p in sharding.split_batch(x, 2)] == [[0, 1, 2, 3],
                                                             [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="not divisible"):
        sharding.split_batch(np.arange(3), 2)
    # Microbatches [0..3] and [4..7]: rank r takes the r-th half of each.
    assert list(sharding.rank_rows(8, 2, 0, 2)) == [0, 1, 4, 5]
    assert list(sharding.rank_rows(8, 2, 1, 2)) == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="not divisible"):
        sharding.rank_rows(6, 2, 0, 2)


def test_sharded_infer_matches_jax(case):
    flat = bt.random_checkpoint(CFG_J, 3)
    frames = np.random.default_rng(1).integers(0, 256, (4, 64, 64, 3),
                                               dtype=np.uint8)
    jinfer = jshard.make_sharded_infer_fn(
        jmesh.make_mesh(2, spatial=1), bt.params.build_param_tree(flat, CFG_J),
        CFG_J, bt.ComputeConfig())
    want = np.asarray(jinfer(jnp.asarray(frames))).astype(np.int32)
    grid = mesh.make_mesh(devices=["cpu", "cpu"])
    infer = sharding.make_sharded_infer_fn(
        grid, pt.build_param_tree(flat, CFG_P), CFG_P, pt.ComputeConfig())
    # CPU groups run at the call: no submit, so serve.InFlight runs each
    # batch as it comes.
    assert isinstance(infer, sharding.ShardedInfer)
    assert not hasattr(infer, "submit")
    got = infer(frames).numpy().astype(np.int32)
    assert got.shape == want.shape == (4, 64, 64)
    assert np.abs(got - want).max() <= 1


def test_data_parallel_forward_matches_one_forward(case):
    flat, _, x, _ = case
    params = pt.build_param_tree(flat, CFG_P)
    grid = mesh.make_mesh(devices=["cpu", "cpu"])
    xs = torch.from_numpy(np.concatenate([x, x[::-1]]))
    fwd = sharding.make_data_parallel_forward(grid, CFG_P, logits=True)
    with torch.no_grad(), pipeline.full_f32():
        got = fwd(sharding.replicate(params, grid), xs)
        from birefnet_tpu_torch.models import birefnet
        want = birefnet.forward_logits(params, CFG_P, xs[2:],
                                       pt.ComputeConfig())
        mask = sharding.make_data_parallel_forward(grid, CFG_P)(params, xs)
        regular = sharding.make_data_parallel_forward(
            grid, CFG_P, REGULAR_P, logits=True)(params, xs)
    assert got.shape == (4, 64, 64, 1)
    assert float((got[2:] - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    assert torch.equal(mask, torch.sigmoid(got))
    # The JAX make_data_parallel_forward on its 2-device virtual mesh, the
    # same checkpoint and rows, in regular mode (the offsets, scaled here,
    # are held to JAX's in tests/test_torch_deform.py): within the 64^2
    # logits goldens' tolerance (tests/test_torch_slice.py).
    jfwd = jshard.make_data_parallel_forward(jmesh.make_mesh(2, spatial=1),
                                             CFG_J, REGULAR_J, logits=True)
    jwant = np.asarray(jfwd(bt.params.build_param_tree(flat, CFG_J),
                            jnp.asarray(xs.numpy())))
    assert jwant.shape == (4, 64, 64, 1)
    np.testing.assert_allclose(regular.numpy(), jwant, atol=5e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The train step over ranks
# ---------------------------------------------------------------------------

def _jax_fsdp_step(flat, x, y):
    """The JAX step on a 2-device data mesh, regular deform mode: params
    and moments sharded by fsdp_specs, the batch by batch_leading."""
    grid = jmesh.make_mesh(2, spatial=1)
    tcfg = jtrain.TrainConfig(learning_rate=LR)
    params = bt.params.build_param_tree(flat, CFG_J)
    specs = jshard.fsdp_specs(params, grid)
    state = jtrain.init_train_state(jax.device_put(params, specs), tcfg)
    lead = jshard.batch_leading(grid)
    step = jtrain.make_train_step(CFG_J, REGULAR_J, tcfg,
                                  in_sharding=lead, param_sharding=specs,
                                  donate=False, split_update=False)
    state, metrics = step(state, jax.device_put(jnp.asarray(x), lead),
                          jax.device_put(jnp.asarray(y), lead))
    return (float(metrics["loss"]),
            pt.from_jax_params(jax.tree.map(np.asarray, state.params)))


def _worst_leaf(flat, want, got):
    """The worst leaf's (error beyond one f32 ulp of its largest value) /
    LR, and its path."""
    before = dict(train.flatten(pt.build_param_tree(flat, CFG_P)))
    return max(((float((got[k] - w).abs().max())
                 - F32_EPS * float(before[k].abs().max())) / LR, k)
               for k, w in train.flatten(want))


def test_train_step_over_two_gloo_ranks_matches_jax(case, tmp_path):
    flat, path, x, y = case
    out = str(tmp_path / "state.safetensors")
    # The ranks run in their processes while JAX compiles here.
    failed = []

    def run_ranks():
        try:
            ranks.spawn(train.rank_step, ["cpu", "cpu"],
                        (CFG_P, REGULAR_P, train.TrainConfig(learning_rate=LR),
                         path, x, y, out), timeout=RANKS_TIMEOUT)
        except Exception as e:  # reported below, in the test's thread
            failed.append(e)

    runner = threading.Thread(target=run_ranks)
    runner.start()
    want_loss, want = _jax_fsdp_step(flat, x, y)
    runner.join(timeout=RANKS_TIMEOUT)
    assert not runner.is_alive() and not failed, failed
    metrics = []
    for r in range(2):
        with open(f"{out}.rank{r}.json") as f:
            metrics.append(json.load(f))
    # Both ranks read the all-reduced loss and the same global norm.
    assert metrics[0]["loss"] == metrics[1]["loss"]
    assert metrics[0]["grad_norm"] == metrics[1]["grad_norm"]
    assert abs(metrics[0]["loss"] - want_loss) <= LOSS_BOUND * abs(want_loss)
    template = train.init_train_state(pt.build_param_tree(flat, CFG_P),
                                      train.TrainConfig())
    state = train.load_train_state(out, template)
    assert int(state.step) == 1
    worst = _worst_leaf(flat, want, dict(train.flatten(state.params)))
    assert worst[0] <= STEP_BOUND, worst


def test_one_rank_group_is_bitwise_the_step_without_one(case, tmp_path):
    flat, _, x, y = case
    tcfg = train.TrainConfig(learning_rate=LR)
    xs, ys = torch.from_numpy(x[:1]), torch.from_numpy(y[:1])
    results = []
    with ranks.process_group(0, 1, "cpu", str(tmp_path / "store")) as group:
        for pg in (None, group):
            state = train.init_train_state(pt.build_param_tree(flat, CFG_P),
                                           tcfg)
            step = train.make_train_step(CFG_P, REGULAR_P, tcfg,
                                         donate=False, process_group=pg)
            results.append(step(state, xs, ys))
    (plain, pm), (grouped, gm) = results
    assert torch.equal(pm["loss"], gm["loss"])
    assert torch.equal(pm["grad_norm"], gm["grad_norm"])
    for (k, a), (_, b) in zip(train._state_items(plain),
                              train._state_items(grouped)):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

@pytest.fixture()
def dataset(tmp_path):
    rng = np.random.default_rng(11)
    imgs, masks = tmp_path / "imgs", tmp_path / "masks"
    imgs.mkdir(), masks.mkdir()
    for i in range(3):
        arr = rng.integers(0, 256, size=(48 + i, 56, 3), dtype=np.uint8)
        Image.fromarray(arr).save(imgs / f"im{i}.png")
        m = rng.integers(0, 2, size=(48 + i, 56), dtype=np.uint8) * 255
        Image.fromarray(m, mode="L").save(masks / f"im{i}.png")
    return str(imgs), str(masks)


def _finetune_args(dataset, tmp_path):
    imgs, masks = dataset
    return [imgs, masks, "--out", str(tmp_path / "trained.safetensors"),
            "--size", "64", "--backbone", "swin_v1_t", "--batch", "2",
            "--lr", "1e-4", "--device", "cpu", "--dp", "2"]


def test_finetune_dp2_on_the_cpu(dataset, tmp_path):
    args = _finetune_args(dataset, tmp_path)
    state_path = str(tmp_path / "state.safetensors")
    history = []
    assert finetune.main(args + ["--steps", "2", "--save-state", state_path],
                         history=history) == 0
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in history)
    cfg = pt.BiRefNetConfig.for_backbone("swin_v1_t")
    trained = dict(train.flatten(pt.load_checkpoint(args[3], cfg)))
    start = dict(train.flatten(pt.init_params(cfg, seed=0)))
    assert any(not torch.equal(v, start[k]) for k, v in trained.items())
    jtree = bt.load_checkpoint(args[3],
                               bt.BiRefNetConfig.for_backbone("swin_v1_t"))
    assert all(torch.equal(a, trained[k])
               for k, a in train.flatten(pt.from_jax_params(jtree)))
    assert finetune.main(args + ["--steps", "1", "--resume", state_path,
                                 "--save-state", state_path]) == 0
    template = train.init_train_state(pt.init_params(cfg, seed=0),
                                      train.TrainConfig())
    assert int(train.load_train_state(state_path, template).step) == 3


def test_finetune_dp_gives_the_run_no_deadline(dataset, tmp_path,
                                               monkeypatch):
    """finetune.main --dp spawns its ranks with no deadline for the whole
    run (a long finetune must not be terminated; a hung rank fails at its
    collective's timeout), and spawn's default is no deadline."""
    import inspect

    assert inspect.signature(ranks.spawn).parameters["timeout"].default \
        is None
    calls = []

    def spawn(fn, devices, args=(), **kw):
        calls.append((fn, list(devices), kw))
        with open(args[1], "w") as f:  # rank 0's step history
            json.dump([], f)

    monkeypatch.setattr(ranks, "spawn", spawn)
    assert finetune.main(_finetune_args(dataset, tmp_path)
                         + ["--steps", "1"]) == 0
    assert calls == [(finetune.rank_main, ["cpu", "cpu"], {})]


def test_finetune_dp_returns_1_when_a_rank_fails(dataset, tmp_path, capsys):
    args = _finetune_args(dataset, tmp_path)
    rc = finetune.main(args + ["--steps", "1", "--resume",
                               str(tmp_path / "missing.safetensors")])
    assert rc == 1
    assert "2 ranks" in capsys.readouterr().err


def _images(tmp_path):
    rng = np.random.default_rng(4)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    sizes = [(80, 70), (64, 64), (100, 40), (33, 90), (57, 61)]
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
                        "RGB").save(img_dir / f"im{i}.png")
    return img_dir, sizes


def test_serve_dp2_on_the_cpu_matches_serve(tmp_path, case):
    _, path, _, _ = case
    img_dir, sizes = _images(tmp_path)
    base = [str(img_dir), "--checkpoint", path, "--batch", "4", "--size",
            "64", "--dtype", "float32", "--cpu", "--backbone", "swin_v1_t"]
    assert serve.main(base + ["--out", str(tmp_path / "one")]) == 0
    assert serve.main(base + ["--out", str(tmp_path / "dp"), "--dp", "2"]) == 0
    names = [f"im{i}_mask.png" for i in range(len(sizes))]
    assert sorted(os.listdir(tmp_path / "dp")) == names
    assert sorted(os.listdir(tmp_path / "one")) == names
    for name, (h, w) in zip(names, sizes):
        a = np.asarray(Image.open(tmp_path / "one" / name)).astype(np.int32)
        b = np.asarray(Image.open(tmp_path / "dp" / name)).astype(np.int32)
        assert a.shape == b.shape == (h, w)
        assert np.abs(a - b).max() <= 1, name


@pytest.mark.parametrize("flags,message", [
    (["--spatial", "2"], "requires --dp"),
    (["--dp", "1", "--spatial", "2"], "2048"),
    (["--batch", "3", "--dp", "2"], "not divisible"),
    (["--batch", "3", "--dp", "3"], "> 2 devices"),
])
def test_serve_refuses_bad_meshes(tmp_path, monkeypatch, capsys, flags,
                                  message):
    """The JAX serve's checks, in its order; two cards here (patched), so
    --dp 3 asks for more cards than there are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit) as exc:
        serve.main([str(tmp_path), "--checkpoint", "unused"] + flags)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_finetune_refuses_bad_dp(dataset, tmp_path, monkeypatch):
    args = _finetune_args(dataset, tmp_path)[:-4] + ["--steps", "1"]
    with pytest.raises(ValueError, match="not divisible by --dp 2"):
        finetune.main(args + ["--batch", "3", "--device", "cpu", "--dp",
                              "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="> 1 CUDA devices"):
        finetune.main(args + ["--batch", "2", "--device", "cuda", "--dp",
                              "2"])
