"""The port's entry points and host front end against the JAX package's.

On seeded inputs made with numpy: `loader.BatchLoader` against the JAX
BatchLoader (every batch bitwise, every size list equal, with and without
drop_remainder; an abandoned iterator joins its producer), the metrics of
`evaluate` against birefnet_tpu.evaluate (within 1e-12, ground truths all
zeros and all ones included) and `evaluate.main`'s printed lines,
`utils/profiling`, the native library's failure report, and the slice as
a whole: the port's `cli.main` against the JAX `cli.main` (swin_t at 64^2,
f32, the default deformable mode, one random checkpoint; the only JAX
model compile here), the checkpoint found in an HF cache under $HOME, the
offline error, and `serve.main --cpu` bitwise against `serve.segment`.
"""

import functools
import os
import shutil
import stat
import threading

import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import save_file

import birefnet_tpu_torch as pt
from birefnet_tpu import cli as jcli
from birefnet_tpu import evaluate as jevaluate
from birefnet_tpu import loader as jloader
from birefnet_tpu.utils import native as jnative
from birefnet_tpu.utils import profiling as jprofiling
from birefnet_tpu_torch import cli, evaluate, hub, loader, pipeline, serve
from birefnet_tpu_torch.utils import native, profiling


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's PyTorch CPU work, restored
    after it: the suite runs in several worker processes at once, and one
    thread per core in each oversubscribes the cores
    (tests/test_torch_train.py measured its forwards 50x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _png(path, arr):
    Image.fromarray(arr).save(path)
    return str(path)


@pytest.fixture(scope="module")
def ckpt_t(tmp_path_factory):
    """One swin_t random checkpoint saved with safetensors."""
    path = tmp_path_factory.mktemp("ck") / "model.safetensors"
    save_file(pt.random_checkpoint(pt.BiRefNetConfig.for_backbone("swin_v1_t"),
                                   3), str(path))
    yield str(path)
    shutil.rmtree(path.parent, ignore_errors=True)


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("imgs")
    return [_png(d / f"img{i}.png",
                 rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            for i, (h, w) in enumerate([(50, 70), (32, 32), (31, 45),
                                        (200, 100), (64, 48)])]


def _hf_cache(home, ckpt):
    """A $HOME whose HF cache holds `ckpt` as the published snapshot."""
    snap = os.path.join(hub.cache_dir(root=os.path.join(
        str(home), ".cache", "huggingface", "hub")), "snapshots", "abc")
    os.makedirs(snap)
    dst = os.path.join(snap, hub.DEFAULT_FILE)
    os.symlink(ckpt, dst)
    return dst


# -------------------------------- loader -----------------------------------

@pytest.mark.parametrize("drop_remainder", [False, True])
def test_batch_loader_matches_the_jax_loader(image_files, monkeypatch,
                                             drop_remainder):
    """Every batch bitwise and every size list equal. The JAX loader
    resizes with the port's library here: the two builds differ in
    compiler flags (-march=native) and may round a .5 apart, which
    test_torch_serve.py bounds by one step."""
    monkeypatch.setattr(jnative, "resize_triangle_u8",
                        native.resize_triangle_u8)
    kw = dict(batch_size=2, size=32, drop_remainder=drop_remainder)
    ours = list(loader.BatchLoader(image_files, **kw))
    theirs = list(jloader.BatchLoader(image_files, **kw))
    assert len(ours) == len(theirs) == len(loader.BatchLoader(image_files,
                                                              **kw))
    assert len(ours) == (2 if drop_remainder else 3)
    for (frames, sizes), (want, want_sizes) in zip(ours, theirs):
        assert frames.dtype == want.dtype == np.uint8
        assert frames.shape == want.shape == (2, 32, 32, 3)
        np.testing.assert_array_equal(frames, want)
        assert sizes == want_sizes
    if not drop_remainder:
        frames, sizes = ours[-1]
        assert sizes == [(64, 48)] and not frames[1].any()


def test_batch_loader_keeps_order_under_thread_stress(tmp_path):
    """More workers than cores decoding ahead across batches, a short
    switch interval: every frame lands in its own batch slot."""
    import sys

    rng = np.random.default_rng(18)
    paths = [_png(tmp_path / f"s{i}.png", rng.integers(
        0, 256, (int(rng.integers(8, 40)), int(rng.integers(8, 40)), 3),
        dtype=np.uint8)) for i in range(41)]
    want = [loader.load_frame(p, 16) for p in paths]
    got = []

    def consume():
        got.extend(loader.BatchLoader(paths, batch_size=3, size=16,
                                      workers=4 * (os.cpu_count() or 4),
                                      prefetch=1))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive() and len(got) == 14
    for i, (frame, orig) in enumerate(want):
        frames, sizes = got[i // 3]
        np.testing.assert_array_equal(frames[i % 3], frame)
        assert sizes[i % 3] == orig
    assert not got[-1][0][2].any() and len(got[-1][1]) == 2


def test_batch_loader_abandoned_joins_its_producer(image_files):
    before = set(threading.enumerate())
    it = iter(loader.BatchLoader(image_files * 4, batch_size=1, size=32,
                                 prefetch=1, workers=2))
    next(it)
    it.close()  # generator close -> cancelled -> the producer winds down
    started = [t for t in threading.enumerate() if t not in before]
    for t in started:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in started)


def test_batch_loader_raises_a_decode_error(image_files, tmp_path):
    """A file that does not decode reaches the consumer as its error."""
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    got = []

    def consume():
        try:
            list(loader.BatchLoader([image_files[0], str(bad)], batch_size=1,
                                    size=32))
        except OSError as e:  # PIL's UnidentifiedImageError
            got.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(got) == 1


# ------------------------------- evaluate ----------------------------------

def _maps(case, h=40, w=52):
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[:h, :w]
    blob = ((yy - 18) ** 2 / 150 + (xx - 30) ** 2 / 220) < 1
    pred = np.clip(0.7 * blob + rng.normal(0, 0.2, (h, w)), 0, 1)
    gt = {"blob": blob, "zeros": np.zeros((h, w)), "ones": np.ones((h, w)),
          "noisy": rng.random((h, w)) > 0.6}[case].astype(np.float64)
    return pred, gt


@pytest.mark.parametrize("case", ["blob", "zeros", "ones", "noisy"])
def test_metrics_match_the_jax_package(case):
    pred, gt = _maps(case)
    for name in ("mae", "s_measure", "weighted_f_measure"):
        a = getattr(evaluate, name)(pred, gt)
        b = getattr(jevaluate, name)(pred, gt)
        assert abs(a - b) <= 1e-12, (name, a, b)
    for name in ("f_measure", "e_measure"):
        a = getattr(evaluate, name)(pred, gt)
        b = getattr(jevaluate, name)(pred, gt)
        assert a.keys() == b.keys() == {"adp", "max"}
        assert all(abs(a[k] - b[k]) <= 1e-12 for k in a), (name, a, b)
    pairs = [_maps(c) for c in ("blob", case)]
    a, b = evaluate.evaluate_maps(pairs), jevaluate.evaluate_maps(pairs)
    assert a.keys() == b.keys() and len(a) == 7
    assert all(abs(a[k] - b[k]) <= 1e-12 for k in a)


def test_evaluate_main_prints_the_jax_lines(tmp_path, capsys):
    rng = np.random.default_rng(12)
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    pred_dir.mkdir()
    gt_dir.mkdir()
    for i, (h, w) in enumerate([(40, 52), (33, 27), (48, 48)]):
        gt = (rng.random((h, w)) > 0.5).astype(np.uint8) * 255
        # The second prediction comes at another size: scored at the GT's.
        ph, pw = (h + 8, w - 4) if i == 1 else (h, w)
        _png(gt_dir / f"m{i}.png", gt)
        _png(pred_dir / f"m{i}.png",
             rng.integers(0, 256, (ph, pw), dtype=np.uint8))
    argv = [str(pred_dir), str(gt_dir)]
    capsys.readouterr()
    assert jevaluate.main(argv) == 0
    want = capsys.readouterr().out
    assert evaluate.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 7


# ------------------------------- profiling ---------------------------------

def test_profiling_helpers(tmp_path):
    x = np.random.default_rng(13).normal(size=(3, 17, 5)).astype(np.float32)
    assert profiling.tensor_stats(x) == jprofiling.tensor_stats(x)
    assert profiling.tensor_stats(torch.from_numpy(x)) == \
        jprofiling.tensor_stats(x)
    holder = {}
    with profiling.span("matmul", holder):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert holder["seconds"] > 0
    a = torch.randn(96, 96)
    rows = profiling.device_op_profile(torch.matmul, a, a, iters=3)
    assert rows and all(ms >= 0 and n > 0 for ms, n, _ in rows)
    assert any("mm" in name for _, _, name in rows)
    with profiling.device_trace(str(tmp_path / "trace")) as logdir:
        torch.relu(a)
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0


# -------------------------------- native -----------------------------------

@pytest.fixture()
def fresh_native(tmp_path, monkeypatch):
    """The native module building into an empty directory, its cached
    load dropped before and after."""
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    native._load.cache_clear()
    yield
    native._load.cache_clear()


def _fake_compiler(tmp_path, message):
    path = tmp_path / "fake-g++"
    path.write_text(f"#!/bin/sh\necho \"{message}\" >&2\nexit 1\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.mark.parametrize("compiler", ["false", "spec"])
def test_native_failure_names_the_command_and_output(tmp_path, monkeypatch,
                                                     fresh_native, compiler):
    """With no compiler that builds, require() raises with each command
    and the compiler's output, and the resizes take the NumPy versions."""
    if compiler == "false":
        cxx, said = shutil.which("false"), "(no output)"
    else:
        said = "cannot read spec file 'libgomp.spec'"
        cxx = _fake_compiler(tmp_path, f"g++: fatal error: {said}")
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(native.NativeLibraryError) as exc:
        native.require()
    msg = str(exc.value)
    assert f"$ {cxx} -O3" in msg and said in msg and "exit 1" in msg
    img = np.random.default_rng(14).integers(0, 256, (9, 7, 3), np.uint8)
    np.testing.assert_array_equal(
        native.resize_triangle_u8(img, 5, 6),
        native._numpy_resample(img, 5, 6, 1.0, native._tri))


def test_native_builds_with_the_next_compiler(tmp_path, monkeypatch,
                                              fresh_native):
    """A $CXX that cannot build OpenMP code (a toolchain without
    libgomp.spec) is passed over for the g++ on PATH."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH")
    monkeypatch.setenv("CXX", _fake_compiler(
        tmp_path, "fatal error: cannot read spec file 'libgomp.spec'"))
    path = native.require()
    assert path.startswith(str(tmp_path / "build")) and os.path.exists(path)


# ------------------------------ cli and serve ------------------------------

def test_cli_matches_the_jax_cli(tmp_path, monkeypatch, ckpt_t):
    """Both cli.main on one seeded 80x70 PNG, swin_t at 64^2, --cpu
    --dtype float32, the default deform mode, no --checkpoint: both find
    the checkpoint in the HF cache under $HOME, and the masks differ by
    at most one uint8 step."""
    monkeypatch.setenv("HOME", str(tmp_path))
    cached = _hf_cache(tmp_path, ckpt_t)
    assert cli.default_checkpoint_path() == jcli.default_checkpoint_path() \
        == cached
    img = _png(tmp_path / "in.png", np.random.default_rng(15).integers(
        0, 256, (80, 70, 3), dtype=np.uint8))
    flags = ["--backbone", "swin_v1_t", "--size", "64", "--cpu", "--dtype",
             "float32"]
    assert jcli.main([img, str(tmp_path / "jax.png")] + flags) == 0
    assert cli.main([img, str(tmp_path / "port.png")] + flags) == 0
    want = np.asarray(Image.open(tmp_path / "jax.png"), np.int32)
    got = np.asarray(Image.open(tmp_path / "port.png"), np.int32)
    assert got.shape == want.shape == (80, 70)
    assert np.abs(got - want).max() <= 1


def test_cli_offline_without_a_cache_exits_1(tmp_path, monkeypatch, capsys):
    """No cache, the endpoint unreachable (127.0.0.1): exit 1 with the
    actionable message, nothing fetched."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(hub, "download", functools.partial(
        hub.download, endpoint="http://127.0.0.1:9", progress=False))
    assert cli.main([str(tmp_path / "in.png"), "--cpu"]) == 1
    err = capsys.readouterr().err
    assert "cannot reach http://127.0.0.1:9" in err and "--checkpoint" in err


@pytest.mark.parametrize("argv", [["--deform-mode", "deformable-local"], []])
def test_cli_refusals(tmp_path, monkeypatch, capsys, argv):
    """deformable-local is refused; without a card and without --cpu the
    cli exits with an error instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli.main([str(tmp_path / "in.png"), "--checkpoint", "unused"] + argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert ("not ported" in err) if argv else ("--cpu" in err)


@pytest.mark.parametrize("entry", ["cli", "serve"])
def test_entry_points_stop_on_a_failed_native_build(tmp_path, monkeypatch,
                                                    capsys, entry):
    """On the card both entry points require the host-image library before
    the first image: a failed build ends the run with exit 1 and the
    compiler's output, before any model is loaded."""
    def fail_build():
        raise native.NativeLibraryError("$ g++ ...\nexit 1: libgomp.spec")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(native, "require", fail_build)
    img = _png(tmp_path / "a.png", np.zeros((40, 30, 3), np.uint8))
    main = cli.main if entry == "cli" else serve.main
    assert main([img, "--checkpoint", "unused"]) == 1
    assert "libgomp.spec" in capsys.readouterr().err


def test_serve_main_masks_bitwise_segment(tmp_path, monkeypatch, ckpt_t):
    """serve.main --cpu (BatchLoader, two batches in flight, the write
    pool) writes bitwise the masks of serve.segment on the same decoded
    images through the same function, the last batch padded with a zero
    frame as the loader pads it; the model sees one frame shape."""
    rng = np.random.default_rng(16)
    sizes = [(80, 70), (64, 64), (100, 40)]
    paths = [_png(tmp_path / f"im{i}.png",
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
             for i, (h, w) in enumerate(sizes)]
    made, shapes = [], []
    make = pipeline.make_infer_fn

    def recording_make_infer_fn(*args, **kw):
        infer = make(*args, **kw)
        made.append(infer)

        def seen(frames):
            shapes.append(tuple(frames.shape))
            return infer(frames)
        return seen

    monkeypatch.setattr(pipeline, "make_infer_fn", recording_make_infer_fn)
    out = tmp_path / "masks"
    assert serve.main(paths + ["--out", str(out), "--checkpoint", ckpt_t,
                               "--batch", "2", "--size", "64", "--dtype",
                               "float32", "--cpu", "--backbone",
                               "swin_v1_t"]) == 0
    assert shapes == [(2, 64, 64, 3)] * 2
    images = [loader._decode(p) for p in paths]
    want = serve.segment(made[0], images + [np.zeros((64, 64, 3), np.uint8)],
                         64, 2)
    for i, (h, w) in enumerate(sizes):
        got = np.asarray(Image.open(out / f"im{i}_mask.png"))
        assert got.shape == (h, w)
        np.testing.assert_array_equal(got, want[i])


def _fake_model(monkeypatch, seen_ckpt):
    """serve.main's loading and model replaced: records the checkpoint
    path, returns masks of 200."""
    from birefnet_tpu_torch import params as P

    monkeypatch.setattr(P, "load_checkpoint",
                        lambda path, cfg: seen_ckpt.append(path) or {})
    monkeypatch.setattr(
        pipeline, "make_infer_fn",
        lambda params, cfg, compute, device, out_size: (
            lambda frames: torch.full(tuple(frames.shape[:3]), 200,
                                      dtype=torch.uint8)))


def test_serve_main_checkpoint_from_the_hf_cache(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    seen = []
    _fake_model(monkeypatch, seen)
    img = _png(tmp_path / "a.png", np.zeros((40, 30, 3), np.uint8))
    argv = [img, "--out", str(tmp_path / "m"), "--size", "64", "--cpu"]
    assert serve.main(argv) == 1
    assert "no checkpoint found; pass --checkpoint" in capsys.readouterr().err
    (tmp_path / "ck.safetensors").write_bytes(b"")
    cached = _hf_cache(tmp_path, str(tmp_path / "ck.safetensors"))
    assert serve.main(argv) == 0 and seen == [cached]
    assert np.asarray(Image.open(tmp_path / "m" / "a_mask.png")).shape == \
        (40, 30)


@pytest.mark.parametrize("blocker", ["file at --out", "dir at a mask"])
def test_serve_main_unwritable_out_exits(tmp_path, monkeypatch, capsys,
                                         blocker):
    """An --out that cannot take the masks ends the run with exit 1 and
    the error, instead of hanging."""
    _fake_model(monkeypatch, [])
    rng = np.random.default_rng(17)
    paths = [_png(tmp_path / f"i{i}.png",
                  rng.integers(0, 256, (30, 20, 3), dtype=np.uint8))
             for i in range(5)]
    out = tmp_path / "out"
    if blocker == "file at --out":
        out.write_text("")
    else:
        (out / "i0_mask.png").mkdir(parents=True)
    done = []

    def run():
        done.append(serve.main(paths + ["--out", str(out), "--checkpoint",
                                        "unused", "--batch", "2", "--size",
                                        "32", "--cpu"]))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert done == [1]
    assert "error:" in capsys.readouterr().err
