"""birefnet_tpu_torch.serve end to end on the CPU, and the port's native
host-resize bindings against the JAX package's.

serve.main decodes three PNGs of different sizes, runs them through the
pipeline at a tiny model size (64x64, f32, CPU, the swin_v1_t backbone to
keep the checkpoint small; the default deform mode, deformable) in
batches of 2 and writes one mask per image at the image's own size.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import save_file

import birefnet_tpu_torch as pt
from birefnet_tpu.utils import native as jnative
from birefnet_tpu_torch import serve
from birefnet_tpu_torch.utils import native


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


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ck") / "m.safetensors"
    save_file(pt.random_checkpoint(pt.BiRefNetConfig.for_backbone("swin_v1_t"),
                                   3), str(path))
    yield str(path)
    shutil.rmtree(path.parent, ignore_errors=True)


def test_serve_main_writes_masks_at_image_sizes(tmp_path, ckpt_path):
    rng = np.random.default_rng(0)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    sizes = [(80, 70), (64, 64), (100, 40)]
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
                        "RGB").save(img_dir / f"im{i}.png")
    out_dir = tmp_path / "masks"
    rc = serve.main([str(img_dir), "--out", str(out_dir), "--checkpoint",
                     ckpt_path, "--batch", "2", "--size", "64", "--dtype",
                     "float32", "--cpu", "--backbone", "swin_v1_t"])
    assert rc == 0
    assert sorted(os.listdir(out_dir)) == [f"im{i}_mask.png" for i in range(3)]
    for i, (h, w) in enumerate(sizes):
        m = np.asarray(Image.open(out_dir / f"im{i}_mask.png"))
        assert m.shape == (h, w) and m.dtype == np.uint8


@pytest.mark.parametrize("flag", [["--batch", "3", "--dp", "2"],
                                  ["--spatial", "2"],
                                  ["--deform-mode", "deformable-local"],
                                  ["--deform-mode", "auto"],
                                  ["--aot-dir", "x"]])
def test_serve_refuses_unported_flags(tmp_path, flag):
    with pytest.raises(SystemExit) as exc:
        serve.main([str(tmp_path), "--checkpoint", "unused"] + flag)
    assert exc.value.code == 2


@pytest.mark.parametrize("argv,want", [([], "deformable"),
                                       (["--deform-mode", "deformable"],
                                        "deformable"),
                                       (["--deform-mode", "regular"],
                                        "regular")])
def test_serve_main_passes_the_deform_mode(tmp_path, monkeypatch, argv, want):
    """--deform-mode defaults to deformable, as in the JAX serve, and
    reaches make_infer_fn's compute policy (here on the CPU)."""
    import torch
    from birefnet_tpu_torch import params as P
    from birefnet_tpu_torch import pipeline

    seen = []

    def fake_make_infer_fn(params, cfg, compute, device, out_size):
        seen.append((compute.deform_mode, torch.device(device).type))
        return lambda frames: torch.zeros(tuple(frames.shape[:3]),
                                          dtype=torch.uint8)

    monkeypatch.setattr(pipeline, "make_infer_fn", fake_make_infer_fn)
    monkeypatch.setattr(P, "load_checkpoint", lambda path, cfg: {})
    Image.fromarray(np.zeros((40, 30, 3), np.uint8), "RGB").save(
        tmp_path / "a.png")
    rc = serve.main([str(tmp_path / "a.png"), "--out", str(tmp_path / "m"),
                     "--checkpoint", "unused", "--size", "64", "--cpu"]
                    + argv)
    assert rc == 0 and seen == [(want, "cpu")]


def test_serve_without_gpu_or_cpu_flag_exits(tmp_path, monkeypatch, capsys):
    """No silent CPU fallback: without --cpu serve needs a CUDA device."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        serve.main([str(tmp_path), "--checkpoint", "unused", "--int8-mlp",
                    "--int8-attn"])
    assert exc.value.code == 2
    assert "--cpu" in capsys.readouterr().err


def test_serve_main_int8_flags_on_cpu(tmp_path, ckpt_path):
    """--int8-mlp/--int8-attn are accepted; on the CPU (no kernel tier)
    the quantized leaves are built and ignored, as in the JAX package."""
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    Image.fromarray(np.full((50, 60, 3), 128, np.uint8), "RGB").save(
        img_dir / "a.png")
    rc = serve.main([str(img_dir), "--out", str(tmp_path / "m"),
                     "--checkpoint", ckpt_path, "--size", "64", "--dtype",
                     "float32", "--cpu", "--backbone", "swin_v1_t",
                     "--int8-mlp", "--int8-attn"])
    assert rc == 0
    m = np.asarray(Image.open(tmp_path / "m" / "a_mask.png"))
    assert m.shape == (50, 60) and m.dtype == np.uint8


def test_make_infer_fn_defaults_to_cuda(monkeypatch):
    """make_infer_fn runs on the card unless the caller asks for the CPU;
    without a card it raises instead of falling back."""
    import torch
    from birefnet_tpu_torch import pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pt.BiRefNetConfig(size=(64, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.make_infer_fn({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.make_infer_fn({}, cfg, pt.ComputeConfig(), "cuda")


def test_segment_restores_each_size():
    images = [np.zeros((30, 50, 3), np.uint8), np.zeros((64, 64, 3), np.uint8)]
    seen = []

    def infer(frames):
        import torch
        seen.append(frames.shape)
        return torch.full(frames.shape[:3], 200, dtype=torch.uint8)

    masks = serve.segment(infer, images, 64, 2)
    assert seen == [(2, 64, 64, 3)]
    assert [m.shape for m in masks] == [(30, 50), (64, 64)]
    assert all(int(m.min()) == int(m.max()) == 200 for m in masks)


def test_native_resizes_match_jax_package():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for ours, theirs in ((native.resize_triangle_u8, jnative.resize_triangle_u8),
                         (native.resize_lanczos3_u8, jnative.resize_lanczos3_u8)):
        a = ours(img, 24, 70).astype(np.int32)
        b = theirs(img, 24, 70).astype(np.int32)
        # the two builds may round a .5 boundary apart (compiler flags)
        assert a.shape == b.shape == (24, 70, 3)
        assert np.abs(a - b).max() <= 1
