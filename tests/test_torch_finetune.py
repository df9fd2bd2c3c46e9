"""The port's finetune CLI and loader against the JAX package's (CPU).

- loader.load_frame, finetune.find_pairs, load_mask and _batches (the
  seeded order and the flip stream) give what the JAX functions give, on
  a tiny dataset of odd-sized images (so the native triangle resize runs);
- finetune.main --device cpu at swin_v1_t 64^2, 2 steps, writes a
  checkpoint that both packages load and a train state that resumes;
- --dp > 1 and a missing CUDA device raise.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import birefnet_tpu as bt
from birefnet_tpu import finetune as jfinetune
from birefnet_tpu import loader as jloader
import birefnet_tpu_torch as pt
from birefnet_tpu_torch import finetune, loader, train


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
    (imgs / "notes.txt").write_text("not an image")
    return str(imgs), str(masks)


def test_load_frame_matches_jax(dataset):
    pairs = finetune.find_pairs(*dataset)
    for src in (pairs[0][0], np.zeros((30, 40), np.uint8)):
        got, got_hw = loader.load_frame(src, 64)
        want, want_hw = jloader.load_frame(src, 64)
        assert got_hw == want_hw and got.dtype == np.uint8
        assert np.array_equal(got, want)


def test_pairs_masks_and_batches_match_jax(dataset):
    pairs = finetune.find_pairs(*dataset)
    assert pairs == jfinetune.find_pairs(*dataset) and len(pairs) == 3
    assert np.array_equal(finetune.load_mask(pairs[1][1], 64),
                          jfinetune.load_mask(pairs[1][1], 64))
    for flip in (False, True):
        got = list(finetune._batches(pairs, 2, 64, 4, seed=5, flip=flip))
        want = list(jfinetune._batches(pairs, 2, 64, 4, seed=5, flip=flip))
        assert len(got) == len(want) == 4
        for (gf, gm), (wf, wm) in zip(got, want):
            assert np.array_equal(gf, wf) and np.array_equal(gm, wm)


def test_find_pairs_missing_mask(tmp_path):
    imgs, masks = tmp_path / "i", tmp_path / "m"
    imgs.mkdir(), masks.mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(imgs / "a.png")
    with pytest.raises(FileNotFoundError, match="no mask"):
        finetune.find_pairs(str(imgs), str(masks))


def test_main_on_the_cpu_writes_a_checkpoint_both_packages_load(dataset,
                                                                tmp_path):
    imgs, masks = dataset
    out = str(tmp_path / "trained.safetensors")
    state_path = str(tmp_path / "state.safetensors")
    history = []
    args = [imgs, masks, "--out", out, "--size", "64", "--backbone",
            "swin_v1_t", "--batch", "1", "--lr", "1e-4", "--device", "cpu"]
    assert finetune.main(args + ["--steps", "2", "--save-state", state_path],
                         history=history) == 0
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in history)
    cfg = pt.BiRefNetConfig.for_backbone("swin_v1_t")
    trained = pt.load_checkpoint(out, cfg)
    start = pt.init_params(cfg, seed=0)
    moved = [k for (k, a), (_, b) in zip(train.flatten(trained),
                                         train.flatten(start))
             if not torch.equal(a, b)]
    assert moved
    jtree = bt.load_checkpoint(out, bt.BiRefNetConfig.for_backbone("swin_v1_t"))
    assert all(torch.equal(a, dict(train.flatten(trained))[k])
               for k, a in train.flatten(pt.from_jax_params(jtree)))
    # The saved state resumes: one more step, from step 2 to 3.
    assert finetune.main(args + ["--steps", "1", "--resume", state_path,
                                 "--save-state", state_path]) == 0
    template = train.init_train_state(pt.init_params(cfg, seed=0),
                                      train.TrainConfig())
    assert int(train.load_train_state(state_path, template).step) == 3


def test_main_refuses_dp_and_a_missing_device(dataset, tmp_path):
    imgs, masks = dataset
    args = [imgs, masks, "--out", str(tmp_path / "x.safetensors"), "--size",
            "64", "--backbone", "swin_v1_t", "--steps", "1"]
    with pytest.raises(NotImplementedError, match="module item 9"):
        finetune.main(args + ["--dp", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            finetune.main(args)
