"""The port's cycgen and mycycgen against the JAX runner's, on the same
weights: InterNet/HRNet at full width, 32x64, f32, the port's model and
frozen VGG19 loaded from the JAX runner's (``tools/jax_weights``).

- the synthetic tree (``clip_NNNNN/{rgb,seg,seg_vis}/TTT.png``) and the
  reference-contract tree (``_cycgen_reference`` on a load tree built as
  ``tests/test_cycgen_reference.py`` builds it: interval 2, vid_len 3,
  3 rollout steps) have the JAX layout file for file;
- their rgb PNGs differ from the JAX runner's by at most 1 level on
  >= 99.9% of pixels (the predicted frames round f32 values that differ
  in their last bits), and their seg ids agree on >= 99%;
- ``mycycgen`` fills ``26.0.png`` as ``tests/test_cli.py:92`` expects, and
  its frame matches the JAX runner's within the same bounds;
- ``num_pred_once > 1`` follows the window rule of the JAX
  ``Runner._mini_test`` (runner.py:844-852): with the model replaced by
  the same stub on both sides, the predictions agree.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deep_video_interpolation_extrapolation_tpu.cli.options import (
    parse_args as jparse,
)
from deep_video_interpolation_extrapolation_tpu.train.runner import (
    Runner as JRunner,
)
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
    Runner,
)
from tests.test_torch_port_runner import port_like

torch.set_num_threads(2)

H, W = 32, 64
ARGV = (f"--dataset synthetic --input_h {H} --input_w {W} --bs 2 "
        "--compute_dtype float32 --syn_type inter --split cycgen INTER "
        "--model InterNet")


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cycgen")
    with pytest.MonkeyPatch.context() as mp:
        # no root_clip.pkl: the clip list comes from the load tree
        mp.setenv("DVIE_DATA_ROOT", str(tmp / "no_data_root"))
        jr = JRunner(jparse(ARGV.split()), str(tmp / "jax"))
        pr = Runner(parse_args(ARGV.split()), str(tmp / "port"), device="cpu")
        port_like(pr, jr)
        yield tmp, jr, pr


def _tree(root):
    return sorted(os.path.relpath(os.path.join(b, f), root)
                  for b, _, fs in os.walk(root) for f in fs)


def _compare_trees(ours, ref, rgb_dir, seg_dir):
    assert _tree(ours) == _tree(ref) and _tree(ref)
    rgb_ok = rgb_n = seg_ok = seg_n = 0
    for rel in _tree(ref):
        a = np.asarray(Image.open(os.path.join(ours, rel)), np.int16)
        b = np.asarray(Image.open(os.path.join(ref, rel)), np.int16)
        assert a.shape == b.shape, rel
        parts = rel.split(os.sep)
        if rgb_dir in parts:
            rgb_ok += int((np.abs(a - b) <= 1).sum())
            rgb_n += a.size
        elif seg_dir in parts:
            seg_ok += int((a == b).sum())
            seg_n += a.size
    assert rgb_ok >= 0.999 * rgb_n, (rgb_ok, rgb_n)
    assert seg_ok >= 0.99 * seg_n, (seg_ok, seg_n)


def test_synthetic_tree_matches_jax(runners):
    _, jr, pr = runners
    ref, ours = jr.cycgen(), pr.cycgen()
    assert os.path.relpath(ours, pr.exp_dir) == os.path.relpath(
        ref, jr.exp_dir) == os.path.join("cycgen", "synthetic", f"{H}x{W}",
                                         "cycgen")
    assert len(os.listdir(ours)) == 8
    _compare_trees(ours, ref, "rgb", "seg")


def _make_load_tree(root, clips, indices):
    rng = np.random.RandomState(0)
    for clip in clips:
        os.makedirs(os.path.join(root, "rgb", clip), exist_ok=True)
        os.makedirs(os.path.join(root, "seg", clip), exist_ok=True)
        for i in indices:
            Image.fromarray(rng.randint(0, 255, (H, W, 3), dtype=np.uint8)
                            ).save(os.path.join(root, "rgb", clip,
                                                f"{i:0>2d}.0.png"))
            Image.fromarray(rng.randint(0, 20, (H, W)).astype(np.uint8)
                            ).save(os.path.join(root, "seg", clip,
                                                f"{i:0>2d}.0.png"))


def test_reference_tree_matches_jax(runners):
    tmp, jr, pr = runners
    load_dir = str(tmp / "load")
    clips = ["val/frankfurt/frankfurt_000000_000275",
             "val/munster/munster_000001_000019"]
    _make_load_tree(load_dir, clips, indices=(0, 2))
    for r in (jr, pr):
        r.cfg = r.cfg.replace(cycgen_load_dir=load_dir, interval=2,
                              vid_length=3, num_pred_step=3, num_pred_once=1,
                              dataset="cityscape")
    ref, ours = jr.cycgen(), pr.cycgen()
    assert os.path.relpath(ours, pr.exp_dir) == os.path.relpath(
        ref, jr.exp_dir) == os.path.join("cycgen", "cityscape", f"{H}x{W}",
                                         "extra_int_2_len_3_nearest")
    assert len(_tree(ref)) == 3 * len(clips) * 5
    _compare_trees(ours, ref, "rgb", "seg")
    # the two input frames are written back as they were read
    for clip in clips:
        for i in (0, 2):
            name = f"{i:0>2d}.0.png"
            assert np.array_equal(
                np.asarray(Image.open(os.path.join(ours, "rgb", clip, name))),
                np.asarray(Image.open(os.path.join(load_dir, "rgb", clip,
                                                   name))))


def test_mycycgen_fills_the_gap(runners):
    tmp, jr, pr = runners
    rng = np.random.RandomState(0)
    root = tmp / "tree"
    for clip in ("aachen_000000", "aachen_000001"):
        (root / clip).mkdir(parents=True)
        (root / "seg" / clip).mkdir(parents=True)
        for idx in (25, 27):
            Image.fromarray(rng.randint(0, 255, (H, W, 3), dtype=np.uint8)
                            ).save(root / clip / f"{idx:0>2d}.0.png")
            Image.fromarray(rng.randint(0, 20, (H, W)).astype(np.uint8)
                            ).save(root / "seg" / clip / f"{idx:0>2d}.0.png")
    shutil.copytree(root, tmp / "tree_jax")
    for r, d in ((pr, root), (jr, tmp / "tree_jax")):
        r.cfg = r.cfg.replace(split="mycycgen", cycgen_load_dir=str(d))
    ours, ref = pr.mycycgen(), jr.mycycgen()
    for clip in ("aachen_000000", "aachen_000001"):
        pred = os.path.join(ours, clip, "26.0.png")
        a = np.asarray(Image.open(pred), np.int16)
        assert a.shape == (H, W, 3)
        b = np.asarray(Image.open(os.path.join(ref, clip, "26.0.png")),
                       np.int16)
        assert (np.abs(a - b) <= 1).mean() >= 0.999
        ids = np.asarray(Image.open(os.path.join(ours, "seg", clip,
                                                 "26.0.png")))
        assert ids.shape == (H, W) and ids.max() < 20
        ref_ids = np.asarray(Image.open(os.path.join(ref, "seg", clip,
                                                     "26.0.png")))
        assert (ids == ref_ids).mean() >= 0.99


def _stub_np(x, seg):
    """Two frames and two seg maps a step, each depending on both slots."""
    a, b = x[..., :3], x[..., 3:6]
    rgb = np.concatenate([0.6 * a + 0.3 * b, 0.2 * a - 0.7 * b + 0.1], -1)
    s1, s2 = seg[..., :20], seg[..., 20:40]
    logits = np.concatenate([s1 + 0.5 * np.roll(s2, 1, -1),
                             np.roll(s1, 3, -1) + 0.7 * s2], -1)
    return rgb, logits


def test_num_pred_once_window_matches_jax(runners):
    _, jr, pr = runners
    kept = jr._minitest_fwd

    def jstub(params, bs, x, seg, key):
        rgb, logits = _stub_np(np.asarray(x), np.asarray(seg))
        return jnp.asarray(rgb), jnp.asarray(logits)

    def pstub(x, seg):
        rgb, logits = _stub_np(x.numpy(), seg.numpy())
        return torch.from_numpy(rgb), torch.from_numpy(logits)

    rng = np.random.RandomState(4)
    imgs = [rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
            for _ in range(2)]
    ids = [rng.randint(0, 20, (1, H, W)).astype(np.uint8) for _ in range(2)]
    try:
        jr._minitest_fwd = jstub
        pr._forward = pstub
        for r in (jr, pr):
            r.cfg = r.cfg.replace(num_pred_once=2, num_pred_step=3)
        ref_imgs, ref_ids = jr._mini_test(
            [jnp.asarray(i) for i in imgs],
            [jnp.asarray(np.eye(20, dtype=np.float32)[i]) for i in ids])
        our_imgs, our_ids = pr._mini_test([torch.from_numpy(i) for i in imgs],
                                          [torch.from_numpy(i) for i in ids])
    finally:
        jr._minitest_fwd = kept
        del pr._forward
    assert len(our_imgs) == len(ref_imgs) == 6
    for a, b in zip(our_imgs, ref_imgs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    for a, b in zip(our_ids, ref_ids):
        assert np.array_equal(a.numpy(), np.asarray(b))
