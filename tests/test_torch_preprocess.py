"""Crop / resize / normalize and the affine helpers: the port's plain
versions against the JAX package's, on the same seeded inputs, float32 on
the CPU (the kernel itself is checked on the card by
test_torch_kernels_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu.ops import affine as jaffine
from golfaction_tpu.ops import preprocess as jpre
from golfaction_tpu_torch.ops import affine as taffine
from golfaction_tpu_torch.ops import launches_since
from golfaction_tpu_torch.ops import preprocess as tpre
from golfaction_tpu_torch.utils import profiling

OUT_HW = (64, 48)


def _inputs(seed, b=3, h=90, w=120, off_frame=False):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    lo, hi = (-0.3, 1.3) if off_frame else (0.3, 0.7)
    boxes = np.stack([rng.uniform(lo * w, hi * w, b), rng.uniform(lo * h, hi * h, b),
                      rng.uniform(0.2 * w, 0.9 * w, b), rng.uniform(0.3 * h, 1.4 * h, b)],
                     axis=-1).astype(np.float32)
    return frames, boxes


CASES = [(0, False), (1, False), (2, True), (3, True)]


@pytest.mark.parametrize("seed,off_frame", CASES)
def test_gather_matches_jax_reference(seed, off_frame):
    frames, boxes = _inputs(seed, off_frame=off_frame)
    want = jpre.crop_resize_normalize_reference(jnp.asarray(frames), jnp.asarray(boxes), OUT_HW)
    got = tpre.crop_resize_normalize_reference(torch.from_numpy(frames),
                                               torch.from_numpy(boxes), OUT_HW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("seed,off_frame", CASES)
def test_separable_matches_jax_fast_path(seed, off_frame):
    frames, boxes = _inputs(seed, off_frame=off_frame)
    want = jpre.crop_resize_normalize(jnp.asarray(frames), jnp.asarray(boxes), OUT_HW,
                                      dtype=jnp.float32)
    got = tpre.crop_resize_normalize_separable(torch.from_numpy(frames),
                                               torch.from_numpy(boxes), OUT_HW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("seed,off_frame", CASES)
def test_entry_point_on_cpu_is_the_gather(seed, off_frame):
    frames, boxes = _inputs(seed, off_frame=off_frame)
    f, b = torch.from_numpy(frames), torch.from_numpy(boxes)
    since = profiling.totals()
    got = tpre.crop_resize_normalize(f, b, OUT_HW)
    assert launches_since(since)["preprocess"] == 0       # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(),
                                  tpre.crop_resize_normalize_reference(f, b, OUT_HW).numpy())
    # The two plain versions compute one function.
    np.testing.assert_allclose(tpre.crop_resize_normalize_separable(f, b, OUT_HW).numpy(),
                               got.numpy(), atol=1e-4)


def test_box_fully_outside_gives_normalized_zero():
    frames = np.full((1, 40, 50, 3), 255, np.uint8)
    boxes = np.float32([[500.0, 500.0, 30.0, 40.0]])
    got = tpre.crop_resize_normalize(torch.from_numpy(frames), torch.from_numpy(boxes), (8, 6))
    want = -np.asarray(tpre.IMAGENET_MEAN, np.float32) / np.asarray(tpre.IMAGENET_STD,
                                                                    np.float32)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, got.shape), atol=1e-6)


def test_affine_helpers_match_jax():
    rng = np.random.default_rng(5)
    boxes = rng.uniform(20, 200, (4, 4)).astype(np.float32)
    pts = rng.uniform(-10, 60, (4, 7, 2)).astype(np.float32)
    jb, tb = jnp.asarray(boxes), torch.from_numpy(boxes)
    np.testing.assert_allclose(taffine.box_to_center_scale(tb, 0.75).numpy(),
                               np.asarray(jaffine.box_to_center_scale(jb, 0.75)), rtol=1e-6)
    jm, tm = jaffine.crop_transform(jb, OUT_HW), taffine.crop_transform(tb, OUT_HW)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(taffine.apply_transform(tm, torch.from_numpy(pts)).numpy(),
                               np.asarray(jaffine.apply_transform(jm, jnp.asarray(pts))),
                               rtol=1e-6, atol=1e-4)
    jh = jaffine.heatmap_to_crop_transform((16, 12), OUT_HW)
    th = taffine.heatmap_to_crop_transform((16, 12), OUT_HW)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6)
    np.testing.assert_allclose(taffine.compose(tm, th.expand_as(tm)).numpy(),
                               np.asarray(jaffine.compose(jm, jnp.broadcast_to(jh, jm.shape))),
                               rtol=1e-6)
