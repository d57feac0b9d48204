"""Single-peak UDP decode: the port's plain decode (kernel D's plain version)
against the JAX package's Pallas decode kernel in interpret mode and its
pure-JAX decode, and the heatmap target functions, float32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from golfaction_tpu.ops import heatmap as jhm
from golfaction_tpu.ops.pallas import decode_kernel
from golfaction_tpu_torch.ops import heatmap as thm


def _assert_decodes_equal(got: np.ndarray, want: np.ndarray):
    """Integer peak and score exact; x, y within 1e-4 px (the two
    frameworks' float32 log may differ in the last bit)."""
    np.testing.assert_array_equal(np.round(got[..., :2]), np.round(want[..., :2]))
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_allclose(got[..., :2], want[..., :2], atol=1e-4)


def _maps(kind: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "noise":                   # negatives, border peaks
        return rng.normal(size=(3, 17, 64, 48)).astype(np.float32)
    if kind == "gaussians":
        centers = rng.uniform(3, 40, (2, 17, 2)).astype(np.float32)
        t, _ = jhm.make_heatmap_targets(jnp.asarray(centers), (64, 48), 2.0)
        return np.array(t)
    if kind == "edge_rows":               # zeros, ties, corners, edges, negative
        return chip_smoke.decode_edge_rows(64, 48)
    return chip_smoke.decode_edge_rows(16, 12)


@pytest.mark.parametrize("kind", ["noise", "gaussians", "edge_rows", "edge_rows_small"])
def test_plain_decode_matches_pallas_kernel_interpreted(kind):
    hm = _maps(kind)
    got = thm.decode_heatmaps_plain(torch.from_numpy(hm), "udp").numpy()
    want = np.asarray(decode_kernel.decode_heatmaps_pallas(jnp.asarray(hm), interpret=True))
    _assert_decodes_equal(got, want)


@pytest.mark.parametrize("method", ["udp", "quarter", "argmax"])
def test_decode_matches_jax_decode(method):
    hm = _maps("noise")
    got = thm.decode_heatmaps(torch.from_numpy(hm), method).numpy()
    want = np.asarray(jhm.decode_heatmaps(jnp.asarray(hm), method=method))
    _assert_decodes_equal(got, want)


def test_ties_and_degenerate_rows():
    rows = torch.from_numpy(chip_smoke.decode_edge_rows(64, 48))
    out = thm.decode_heatmaps(rows, "udp")
    assert out[0].tolist() == [0.0, 0.0, 0.0]                  # all zeros -> (0, 0)
    assert out[1, :2].round().tolist() == [48 // 2, 64 // 3]   # the first of two maxima
    assert out[1, 2] == pytest.approx(0.9)
    # A corner peak's clamped neighbours give a one-sided Taylor step,
    # clipped to half a pixel, as in the reference.
    assert out[2, :2].round().abs().tolist() == [0.0, 0.0] and (out[2, :2].abs() <= 0.5).all()
    assert torch.isfinite(out).all()


def test_decode_on_cpu_launches_nothing():
    n0 = thm.decode_heatmaps.launches
    hm = torch.from_numpy(_maps("gaussians"))
    np.testing.assert_array_equal(thm.decode_heatmaps(hm, "udp").numpy(),
                                  thm.decode_heatmaps_plain(hm, "udp").numpy())
    assert thm.decode_heatmaps.launches == n0
    with pytest.raises(ValueError):
        thm.decode_heatmaps(hm, "nearest")


def test_heatmap_targets_match_jax():
    rng = np.random.default_rng(0)
    k = rng.uniform(-4, 66, (3, 17, 2)).astype(np.float32)      # some outside the map
    t, w = thm.make_heatmap_targets(torch.from_numpy(k), (64, 48), 1.25)
    tj, wj = jhm.make_heatmap_targets(jnp.asarray(k), (64, 48), 1.25)
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    assert 0 < w.sum() < w.numel()
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-6)


def test_image_keypoints_round_trip_matches_jax():
    rng = np.random.default_rng(1)
    kp = np.concatenate([rng.uniform(100, 800, (5, 17, 2)), np.ones((5, 17, 1))],
                        -1).astype(np.float32)
    boxes = np.stack([rng.uniform(300, 600, 5), rng.uniform(300, 600, 5),
                      rng.uniform(300, 500, 5), rng.uniform(400, 700, 5)], -1).astype(np.float32)
    got = thm.image_keypoints_to_heatmap(torch.from_numpy(kp), torch.from_numpy(boxes),
                                         (64, 48), (256, 192))
    want = jhm.image_keypoints_to_heatmap(jnp.asarray(kp), jnp.asarray(boxes), (64, 48),
                                          (256, 192))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    back = thm.keypoints_to_image(got, torch.from_numpy(boxes), (64, 48), (256, 192))
    np.testing.assert_allclose(back.numpy(), kp, atol=1e-2)


def test_planted_gaussians_decode_back():
    rng = np.random.default_rng(3)
    k = rng.uniform(4, 40, (2, 17, 2)).astype(np.float32)
    t, _ = thm.make_heatmap_targets(torch.from_numpy(k), (64, 48), 2.0)
    out = thm.decode_heatmaps(t, "udp")
    np.testing.assert_allclose(out[..., :2].numpy(), k, atol=1e-2)
