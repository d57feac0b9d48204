"""The port's C++ motion boxes (golfaction_tpu_torch/native) against the JAX
package's library and the numpy body, and the default analyze (no boxes
given, so the C++ boxes) against the JAX pipeline's default analyze."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import native as jnative
from golfaction_tpu import types as jtypes
from golfaction_tpu.pipeline import orchestrator as jorch
from golfaction_tpu_torch import native
from golfaction_tpu_torch import types as ttypes
from golfaction_tpu_torch.ops import _kernels
from golfaction_tpu_torch.pipeline import orchestrator as torch_orch
from golfaction_tpu_torch.pipeline import video_io
from tests.golden.common import GOLDEN_CFG, fixture_clips
from tests.test_torch_slice import SHIPPED_CFG, _reference
from tests.torch_parity import port_config, port_params


def _clip(t=12, h=90, w=120, seed=0):
    """A bar moving right over noise (tests/test_native.py's clip)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(25, 45, (t, h, w, 3)).astype(np.uint8)
    for i in range(t):
        cx = 30 + 5 * i
        frames[i, 15:70, cx - 8:cx + 8] = 210
    return frames


def _clips():
    a, b = fixture_clips()
    return {"fixture_a": a, "fixture_b": b, "static": np.full((6, 80, 100, 3), 33, np.uint8),
            **{f"bar_t{t}": _clip(t=t, seed=t) for t in (1, 2, 5, 9, 16)},
            "bar_wide": _clip(t=7, h=72, w=200, seed=3)}


@pytest.mark.parametrize("name", sorted(_clips()))
def test_motion_boxes_equal_the_jax_library_and_sit_near_the_numpy_body(name):
    frames = _clips()[name]
    if not jnative.available():
        pytest.fail("the JAX package's native library did not build: nothing to compare with")
    got = native.motion_boxes(frames)
    np.testing.assert_array_equal(got, jnative.motion_boxes(frames))
    np.testing.assert_allclose(got, video_io.estimate_person_boxes(frames, use_native=False),
                               atol=1.0)
    np.testing.assert_array_equal(video_io.estimate_person_boxes(frames), got)   # the default


@pytest.mark.parametrize("min_size,smooth", [(0.15, 9), (0.3, 1), (0.05, 4)])
def test_motion_box_options_reach_the_library(min_size, smooth):
    frames = _clip(t=10, seed=1)
    got = video_io.estimate_person_boxes(frames, smooth=smooth, min_size=min_size)
    np.testing.assert_array_equal(
        got, jnative.motion_boxes(frames, min_size=min_size, smooth=smooth))
    np.testing.assert_allclose(
        got, video_io.estimate_person_boxes(frames, smooth=smooth, min_size=min_size,
                                            use_native=False), atol=1.0)


def test_bgr_to_rgb_swaps_channels_as_the_jax_library():
    x = np.random.default_rng(0).integers(0, 256, (3, 8, 9, 3)).astype(np.uint8)
    got = native.bgr_to_rgb(x)
    np.testing.assert_array_equal(got, x[..., ::-1])
    np.testing.assert_array_equal(got, jnative.bgr_to_rgb(x))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "golfer_host.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_kernels, "NATIVE", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setattr(_kernels, "_fns", {})
    with pytest.raises(RuntimeError, match="failed for libgolfer_host"):
        video_io.estimate_person_boxes(_clip())
    with pytest.raises(ValueError, match="frames"):
        native.motion_boxes(np.zeros((2, 4, 4), np.uint8))


@pytest.fixture(scope="module", params=["golden", "shipped_contract"])
def default_runs(request):
    """Both pipelines' analyze with no boxes (each package's default: its
    C++ motion boxes), alone and against a reference."""
    jcfg = GOLDEN_CFG if request.param == "golden" else SHIPPED_CFG
    jpipe = jorch.Pipeline(jcfg, seed=0)
    tpipe = torch_orch.Pipeline(port_config(jcfg), port_params(jpipe.params), device="cpu")
    clip_a, clip_b = fixture_clips()
    out = {}
    a_jax = jpipe.analyze(clip_a)
    ref_k, ref_v = _reference(a_jax.keypoints), np.array(a_jax.valid)
    refs = {"jax": jtypes.Skeleton(keypoints=jnp.asarray(ref_k), valid=jnp.asarray(ref_v)),
            "port": ttypes.Skeleton(keypoints=torch.from_numpy(ref_k),
                                    valid=torch.from_numpy(ref_v))}
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        out[name] = {"a": pipe.analyze(clip_a),
                     "b": pipe.analyze(clip_b, reference=refs[name]),
                     "batch": pipe.analyze_batch([clip_a, clip_b], reference=refs[name])}
    return out


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def test_default_analyze_matches_jax_default(default_runs):
    port, jax_ = default_runs["port"], default_runs["jax"]
    pairs = [(port["a"], jax_["a"]), (port["b"], jax_["b"])]
    pairs += list(zip(port["batch"], jax_["batch"]))
    for got, want in pairs:
        np.testing.assert_allclose(_np(got.keypoints), _np(want.keypoints), atol=1e-3)
        np.testing.assert_array_equal(_np(got.phase_labels), _np(want.phase_labels))
        np.testing.assert_allclose(_np(got.phase_logits), _np(want.phase_logits), atol=1e-3)
        np.testing.assert_allclose(_np(got.error_probs), _np(want.error_probs), atol=1e-4)


def test_default_alignment_matches_jax_default(default_runs):
    port, jax_ = default_runs["port"], default_runs["jax"]
    for got, want in [(port["b"], jax_["b"])] + list(zip(port["batch"], jax_["batch"])):
        g, w = got.alignment, want.alignment
        np.testing.assert_allclose(_np(g.cost), _np(w.cost), rtol=1e-4)
        assert int(_np(g.path_length)) == int(_np(w.path_length))
        np.testing.assert_array_equal(_np(g.path), _np(w.path))
