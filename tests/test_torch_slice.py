"""The port's whole slice against the JAX pipeline: analyze, compare-mode
analyze and analyze_batch with a reference, at the golden fixture config,
with and without the shipped decode contract (tracked decode, sigma 1.25,
suppress radius 2.0, mode features).  The JAX pipeline's seed-0 params are
carried over with weights.from_flax; both run on the CPU in float32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import types as jtypes
from golfaction_tpu.pipeline import orchestrator as jorch
from golfaction_tpu.pipeline import video_io as jvideo
from golfaction_tpu_torch.pipeline import orchestrator as torch_orch
from golfaction_tpu_torch import types as ttypes
from golfaction_tpu_torch.pipeline import video_io as tvideo
from tests.golden.common import GOLDEN_CFG, fixture_clips
from tests.torch_parity import port_config, port_params

SHIPPED_CFG = dataclasses.replace(
    GOLDEN_CFG,
    pose=dataclasses.replace(GOLDEN_CFG.pose, sigma=1.25, decode_tracking=4,
                             track_suppress_radius=2.0),
    error=dataclasses.replace(GOLDEN_CFG.error, mode_features=True),
)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _reference(kpts: np.ndarray) -> np.ndarray:
    """A reference swing unlike both clips: clip a's keypoints moved by a
    seeded offset.  (Aligned against itself, a clip's zero deviation puts
    the error head's projection feature at a discontinuity, so float noise
    decides it; see ROADMAP Queue 3.)"""
    rng = np.random.default_rng(7)
    out = np.array(kpts, np.float32)
    out[..., :2] += rng.normal(0.0, 2.0, out[..., :2].shape).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=["golden", "shipped_contract"])
def runs(request):
    jcfg = GOLDEN_CFG if request.param == "golden" else SHIPPED_CFG
    jpipe = jorch.Pipeline(jcfg, seed=0)
    tpipe = torch_orch.Pipeline(port_config(jcfg), port_params(jpipe.params),
                                device="cpu")
    clip_a, clip_b = fixture_clips()
    boxes = [jvideo.estimate_person_boxes(c, use_native=False) for c in (clip_a, clip_b)]
    out = {"boxes_port": [tvideo.estimate_person_boxes(c) for c in (clip_a, clip_b)],
           "boxes": boxes}
    a_jax = jpipe.analyze(clip_a, boxes=boxes[0])
    ref_k = _reference(a_jax.keypoints)
    ref_v = np.asarray(a_jax.valid)
    refs = {"jax": jtypes.Skeleton(keypoints=jnp.asarray(ref_k), valid=jnp.asarray(ref_v)),
            "port": ttypes.Skeleton(keypoints=torch.from_numpy(ref_k),
                                    valid=torch.from_numpy(ref_v))}
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        a = pipe.analyze(clip_a, boxes=boxes[0])
        b = pipe.analyze(clip_b, boxes=boxes[1], reference=refs[name])
        batch = pipe.analyze_batch([clip_a, clip_b], boxes=boxes, reference=refs[name])
        out[name] = {"a": a, "b": b, "batch": batch}
    return out


def test_motion_boxes_match(runs):
    for got, want in zip(runs["boxes_port"], runs["boxes"]):
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_keypoints(runs):
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(runs["port"][k].keypoints),
                                   _np(runs["jax"][k].keypoints), atol=1e-3)


def test_phase_logits_and_labels(runs):
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(runs["port"][k].phase_logits),
                                   _np(runs["jax"][k].phase_logits), atol=1e-3)
        np.testing.assert_array_equal(_np(runs["port"][k].phase_labels),
                                      _np(runs["jax"][k].phase_labels))


def test_error_probs(runs):
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(runs["port"][k].error_probs),
                                   _np(runs["jax"][k].error_probs), atol=1e-4)


def test_alignment(runs):
    got, want = runs["port"]["b"].alignment, runs["jax"]["b"].alignment
    np.testing.assert_allclose(_np(got.cost), _np(want.cost), rtol=1e-4)
    assert int(_np(got.path_length)) == int(_np(want.path_length))
    np.testing.assert_array_equal(_np(got.path), _np(want.path))


def test_analyze_batch_with_reference(runs):
    got, want = runs["port"]["batch"], runs["jax"]["batch"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g.keypoints), _np(w.keypoints), atol=1e-3)
        np.testing.assert_allclose(_np(g.phase_logits), _np(w.phase_logits), atol=1e-3)
        np.testing.assert_array_equal(_np(g.phase_labels), _np(w.phase_labels))
        np.testing.assert_allclose(_np(g.error_probs), _np(w.error_probs), atol=1e-4)
        np.testing.assert_allclose(_np(g.alignment.cost), _np(w.alignment.cost), rtol=1e-4)
        assert int(_np(g.alignment.path_length)) == int(_np(w.alignment.path_length))
        np.testing.assert_array_equal(_np(g.alignment.path), _np(w.alignment.path))


def test_batch_matches_single(runs):
    # analyze_batch and analyze agree inside the port.
    port = runs["port"]
    for single, batched in zip((port["a"], port["b"]), port["batch"]):
        np.testing.assert_allclose(_np(batched.keypoints), _np(single.keypoints), atol=1e-4)
    np.testing.assert_allclose(_np(port["batch"][1].alignment.cost),
                               _np(port["b"].alignment.cost), rtol=1e-5)


def test_cuda_by_default_and_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    cfg = port_config(GOLDEN_CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_orch.Pipeline(cfg)                       # device="cuda" is the default
    assert torch_orch.Pipeline(cfg, device="cpu").device.type == "cpu"
