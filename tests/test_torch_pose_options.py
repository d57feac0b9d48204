"""The pose pass's options in the port against the JAX package, on the CPU:
keypoint-seeded box refinement (box_refine_stride), temporal context
(pose.in_frames), the keypoint refiner and the heatmap-spread features; the
functions each needs, then the whole pipeline with one option on at a time.

The pipeline runs use the golden fixture's narrow config and clips, the JAX
pipeline's seed-0 params carried over with weights.from_flax, single-peak
decode (the tracked decode is discontinuous at near-tied modes)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg_mod
from golfaction_tpu import types as jtypes
from golfaction_tpu.models import error as jerror
from golfaction_tpu.models import refine as jrefine
from golfaction_tpu.ops import affine as jaffine
from golfaction_tpu.ops import heatmap as jheatmap
from golfaction_tpu.pipeline import orchestrator as jorch
from golfaction_tpu.pipeline import video_io as jvideo
from golfaction_tpu.train import data as jdata
from golfaction_tpu.train import loops as jloops
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import types as ttypes
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models.error import ErrorClassifier
from golfaction_tpu_torch.models.refine import KeypointRefiner
from golfaction_tpu_torch.ops import affine as taffine
from golfaction_tpu_torch.ops import heatmap as theatmap
from golfaction_tpu_torch.pipeline import orchestrator as torch_orch
from golfaction_tpu_torch.train import data as tdata
from golfaction_tpu_torch.train import loops as tloops
from tests.golden.common import GOLDEN_CFG, fixture_clips
from tests.torch_parity import port_config, port_params, sub_config, to_numpy


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _keypoints(rng, shape, hw=(96, 128)):
    xy = rng.uniform(0, 1, (*shape, 17, 2)) * np.array([hw[1], hw[0]])
    return np.concatenate([xy, rng.uniform(0.1, 1, (*shape, 17, 1))], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# Box tracking
# ---------------------------------------------------------------------------

def test_boxes_from_keypoints():
    rng = np.random.default_rng(0)
    k = _keypoints(rng, (2, 6))
    k[0, 0, :, :2] = 40.0                      # degenerate extent: min_size floors it
    k[0, 1, :, 0] += 200.0                     # center clipped to the frame
    for kw in ({}, {"margin": 1.5, "min_size": 9.6}):
        want = jaffine.boxes_from_keypoints(jnp.asarray(k), (96, 128), **kw)
        got = taffine.boxes_from_keypoints(torch.from_numpy(k), (96, 128), **kw)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("stride,T", [(4, 16), (8, 64), (3, 16), (4, 14), (5, 6)])
def test_interp_boxes(stride, T):
    rng = np.random.default_rng(stride * T)
    b = rng.uniform(10, 500, (-(-T // stride), 4)).astype(np.float32)
    want = jaffine.interp_boxes(jnp.asarray(b), stride, T)
    got = taffine.interp_boxes(torch.from_numpy(b), stride, T)
    assert tuple(got.shape) == (T, 4)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,window", [(16, 9), (64, 9), (6, 9), (5, 9), (2, 9), (1, 9), (16, 3)])
def test_smooth_boxes(T, window):
    rng = np.random.default_rng(T + window)
    b = rng.uniform(10, 500, (T, 4)).astype(np.float32)
    want = jaffine.smooth_boxes(jnp.asarray(b), window)
    got = taffine.smooth_boxes(torch.from_numpy(b), window)
    # rtol: the window mean is a difference of float32 running sums.
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Heatmap moments, refiner, spread features
# ---------------------------------------------------------------------------

def test_moment_stats():
    rng = np.random.default_rng(1)
    ys, xs = np.mgrid[0:64, 0:48].astype(np.float32)
    hm = np.stack([np.exp(-((xs - cx) ** 2 / (2 * sx ** 2) + (ys - cy) ** 2 / (2 * sy ** 2)))
                   + 0.2 * np.exp(-((xs - cx - 3) ** 2 + (ys - cy + 2) ** 2) / 8.0)
                   for cx, cy, sx, sy in rng.uniform([2, 2, 1, 1], [45, 61, 3, 3], (34, 4))])
    hm = (hm + rng.normal(0, 0.01, hm.shape)).astype(np.float32).reshape(2, 17, 64, 48)
    for radius in (8.0, 3.0):
        want = jheatmap.moment_stats(jnp.asarray(hm), radius)
        got = theatmap.moment_stats(torch.from_numpy(hm), radius)
        assert tuple(got.shape) == (2, 17, 5)
        np.testing.assert_allclose(_np(got)[..., :2], np.asarray(want)[..., :2], atol=1e-4)
        # The covariances are E[x^2] - mean^2 in float32 with coordinates up to
        # 64: both terms reach 4096, where one ulp is 4.9e-4, and each carries
        # a few ulps of its sum's order (measured gap 2.7e-3 px²).
        np.testing.assert_allclose(_np(got)[..., 2:], np.asarray(want)[..., 2:], atol=5e-3)


@pytest.fixture(scope="module")
def refiner():
    jc = jcfg_mod.RefineConfig(enabled=True, block_channels=(16, 16),
                               temporal_branches=((3, 1), (3, 2)), dtype="float32")
    rng = np.random.default_rng(2)
    k = _keypoints(rng, (2, 12))
    valid = np.ones((2, 12), bool)
    valid[1, 9:] = False
    model = jrefine.create_refine_model(jc)
    params = model.init(jax.random.key(0), jnp.asarray(k), jnp.asarray(valid))
    port = KeypointRefiner(sub_config(tcfg.RefineConfig, jc))
    return jc, model, params, port, k, valid


def test_refiner_is_identity_at_init(refiner):
    _, _, params, port, k, valid = refiner
    port.load_state_dict(weights.refine_state_dict(to_numpy(params)))
    out = port(torch.from_numpy(k), torch.from_numpy(valid))
    np.testing.assert_allclose(_np(out), k, atol=1e-6)
    fresh = KeypointRefiner(port.cfg)(torch.from_numpy(k), torch.from_numpy(valid))
    np.testing.assert_allclose(_np(fresh), k, atol=1e-6)


def test_refiner_matches_jax_from_exported_params(refiner):
    _, model, params, port, k, valid = refiner
    p = to_numpy(params)
    rng = np.random.default_rng(3)
    p["params"]["Dense_0"]["kernel"] = rng.normal(0, 0.2, (16, 2)).astype(np.float32)
    p["params"]["Dense_0"]["bias"] = rng.normal(0, 0.05, (2,)).astype(np.float32)
    port.load_state_dict(weights.refine_state_dict(p))
    for v in (valid, None):
        want = model.apply(jax.tree.map(jnp.asarray, p), jnp.asarray(k),
                           None if v is None else jnp.asarray(v))
        with torch.no_grad():
            got = port(torch.from_numpy(k), None if v is None else torch.from_numpy(v))
        assert np.abs(np.asarray(want) - k).max() > 0.1        # a real correction
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)
    back = weights.to_flax({"refine": port.state_dict()})["refine"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("with_aux", [False, True])
def test_error_head_spread_features(with_ref, with_aux):
    jc = jcfg_mod.ErrorConfig(hidden_dim=32, dtype="float32", spread_features=True)
    rng = np.random.default_rng(4)
    k = _keypoints(rng, (2, 12))
    logits = rng.normal(size=(2, 12, 9)).astype(np.float32)
    valid = np.ones((2, 12), bool)
    valid[0, 10:] = False
    ref = _keypoints(rng, (2, 12)) if with_ref else None
    aux = None
    if with_aux:
        c = rng.uniform(2, 40, (2, 12, 17, 2))
        aux = np.concatenate([c[..., :1], rng.normal(0, 3, (2, 12, 17, 1)), c[..., 1:],
                              rng.uniform(1, 10, (2, 12, 17, 1))], -1).astype(np.float32)
    model = jerror.create_error_model(jc)
    j = lambda a: None if a is None else jnp.asarray(a)      # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    params = model.init(jax.random.key(0), j(k), j(logits), j(valid), j(ref), j(aux))
    port = ErrorClassifier(sub_config(tcfg.ErrorConfig, jc))
    port.load_state_dict(weights.error_state_dict(to_numpy(params)))
    want = model.apply(params, j(k), j(logits), j(valid), j(ref), j(aux))
    with torch.no_grad():
        got = port(t(k), t(logits), t(valid), t(ref), t(aux))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


def test_spread_and_mode_features_stay_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        ErrorClassifier(tcfg.ErrorConfig(spread_features=True, mode_features=True))


# ---------------------------------------------------------------------------
# The trainers' pose batches with temporal context
# ---------------------------------------------------------------------------

def test_pose_batches_with_three_frames():
    pose = dict(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
                stage_channels=(8, 16, 32), deconv_channels=(16, 16), in_frames=3)
    jc, tc = jcfg_mod.PoseConfig(**pose), tcfg.PoseConfig(**pose)
    kw = dict(seed=5, image_hw=(96, 128), render=True, render_style="blob")
    js, ts = jdata.make_swing_batch(2, 6, **kw), tdata.make_swing_batch(2, 6, **kw)
    want = jloops.build_pose_batch(js, jc, frame_stride=2, box_jitter=0.1,
                                   jitter_rng=np.random.default_rng(1), full_frame_prob=0.3)
    got = tloops.build_pose_batch(ts, tc, frame_stride=2, box_jitter=0.1,
                                  jitter_rng=np.random.default_rng(1), full_frame_prob=0.3,
                                  device="cpu")
    assert tuple(got[0].shape) == (6, 64, 48, 9)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4)
    boxes = np.tile(np.float32([64, 48, 45, 60]), (6, 1))
    want = jloops.pose_eval_crops(js[0].frames, jnp.asarray(boxes), jc)
    got = tloops.pose_eval_crops(ts[0].frames, torch.from_numpy(boxes), tc)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)
    # Frame 0's context is (0, 0, 1): its first two groups are the same crop.
    assert torch.equal(got[0, ..., :3], got[0, ..., 3:6])


# ---------------------------------------------------------------------------
# The pipeline with one option on at a time
# ---------------------------------------------------------------------------

def _with(option: str):
    c = GOLDEN_CFG
    if option == "box_refine":
        return dataclasses.replace(c, box_refine_stride=4)
    if option == "in_frames":
        return dataclasses.replace(c, pose=dataclasses.replace(c.pose, in_frames=3))
    if option == "refine":
        return dataclasses.replace(c, refine=jcfg_mod.RefineConfig(
            enabled=True, block_channels=(8, 8), temporal_branches=((3, 1), (3, 2)),
            dtype="float32"))
    return dataclasses.replace(c, error=dataclasses.replace(c.error, spread_features=True))


@pytest.fixture(scope="module", params=["box_refine", "in_frames", "refine", "spread_features"])
def runs(request):
    jc = _with(request.param)
    jpipe = jorch.Pipeline(jc, seed=0)
    params = dict(jpipe.params)
    if request.param == "refine":
        # A zero head is the identity: give the refiner something to do.
        p = to_numpy(params["refine"])
        p["params"]["Dense_0"]["kernel"] = np.random.default_rng(6).normal(
            0, 0.3, (8, 2)).astype(np.float32)
        params["refine"] = jax.tree.map(jnp.asarray, p)
        jpipe = jorch.Pipeline(jc, params=params)
    tpipe = torch_orch.Pipeline(port_config(jc), port_params(params), device="cpu")
    clip_a, clip_b = fixture_clips()
    boxes = [jvideo.estimate_person_boxes(c, use_native=False) for c in (clip_a, clip_b)]
    a_jax = jpipe.analyze(clip_a, boxes=boxes[0])
    ref_k = np.array(a_jax.keypoints, np.float32)
    ref_k[..., :2] += np.random.default_rng(7).normal(0, 2.0, ref_k[..., :2].shape)
    ref_v = np.array(a_jax.valid)
    refs = {"jax": jtypes.Skeleton(keypoints=jnp.asarray(ref_k), valid=jnp.asarray(ref_v)),
            "port": ttypes.Skeleton(keypoints=torch.from_numpy(ref_k),
                                    valid=torch.from_numpy(ref_v))}
    out = {"option": request.param, "jax": {"a": a_jax}, "port": {}, "tpipe": tpipe}
    out["port"]["a"] = tpipe.analyze(clip_a, boxes=boxes[0])
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        out[name]["b"] = pipe.analyze(clip_b, boxes=boxes[1], reference=refs[name])
    out["port"]["batch"] = tpipe.analyze_batch([clip_a, clip_b], boxes=boxes,
                                               reference=refs["port"])
    return out


# Keypoint tolerances in image px.  The random-weight heatmaps are nearly
# flat, so the UDP step (a division by the log-heatmap Hessian) amplifies
# float32 noise about a hundredfold.  With in_frames=3 the nine-channel stem
# sums in another order (measured gap 1.03e-3).  With box refinement the
# second pass crops with boxes that already differ by 1e-3 px between the
# packages (the coarse pass's keypoints, from full-frame crops where one
# heatmap px is 8 image px, differ by 2.5e-3, and the smoothing is a
# difference of float32 running sums), measured gap 6.1e-2;
# test_refined_boxes_match_jax holds the boxes themselves to 5e-3 px.
KEYPOINT_ATOL = {"box_refine": 1.5e-1, "in_frames": 2e-3, "refine": 1e-3, "spread_features": 1e-3}


def test_pipeline_keypoints(runs):
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(runs["port"][k].keypoints),
                                   _np(runs["jax"][k].keypoints),
                                   atol=KEYPOINT_ATOL[runs["option"]])


def test_refined_boxes_match_jax():
    """The box refinement stage by stage: coarse keypoints from full-frame
    boxes, tight boxes, interpolation, smoothing."""
    jc = _with("box_refine")
    jpipe = jorch.Pipeline(jc, seed=0)
    tpipe = torch_orch.Pipeline(port_config(jc), port_params(jpipe.params), device="cpu")
    _, clip = fixture_clips()
    frames, _, _ = jvideo.pad_to_bucket(clip, jvideo.estimate_person_boxes(
        clip, use_native=False), jc.length_buckets)
    T, H, W = frames.shape[:3]
    s = jc.box_refine_stride
    full = np.tile(np.float32([W / 2.0, H / 2.0, W, H]), (len(frames[::s]), 1))
    coarse = jpipe._pose_pass(jpipe.params, jnp.asarray(frames[::s]), jnp.asarray(full))
    want = jaffine.smooth_boxes(jaffine.interp_boxes(jaffine.boxes_from_keypoints(
        coarse, (H, W), min_size=0.1 * H), s, T), window=9)
    seen = []
    pass_ = tpipe._pose_pass
    contiguous = []
    tpipe._pose_pass = lambda f, b, **kw: (seen.append(b), contiguous.append(f.is_contiguous()),
                                           pass_(f, b, **kw))[2]
    with torch.inference_mode():
        tpipe._pose_fn(torch.from_numpy(frames)[None], torch.zeros((1, T, 4)))
    assert all(contiguous)             # kernel A takes no strided frames
    assert len(seen) == 2 and tuple(seen[0].shape) == (1, len(full), 4)
    np.testing.assert_array_equal(_np(seen[0][0]), full)      # the coarse pass: full frame
    np.testing.assert_allclose(_np(seen[1][0]), np.asarray(want), atol=5e-3)
    assert (np.abs(_np(seen[1][0]) - full[0]).max(axis=-1) > 1.0).all()


def test_pipeline_phase_labels(runs):
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(runs["port"][k].phase_logits),
                                   _np(runs["jax"][k].phase_logits), atol=1e-3)
        np.testing.assert_array_equal(_np(runs["port"][k].phase_labels),
                                      _np(runs["jax"][k].phase_labels))


def test_pipeline_error_probs(runs):
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(runs["port"][k].error_probs),
                                   _np(runs["jax"][k].error_probs), atol=1e-4)


def test_pipeline_batch_matches_single(runs):
    port = runs["port"]
    for single, batched in zip((port["a"], port["b"]), port["batch"]):
        np.testing.assert_allclose(_np(batched.keypoints), _np(single.keypoints), atol=1e-4)
    np.testing.assert_allclose(_np(port["batch"][1].error_probs), _np(port["b"].error_probs),
                               atol=1e-5)


def test_option_is_really_on(runs):
    """Each option changes what the pipeline computes: against the same
    params with the option off, the keypoints (or the error head's input
    width) differ."""
    tpipe, option = runs["tpipe"], runs["option"]
    if option == "in_frames":
        assert tpipe.pose_model.stem.in_channels == 9
    elif option == "spread_features":
        assert tpipe.error_model.fc0.in_features == tcfg.ErrorConfig().num_joints * 2 + \
            torch_orch.ErrorClassifier(tcfg.ErrorConfig()).fc0.in_features
    else:
        off = {"box_refine": {"box_refine_stride": 0},
               "refine": {"refine": tcfg.RefineConfig()}}[option]
        sds = {k: m.state_dict() for k, m in tpipe.models.items() if k != "refine"}
        plain = torch_orch.Pipeline(dataclasses.replace(tpipe.cfg, **off), sds, device="cpu")
        clip_a, _ = fixture_clips()
        boxes = jvideo.estimate_person_boxes(clip_a, use_native=False)
        base = plain.analyze(clip_a, boxes=boxes)
        diff = (base.keypoints - runs["port"]["a"].keypoints)[runs["port"]["a"].valid]
        assert float(diff.abs().max()) > 1e-2
