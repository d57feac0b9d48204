"""The shipped model from artifacts/ at full width in both packages: one clip
of 16 frames (bucket 16, 270x480) with a reference swing, on the CPU.

  * float32 on both sides: keypoints within 1e-3 px, phase labels and the
    alignment path exact, error probabilities within 1e-4;
  * the shipped dtype (the port's defaults, bfloat16; the JAX side with
    gcn.dtype=float32, the program its TPU path runs, see
    golfaction_tpu_torch/models/gcn.py):
      - layer by layer on one full-width crop, each port layer given the
        flax layer's input (flax run op by op) equals the flax layer's
        output but for one-ulp flips where the two sum in another order:
        at most 1% of the elements differ [measured <= 0.5%], by at most
        1e-2 of the layer's largest value [4.8e-3].  The float32 control
        (the same layer at float32) differs on more than 99% of them;
      - the keypoints of the whole program lie strictly nearer the JAX
        package's bfloat16 program than its float32 program does: a larger
        share within 0.5 px and a smaller median gap [0.967 against 0.956,
        0.056 against 0.073 px], which the float32 control (the port's
        float32, equal to the JAX float32 to 1e-3 px) cannot meet.  The
        JAX side is compiled with every bfloat16 rounding kept
        (xla_allow_excess_precision off): its default CPU compilation skips
        roundings inside fusions, a liberty of the compiler, not of flax's
        semantics.  Bfloat16 noise is chaotic through the tracked decode,
        so no second implementation that sums in another order can reach
        0.5 px on 99% of the pairs: the JAX package's own two compilations
        agree on 93.8% of them (tools/bf16_spread.py, PERF.md);
      - the program after the pose network on the JAX side's own keypoints
        and mode features: phase logits (float32 GCN on both sides) within
        1e-3 and labels exact, error probabilities (the bfloat16 head)
        within 1e-2, alignment cost within rel 1e-2 and the path exact.

It also runs the port's demo_e2e at tiny counts on the CPU and holds its
JSON keys to those of the JAX script's shipped result
(artifacts/demo/e2e_metrics.json).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu import types as jtypes
from golfaction_tpu.ops import preprocess as jpre
from golfaction_tpu.pipeline import orchestrator as jorch
from golfaction_tpu.pipeline import video_io as jvideo
from golfaction_tpu.train import checkpoint as jckpt
from golfaction_tpu.train import data as jdata
from golfaction_tpu_torch import demo_e2e
from golfaction_tpu_torch import types as ttypes
from golfaction_tpu_torch.models.gcn import normalize_skeleton as tnorm
from golfaction_tpu_torch.pipeline import orchestrator as torch_orch
from tests.torch_parity import flax_pose_layers, pose_layer_gaps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "artifacts")
T, HW = 16, (270, 480)
F32 = ["pose.dtype='float32'", "gcn.dtype='float32'", "align.dtype='float32'",
       "error.dtype='float32'", "refine.dtype='float32'"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def clip():
    s = jdata.make_swing_batch(1, T, seed=995_000, image_hw=HW, render=True,
                               fault_prob=0.0)[0]
    return s.frames, jvideo.estimate_person_boxes(s.frames, use_native=False)


def _run(mode, frames, boxes):
    overrides = [f"video_hw={HW}", f"length_buckets=({T},)"]
    port_sets = overrides + (F32 if mode == "float32" else [])
    jax_sets = overrides + (F32 if mode == "float32" else ["gcn.dtype='float32'"])
    cfg = jckpt.config_for_artifacts(
        jcfg.apply_overrides(jcfg.get_config("full_pipeline"), jax_sets), ARTIFACTS)
    jpipe = jorch.Pipeline(cfg, seed=0)
    jpipe.params = jckpt.load_pipeline_params(ARTIFACTS, like=jpipe.params)
    tpipe = torch_orch.Pipeline.from_artifacts(ARTIFACTS, device="cpu", overrides=port_sets)
    assert tpipe.cfg.pose.dtype == cfg.pose.dtype
    frames_p, boxes_p, valid = jvideo.pad_to_bucket(frames, boxes, (T,))
    args = (jpipe.params, jnp.asarray(frames_p), jnp.asarray(boxes_p), jnp.asarray(valid))
    core = jpipe._core(*args)
    kept = None
    if mode == "shipped":       # every bfloat16 rounding the program states
        kept = jpipe._core.lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)["keypoints"]
    # A reference unlike the clip (a clip against itself puts the error
    # head at a discontinuity; ROADMAP, reference behaviour (i)).
    ref = np.array(core["keypoints"], np.float32)
    ref[..., :2] += np.random.default_rng(7).normal(0, 3.0, ref[..., :2].shape)
    want = jpipe.analyze(frames, boxes=boxes, reference=jtypes.Skeleton(
        keypoints=jnp.asarray(ref), valid=jnp.asarray(valid)))
    got = tpipe.analyze(frames, boxes=boxes, reference=ttypes.Skeleton(
        keypoints=torch.from_numpy(ref), valid=torch.from_numpy(valid)))
    return dict(jpipe=jpipe, tpipe=tpipe, core=core, kept=kept, ref=ref, valid=valid,
                want=want, got=got)


@pytest.fixture(scope="module")
def runs(clip):
    return {mode: _run(mode, *clip) for mode in ("float32", "shipped")}


def test_float32_matches_the_jax_package(runs):
    want, got = runs["float32"]["want"], runs["float32"]["got"]
    np.testing.assert_allclose(_np(got.keypoints), _np(want.keypoints), atol=1e-3)
    np.testing.assert_array_equal(_np(got.phase_labels), _np(want.phase_labels))
    np.testing.assert_allclose(_np(got.error_probs), _np(want.error_probs), atol=1e-4)
    assert int(_np(got.alignment.path_length)) == int(_np(want.alignment.path_length))
    np.testing.assert_array_equal(_np(got.alignment.path), _np(want.alignment.path))


def _share_within(a, b, px=0.5):
    gap = np.linalg.norm(_np(a)[..., :2] - _np(b)[..., :2], axis=-1)
    return np.mean(gap <= px), np.median(gap)


def test_shipped_keypoints_within_the_reference_bfloat16_noise(runs):
    kept = runs["shipped"]["kept"]
    share, median = _share_within(runs["shipped"]["got"].keypoints, kept)
    ref_share, ref_median = _share_within(runs["float32"]["want"].keypoints, kept)
    f32_share, f32_median = _share_within(runs["float32"]["got"].keypoints, kept)
    assert share > ref_share and median < ref_median, (share, ref_share, median, ref_median)
    # The float32 control cannot meet the bar.
    assert not (f32_share > ref_share and f32_median < ref_median), (f32_share, f32_median)


def test_shipped_pose_layers_round_as_flax(clip, runs):
    frames, boxes = clip
    jpipe, tpipe = runs["shipped"]["jpipe"], runs["shipped"]["tpipe"]
    crop = jpre.crop_resize_normalize(jnp.asarray(frames[:1]), jnp.asarray(boxes[:1]),
                                      jpipe.cfg.pose.input_hw)
    layers = flax_pose_layers(jpipe.pose_model, jpipe.params["pose"], crop)
    assert len(layers) == 47
    for path, differ, gap in pose_layer_gaps(tpipe.pose_model, layers, torch.bfloat16):
        assert differ <= 1e-2 and gap <= 1e-2, (path, differ, gap)
    # The float32 control differs almost everywhere.
    for path, differ, _ in pose_layer_gaps(tpipe.pose_model, layers, torch.float32):
        assert differ > 0.99, (path, differ)


def test_shipped_program_after_the_pose_network(runs):
    r = runs["shipped"]
    jpipe, tpipe, core, valid = r["jpipe"], r["tpipe"], r["core"], r["valid"]
    k, aux = _np(core["keypoints"]), _np(core["kpt_aux"])
    kt, vt, auxt = torch.from_numpy(np.array(k)), torch.from_numpy(valid), torch.from_numpy(
        np.array(aux))
    with torch.no_grad():
        logits = tpipe.gcn_model(tnorm(kt[None], vt[None]), vt[None])[0]
        a = tpipe._align_refine_fn(kt, vt, torch.from_numpy(r["ref"]), vt, logits, auxt)
    want = jpipe._align_refine(jpipe.params, core["keypoints"], jnp.asarray(valid),
                               jnp.asarray(r["ref"]), jnp.asarray(valid),
                               core["phase_logits"], core["kpt_aux"])
    np.testing.assert_allclose(_np(logits), _np(core["phase_logits"]), atol=1e-3)
    np.testing.assert_array_equal(_np(logits).argmax(-1), _np(core["phase_labels"]))
    np.testing.assert_allclose(_np(torch.sigmoid(a["error_logits"])),
                               np.asarray(jax.nn.sigmoid(want["error_logits"])), atol=1e-2)
    np.testing.assert_allclose(_np(a["cost"]), _np(want["cost"]), rtol=1e-2)
    np.testing.assert_array_equal(_np(a["path"]), _np(want["path"]))


def _keys(tree):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in tree.items()}


def test_demo_e2e_keys_match_the_jax_script(tmp_path):
    got = demo_e2e.main(["--artifacts", ARTIFACTS, "--out", str(tmp_path), "--device", "cpu",
                         "--clips", "1", "--per-fault", "1", "--domain-clips", "1",
                         "--jitter-clips", "1", "--frames", "16", "--hw", "270", "480"])
    with open(os.path.join(ARTIFACTS, "demo", "e2e_metrics.json")) as f:
        want = json.load(f)
    assert _keys(got) == _keys(want)
    assert json.load(open(tmp_path / "e2e_metrics.json")) == got
    assert os.path.getsize(got["comparison_video"]) > 0
    for v in (got["pck05_mean"], got["phase_acc_mean"], got["phase_f1_mean"],
              *got["error_detection"].values(), got["align_progress_err_mean"]):
        assert 0.0 <= v <= 1.0
