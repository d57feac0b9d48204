"""`preprocess_dtype="bfloat16"` in the port against the JAX package, on the
CPU: the bfloat16 crops equal to the bit, the float32 crops unchanged, the
config, the whole pipeline at the knob, the probes' pose front and the
port's `bench_preprocess_dtype`.

The pipelines run the golden fixture's widths in float32 with the port's
seeded random parameters, carried into the JAX package by
`weights.to_flax` (which skips JAX's slow init); the pipeline is held at
tests/test_torch_slice.py's limits.  The JAX pipeline's crop front
(`affine.box_to_center_scale`, `preprocess.crop_resize_normalize`) runs as
written there, op by op in a host callback, and the rest of it jitted: under
jit XLA computes the crops' sample coordinates with reciprocal multiplies and
fused multiply-adds, one float32 ulp off the operations as written, and a
bfloat16 rounding turns that into one bfloat16 ulp on about 0.2% of the
crop values.  The jitted pipeline's keypoints then differ from its own
op-by-op run by up to 0.59 px, as far as the port's do
(`python tools/bf16_crop_spread.py`).  The bfloat16 kernel itself is
checked on the card by tests/test_torch_kernels_cuda.py.
"""

import contextlib
import dataclasses
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import types as jtypes
from golfaction_tpu.ops import affine as jaffine
from golfaction_tpu.ops import preprocess as jpre
from golfaction_tpu.pipeline import orchestrator as jorch
from golfaction_tpu.pipeline import video_io as jvideo
from golfaction_tpu_torch import bench_preprocess_dtype, weights
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import types as ttypes
from golfaction_tpu_torch.ops import preprocess as tpre
from golfaction_tpu_torch.pipeline import orchestrator as torch_orch
from tests.golden.common import GOLDEN_CFG, fixture_clips
from tests.torch_cascade_tree import ROOT
from tests.torch_parity import port_config

sys.path.insert(0, str(ROOT / "scripts"))
import _probe_common as jprobe  # noqa: E402

OUT_HWS = ((64, 48), (33, 31))
# in-frame, partly outside, wholly outside, and every sample coordinate in
# [-1, 1) (the taps around the frame's first pixel, where the hat weight of
# a tap and frac / 1 - frac part ways in float32).
BOX_KINDS = ("inside", "partly_outside", "outside", "unit_corner")


def _np(x):
    return np.asarray(x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) else x)


def _inputs(seed: int, kind: str, b: int = 4, h: int = 90, w: int = 120):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    if kind == "unit_corner":
        # Centers in [-0.1, 0.1] and sizes in [0.2, 0.9]: every coordinate
        # start + i * step lies in [-0.55, 0.55].
        boxes = np.stack([rng.uniform(-0.1, 0.1, b), rng.uniform(-0.1, 0.1, b),
                          rng.uniform(0.2, 0.9, b), rng.uniform(0.2, 0.9, b)], axis=-1)
    else:
        lo, hi = {"inside": (0.3, 0.7), "partly_outside": (-0.3, 1.3),
                  "outside": (1.8, 2.5)}[kind]
        boxes = np.stack([rng.uniform(lo * w, hi * w, b), rng.uniform(lo * h, hi * h, b),
                          rng.uniform(0.2 * w, 0.9 * w, b), rng.uniform(0.3 * h, 1.4 * h, b)],
                         axis=-1)
    return frames, boxes.astype(np.float32)


@pytest.mark.parametrize("kind", BOX_KINDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_reference_equals_jax_bit_for_bit(seed, kind):
    frames, boxes = _inputs(seed, kind)
    f, b = torch.from_numpy(frames), torch.from_numpy(boxes)
    for out_hw in OUT_HWS:
        want = jpre.crop_resize_normalize(jnp.asarray(frames), jnp.asarray(boxes), out_hw,
                                          dtype=jnp.bfloat16)
        got = tpre.crop_resize_normalize_bf16_reference(f, b, out_hw)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        # Compared as float32: every bfloat16 value is exact there.
        np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))
        n0 = tpre.crop_resize_normalize_bf16.launches
        entry = tpre.crop_resize_normalize(f, b, out_hw, dtype=torch.bfloat16)
        assert tpre.crop_resize_normalize_bf16.launches == n0     # no kernel on the CPU
        assert torch.equal(entry, got)
    if kind == "outside":      # normalized zero, as JAX's zero border gives
        zero = -torch.tensor(tpre.IMAGENET_MEAN) / torch.tensor(tpre.IMAGENET_STD)
        assert torch.equal(got, zero.to(torch.bfloat16).expand_as(got))


def test_kernel_reciprocals_are_the_correctly_rounded_ones():
    """The bfloat16 kernel divides by each std and by 255 with RN(1/d) and one
    correction (csrc/preprocess.cu:divide); the launch passes what
    division_reciprocals computes: the float32 nearest the exact reciprocal of
    the float32 divisor that the plain version and JAX divide by."""
    from fractions import Fraction

    got = tpre.division_reciprocals(tpre.IMAGENET_MEAN, tpre.IMAGENET_STD)
    divisors = [np.float32(v) for v in tpre.IMAGENET_STD] + [np.float32(255.0)]
    assert len(got) == 4
    for r, d in zip(got, divisors):
        r32 = np.float32(r)
        assert float(r32) == r
        exact = 1 / Fraction(float(d))
        for n in (np.nextafter(r32, np.float32(0)), np.nextafter(r32, np.float32(np.inf))):
            assert abs(Fraction(float(r32)) - exact) < abs(Fraction(float(n)) - exact)
    # jnp's float32 constants are the same divisors.
    assert [float(v) for v in np.asarray(jnp.asarray(tpre.IMAGENET_STD, jnp.float32))] == \
        [float(v) for v in divisors[:3]]


@pytest.mark.parametrize("mean,std,ok", [
    ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), True),
    ((-3.0, 2.0 ** -40, 0.5), (2.0 ** 40, 2.0 ** -40, 7.0), True),
    ((0.5, 0.5, 0.5), (0.2, 0.0, 0.2), False),
    ((0.5, 0.5, 0.5), (0.2, -0.2, 0.2), False),
    ((0.5, 0.5, 0.5), (2.0 ** 41, 0.2, 0.2), False),
    ((1e-45, 0.5, 0.5), (0.2, 0.2, 0.2), False),
    ((0.5, 2.0 ** 41, 0.5), (0.2, 0.2, 0.2), False)])
def test_kernel_division_refuses_what_it_cannot_take(mean, std, ok):
    """Outside these ranges an operand, remainder or quotient of the kernel's
    divisions could leave float32's normal range, where a reciprocal and one
    correction may round otherwise than IEEE division."""
    if ok:
        assert len(tpre.division_reciprocals(mean, std)) == 4
    else:
        with pytest.raises(ValueError, match="division"):
            tpre.division_reciprocals(mean, std)


@pytest.mark.parametrize("kind", BOX_KINDS)
def test_float32_entry_point_is_unchanged(kind):
    """At float32 (the default) the entry point is still the float32 gather,
    to the bit; a dtype that is neither is refused."""
    frames, boxes = _inputs(7, kind)
    f, b = torch.from_numpy(frames), torch.from_numpy(boxes)
    want = tpre.crop_resize_normalize_reference(f, b, (64, 48))
    for got in (tpre.crop_resize_normalize(f, b, (64, 48)),
                tpre.crop_resize_normalize(f, b, (64, 48), dtype=torch.float32)):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tpre.crop_resize_normalize(f, b, (64, 48), dtype=torch.float16)


@pytest.mark.parametrize("build", [
    lambda: tcfg.PipelineConfig(preprocess_dtype="bfloat16"),
    lambda: tcfg.get_config("full_pipeline", preprocess_dtype="bfloat16"),
    lambda: tcfg.apply_overrides(tcfg.get_config(), ["preprocess_dtype=bfloat16"]),
    lambda: dataclasses.replace(tcfg.get_config(), preprocess_dtype="bfloat16"),
])
def test_config_accepts_bfloat16(build):
    assert build().preprocess_dtype == "bfloat16"
    with pytest.raises(ValueError, match="'float32', 'bfloat16'"):
        dataclasses.replace(build(), preprocess_dtype="float16")


# ---------------------------------------------------------------------------
# The pipeline at preprocess_dtype="bfloat16"
# ---------------------------------------------------------------------------

def _reference(kpts: np.ndarray) -> np.ndarray:
    """A reference swing unlike both clips (tests/test_torch_slice.py's)."""
    rng = np.random.default_rng(7)
    out = np.array(kpts, np.float32)
    out[..., :2] += rng.normal(0.0, 2.0, out[..., :2].shape).astype(np.float32)
    return out


def _pipelines(jcfg, seed: int = 0):
    """The port at `jcfg` with seeded random weights, and the JAX pipeline
    with the same weights."""
    tc = port_config(jcfg)
    sd = torch_orch.init_params(tc, seed=seed)
    return torch_orch.Pipeline(tc, sd, device="cpu"), jorch.Pipeline(jcfg,
                                                                     params=weights.to_flax(sd))


@contextlib.contextmanager
def crop_front_as_written():
    """JAX's crop front, its own unchanged functions, run as written inside
    the jitted pipeline (the module docstring says why)."""
    box_fn, crop_fn = jaffine.box_to_center_scale, jpre.crop_resize_normalize

    def boxes(b, aspect_ratio):
        return jax.pure_callback(lambda x: np.asarray(box_fn(x, aspect_ratio)),
                                 jax.ShapeDtypeStruct(b.shape, b.dtype), b,
                                 vmap_method="sequential")

    def crops(frames, b, out_hw, mean=jpre.IMAGENET_MEAN, std=jpre.IMAGENET_STD,
              dtype=jnp.float32):
        shape = jax.ShapeDtypeStruct((frames.shape[0], *out_hw, 3), jnp.dtype(dtype))
        return jax.pure_callback(
            lambda f, x: np.asarray(crop_fn(f, x, out_hw, mean, std, dtype)), shape, frames, b,
            vmap_method="sequential")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaffine, "box_to_center_scale", boxes)
        mp.setattr(jpre, "crop_resize_normalize", crops)
        yield


@pytest.fixture(scope="module", params=[1, 3], ids=["in_frames_1", "in_frames_3"])
def runs(request):
    jcfg = dataclasses.replace(
        GOLDEN_CFG, preprocess_dtype="bfloat16",
        pose=dataclasses.replace(GOLDEN_CFG.pose, in_frames=request.param))
    tpipe, jpipe = _pipelines(jcfg)
    clip_a, clip_b = fixture_clips()
    boxes = [jvideo.estimate_person_boxes(c, use_native=False) for c in (clip_a, clip_b)]
    out = {}
    with crop_front_as_written():
        a_jax = jpipe.analyze(clip_a, boxes=boxes[0])
        ref_k, ref_v = _reference(a_jax.keypoints), np.array(a_jax.valid)
        refs = {"jax": jtypes.Skeleton(keypoints=jnp.asarray(ref_k), valid=jnp.asarray(ref_v)),
                "port": ttypes.Skeleton(keypoints=torch.from_numpy(ref_k),
                                        valid=torch.from_numpy(ref_v))}
        for name, pipe in (("jax", jpipe), ("port", tpipe)):
            out[name] = {"a": pipe.analyze(clip_a, boxes=boxes[0]),
                         "b": pipe.analyze(clip_b, boxes=boxes[1], reference=refs[name]),
                         "batch": pipe.analyze_batch([clip_a, clip_b], boxes=boxes,
                                                     reference=refs[name])}
    f32 = torch_orch.Pipeline(dataclasses.replace(tpipe.cfg, preprocess_dtype="float32"),
                              {k: m.state_dict() for k, m in tpipe.models.items()},
                              device="cpu")
    out["port_f32"] = {"a": f32.analyze(clip_a, boxes=boxes[0]),
                       "b": f32.analyze(clip_b, boxes=boxes[1])}
    return out


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


def test_error_probs_and_alignment(runs):
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(runs["port"][k].error_probs),
                                   _np(runs["jax"][k].error_probs), atol=1e-4)
    got, want = runs["port"]["b"].alignment, runs["jax"]["b"].alignment
    np.testing.assert_allclose(_np(got.cost), _np(want.cost), rtol=1e-4)
    np.testing.assert_array_equal(_np(got.path), _np(want.path))


def test_analyze_batch_with_reference(runs):
    got, want = runs["port"]["batch"], runs["jax"]["batch"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g.keypoints), _np(w.keypoints), atol=1e-3)
        np.testing.assert_allclose(_np(g.phase_logits), _np(w.phase_logits), atol=1e-3)
        np.testing.assert_allclose(_np(g.error_probs), _np(w.error_probs), atol=1e-4)
        np.testing.assert_allclose(_np(g.alignment.cost), _np(w.alignment.cost), rtol=1e-4)
        np.testing.assert_array_equal(_np(g.alignment.path), _np(w.alignment.path))


def test_bf16_crops_keep_keypoints_near_float32(runs):
    """The JAX package's own property (tests/test_pipeline.py): the median
    keypoint gap between bfloat16 and float32 crops is under 2 px, and the
    knob does change the crops the pose net sees."""
    for k in ("a", "b"):
        bf, f32 = _np(runs["port"][k].keypoints), _np(runs["port_f32"][k].keypoints)
        assert np.isfinite(bf).all()
        assert np.median(np.abs(bf[..., :2] - f32[..., :2])) < 2.0
        assert not np.array_equal(bf, f32)


def test_probe_pose_front_with_box_refinement():
    """`_pose_heatmaps` with box refinement and the knob on against the JAX
    probes' pose front (`make_pose_heatmaps_fn`): the coarse pass crops in
    bfloat16 and the final crops in float32 in both.  Held as
    tests/test_torch_probes.py holds it: boxes within 1e-2 px, heatmaps within
    1e-4 of their peak of the JAX crop and net on the port's boxes, within
    1e-3 of the peak of JAX's heatmaps from its own boxes."""
    jcfg = dataclasses.replace(GOLDEN_CFG, preprocess_dtype="bfloat16", box_refine_stride=4)
    tpipe, jpipe = _pipelines(jcfg, seed=3)
    frames = fixture_clips()[0]
    frames_p, boxes_p, _ = jpipe._prepare(
        frames, jvideo.estimate_person_boxes(frames, use_native=False))
    jhm, jboxes = jprobe.make_pose_heatmaps_fn(jpipe)(jpipe.params, jnp.asarray(frames_p),
                                                      jnp.asarray(boxes_p))
    with torch.inference_mode():
        thm, tboxes = tpipe._pose_heatmaps(torch.from_numpy(frames_p),
                                           torch.from_numpy(np.asarray(boxes_p)))
    assert thm.dtype == torch.float32
    np.testing.assert_allclose(tboxes.numpy(), np.asarray(jboxes), rtol=0, atol=1e-2)
    on_port_boxes = np.asarray(jax.jit(jpipe.pose_model.apply)(
        jpipe.params["pose"], jpre.crop_resize_normalize(
            jnp.asarray(frames_p), jnp.asarray(tboxes.numpy()), jcfg.pose.input_hw)))
    peak = float(np.abs(on_port_boxes).max())
    np.testing.assert_allclose(thm.numpy(), on_port_boxes, rtol=0, atol=1e-4 * peak)
    assert float(np.abs(thm.numpy() - np.asarray(jhm)).max()) < 1e-3 * peak
    # The coarse pass read the knob: at float32 it gives other boxes.
    f32 = torch_orch.Pipeline(dataclasses.replace(tpipe.cfg, preprocess_dtype="float32"),
                              {k: m.state_dict() for k, m in tpipe.models.items()},
                              device="cpu")
    with torch.inference_mode():
        _, f32_boxes = f32._pose_heatmaps(torch.from_numpy(frames_p),
                                          torch.from_numpy(np.asarray(boxes_p)))
    assert not torch.equal(f32_boxes, tboxes)


def test_bench_preprocess_dtype_prints_the_scripts_keys():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = bench_preprocess_dtype.main(["--cpu", "--clips", "1", "--frames", "4",
                                              "--iters", "1"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line == result
    assert set(line) == {"fps_f32", "fps_bf16", "speedup", "kpt_med_px", "kpt_p99_px",
                         "clips", "frames"}
    assert line["clips"] == 1 and line["frames"] == 4
    assert all(np.isfinite(line[k]) and line[k] > 0
               for k in ("fps_f32", "fps_bf16", "speedup"))
    assert np.isfinite(line["kpt_med_px"]) and np.isfinite(line["kpt_p99_px"])
