"""Streaming, the swing report, the rest of video_io and the CLI of the port
against the JAX package's modules on the same inputs, float32 on the CPU at
the narrow widths of tests/test_streaming.py and tests/test_cli.py, the JAX
pipeline's seed-0 weights carried over.

Limits: keypoints within 1e-3 px (the slice's float32 limit,
tests/test_torch_slice.py) on 99% of (frame, joint) pairs and within 2e-2
px on all (measured: 1.3e-2 px at one pair of 40 x 17 streamed, the
single-peak decode's sub-pixel Taylor step on a near-flat random-weight
heatmap amplifying float32 noise), phase logits within 1e-3, labels, phases
and frame
indices exact, error probabilities within 1e-4 (in the CLI's JSON, rounded
to 4 decimals: 2e-4); report dicts and strings equal; boxes and camera
shifts equal.
"""

import contextlib
import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import cli as jcli
from golfaction_tpu import config as jcfg
from golfaction_tpu import types as jtypes
from golfaction_tpu.pipeline import orchestrator as jorch
from golfaction_tpu.pipeline import report as jreport
from golfaction_tpu.pipeline import streaming as jstream
from golfaction_tpu.pipeline import video_io as jvideo
from golfaction_tpu.pipeline import visualize as jvis
from golfaction_tpu.train import checkpoint as jckpt
from golfaction_tpu.train import data
import golfaction_tpu_torch
from golfaction_tpu_torch import cli as tcli
from golfaction_tpu_torch import types as ttypes
from golfaction_tpu_torch.pipeline import orchestrator as torch_orch
from golfaction_tpu_torch.pipeline import report as treport
from golfaction_tpu_torch.pipeline import streaming as tstream
from golfaction_tpu_torch.pipeline import video_io as tvideo
from tests.torch_parity import port_config, port_params

cv2 = pytest.importorskip("cv2")

CFG = jcfg.PipelineConfig(
    pose=jcfg.PoseConfig(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
                         stage_channels=(8, 8, 16), deconv_channels=(8, 8), dtype="float32"),
    gcn=jcfg.GCNConfig(block_channels=(8,), temporal_branches=((3, 1),), dropout=0.0,
                       dtype="float32"),
    align=jcfg.AlignConfig(embed_dim=8, hidden_channels=(8,), dtype="float32"),
    error=jcfg.ErrorConfig(hidden_dim=16, dtype="float32"),
    frame_batch=4, length_buckets=(16,),
)
TINY_SETS = [
    "--set", "pose.stage_blocks=(1,1,1)", "--set", "pose.stage_channels=(8,8,16)",
    "--set", "pose.deconv_channels=(8,8)", "--set", "pose.input_hw=(64,48)",
    "--set", "pose.heatmap_hw=(16,12)", "--set", "pose.dtype='float32'",
    "--set", "gcn.block_channels=(8,)", "--set", "gcn.temporal_branches=((3,1),)",
    "--set", "gcn.dtype='float32'", "--set", "align.hidden_channels=(8,)",
    "--set", "align.embed_dim=8", "--set", "align.dtype='float32'",
    "--set", "error.hidden_dim=16", "--set", "error.dtype='float32'",
    "--set", "frame_batch=4", "--set", "length_buckets=(16,)",
]


def _clip(t, seed=0, jitter=0.0):
    return data.make_swing_batch(1, t, seed=seed, image_hw=(96, 128), render=True,
                                 camera_jitter=jitter)[0].frames


@pytest.fixture(scope="module")
def pipes():
    jpipe = jorch.Pipeline(CFG, seed=0)
    return jpipe, torch_orch.Pipeline(port_config(CFG), port_params(jpipe.params),
                                      device="cpu")


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------

def _assert_close_keypoints(got, want):
    gap = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max(-1)
    assert np.mean(gap <= 1e-3) >= 0.99 and gap.max() <= 2e-2, (np.mean(gap <= 1e-3), gap.max())


def _assert_same_stream(got, want):
    assert [r["frame_index"] for r in got] == [r["frame_index"] for r in want]
    _assert_close_keypoints([g["keypoints"] for g in got], [w["keypoints"] for w in want])
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["phase_label"] == w["phase_label"] and g["phase"] == w["phase"]
        np.testing.assert_allclose(g["phase_logits"], np.asarray(w["phase_logits"]),
                                   atol=1e-3)
        np.testing.assert_allclose(g["error_probs"], np.asarray(w["error_probs"]), atol=1e-4)


@pytest.mark.parametrize("t, hop, host_boxes", [(40, 4, None), (23, 16, True),
                                                (7, 4, None)])
def test_stream_matches_jax(pipes, t, hop, host_boxes):
    jpipe, tpipe = pipes
    frames = _clip(t, seed=t)
    want_sa = jstream.StreamAnalyzer(jpipe, window=16, hop=hop, host_boxes=host_boxes)
    got_sa = tstream.StreamAnalyzer(tpipe, window=16, hop=hop, host_boxes=host_boxes)
    want = [r for f in frames for r in want_sa.push(f)] + want_sa.flush()
    got = [r for f in frames for r in got_sa.push(f)] + got_sa.flush()
    assert [r["frame_index"] for r in got] == list(range(t))
    _assert_same_stream(got, want)
    assert got_sa.windows_processed == want_sa.windows_processed
    assert got_sa.host_boxes == want_sa.host_boxes and got_sa.flush() == []


def test_analyze_stream_with_box_refinement_matches_jax():
    cfg = dataclasses.replace(CFG, box_refine_stride=4)
    jpipe = jorch.Pipeline(cfg, seed=0)
    tpipe = torch_orch.Pipeline(port_config(cfg), port_params(jpipe.params), device="cpu")
    frames = _clip(20, seed=5)
    want = list(jstream.analyze_stream(jpipe, iter(frames), window=16, hop=8))
    got = list(golfaction_tpu_torch.analyze_stream(tpipe, iter(frames), window=16, hop=8))
    # Box refinement smooths float32 running sums (reference behaviour (iii)):
    # 0.15 px, the limit of tests/test_torch_pose_options.py.
    assert [r["frame_index"] for r in got] == [r["frame_index"] for r in want]
    np.testing.assert_allclose(np.stack([r["keypoints"] for r in got]),
                               np.stack([np.asarray(r["keypoints"]) for r in want]),
                               atol=0.15)
    assert [r["phase"] for r in got] == [r["phase"] for r in want]


def test_stream_validates_window(pipes):
    _, tpipe = pipes
    with pytest.raises(ValueError):
        tstream.StreamAnalyzer(tpipe, window=13, hop=4)
    with pytest.raises(ValueError):
        tstream.StreamAnalyzer(tpipe, window=16, hop=0)


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------

def _results(labels, probs, path=None, cost=1.5):
    T = len(labels)
    arrays = dict(keypoints=np.zeros((T, 17, 3), np.float32), phase_labels=labels,
                  phase_logits=np.zeros((T, 9), np.float32), error_flags=probs > 0.5,
                  error_probs=probs, valid=np.arange(T) < T - 2)
    out = []
    for types, conv in ((jtypes, jnp.asarray), (ttypes, torch.as_tensor)):
        al = None
        if path is not None:
            al = types.AlignmentResult(cost=conv(np.float32(cost)), path=conv(path),
                                       path_length=conv(np.int32(len(path) - 1)))
        out.append(types.AnalysisResult(**{k: conv(v) for k, v in arrays.items()},
                                        alignment=al))
    return out


@pytest.mark.parametrize("case", range(4))
def test_report_equals_jax(case):
    rng = np.random.default_rng(case)
    names = jcfg.SWING_PHASES
    labels = np.repeat(rng.integers(0, len(names), 8), rng.integers(1, 9, 8)).astype(np.int32)
    probs = rng.uniform(0, 1, len(jcfg.SWING_ERRORS)).astype(np.float32)
    path = None
    if case % 2:
        i = np.arange(len(labels))
        path = np.stack([i, np.clip(i - case, 0, None)], -1).astype(np.int32)
        path = np.concatenate([path, [[-1, -1]]]).astype(np.int32)
    thr = 0.5 if case < 2 else rng.uniform(0.2, 0.9, len(jcfg.SWING_ERRORS)).astype(np.float32)
    jres, tres = _results(labels, probs, path)
    kw = dict(fps=24.0, error_threshold=thr, reference_name="pro.mp4")
    want = jreport.build_report(jres, **kw)
    got = treport.build_report(tres, error_threshold=torch.as_tensor(thr), fps=24.0,
                               reference_name="pro.mp4")
    assert got == want
    assert treport.format_report(got) == jreport.format_report(want)
    assert treport.phase_segments(torch.from_numpy(labels)) == jreport.phase_segments(labels)
    assert treport.tempo_ratio(got["phases"]) == jreport.tempo_ratio(want["phases"])
    json.dumps(got)
    assert golfaction_tpu_torch.build_report is treport.build_report
    assert golfaction_tpu_torch.format_report is treport.format_report


# ---------------------------------------------------------------------------
# video_io
# ---------------------------------------------------------------------------

def test_camera_shifts_and_stabilized_boxes_equal_jax():
    for jitter in (0.0, 0.05):
        frames = _clip(12, seed=6, jitter=jitter)
        np.testing.assert_array_equal(tvideo.estimate_camera_shifts(frames),
                                      jvideo.estimate_camera_shifts(frames))
        for native in (True, False):
            np.testing.assert_array_equal(
                tvideo.estimate_person_boxes(frames, stabilize=True, use_native=native),
                jvideo.estimate_person_boxes(frames, stabilize=True, use_native=native))


def test_iter_clip_batches_and_frame_source_equal_jax(tmp_path):
    frames = _clip(10, seed=7)
    for a, b in zip(tvideo.iter_clip_batches(frames, 4), jvideo.iter_clip_batches(frames, 4)):
        np.testing.assert_array_equal(a, b)
    npy = str(tmp_path / "clip.npy")
    np.save(npy, frames)
    mp4 = str(tmp_path / "clip.mp4")
    jvis.write_video(mp4, frames, fps=30)
    for spec in (npy, mp4):
        for max_frames in (None, 6):
            got = list(tvideo.frame_source(spec, max_frames=max_frames))
            want = list(jvideo.frame_source(spec, max_frames=max_frames))
            assert len(got) == len(want) == (max_frames or 10)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        next(tvideo.frame_source(str(tmp_path / "missing.mp4")))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """Two swing mp4s and an artifacts tree of the JAX pipeline's seed-0
    weights (npz) and per-fault thresholds, which both CLIs load."""
    d = tmp_path_factory.mktemp("cli")
    paths = []
    for seed in (0, 1):
        p = str(d / f"swing{seed}.mp4")
        jvis.write_video(p, _clip(12, seed=seed + 10), fps=30)
        paths.append(p)
    cfg = jcfg.apply_overrides(jcfg.get_config("full_pipeline"), TINY_SETS[1::2])
    params = jorch.Pipeline(cfg, seed=0).params
    os.makedirs(d / "art" / "params")
    for name, tree in params.items():
        jckpt.save_params_npz(str(d / "art" / "params" / f"{name}.npz"), tree)
    # Per-fault thresholds, which both CLIs pass to analyze as an array.
    thr = np.random.default_rng(3).uniform(0.2, 0.8, len(jcfg.SWING_ERRORS))
    with open(d / "art" / "error_thresholds.json", "w") as f:
        json.dump({n: float(t) for n, t in zip(jcfg.SWING_ERRORS, thr)}, f)
    return paths, str(d / "art")


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_cli_analyze_matches_jax(cli_inputs, tmp_path):
    (a, b), art = cli_inputs
    common = [a, "--reference", b, "--checkpoint", art, "--report", *TINY_SETS]
    want = json.loads(_run(jcli.main, ["analyze", *common]))
    got = json.loads(_run(tcli.main, ["analyze", *common, "--device", "cpu",
                                      "--out", str(tmp_path / "res.json"),
                                      "--render", str(tmp_path / "overlay.mp4")]))
    full = json.load(open(tmp_path / "res.json"))
    assert set(got) | {"keypoints"} == set(full) == set(want)
    _assert_close_keypoints(full["keypoints"], want["keypoints"])
    for k in ("num_frames", "phase_labels", "error_flags"):
        assert full[k] == want[k], k
    np.testing.assert_allclose(list(full["error_probs"].values()),
                               list(want["error_probs"].values()), atol=2e-4)
    assert full["alignment"]["path"] == want["alignment"]["path"]
    np.testing.assert_allclose(full["alignment"]["cost"], want["alignment"]["cost"], rtol=1e-4)
    assert full["report"]["phases"] == want["report"]["phases"]
    assert full["report"]["comparison"] == want["report"]["comparison"]
    cap = cv2.VideoCapture(str(tmp_path / "overlay.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 12
    cap.release()


def test_cli_compare_matches_jax(cli_inputs, tmp_path):
    (a, b), art = cli_inputs
    common = [a, b, "--checkpoint", art, "--max-pairs", "6", *TINY_SETS]
    want = json.loads(_run(jcli.main, ["compare", *common,
                                       "--out-video", str(tmp_path / "j.mp4")]))
    got = json.loads(_run(tcli.main, ["compare", *common, "--device", "cpu",
                                      "--out-video", str(tmp_path / "t.mp4")]))
    assert got["comparison_video"] == str(tmp_path / "t.mp4")
    for k in ("frames", "phases", "tempo_ratio", "comparison"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(list(got["fault_probabilities"].values()),
                               list(want["fault_probabilities"].values()), atol=2e-3)
    cap = cv2.VideoCapture(str(tmp_path / "t.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    cap.release()


def test_cli_stream_matches_jax(cli_inputs, capsys):
    (a, _), art = cli_inputs
    common = [a, "--checkpoint", art, "--window", "16", "--hop", "8", *TINY_SETS]
    want = [json.loads(x) for x in _run(jcli.main, ["stream", *common]).splitlines()]
    got = [json.loads(x) for x in _run(tcli.main, ["stream", *common, "--device", "cpu",
                                                   "--keypoints"]).splitlines()]
    assert [g["frame_index"] for g in got] == [w["frame_index"] for w in want] == list(range(12))
    assert [g["phase"] for g in got] == [w["phase"] for w in want]
    summary = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert summary["frames"] == 12 and summary["host_boxes"] is True


def test_cli_train_writes_a_checkpoint_the_jax_package_loads(tmp_path):
    out = json.loads(_run(tcli.main, [
        "train", "gcn", "--steps", "2", "--batch-size", "2", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "new"), "--set", "gcn.block_channels=(8,)",
        "--set", "gcn.temporal_branches=((3,1),)"]))
    assert out["model"] == "gcn" and out["steps"] == 2 and np.isfinite(out["final"]["loss"])
    tree = jckpt.restore_params_npz(out["checkpoint"])
    assert tree["params"]["GCNBlock_0"]["SpatialGraphConv_0"]["kernel"].shape[-1] == 8


def test_cli_refuses_what_it_does_not_know():
    with pytest.raises(SystemExit):
        _run(tcli.main, ["train", "nonexistent"])
    with pytest.raises(SystemExit):
        _run(tcli.main, ["bench"])
