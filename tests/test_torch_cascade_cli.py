"""The port's cascade and calibration as a user runs them, on the CPU at the
tiny float32 widths of tests/torch_cascade_tree.py: the new tree they
write (loaded by the port and by the JAX package), the source tree left as
it was, the folders they refuse to write into, the collect-cache and its
fingerprint, the refiner and the --spread / --modes heads, and the card as
the default device."""

import contextlib
import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from golfaction_tpu.train import checkpoint as jckpt
from golfaction_tpu_torch import calibrate_thresholds as ct
from golfaction_tpu_torch import cascade_finetune as cf
from golfaction_tpu_torch import checkpoint
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from tests.torch_cascade_tree import (ROOT, TINY, TINY_SET, build_tree, jax_params,
                                      tree_bytes)

SETS = [a for s in TINY_SET for a in ("--set", s)]
SMALL = ["--clips", "2", "--aug", "4", "--calib-clips", "1", "--frames", "16", "--steps", "2",
         "--error-steps", "2", "--batch-size", "4", "--hw", "96", "128", "--cpu", *SETS]


def _run(argv):
    """main(argv) with its stdout kept: (result, last stdout line as JSON)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = cf.main(argv)
    return res, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cascade_cli")
    src = build_tree(tmp / "src")
    before = tree_bytes(src)
    cache = str(tmp / "collection.npz")
    res, line = _run(["--artifacts", src, "--out", str(tmp / "out"), "--collect-cache", cache,
                      *SMALL])
    return {"tmp": tmp, "src": src, "before": before, "res": res, "line": line, "cache": cache}


def test_main_writes_a_complete_tree_and_leaves_the_source_as_it_was(run):
    out = run["tmp"] / "out"
    assert tree_bytes(run["src"]) == run["before"]
    assert run["line"] == {"gcn_checkpoint": str(out / "params" / "gcn.npz"),
                           "error_checkpoint": str(out / "params" / "error.npz"),
                           "clips": 6, "thresholds": str(out / "error_thresholds.json")}
    names = sorted(os.listdir(out / "params"))
    assert names == ["align.npz", "error.npz", "gcn.npz", "pose.npz"]
    for fname in ("pose.npz", "align.npz"):        # copied as they are
        assert (out / "params" / fname).read_bytes() == (
            run["tmp"] / "src" / "params" / fname).read_bytes()
    for fname in ("pose_meta.json", "probe_arm_gain.json", "probe_heatmap_spread.json",
                  "probe_heatmap_modes.json"):
        assert (out / fname).read_bytes() == (run["tmp"] / "src" / fname).read_bytes()
    thr = json.loads((out / "error_thresholds.json").read_text())
    grid = set(np.round(np.linspace(0.20, 0.90, 15), 6))
    assert all(round(v, 6) in grid for v in thr.values()) and len(thr) == 8
    assert all(np.isfinite(v) for losses in run["res"]["losses"].values() for v in losses)
    assert set(run["res"]["seconds"]) == {"render", "pose_front", "refine", "gcn", "error",
                                          "calibration"}


def test_the_new_tree_loads_in_the_port_and_in_the_jax_package(run):
    out = str(run["tmp"] / "out")
    pipe = Pipeline.from_artifacts(out, device="cpu", overrides=TINY_SET)
    for name in ("gcn", "error"):
        got = pipe.models[name].state_dict()
        want = run["res"]["params"][name]
        assert all(torch.equal(got[k], want[k]) for k in want)     # float32, not rounded
        tree = jckpt.restore_params_npz(os.path.join(out, "params", f"{name}.npz"))
        assert all(a.dtype == np.float32 for a in _leaves(tree))
    np.testing.assert_array_equal(
        pipe.error_thresholds.numpy(),
        np.asarray([run["res"]["thresholds_values"][k] for k in run["res"]["thresholds_values"]],
                   np.float32))
    frames = np.zeros((16, 96, 128, 3), np.uint8)
    assert torch.isfinite(pipe.analyze(frames).error_probs).all()


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def test_a_rerun_from_the_cache_gives_the_same_tree(run):
    out2 = run["tmp"] / "out2"
    res, _ = _run(["--artifacts", run["src"], "--out", str(out2), "--collect-cache",
                   run["cache"], *SMALL])
    assert "pose_front" not in res["seconds"]
    for name in ("gcn", "error"):
        assert (out2 / "params" / f"{name}.npz").read_bytes() == (
            run["tmp"] / "out" / "params" / f"{name}.npz").read_bytes()
    assert res["thresholds_values"] == run["res"]["thresholds_values"]


@pytest.mark.parametrize("where", ["src", "inside_src", "repo_artifacts", "inside_repo"])
def test_write_artifacts_refuses_the_source_and_the_repos_artifacts(run, where):
    out = {"src": run["src"], "inside_src": os.path.join(run["src"], "params", "new"),
           "repo_artifacts": str(ROOT / "artifacts"),
           "inside_repo": str(ROOT / "artifacts" / "demo" / "new")}[where]
    with pytest.raises(ValueError, match="lies inside"):
        checkpoint.write_artifacts(out, run["src"], {"gcn": run["res"]["params"]["gcn"]})
    with pytest.raises(ValueError, match="lies inside"):
        cf.main(["--artifacts", run["src"], "--out", out, *SMALL])
    assert not os.path.exists(os.path.join(run["src"], "params", "new"))


def test_a_cache_from_another_pose_checkpoint_is_refused(run):
    other = run["tmp"] / "other_pose"
    shutil.copytree(run["src"], other)
    pose = dict(np.load(other / "params" / "pose.npz"))
    pose["params/Conv_0/kernel"] = pose["params/Conv_0/kernel"] * 2
    np.savez_compressed(other / "params" / "pose.npz", **pose)
    with pytest.raises(ValueError, match="pose_sha256") as e:
        cf.main(["--artifacts", str(other), "--out", str(run["tmp"] / "o"), "--collect-cache",
                 run["cache"], *SMALL])
    assert "spread_features" not in str(e.value)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A tree whose error head reads no aux block, and one cascade on it
    with a collect-cache (which then holds no aux)."""
    tmp = tmp_path_factory.mktemp("cascade_base")
    cfg = dataclasses.replace(TINY, error=dataclasses.replace(TINY.error, mode_features=False))
    src = build_tree(tmp / "src", jax_params(cfg))
    cache = str(tmp / "no_aux.npz")
    res, _ = _run(["--artifacts", src, "--out", str(tmp / "out"), "--collect-cache", cache,
                   *SMALL])
    return {"tmp": tmp, "src": src, "cache": cache, "res": res}


def test_a_cache_without_aux_is_refused_where_aux_is_needed(base):
    assert base["res"]["collection"]["pred_aux"] is None
    with pytest.raises(ValueError, match="holds no pred_aux"):
        cf.main(["--artifacts", base["src"], "--out", str(base["tmp"] / "o"), "--modes",
                 "--collect-cache", base["cache"], *SMALL])


def test_spread_and_modes_heads_and_a_spread_cache_in_a_modes_run(base):
    """--spread and --modes widen the head (a new one, seed 0), and a
    --spread cache is refused by a --modes run, naming both aux fields."""
    tmp = base["tmp"]
    cache = str(tmp / "spread.npz")
    res, _ = _run(["--artifacts", base["src"], "--out", str(tmp / "spread"), "--spread",
                   "--collect-cache", cache, *SMALL])
    width = base["res"]["params"]["error"]["fc0.weight"].shape[1]
    assert res["params"]["error"]["fc0.weight"].shape[1] == width + 2 * 17
    pipe = Pipeline.from_artifacts(str(tmp / "spread"), device="cpu", overrides=TINY_SET)
    assert pipe.cfg.error.spread_features and not pipe.cfg.error.mode_features
    with pytest.raises(ValueError, match="spread_features.*mode_features"):
        cf.main(["--artifacts", base["src"], "--out", str(tmp / "o"), "--modes",
                 "--collect-cache", cache, *SMALL])
    res, _ = _run(["--artifacts", base["src"], "--out", str(tmp / "modes"), "--modes",
                   *SMALL])
    assert res["params"]["error"]["fc0.weight"].shape[1] == width + 3 * 17


def test_the_refiner_trains_and_goes_into_the_tree(run, tmp_path):
    res, _ = _run(["--artifacts", run["src"], "--out", str(tmp_path / "r"), "--refine-steps",
                   "2", "--pool-rendered-frac", "0.5", "--fault-weight", "casting=3",
                   "--collect-cache", run["cache"], *SMALL])
    assert len(res["losses"]["refine"]) == 2
    assert all(np.isfinite(res["losses"]["refine"]))
    pipe = Pipeline.from_artifacts(str(tmp_path / "r"), device="cpu", overrides=TINY_SET)
    assert pipe.refine_model is not None and pipe.cfg.refine.enabled
    head = pipe.refine_model.state_dict()["head.weight"]
    assert torch.equal(head, res["params"]["refine"]["head.weight"]) and head.abs().max() > 0


def test_calibrate_thresholds_writes_the_json_and_its_last_line(run, tmp_path):
    before = tree_bytes(run["src"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ct.main(["--artifacts", run["src"], "--out", str(tmp_path / "cal"),
                       "--per-fault", "1", "--frames", "16", "--hw", "96", "128", "--cpu",
                       *SETS])
    path = str(tmp_path / "cal" / "error_thresholds.json")
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == {"thresholds": path}
    assert json.loads(open(path).read()) == res["values"]
    assert res["probs"].shape == (20, 8) and np.isfinite(res["probs"]).all()
    assert tree_bytes(run["src"]) == before
    with pytest.raises(ValueError, match="lies inside"):
        ct.main(["--artifacts", run["src"], "--out", run["src"], "--cpu", *SETS])


def test_the_entry_points_ask_for_the_card_by_default(run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    argv = ["--artifacts", run["src"], "--out", str(tmp_path / "o"), *SETS]
    with pytest.raises(RuntimeError, match="CUDA"):
        cf.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.main(argv)
