"""An artifacts tree that keeps a model as an Orbax step folder
(`params/<name>/step_*`) is refused by every port entry point that reads a
tree, for every model name: the JAX package would load that folder in
preference to `<name>.npz`, and the port cannot read it.  An empty
`params/<name>/` is accepted, as the JAX package's `latest_step_dir`
returns None for it, and the shipped tree loads to the bit as before."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from golfaction_tpu_torch import (calibrate_thresholds, cascade_finetune, checkpoint, demo_e2e,
                                  promote_artifacts, quantize_eval, train_eval, weights)
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "artifacts")
NAMES = ("pose", "gcn", "align", "error", "refine")


def _orbax_tree(root, name: str) -> str:
    """A tree whose only checkpoint is an Orbax step folder of `name` (with
    a file in it, as Orbax writes one)."""
    step = os.path.join(root, "params", name, "step_00000800")
    os.makedirs(step)
    with open(os.path.join(step, "_METADATA"), "w") as f:
        f.write("{}")
    return str(root)


ENTRY_POINTS = {
    "from_artifacts": lambda t, tmp: Pipeline.from_artifacts(t, device="cpu"),
    "cascade_finetune": lambda t, tmp: cascade_finetune.main(
        ["--artifacts", t, "--out", str(tmp / "out"), "--cpu"]),
    "calibrate_thresholds": lambda t, tmp: calibrate_thresholds.main(
        ["--artifacts", t, "--out", str(tmp / "out"), "--cpu"]),
    "quantize_eval": lambda t, tmp: quantize_eval.main(["--artifacts", t, "--device", "cpu"]),
    "demo_e2e": lambda t, tmp: demo_e2e.main(["--artifacts", t, "--out", str(tmp / "out"),
                                              "--cpu"]),
    "train_eval_eval_only": lambda t, tmp: train_eval.main(["--out", t, "--eval-only", "--cpu"]),
    "promote_staged": lambda t, tmp: promote_artifacts.main(
        ["--staged", t, "--artifacts", str(tmp / "dest")]),
    "promote_destination": lambda t, tmp: promote_artifacts.main(
        ["--staged", str(_staged(tmp)), "--artifacts", t]),
}


def _staged(tmp):
    staged = tmp / "staged"
    (staged / "params").mkdir(parents=True, exist_ok=True)
    return staged


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_every_entry_point_refuses_an_orbax_step_folder(tmp_path, entry, name):
    tree = _orbax_tree(tmp_path / "tree", name)
    with pytest.raises(ValueError, match=rf"params/{name}/step_00000800.*npz") as err:
        ENTRY_POINTS[entry](tree, tmp_path)
    assert f"{name}.npz" in str(err.value)
    assert not (tmp_path / "out").exists() and not (tmp_path / "dest").exists()


@pytest.mark.parametrize("name", NAMES)
def test_the_readers_refuse_it_without_a_params_folder(tmp_path, name):
    """The JAX package also looks for `<root>/<name>/step_*` when the tree
    has no `params/` folder."""
    os.makedirs(tmp_path / name / "step_00000001")
    with pytest.raises(ValueError, match=f"{name}/step_00000001"):
        checkpoint.load_params(str(tmp_path))
    with pytest.raises(ValueError, match=f"{name}/step_00000001"):
        checkpoint.config_for_artifacts(tcfg.get_config(), str(tmp_path))


def test_an_orbax_pose_init_is_refused(tmp_path):
    step = tmp_path / "pose" / "step_00000001"
    step.mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        train_eval.main(["--out", str(tmp_path / "out"), "--cpu", "--skip", "gcn", "error",
                         "align", "--pose-init-from", str(step)])
    assert not (tmp_path / "out" / "params" / "pose.npz").exists()


@pytest.fixture(scope="module")
def shipped_copy(tmp_path_factory):
    """The shipped tree's checkpoints and pose_meta.json, with an empty
    params/gcn/ folder added."""
    root = tmp_path_factory.mktemp("shipped")
    shutil.copytree(os.path.join(ARTIFACTS, "params"), root / "params")
    shutil.copyfile(os.path.join(ARTIFACTS, "pose_meta.json"), root / "pose_meta.json")
    (root / "params" / "gcn").mkdir()
    return str(root)


def _raw(root: str) -> dict:
    """{name: {key: array}} of every npz under `<root>/params`, as np.load
    reads it (float leaves to float32, as the loader has always cast)."""
    out = {}
    for name in NAMES:
        path = os.path.join(root, "params", f"{name}.npz")
        if os.path.exists(path):
            with np.load(path) as d:
                out[name] = {k: d[k].astype(np.float32) for k in d.files}
    return out


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_the_shipped_tree_loads_to_the_bit(shipped_copy):
    raw = _raw(ARTIFACTS)
    assert sorted(raw) == ["align", "error", "gcn", "pose"]
    for root in (ARTIFACTS, shipped_copy):        # the empty params/gcn/ changes nothing
        assert checkpoint.step_dirs(root) == []
        got = checkpoint.load_params(root)
        assert sorted(got) == sorted(raw)
        for name, arrays in raw.items():
            flat = _flat(got[name])
            assert sorted(flat) == sorted(arrays)
            for key, want in arrays.items():
                assert flat[key].dtype == np.float32 and np.array_equal(flat[key], want)
    cfg = checkpoint.config_for_artifacts(tcfg.get_config("full_pipeline"), ARTIFACTS)
    assert checkpoint.config_for_artifacts(tcfg.get_config("full_pipeline"), shipped_copy) == cfg
    assert cfg == tcfg.apply_overrides(tcfg.get_config("full_pipeline"), [
        "pose.sigma=1.25", "pose.decode_tracking=4", "pose.track_suppress_radius=2.0",
        "error.mode_features=True"])


def test_an_empty_model_folder_is_accepted_by_from_artifacts(shipped_copy):
    pipe = Pipeline.from_artifacts(shipped_copy, device="cpu")
    want = weights.from_flax({
        name: checkpoint.restore_params_npz(os.path.join(ARTIFACTS, "params", f"{name}.npz"))
        for name in ("pose", "gcn", "align", "error")})
    for name, sd in want.items():
        got = pipe.models[name].state_dict()
        assert all(torch.equal(got[k], v) for k, v in sd.items()), name
    assert pipe.refine_model is None


def test_save_pose_meta_writes_what_config_for_artifacts_reads(tmp_path):
    meta = {"sigma": 1.25, "decode_tracking": 4, "track_suppress_radius": 2.0}
    path = checkpoint.save_pose_meta(str(tmp_path), **meta)
    assert path == os.path.join(str(tmp_path), "pose_meta.json")
    assert json.loads(open(path).read()) == meta
    with open(os.path.join(ARTIFACTS, "pose_meta.json")) as f:
        assert json.load(f) == meta              # the shipped sidecar says the same
    cfg = checkpoint.config_for_artifacts(tcfg.get_config(), str(tmp_path))
    assert (cfg.pose.sigma, cfg.pose.decode_tracking, cfg.pose.track_suppress_radius) == (
        1.25, 4, 2.0)
    with pytest.raises(ValueError, match="unknown pose_meta keys"):
        checkpoint.save_pose_meta(str(tmp_path), sigma=2.0, dtype="float32")
