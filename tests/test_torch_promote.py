"""The port's `promote_artifacts` as a user runs it, on the CPU: the gate on
the staged `demo/e2e_metrics.json` (pass, miss, --force), the float16
compaction against the JAX package's `save_params_npz`, the sidecars and
`demo/` copied (demo/ before any file of the destination is overwritten),
a staged tree or a destination with an Orbax step folder refused with the
paths named, and the staged tree left as it was."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

from golfaction_tpu.train import checkpoint as jckpt
from golfaction_tpu_torch import checkpoint, promote_artifacts, weights
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch.pipeline.orchestrator import init_params
from tests.torch_cascade_tree import PROBES, ROOT, TINY_SET, build_tree, tree_bytes

MODELS = ("pose", "gcn", "error", "align")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A staged tree (float32 npz of seeded random weights, the sidecars,
    demo/ with the shipped e2e metrics) and a destination template (other
    weights, its own demo/ file)."""
    tmp = tmp_path_factory.mktemp("promote")
    cfg = tcfg.apply_overrides(tcfg.get_config("full_pipeline"), TINY_SET)
    staged = build_tree(tmp / "staged", params=weights.to_flax(init_params(cfg, seed=1)))
    os.makedirs(os.path.join(staged, "demo"))
    shutil.copyfile(ROOT / "artifacts" / "demo" / "e2e_metrics.json",
                    os.path.join(staged, "demo", "e2e_metrics.json"))
    with open(os.path.join(staged, "demo", "compare.mp4"), "wb") as f:
        f.write(b"\x00staged video")
    dest = build_tree(tmp / "dest", params=weights.to_flax(init_params(cfg, seed=2)))
    os.makedirs(os.path.join(dest, "demo"))
    with open(os.path.join(dest, "demo", "compare.mp4"), "wb") as f:
        f.write(b"\x00old video")
    with open(os.path.join(dest, "demo", "notes.txt"), "w") as f:
        f.write("kept")
    return tmp, staged, dest


def _fresh_dest(trees, name):
    tmp, _, dest = trees
    out = tmp / name
    shutil.copytree(dest, out)
    return str(out)


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = promote_artifacts.main(argv)
    return res, json.loads(out.getvalue().strip().splitlines()[-1])


def test_a_passing_gate_promotes_float16_npz_sidecars_and_demo(trees):
    tmp, staged, _ = trees
    dest = _fresh_dest(trees, "pass")
    before = tree_bytes(staged)
    res, line = _run(["--staged", staged, "--artifacts", dest,
                      "--gate", "swaying=0.9", "casting=0.75", "overall=0.7"])
    assert line == {"promoted": list(MODELS), "gate_misses": []}
    assert tree_bytes(staged) == before
    for name in MODELS:
        got = os.path.join(dest, "params", f"{name}.npz")
        want = str(tmp / f"jax_{name}.npz")
        jckpt.save_params_npz(want, jckpt.restore_params_npz(
            os.path.join(staged, "params", f"{name}.npz")))
        with np.load(got) as g, np.load(want) as w:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                assert g[k].dtype == w[k].dtype == np.float16
                assert np.array_equal(g[k], w[k])
    for fname in ("pose_meta.json", "error_thresholds.json", *PROBES):
        with open(os.path.join(staged, fname), "rb") as a, open(os.path.join(dest, fname),
                                                                   "rb") as b:
            assert a.read() == b.read(), fname
    demo = os.path.join(dest, "demo")
    assert sorted(os.listdir(demo)) == ["compare.mp4", "e2e_metrics.json", "notes.txt"]
    with open(os.path.join(demo, "compare.mp4"), "rb") as f:
        assert f.read() == b"\x00staged video"
    # The promoted tree loads in the port (float16 on disk, as shipped).
    assert sorted(checkpoint.load_params(dest)) == ["align", "error", "gcn", "pose"]
    assert res["written"] == list(MODELS)


@pytest.mark.parametrize("gate", [["swaying=0.99"], ["overall=0.80"], ["no_such_fault=0.1"]])
def test_a_missed_gate_exits_1_and_writes_nothing(trees, gate):
    _, staged, _ = trees
    dest = _fresh_dest(trees, f"miss_{gate[0].split('=')[0]}")
    before = tree_bytes(dest)
    with pytest.raises(SystemExit) as err:
        _run(["--staged", staged, "--artifacts", dest, "--gate", *gate])
    assert err.value.code == 1
    assert tree_bytes(dest) == before


def test_force_promotes_and_lists_the_misses(trees):
    _, staged, _ = trees
    dest = _fresh_dest(trees, "force")
    _, line = _run(["--staged", staged, "--artifacts", dest, "--gate", "swaying=0.99",
                    "casting=0.5", "--force", "--models", "gcn"])
    assert line["promoted"] == ["gcn"]
    assert [m[0] for m in line["gate_misses"]] == ["swaying"]
    assert line["gate_misses"][0][1] == pytest.approx(0.9474) and line["gate_misses"][0][2] == 0.99
    with np.load(os.path.join(dest, "params", "gcn.npz")) as g:
        assert all(g[k].dtype == np.float16 for k in g.files if g[k].dtype.kind == "f")


def test_demo_is_copied_before_anything_is_overwritten(trees, monkeypatch):
    _, staged, _ = trees
    dest = _fresh_dest(trees, "interrupted")
    params_before = {k: v for k, v in tree_bytes(dest).items() if k.startswith("params")}

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "save_params_npz", fail)
    with pytest.raises(OSError, match="disk full"):
        promote_artifacts.main(["--staged", staged, "--artifacts", dest])
    after = tree_bytes(dest)
    assert {k: v for k, v in after.items() if k.startswith("params")} == params_before
    assert after[os.path.join("demo", "compare.mp4")] == b"\x00staged video"
    assert after[os.path.join("demo", "notes.txt")] == b"kept"


@pytest.mark.parametrize("where", ["dest", "staged"])
def test_an_orbax_step_folder_is_refused_with_its_path(trees, where):
    tmp, staged, _ = trees
    dest = _fresh_dest(trees, f"orbax_{where}")
    if where == "staged":
        staged = str(tmp / "staged_orbax")
        shutil.copytree(trees[1], staged)
    root = dest if where == "dest" else staged
    steps = [os.path.join(root, "params", "gcn", "step_00000001"),
             os.path.join(root, "params", "error", "step_00000400")]
    for d in steps:
        os.makedirs(d)
    before = tree_bytes(dest)
    with pytest.raises(ValueError) as err:
        promote_artifacts.main(["--staged", staged, "--artifacts", dest])
    for d in steps:
        assert d in str(err.value)
    assert tree_bytes(dest) == before


def test_the_destination_is_required_and_may_not_overlap(trees):
    _, staged, _ = trees
    with pytest.raises(SystemExit):
        promote_artifacts.parse_args(["--staged", staged])
    with pytest.raises(ValueError, match="overlap"):
        promote_artifacts.main(["--staged", staged, "--artifacts", os.path.join(staged, "x")])
