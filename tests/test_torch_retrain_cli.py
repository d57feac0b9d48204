"""The port's `train_eval`, `import_pose` and `softdtw_bwd_bench` as a user
runs them, on the CPU at the tiny float32 widths of
tests/torch_cascade_tree.py: train_eval's --skip, the metrics merge,
--eval-only and --pose-init-from (npz and the port's own training
checkpoint accepted, an Orbax folder refused), npz files the JAX package
loads, the repo's artifacts/ refused as --out; import_pose's report
against the JAX importer on the same in-memory state dict (apart from the
square ConvTranspose, ROADMAP reference behaviour (x)); the bench's
gradient against `jax.grad` of the JAX script's loss (in D to the bit, in
the embeddings within rtol 1e-4), its JSON keys, and the card as its
default device."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu.ops import softdtw as jsoftdtw
from golfaction_tpu.train import checkpoint as jckpt
from golfaction_tpu.train import import_weights as jimport
from golfaction_tpu_torch import checkpoint, import_pose, softdtw_bwd_bench, train_eval, weights
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from tests.test_torch_import_weights import POSE, SQUARE_DECONV, _mmpose_state_dict
from tests.torch_cascade_tree import ROOT, TINY_SET

SETS = [a for s in TINY_SET for a in ("--set", s)]
SMALL = ["--cpu", "--steps", "2", "--eval-clips", "2", "--frames", "16", "--batch-size", "4",
         "--pose-steps", "1", *SETS]
KEYS = {"gcn": {"history", "eval_acc", "eval_f1", "checkpoint"},
        "error": {"history", "eval", "eval_with_ref", "checkpoint"},
        "align": {"history", "eval_progress_err", "checkpoint"},
        "pose": {"history", "eval_pck05", "checkpoint"}}


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_eval.main(argv)
    return res, json.loads(out.getvalue())


@pytest.fixture(scope="module", autouse=True)
def tiny_pose_frames():
    """The pose pool and evaluation at 96x128 frames, the pool at 2 clips
    (the script's 540x960 and 160 are module constants)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_eval, "POSE_HW", (96, 128))
        mp.setattr(train_eval, "POSE_POOL", 2)
        yield


@pytest.fixture(scope="module")
def run(tiny_pose_frames, tmp_path_factory):
    """--skip pose, then pose alone into the same --out (the merge)."""
    out = tmp_path_factory.mktemp("train_eval") / "out"
    first, printed = _main(["--out", str(out), "--skip", "pose", *SMALL])
    second, _ = _main(["--out", str(out), "--skip", "gcn", "error", "align", *SMALL])
    return {"out": str(out), "first": first["metrics"], "second": second["metrics"],
            "printed": printed, "seconds": first["seconds"]}


def test_skip_trains_the_others_and_the_merge_keeps_them(run):
    first, second = run["first"], run["second"]
    assert set(first) == {"gcn", "error", "align", "wall_time_s"}
    assert sorted(os.listdir(os.path.join(run["out"], "params"))) == [
        "align.npz", "error.npz", "gcn.npz", "pose.npz"]
    assert set(second) == {"gcn", "error", "align", "pose", "wall_time_s"}
    for name, keys in KEYS.items():
        assert set(second[name]) == keys, name
        assert second[name]["checkpoint"] == os.path.join(run["out"], "params", f"{name}.npz")
    for name in ("gcn", "error", "align"):
        assert second[name] == first[name]
    with open(os.path.join(run["out"], "metrics.json")) as f:
        assert json.load(f) == second
    assert run["printed"] == {k: ({kk: vv for kk, vv in v.items() if kk != "history"}
                                  if isinstance(v, dict) else v) for k, v in first.items()}
    assert set(run["seconds"]) == {"gcn", "error", "align"}
    hist = second["gcn"]["history"]
    assert [h["step"] for h in hist] == [0, 1] and all(np.isfinite(h["loss"]) for h in hist)
    assert set(second["error"]["eval"]) == {"precision", "recall", "f1"}


def test_the_npz_files_load_in_the_jax_package_at_float32(run):
    for name in ("pose", "gcn", "align", "error"):
        path = os.path.join(run["out"], "params", f"{name}.npz")
        with np.load(path) as d:
            assert all(d[k].dtype == np.float32 for k in d.files)
        tree = jckpt.restore_params_npz(path)
        ported = checkpoint.restore_params_npz(path)
        flat_j = jax.tree_util.tree_leaves_with_path(tree)
        flat_t = jax.tree_util.tree_leaves_with_path(ported)
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(flat_j, flat_t))
    pipe = Pipeline.from_artifacts(run["out"], device="cpu", overrides=TINY_SET)
    assert pipe.refine_model is None


def test_eval_only_reproduces_the_training_runs_numbers(run):
    res, _ = _main(["--out", run["out"], "--eval-only", *SMALL])
    for name in KEYS:
        assert res["metrics"][name] == run["second"][name], name


def test_pose_init_from_takes_npz_and_training_checkpoints(run, tmp_path):
    init = os.path.join(run["out"], "params", "pose.npz")
    ckpt = str(tmp_path / "resume.pt")
    sd = weights.from_flax({"pose": checkpoint.restore_params_npz(init)})["pose"]
    torch.save({"model": sd, "step": 1}, ckpt)
    for i, src in enumerate((init, ckpt)):
        out = str(tmp_path / f"warm{i}")
        # At learning rate 0 AdamW moves nothing: the written weights are the init's.
        _main(["--out", out, "--skip", "gcn", "error", "align", "--pose-init-from", src,
               "--pose-lr", "0", *SMALL])
        with np.load(os.path.join(out, "params", "pose.npz")) as got, np.load(init) as want:
            assert sorted(got.files) == sorted(want.files)
            assert all(np.array_equal(got[k], want[k]) for k in want.files)
    step = tmp_path / "orbax" / "step_00000002"
    step.mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        train_eval.main(["--out", str(tmp_path / "refused"), "--pose-init-from", str(step),
                         *SMALL])
    assert not (tmp_path / "refused").exists()


def test_out_inside_the_repos_artifacts_is_refused():
    target = ROOT / "artifacts" / "retrain"
    with pytest.raises(ValueError, match="artifacts"):
        train_eval.main(["--out", str(target), *SMALL])
    with pytest.raises(ValueError, match="artifacts"):
        import_pose.main(["x.pth", "--out", str(target)])
    assert not target.exists()


def test_the_card_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        train_eval.main(["--out", str(tmp_path / "o"), "--steps", "1", *SETS])
    with pytest.raises(RuntimeError, match="cuda"):
        softdtw_bwd_bench.main(["--B", "2", "--T", "8"])


# ---------------------------------------------------------------------------
# import_pose
# ---------------------------------------------------------------------------

POSE_SETS = [a for k, v in POSE.items() for a in ("--set", f"pose.{k}={v!r}")]


@pytest.mark.parametrize("wrap", [None, "state_dict", "weights"])
def test_import_pose_report_is_the_jax_importers(tmp_path, wrap):
    tc, jc = tcfg.PoseConfig(**POSE), jcfg.PoseConfig(**POSE)
    sd = _mmpose_state_dict(tc)
    pth = str(tmp_path / "w.pth")
    torch.save(sd if wrap is None else {wrap: sd, "meta": {"epoch": 3}}, pth)
    key = ["--state-dict-key", wrap] if wrap == "weights" else []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = import_pose.main([pth, "--out", str(tmp_path / "tree"), *key, *POSE_SETS])
    assert json.loads(out.getvalue()) == line
    assert line["checkpoint"] == str(tmp_path / "tree" / "params" / "pose.npz")
    with open(line["report"]) as f:
        report = json.load(f)
    # The JAX importer reads only the tree's structure and shapes from `like`.
    like = weights.to_flax({"pose": PoseNet(tc).state_dict()})["pose"]
    _, jreport = jimport.import_torch_pose(like, sd, jc)
    assert report["coverage"] == jreport["coverage"] == line["coverage"] == 1.0
    assert line["imported"] == len(jreport["imported"])
    assert [(e["flax"], e["torch"]) for e in report["imported"]] == [
        (e["flax"], e["torch"]) for e in jreport["imported"]]
    assert [e["torch"] for e in report["skipped_torch"]] == [
        e["torch"] for e in jreport["skipped_torch"]]
    # The written tree: the source's tensors in the port's modules, the square
    # ConvTranspose as the source has it (reference behaviour (x)).
    pipe = Pipeline.from_artifacts(str(tmp_path / "tree"), device="cpu",
                                   overrides=[f"pose.{k}={v!r}" for k, v in POSE.items()])
    got = pipe.pose_model.state_dict()
    for e in report["imported"]:
        assert torch.equal(got[e["param"]], sd[e["torch"]].float()), e["param"]
    assert torch.equal(got[SQUARE_DECONV], sd[next(e["torch"] for e in report["imported"]
                                                  if e["param"] == SQUARE_DECONV)])


# ---------------------------------------------------------------------------
# softdtw_bwd_bench
# ---------------------------------------------------------------------------

def _jax_grads(B, T, dim, gamma):
    """jax.grad of the JAX script's loss (its "scan" path) on its inputs."""
    rng = np.random.default_rng(0)
    ea = jnp.asarray(rng.normal(size=(B, T, dim)), jnp.float32)
    eb = jnp.asarray(rng.normal(size=(B, T, dim)), jnp.float32)

    def loss(ea, eb):
        Dab = jax.vmap(jsoftdtw.pairwise_sqdist)(ea, eb)
        return jax.vmap(lambda d: jsoftdtw.softdtw_cost(d, gamma))(Dab).sum()

    return jax.grad(loss, argnums=(0, 1))(ea, eb)


def test_bench_gradient_is_jax_grad_of_the_scripts_loss():
    """On JAX's own cost matrices the gradient in D is JAX's to the bit
    through both paths.  In the embeddings the two differ by up to 7.6e-5
    relative: D = |a|² + |b|² - 2ab (values up to 118) rounds one ulp apart
    under another matmul order, which the soft-min at gamma 0.1 amplifies;
    each float32 program lies 3.8e-4 from a float64 oracle.  Held at rtol
    1e-4."""
    want = _jax_grads(2, 8, 32, 0.1)
    ea, eb = softdtw_bwd_bench.inputs(2, 8, 32, "cpu")
    np.testing.assert_array_equal(ea.numpy(), np.asarray(
        jnp.asarray(np.random.default_rng(0).normal(size=(2, 8, 32)), jnp.float32)))
    Dj = jax.jit(jax.vmap(jsoftdtw.pairwise_sqdist))(jnp.asarray(ea.numpy()),
                                                     jnp.asarray(eb.numpy()))
    Ej = jax.jit(jax.grad(lambda d: jax.vmap(lambda x: jsoftdtw.softdtw_cost(x, 0.1))(d).sum()))(
        Dj)
    for plain in (False, True):
        D = torch.tensor(np.asarray(Dj)).requires_grad_()
        (E,) = torch.autograd.grad(softdtw_bwd_bench.softdtw.softdtw_cost(D, 0.1, plain).sum(), D)
        np.testing.assert_array_equal(E.numpy(), np.asarray(Ej))
    for path in ("kernel", "plain"):
        got = softdtw_bwd_bench.grad_fn(path, 0.1)(ea, eb)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_bench_json_line_and_its_time_bound(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = softdtw_bwd_bench.main(["--B", "2", "--T", "8", "--iters", "2", "--device", "cpu",
                                      "--out", str(tmp_path / "b.json")])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line == res == json.loads((tmp_path / "b.json").read_text())
    assert set(line) == {"B", "T", "dim", "gamma", "iters", "device", "backward_geometry",
                         "kernel", "plain"}
    assert (line["B"], line["T"], line["dim"]) == (2, 8, 32)
    for path in ("kernel", "plain"):
        assert set(line[path]) == {"compile_s", "step_s"} and line[path]["step_s"] > 0
    assert line["backward_geometry"] == {"rows": 1, "warps": 1, "fits": True, "ring": 0}
    with contextlib.redirect_stdout(io.StringIO()):
        cut = softdtw_bwd_bench.main(["--B", "2", "--T", "8", "--iters", "3", "--device", "cpu",
                                      "--scan-timeout", "0"])
    assert cut["plain"]["timed_out"] and cut["plain"]["steps"] == 0
    assert cut["plain"]["step_s"] is None and "timed_out" not in cut["kernel"]
    # At the recorded points kernel E takes its two-launch layout.
    for B in (64, 192):
        geo = softdtw_bwd_bench.softdtw.backward_geometry(B, 128, 128)
        assert (geo.rows, geo.warps, geo.fits, geo.ring) == (4, 1, False, 32)
