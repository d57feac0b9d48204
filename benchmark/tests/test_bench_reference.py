"""The plain reference against the port, on the CPU at a tiny size, stage by
stage, with the same weights and inputs (both decodes)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import system, traffic as gen
from benchmark.reference import weights
from benchmark.reference.pipeline import Reference
from benchmark.tests.conftest import load, tiny_pipeline


def _inputs(seed=5):
    g = torch.Generator().manual_seed(seed)
    base = torch.randint(0, 256, (12, 96, 128, 3), generator=g, dtype=torch.uint8)
    boxes = torch.tensor([60.0, 50.0, 40.0, 70.0]).repeat(12, 1) \
        + torch.randn(12, 4, generator=g) * 3
    clips = [gen.Clip(7, 8, False, 4), gen.Clip(6, 8, True, -3)]
    return gen.build_chunk(base, boxes, clips), (base, boxes)


@pytest.mark.parametrize("tracked", [False, True])
def test_reference_stages_agree_with_the_port(tracked):
    conf = tiny_pipeline(load("configs", "shipped" if tracked else "full_pipeline"))
    if tracked:          # the tracked decode, mode features, random tiny weights
        conf["weights"] = "seed"
        conf["overrides"] += ["pose.decode_tracking=4", "pose.track_suppress_radius=2.0",
                              "pose.sigma=1.25", "error.mode_features=True"]
    pipe, state = system.build(conf, 2 ** 31 + 3, "cpu", ".")
    ref = Reference(conf, state, "cpu")
    (frames, boxes, valid), (base, bboxes) = _inputs()
    with torch.inference_mode():
        rv = torch.ones(1, base.shape[0], dtype=torch.bool)
        rs = pipe._core_fn(base[None], bboxes[None], rv)
        out = system.request(pipe, frames, boxes, valid, (rs["keypoints"][0], rv[0]))
        kp, aux = ref.pose(frames, boxes)
        torch.testing.assert_close(out["keypoints"], kp, atol=1e-3, rtol=0)
        assert (aux is None) == (not tracked)
        if tracked:
            torch.testing.assert_close(out["kpt_aux"], aux, atol=1e-3, rtol=0)
        logits, _ = ref.heads(out["keypoints"], out["kpt_aux"], valid)
        torch.testing.assert_close(out["phase_logits"], logits, atol=1e-5, rtol=1e-5)
        D, cost, hard, la, lb = ref.compare(out["keypoints"], valid, rs["keypoints"][0], rv[0])
        torch.testing.assert_close(out["cost"], cost, atol=1e-5, rtol=1e-5)
        from benchmark.check import backtrack
        path, length = backtrack(hard, la, lb)
        assert torch.equal(out["path"], path) and torch.equal(out["path_length"], length)
        err = ref.refined_error(out["keypoints"], out["phase_logits"], valid,
                                rs["keypoints"][0], out["path"], out["path_length"],
                                out["kpt_aux"])
        torch.testing.assert_close(out["error_logits"], err, atol=1e-4, rtol=1e-4)


def test_npz_weights_convert_as_the_port_converts_them():
    from golfaction_tpu_torch import checkpoint
    from golfaction_tpu_torch import weights as port_weights

    ours = weights.from_artifacts("artifacts")
    theirs = port_weights.from_flax(checkpoint.load_params("artifacts"))
    for model in weights.MODELS:
        assert set(ours[model]) == set(theirs[model])
        for k, v in ours[model].items():
            assert torch.equal(v, theirs[model][k]), (model, k)


def test_the_configuration_files_state_what_the_port_runs():
    import dataclasses

    from golfaction_tpu_torch import checkpoint
    from golfaction_tpu_torch.config import get_config

    def plain(c):
        return json.loads(json.dumps(dataclasses.asdict(c)))

    assert load("configs", "full_pipeline")["pipeline"] == plain(get_config("full_pipeline"))
    assert load("configs", "shipped")["pipeline"] == plain(
        checkpoint.config_for_artifacts(get_config("full_pipeline"), "artifacts"))


def test_random_weights_are_the_seeds_and_fill_every_parameter():
    conf = tiny_pipeline(load("configs", "full_pipeline"))
    mods = system.reference_modules(conf)
    a = weights.random_state(mods, 2 ** 40 + 1, "cpu")
    b = weights.random_state(mods, 2 ** 40 + 1, "cpu")
    c = weights.random_state(mods, 2 ** 40 + 2, "cpu")
    for m, mod in mods.items():
        assert set(a[m]) == {n for n, _ in mod.named_parameters()}
        mod.load_state_dict(a[m])
        assert all(torch.equal(a[m][k], b[m][k]) for k in a[m])
    assert not torch.equal(a["pose"]["stem.weight"], c["pose"]["stem.weight"])
