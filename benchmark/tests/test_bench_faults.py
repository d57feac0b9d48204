"""A run with the timed path broken underneath comes out not correct.

Each case drives the whole of a run (set-up, window, check) on the CPU at a
tiny size with the cell's own limits, the look for a card skipped, and
`system.request` replaced by one that breaks its outputs in one way.  The
unbroken run comes out correct."""

from __future__ import annotations

import pytest
import torch

from benchmark import run, system
from benchmark.tests.conftest import load, tiny_pipeline, tiny_traffic


def _half_batch(out):
    """The second half of the chunk left out: the first half's answers repeated."""
    n = out["keypoints"].shape[0]
    h = n // 2
    idx = torch.arange(n) % max(h, 1)
    return {k: (v[idx] if torch.is_tensor(v) and v.dim() and v.shape[0] == n else v)
            for k, v in out.items()}


def _label(out):
    lab = out["phase_labels"].clone()
    lab[0][lab[0] >= 0] = (lab[0][lab[0] >= 0] + 1) % out["phase_logits"].shape[-1]
    return dict(out, phase_labels=lab)


def _keypoints(out):
    kp = out["keypoints"].clone()
    kp[0, ..., 0] += 3.0
    return dict(out, keypoints=kp)


def _path(out):
    path = out["path"].clone()
    n = int(out["path_length"][0])
    path[0, :n] = path[0, :n].flip(0)
    return dict(out, path=path)


def _flags(out):
    f = out["error_flags"].clone()
    f[0] = ~f[0]
    return dict(out, error_flags=f)


def _cost(out):
    return dict(out, cost=out["cost"] * 1.1)


def _logits(out):
    lg = out["phase_logits"].clone()
    lg[0] += torch.linspace(-1, 1, lg.shape[-1])
    return dict(out, phase_logits=lg, phase_labels=torch.where(
        out["phase_labels"] >= 0, lg.argmax(-1).to(out["phase_labels"].dtype), -1))


FAULTS = {"none": None, "half_batch": _half_batch, "label": _label, "keypoints": _keypoints,
          "path": _path, "flags": _flags, "cost": _cost, "logits": _logits}


@pytest.mark.parametrize("config", ["full_pipeline", "shipped"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, config, fault):
    conf = tiny_pipeline(load("configs", config))
    if config == "shipped":          # tiny widths need tiny weights: seeded, tracked decode
        conf["weights"], conf["thresholds"] = "seed", 0.5
        conf["overrides"] += ["pose.decode_tracking=4", "pose.track_suppress_radius=2.0",
                              "pose.sigma=1.25", "error.mode_features=True"]
    broken = FAULTS[fault]
    if broken is not None:
        real = system.request
        monkeypatch.setattr(system, "request", lambda *a: broken(real(*a)))
    res = run.execute(conf, tiny_traffic(), 2 ** 31 + 21, 0.3, False, device="cpu",
                      metrics={"frames_per_s": "frames/s"})
    assert res["correct"] is (fault == "none"), res["checked"]
