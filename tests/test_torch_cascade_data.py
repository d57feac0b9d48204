"""The generator's conditioned-synthesis tail (train/data.py) against the
JAX package's: the probe-profile loaders on the repo's three
artifacts/probe_*.json files and on hand-made profiles, the conditioned
gain / beta / presence and synth_modes equal to the bit from the same
generator seeds (and leaving the generator in the same state), and
synth_spread at rtol 1e-5 (its boxes go through float32 affine arithmetic
in each package)."""

import json

import numpy as np
import pytest

from golfaction_tpu import config as jcfg
from golfaction_tpu.train import data as jdata
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch.train import data as tdata
from tests.torch_cascade_tree import ROOT

E, V = 8, 17
LOADERS = {"probe_arm_gain.json": "load_gain_profile",
           "probe_heatmap_spread.json": "load_spread_profile",
           "probe_heatmap_modes.json": "load_mode_profile"}


def _same(got, want):
    if want is None:
        assert got is None
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fname", sorted(LOADERS))
def test_profile_loaders_read_the_repos_probes_as_the_jax_package(fname):
    path = str(ROOT / "artifacts" / fname)
    got, want = getattr(tdata, LOADERS[fname])(path), getattr(jdata, LOADERS[fname])(path)
    _same(got, want)
    tabs = got if isinstance(got, tuple) else (got,)
    assert all(np.isfinite(t).any() and np.isnan(t).any() for t in tabs)


def _hand_made(kind: str) -> dict:
    """Hand-made profiles: NaN-free partial tables, a fault the package does
    not know, one fault's probe output (the single-fault form)."""
    if kind == "gain":
        return {"faults": {"chicken_wing": {"per_joint_gain": {"7": 0.18, "9": 0.5}},
                           "swaying": {"per_joint_gain": {"11": 0.43, "12": 0.7}},
                           "no_such_fault": {"per_joint_gain": {"0": 0.1}}}}
    if kind == "spread":
        return {"faults": {"casting": {"per_joint_beta": {"9": 0.0, "10": 0.52}}}}
    if kind == "modes_merged":
        return {"faults": {"chicken_wing": {"per_joint_presence": {"7": 0.96},
                                            "per_joint_canon_frac": {"7": 0.62}},
                           "early_extension": {"per_joint_presence": {"11": 0.0}}}}
    if kind == "modes_single":
        return {"summary": {"fault": "chicken_wing", "true_mode_present_frac": 0.9,
                            "peak_nearer_canon_frac": 0.6},
                "frames": [{"joint": 7}, {"joint": 9}, {"joint": 7}]}
    return {"summary": {"fault": "over_the_top", "true_mode_present_frac": None},
            "frames": [{"joint": 10}]}


@pytest.mark.parametrize("kind,loader", [
    ("gain", "load_gain_profile"), ("spread", "load_spread_profile"),
    ("modes_merged", "load_mode_profile"), ("modes_single", "load_mode_profile"),
    ("modes_single_no_frac", "load_mode_profile")])
def test_profile_loaders_on_hand_made_profiles(tmp_path, kind, loader):
    path = tmp_path / "p.json"
    path.write_text(json.dumps(_hand_made(kind)))
    got = getattr(tdata, loader)(str(path))
    _same(got, getattr(jdata, loader)(str(path)))
    assert getattr(tdata, loader)(str(tmp_path / "missing.json")) is None


def _tables(seed: int):
    rng = np.random.default_rng(seed)
    tab = rng.uniform(0.05, 1.0, (E, V)).astype(np.float32)
    tab[rng.uniform(size=(E, V)) < 0.6] = np.nan
    return tab


def _flags(rng, n: int):
    flags = (rng.uniform(size=(n, E)) < 0.25).astype(np.float32)
    flags[0] = 0.0                                   # a clean clip
    return flags


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("table", [True, False], ids=["profile", "no_profile"])
def test_conditioned_draws_are_bit_equal(seed, table):
    tab = _tables(seed) if table else None
    flags = _flags(np.random.default_rng(seed + 10), 12)
    r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for f in flags:
        np.testing.assert_array_equal(tdata.conditioned_gain(r_t, tab, f),
                                      jdata.conditioned_gain(r_j, tab, f))
        for fn in ("conditioned_beta", "conditioned_presence"):
            for default in (0.0, 1.0):
                _same(getattr(tdata, fn)(tab, f, default=default),
                      getattr(jdata, fn)(tab, f, default=default))
    assert r_t.random() == r_j.random()


def _mode_inputs(seed: int, variant: str):
    rng = np.random.default_rng(seed)
    N, T = 3, 10
    kpts = rng.uniform(0, 300, (N, T, V, 3)).astype(np.float32)
    kw = {"clean_rel": rng.uniform(0.05, 0.3, V).astype(np.float32),
          "clean_sep": rng.uniform(2, 8, V).astype(np.float32), "miss_prob": 0.2}
    if variant == "floor":
        return kpts, kw
    kw["defl_vec"] = rng.normal(0, 6, (N, T, V, 2)).astype(np.float32)
    if variant == "flicker":
        kw["present_mask"] = rng.uniform(size=(N, T, V)) < 0.5
        kw["side_canon"] = rng.uniform(size=(N, T, V)) < 0.6
        return kpts, kw
    kw["gain"] = rng.uniform(0.2, 1.0, (N, 1, V, 1))
    if variant == "blend_measured":
        kw["presence"] = rng.uniform(size=(N, 1, V)).astype(np.float32)
        kw["canon_frac"] = rng.uniform(size=(N, 1, V)).astype(np.float32)
    return kpts, kw


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("variant", ["floor", "flicker", "blend", "blend_measured"])
def test_synth_modes_is_bit_equal(seed, variant):
    kpts, kw = _mode_inputs(seed, variant)
    r_t, r_j = np.random.default_rng(seed + 100), np.random.default_rng(seed + 100)
    got, want = tdata.synth_modes(kpts, r_t, **kw), jdata.synth_modes(kpts, r_j, **kw)
    _same(got, want)
    assert got.shape == (*kpts.shape[:3], 4)
    assert r_t.random() == r_j.random()


@pytest.mark.parametrize("given", ["present_mask", "side_canon"])
def test_synth_modes_refuses_half_the_flicker_pair(given):
    kpts, kw = _mode_inputs(0, "flicker")
    kw.pop("side_canon" if given == "present_mask" else "present_mask")
    with pytest.raises(ValueError, match="present_mask and side_canon go together"):
        tdata.synth_modes(kpts, np.random.default_rng(0), **kw)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("variant", ["floor", "floor_blur", "deflected", "deflected_beta"])
def test_synth_spread_matches_jax(seed, variant):
    rng = np.random.default_rng(seed)
    N, T, hw = 3, 10, (540, 960)
    kpts = np.concatenate([rng.uniform(200, 700, (N, T, V, 1)), rng.uniform(100, 400, (N, T, V, 1)),
                           rng.uniform(0, 1, (N, T, V, 1))], -1)     # float64, as the cascade's
    kw = {}
    if variant != "floor":
        kw["blur_iso"] = rng.uniform(0, 30, V).astype(np.float32)
    if variant.startswith("deflected"):
        kw["defl_vec"] = rng.normal(0, 10, (N, T, V, 2)).astype(np.float32)
        kw["gain"] = rng.uniform(0.2, 1.0, (N, 1, V, 1))
        if variant.endswith("beta"):
            kw["beta"] = rng.uniform(0, 0.6, (N, 1, V, 1)).astype(np.float32)
    r_t, r_j = np.random.default_rng(seed + 7), np.random.default_rng(seed + 7)
    pose_t = tcfg.PoseConfig(sigma=1.25)
    pose_j = jcfg.PoseConfig(sigma=1.25)
    got = tdata.synth_spread(kpts, pose_t, hw, r_t, **kw)
    want = jdata.synth_spread(kpts, pose_j, hw, r_j, **kw)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (N, T, V, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert r_t.random() == r_j.random()
