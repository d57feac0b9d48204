"""Carrying the shipped checkpoints over to the port: every leaf of the four
npz files lands in a port module with its layout converted, and the port
resolves the same config from artifacts/ as the JAX package."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu.train import checkpoint as jckpt
from golfaction_tpu_torch import checkpoint as tckpt
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models.align import AlignEncoder
from golfaction_tpu_torch.models.error import ErrorClassifier
from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN
from golfaction_tpu_torch.models.pose import PoseNet
from tests.torch_parity import jax_config_dict

ROOT = Path(__file__).resolve().parent.parent / "artifacts"
MODELS = ("pose", "gcn", "align", "error")


@pytest.fixture(scope="module")
def shipped():
    cfg = tckpt.config_for_artifacts(tcfg.get_config("full_pipeline"), str(ROOT))
    trees = tckpt.load_params(str(ROOT))
    return cfg, trees, weights.from_flax(trees)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("name", MODELS)
def test_npz_restore_matches_jax(name):
    path = str(ROOT / "params" / f"{name}.npz")
    got = dict(_leaves(tckpt.restore_params_npz(path)))
    want = dict(_leaves(jckpt.restore_params_npz(path)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", MODELS)
def test_every_leaf_carried_over(shipped, name):
    cfg, trees, sds = shipped
    module = {"pose": lambda: PoseNet(cfg.pose), "gcn": lambda: ActionSegmentationGCN(cfg.gcn),
              "align": lambda: AlignEncoder(cfg.align),
              "error": lambda: ErrorClassifier(cfg.error)}[name]()
    module.load_state_dict(sds[name], strict=True)       # every port parameter filled
    leaves = [v for _, v in _leaves(trees[name])]
    tensors = list(sds[name].values())
    assert len(leaves) == len(tensors)                    # no flax leaf dropped
    # Layout changes permute values; the multiset of values is kept.
    np.testing.assert_array_equal(np.sort(np.concatenate([v.ravel() for v in leaves])),
                                  np.sort(torch.cat([t.reshape(-1) for t in tensors]).numpy()))


@pytest.mark.parametrize("name", MODELS)
def test_to_flax_inverts_from_flax(shipped, name):
    """to_flax(from_flax(p)) == p, leaf for leaf: what the port trains goes
    back into the JAX package's tree unchanged in name, shape and value."""
    _, trees, sds = shipped
    back = dict(_leaves(weights.to_flax({name: sds[name]})[name]))
    want = dict(_leaves(trees[name]))
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].shape == want[k].shape and back[k].dtype == np.float32, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_saved_npz_is_the_jax_packages_file(shipped, name, tmp_path):
    """save_params_npz writes the keys and values that the JAX package's
    save_params_npz writes for the same tree, and its loader reads them."""
    _, trees, _ = shipped
    ours = tckpt.save_params_npz(str(tmp_path / "ours.npz"), trees[name])
    theirs = jckpt.save_params_npz(str(tmp_path / "theirs.npz"), trees[name])
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype == np.float16
            np.testing.assert_array_equal(a[k], b[k])
    got = dict(_leaves(jckpt.restore_params_npz(ours)))
    for k, v in _leaves(trees[name]):
        np.testing.assert_array_equal(got[k], v)        # the shipped leaves are float16 values


def test_layouts(shipped):
    _, trees, sds = shipped
    pose, gcn = trees["pose"]["params"], trees["gcn"]["params"]
    k = pose["Conv_0"]["kernel"]                                             # HWIO
    np.testing.assert_array_equal(sds["pose"]["stem.weight"].numpy(), k.transpose(3, 2, 0, 1))
    d = pose["ConvTranspose_0"]["kernel"]                                    # HWIO
    np.testing.assert_array_equal(sds["pose"]["deconvs.0.weight"].numpy(),
                                  d[::-1, ::-1].transpose(2, 3, 0, 1))
    m = gcn["GCNBlock_0"]["MultiBranchTemporalConv_0"]
    np.testing.assert_array_equal(sds["gcn"]["blocks.0.mbtc.dense.0.weight"].numpy(),
                                  m["Dense_0"]["kernel"].T)
    c = m["Conv_1"]["kernel"]                                                # (k,1,1,ch)
    np.testing.assert_array_equal(sds["gcn"]["blocks.0.mbtc.conv.1.weight"].numpy(),
                                  c[:, 0, 0, :].T[:, None, :])
    a = trees["align"]["params"]["Conv_1"]["kernel"]                         # (k,Cin,Cout)
    np.testing.assert_array_equal(sds["align"]["convs.1.weight"].numpy(), a.transpose(2, 1, 0))


def test_config_for_artifacts_matches_jax():
    want = jckpt.config_for_artifacts(jcfg.get_config("full_pipeline"), str(ROOT))
    got = tckpt.config_for_artifacts(tcfg.get_config("full_pipeline"), str(ROOT))
    assert dataclasses.asdict(got) == jax_config_dict(want)
    assert got.pose.sigma == 1.25 and got.pose.decode_tracking == 4
    assert got.pose.track_suppress_radius == 2.0 and got.error.mode_features


def test_error_thresholds_match_jax():
    np.testing.assert_array_equal(tckpt.load_error_thresholds(str(ROOT)),
                                  jckpt.load_error_thresholds(str(ROOT)))


@pytest.mark.parametrize("assignments", [["frame_batch=16"],
                                         ["pose.sigma=1.25", "length_buckets=(32,64)"],
                                         ["error.mode_features=True", "gcn.dtype=float32"]])
def test_apply_overrides_matches_jax(assignments):
    got = tcfg.apply_overrides(tcfg.get_config("clip_pose"), assignments)
    want = jcfg.apply_overrides(jcfg.get_config("clip_pose"), assignments)
    assert dataclasses.asdict(got) == jax_config_dict(want)


@pytest.mark.parametrize("assignment", ["preprocess_impl=pallas", "gcn.inference_impl=xla",
                                        "pose.decode_impl=pallas"])
def test_implementation_choices_are_refused(assignment):
    # Each stage of the port has one implementation: its kernel on the card.
    with pytest.raises(AttributeError):
        tcfg.apply_overrides(tcfg.get_config("clip_pose"), [assignment])
