"""The port's external-weights importer against the JAX package's
(`golfaction_tpu/train/import_weights.py`): a synthetic MMPose-style pose
checkpoint (BatchNorm, foreign names, PyTorch layouts), made with numpy from
a seed, goes into the JAX PoseNet and into the port's; the JAX result,
carried across by weights.py, equals the port's to the bit, but for the
square ConvTranspose the JAX importer takes for an OIHW kernel (ROADMAP
reference behaviour (x))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu.models import pose as jpose
from golfaction_tpu.train import import_weights as jimport
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.train import import_weights as timport

# Three stages and two deconvs: 64 -> 32 (in != out) then 32 -> 32
# (a square ConvTranspose, as the shipped head's last, 128 -> 128).
POSE = dict(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
            stage_channels=(16, 32, 64), deconv_channels=(32, 32), dtype="float32")
SQUARE_DECONV = "deconvs.1.weight"


def _mmpose_state_dict(cfg, seed: int = 0) -> dict:
    """A pose checkpoint as MMPose writes one, in definition order:
    backbone convs (OIHW) each followed by a BatchNorm (weight, bias,
    running_mean, running_var, num_batches_tracked), the head's
    ConvTranspose2d (IOHW) each with its BatchNorm, then the final 1x1 conv
    with its bias; values from numpy."""
    rng = np.random.default_rng(seed)
    shapes = {n: tuple(t.shape) for n, t in PoseNet(cfg).state_dict().items()}
    sd = {}
    for i, (name, _) in enumerate(timport.pose_param_order(cfg)):
        if name.endswith(".bias") and not name.startswith("final"):
            continue                                   # written with its BatchNorm
        shape = shapes[name]
        if len(shape) == 1 and not name.startswith("final"):
            prefix = f"backbone.layer{i}.bn"
            sd[f"{prefix}.weight"] = torch.from_numpy(rng.normal(1, 0.1, shape).astype("f4"))
            sd[f"{prefix}.bias"] = torch.from_numpy(rng.normal(0, 0.1, shape).astype("f4"))
            sd[f"{prefix}.running_mean"] = torch.from_numpy(rng.normal(0, 1, shape).astype("f4"))
            sd[f"{prefix}.running_var"] = torch.from_numpy(rng.uniform(0.5, 2, shape).astype("f4"))
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(1000)
        else:
            key = f"keypoint_head.layer{i}.{name.split('.')[-1]}"
            sd[key] = torch.from_numpy(rng.normal(0, 0.05, shape).astype("f4"))
    return sd


@pytest.fixture(scope="module")
def imported():
    tc = tcfg.PoseConfig(**POSE)
    jc = jcfg.PoseConfig(**POSE)
    sd = _mmpose_state_dict(tc)
    model = PoseNet(tc)
    port_report = timport.import_torch_pose(model, sd, tc)
    like = jpose.create_pose_model(jc).init(jax.random.key(0),
                                            jnp.zeros((1, *jc.input_hw, 3)))
    jparams, jax_report = jimport.import_torch_pose(like, sd, jc)
    carried = weights.pose_state_dict(jax.tree.map(np.asarray, jparams))
    return sd, model, port_report, carried, jax_report


def test_port_equals_jax_carried_across_to_the_bit(imported):
    sd, model, _, carried, _ = imported
    got = model.state_dict()
    assert set(got) == set(carried)
    for name, t in got.items():
        if name == SQUARE_DECONV:
            continue
        assert torch.equal(t, carried[name]), name


def test_square_deconv_is_the_source_kernel(imported):
    """Reference behaviour (x): the JAX importer's first candidate for a 4-D
    source (OIHW -> HWIO) fits a square ConvTranspose's flax shape, so its
    IOHW kernel comes through with in and out swapped and unflipped; the
    port keeps the source's kernel, whose output equals PyTorch's own
    ConvTranspose2d with it."""
    sd, model, report, carried, _ = imported
    (entry,) = [e for e in report["imported"] if e["param"] == SQUARE_DECONV]
    src = sd[entry["torch"]]
    assert src.shape[0] == src.shape[1]
    assert torch.equal(model.state_dict()[SQUARE_DECONV], src)
    assert torch.equal(carried[SQUARE_DECONV], src.transpose(0, 1).flip(2, 3))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 32, 4, 3)).astype("f4"))
    ref = torch.nn.ConvTranspose2d(32, 32, 4, 2, padding=1, bias=False)
    with torch.no_grad():
        ref.weight.copy_(src)
        torch.testing.assert_close(model.deconvs[1](x), ref(x))


def test_reports_list_the_same_tensors(imported):
    _, _, port_report, _, jax_report = imported
    assert [(e["flax"], e["torch"]) for e in port_report["imported"]] == [
        (e["flax"], e["torch"]) for e in jax_report["imported"]]
    assert port_report["skipped_torch"] == jax_report["skipped_torch"]
    assert port_report["coverage"] == jax_report["coverage"] == 1.0


def test_batchnorm_running_statistics_are_skipped(imported):
    sd, _, report, _, _ = imported
    stats = [k for k in sd if "running_" in k or k.endswith("num_batches_tracked")]
    assert stats
    used = {e["torch"] for e in report["imported"]}
    assert not used & set(stats)
    assert {e["torch"] for e in report["skipped_torch"]}.isdisjoint(stats)
    assert used == set(sd) - set(stats)


def test_strict_raises_on_leftovers_in_both():
    tc, jc = tcfg.PoseConfig(**POSE), jcfg.PoseConfig(**POSE)
    sd = _mmpose_state_dict(tc)
    short = dict(list(sd.items())[:-1])                # the final conv's bias is gone
    model = PoseNet(tc)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="exhausted"):
        timport.import_torch_pose(model, short, tc, strict=True)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    like = jpose.create_pose_model(jc).init(jax.random.key(0), jnp.zeros((1, *jc.input_hw, 3)))
    with pytest.raises(ValueError, match="exhausted"):
        jimport.import_torch_pose(like, short, jc, strict=True)
    report = timport.import_torch_pose(model, short, tc, strict=False)
    (_, jreport) = jimport.import_torch_pose(like, short, jc, strict=False)
    assert len(report["imported"]) == len(jreport["imported"]) == len(
        timport.pose_param_order(tc)) - 1


def test_param_order_mirrors_the_jax_order():
    for kw in (POSE, {}):
        tc, jc = tcfg.PoseConfig(**kw), jcfg.PoseConfig(**kw)
        got = timport.pose_param_order(tc)
        assert [f for _, f in got] == jimport.pose_param_order(jc)
        assert {n for n, _ in got} == set(PoseNet(tc).state_dict())


def test_state_dict_import_by_name_reports_and_strict():
    tc = tcfg.PoseConfig(**POSE)
    src = PoseNet(tc)
    weights.init_random(src, torch.Generator().manual_seed(3))
    sd = dict(src.state_dict())
    sd["stem.weight"] = sd["stem.weight"][:, :, :5]               # another shape
    del sd["final.bias"]
    sd["head.extra"] = torch.zeros(2)
    sd["gn0.num_batches_tracked"] = torch.tensor(5)
    model = PoseNet(tc)
    with pytest.raises(ValueError, match="strict import failed"):
        timport.import_torch_state_dict(model, sd, strict=True)
    report = timport.import_torch_state_dict(model, sd)
    assert [m["param"] for m in report["shape_mismatch"]] == ["stem.weight"]
    assert [s["param"] for s in report["skipped"]] == ["final.bias"]
    assert report["unused_torch"] == ["head.extra"]
    got, want = model.state_dict(), src.state_dict()
    for name in got:
        if name not in ("stem.weight", "final.bias"):
            assert torch.equal(got[name], want[name]), name
    assert not torch.equal(got["stem.weight"], want["stem.weight"])
    full = PoseNet(tc)
    rep = timport.import_torch_state_dict(full, src.state_dict(), strict=True)
    assert rep["coverage"] == 1.0
