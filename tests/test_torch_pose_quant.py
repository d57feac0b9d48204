"""The port's int8 pose path (models.pose_quant, quantize_eval) against the JAX
package's, at a small size on the CPU.

The JAX model's seed-1 params go into the port's PoseNet with
weights.pose_state_dict; the JAX quantized weights and calibration scales go
over with weights.quantized_from_flax, so both packages run the same
quantized graph.  The fused JAX forward runs its Pallas epilogue in interpret
mode.  Integer results are compared exactly; heatmaps within 0.01 of the
largest absolute heatmap value (one flipped rounding at an early site
propagates through every later layer; the gaps measured here are 0 for the
int8, fused and mixed 1 and 3 forwards and 5e-4 for mixed 2)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu.config import PoseConfig
from golfaction_tpu.models import pose as jpose
from golfaction_tpu.models import pose_quant as jq
from golfaction_tpu.ops.pallas import requant_kernel as rk
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import quantize_eval, weights
from golfaction_tpu_torch.models import pose_quant as tq
from golfaction_tpu_torch.models.pose import PoseNet
from tests.torch_parity import sub_config, to_numpy

TINY = PoseConfig(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
                  stage_channels=(16, 32, 64), deconv_channels=(32, 32), dtype="float32")
HEATMAP_TOL = 0.01


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *TINY.input_hw, 3)).astype(np.float32)
    calib = rng.normal(size=(8, *TINY.input_hw, 3)).astype(np.float32)
    jmodel = jpose.create_pose_model(TINY)
    params = jmodel.init(jax.random.key(1), jnp.asarray(x))
    qw, scales = jq.prepare_int8(params, TINY, jnp.asarray(calib))
    model = PoseNet(sub_config(tcfg.PoseConfig, TINY))
    model.load_state_dict(weights.pose_state_dict(to_numpy(params)))
    model.eval()
    tqw, tscales = weights.quantized_from_flax(to_numpy(qw), scales)
    return {"x": x, "calib": calib, "params": params, "qw": qw, "scales": scales,
            "model": model, "tqw": tqw, "tscales": tscales}


def _rel_gap(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-6))


def test_quantized_weights_equal_the_jax_ones(setup):
    own = tq.quantize_weights(setup["model"])
    assert set(own) == set(setup["tqw"]) == set(tq.conv_names(setup["model"])[:-1])
    for name, (w, s) in own.items():
        w_j, s_j = setup["tqw"][name]
        assert w.dtype == torch.int8 and torch.equal(w, w_j), name
        assert torch.equal(s, s_j), name


def test_quantized_round_trip_to_flax(setup):
    qw_back, scales_back = weights.quantized_to_flax(setup["tqw"], setup["tscales"])
    assert scales_back == {k: float(v) for k, v in setup["scales"].items()}
    want = to_numpy(setup["qw"])
    flat_w = jax.tree.leaves(want)
    flat_g = jax.tree.leaves(qw_back)
    assert jax.tree.structure(want) == jax.tree.structure(qw_back)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w)


def test_calibration_scales(setup):
    got = tq.calibrate(setup["model"], torch.from_numpy(setup["calib"]))
    assert set(got) == set(setup["tscales"])
    for k, v in setup["tscales"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_is_exact(dtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(0, 2, (4, 9, 7, 8))).astype(np.float32)
    scale = float(np.abs(x).max()) / 127.0
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(tq._q8(xt, scale).numpy(), np.asarray(jq._q8(xj, scale)))


@pytest.mark.parametrize("k,stride,cin,cout,hw", [
    (7, 2, 3, 16, (64, 48)), (3, 1, 16, 16, (16, 12)), (3, 2, 16, 32, (16, 12)),
    (1, 2, 16, 32, (16, 12)), (1, 1, 8, 8, (5, 7)), (3, 2, 8, 24, (9, 7)),
    (3, 1, 512, 8, (4, 3)),
])
def test_integer_convolution_is_exact(k, stride, cin, cout, hw):
    rng = np.random.default_rng(k * 100 + stride * 10 + cin)
    x = rng.integers(-127, 128, (2, *hw, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    want = np.asarray(jq._conv_raw_i8(jnp.asarray(x), jnp.asarray(w), stride))
    got = tq.conv_i8(torch.from_numpy(x), torch.from_numpy(w.reshape(-1, cout)), k, stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cin,cout,hw", [(64, 32, (4, 3)), (8, 16, (5, 7))])
def test_integer_transposed_convolution_is_exact(cin, cout, hw):
    rng = np.random.default_rng(cin + cout)
    x = rng.integers(-127, 128, (2, *hw, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (4, 4, cin, cout)).astype(np.int8)
    want = np.asarray(jq._deconv_raw_i8(jnp.asarray(x), jnp.asarray(w)))
    got = tq.deconv_i8(torch.from_numpy(x), torch.from_numpy(w.reshape(-1, cout)))
    assert tuple(got.shape) == (2, 2 * hw[0], 2 * hw[1], cout)
    np.testing.assert_array_equal(got.numpy(), want)


def test_integer_convolution_matches_float64(setup):
    # The port's own check of exactness, as chip_smoke runs it on the card.
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-127, 128, (1, 6, 5, 512)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 512, 16)).astype(np.int8))
    got = tq.conv_i8(x, w.reshape(-1, 16), 3, 1)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).double(),
                                      w.permute(3, 2, 0, 1).double(), padding=1)
    assert torch.equal(got.double(), want.permute(0, 2, 3, 1))


@pytest.mark.parametrize("hw", [(32, 24), (9, 7)])
def test_int8_max_pool_is_exact(hw):
    rng = np.random.default_rng(hw[0])
    x = rng.integers(-128, 128, (2, *hw, 8)).astype(np.int8)
    want = np.asarray(jq._max_pool_i8(jnp.asarray(x)))
    np.testing.assert_array_equal(tq.max_pool_i8(torch.from_numpy(x)).numpy(), want)


def test_first_fused_site_int8_activations(setup):
    """The stem's epilogue output, int8: equal except at most 1 LSB on under
    0.5% of the elements."""
    seen = []

    def spy(*a, **kw):
        out = tq.requant.requant_epilogue(*a, **kw)
        seen.append(out)
        return out

    tq.pose_forward_int8_fused(setup["model"], setup["tqw"], setup["tscales"],
                               torch.from_numpy(setup["x"]), epilogue=spy)
    n_sites = 1 + 2 * sum(TINY.stage_blocks) + len(setup["model"].deconvs)
    assert len(seen) == n_sites
    p, qw, scales = setup["params"]["params"], setup["qw"], setup["scales"]
    x_i8 = jq._q8(jnp.asarray(setup["x"]), scales["Conv_0"])
    w0, sw0 = qw["Conv_0"]
    y = jq._conv_raw_i8(x_i8, w0, stride=2)
    want = rk.requant_epilogue_pallas(
        y, scales["Conv_0"] * sw0, p["GroupNorm_0"]["scale"], p["GroupNorm_0"]["bias"],
        groups=32, relu=True, out_scale=float(scales["ResBlock_0/Conv_0"]), interpret=True)
    diff = np.abs(seen[0].numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.005
    assert seen[-1].dtype == torch.bfloat16 and all(s.dtype == torch.int8 for s in seen[:-1])


def test_forward_int8(setup):
    want = jq.pose_forward_int8(setup["params"], setup["qw"], setup["scales"], TINY,
                                jnp.asarray(setup["x"]))
    got = tq.pose_forward_int8(setup["model"], setup["tqw"], setup["tscales"],
                               torch.from_numpy(setup["x"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 17, 16, 12)
    gap = _rel_gap(got, want)
    print(f"int8 heatmap gap {gap:.5f}")
    assert gap < HEATMAP_TOL


def test_forward_int8_fused(setup):
    want = jq.pose_forward_int8_fused(setup["params"], setup["qw"], setup["scales"], TINY,
                                      jnp.asarray(setup["x"]), interpret=True)
    got = tq.pose_forward_int8_fused(setup["model"], setup["tqw"], setup["tscales"],
                                     torch.from_numpy(setup["x"]))
    gap = _rel_gap(got, want)
    print(f"fused heatmap gap {gap:.5f}")
    assert gap < HEATMAP_TOL


@pytest.mark.parametrize("k", [1, 2, 3])
def test_forward_int8_mixed(setup, k):
    want = jq.pose_forward_int8_mixed(setup["params"], setup["qw"], setup["scales"], TINY,
                                      jnp.asarray(setup["x"]), int8_stages=k)
    got = tq.pose_forward_int8_mixed(setup["model"], setup["tqw"], setup["tscales"],
                                     torch.from_numpy(setup["x"]), int8_stages=k)
    gap = _rel_gap(got, want)
    print(f"mixed{k} heatmap gap {gap:.5f}")
    assert gap < HEATMAP_TOL


def test_int8_forwards_stay_close_to_float(setup):
    x = torch.from_numpy(setup["x"])
    with torch.no_grad():
        ref = setup["model"](x)
    scale = float(ref.abs().max())
    for fn in (tq.pose_forward_int8, tq.pose_forward_int8_fused):
        got = fn(setup["model"], setup["tqw"], setup["tscales"], x)
        assert float((got - ref).abs().max()) / scale < 0.12


def test_quantize_eval_runs_end_to_end_on_the_cpu(tmp_path, capsys):
    out = quantize_eval.main([
        "--device", "cpu", "--artifacts", str(tmp_path / "none"), "--calib-clips", "1",
        "--eval-clips", "2", "--frames", "4", "--image-hw", "128", "192",
        "--set", "input_hw=(64,48)", "--set", "heatmap_hw=(16,12)",
        "--set", "stage_blocks=(1,1,1)", "--set", "stage_channels=(16,32,64)",
        "--set", "deconv_channels=(32,32)"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    jax_keys = {"pck_float", "pck_int8", "pck_int8_fused", "ms_float", "ms_int8",
                "ms_int8_fused", "speedup", "speedup_fused", "mixed", "crops"}
    assert jax_keys <= set(out)
    assert out["crops"] == 8 and out["device"] == "cpu"
    assert set(out["mixed"]) == {"1", "2", "3"}
    for m in out["mixed"].values():
        assert set(m) == {"ms", "pck", "speedup"} and 0.0 <= m["pck"] <= 1.0
    for k in ("pck_float", "pck_int8", "pck_int8_fused"):
        assert 0.0 <= out[k] <= 1.0
    assert all(np.isfinite(out[k]) and out[k] > 0 for k in ("ms_float", "ms_int8",
                                                            "ms_int8_fused"))


def test_quantize_eval_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize_eval.main(["--artifacts", str(tmp_path / "none")])
