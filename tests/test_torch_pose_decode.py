"""PoseNet and the heatmap decode: the port against the JAX package on the
same seeded inputs and the same weights, float32 on the CPU."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu.models import pose as jpose
from golfaction_tpu.ops import heatmap as jhm
from golfaction_tpu.train import checkpoint as jckpt
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.ops import heatmap as thm
from tests.torch_parity import sub_config, to_numpy

NARROW = [
    dict(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
         stage_channels=(8, 16, 32), deconv_channels=(16, 16)),
    # One declared deconv short of heatmap resolution: the extra-deconv loop
    # (its GroupNorm takes 32 groups whatever the width, so 32 channels).
    dict(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
         stage_channels=(8, 16, 32), deconv_channels=(32,)),
    # Three frames concatenated on channels.
    dict(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 2),
         stage_channels=(16, 32), deconv_channels=(16,), in_frames=3),
]


def _pose_pair(jax_cfg, params):
    port = PoseNet(sub_config(tcfg.PoseConfig, jax_cfg)).eval()
    port.load_state_dict(weights.pose_state_dict(to_numpy(params)), strict=True)
    return port


@pytest.mark.parametrize("kw", NARROW)
def test_posenet_matches_flax(kw):
    cfg = jcfg.PoseConfig(dtype="float32", **kw)
    model = jpose.create_pose_model(cfg)
    x = np.random.default_rng(0).normal(size=(2, *cfg.input_hw, 3 * cfg.in_frames))
    x = x.astype(np.float32)
    params = model.init(jax.random.key(1), jnp.asarray(x))
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _pose_pair(cfg, params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 17, *cfg.heatmap_hw)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_posenet_full_width_shipped_weights():
    cfg = jcfg.PoseConfig(dtype="float32")
    root = Path(__file__).resolve().parent.parent / "artifacts" / "params" / "pose.npz"
    params = jckpt.restore_params_npz(str(root))
    x = np.random.default_rng(1).normal(size=(2, 256, 192, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jpose.create_pose_model(cfg).apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _pose_pair(cfg, params)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 17, 64, 48)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def _heatmaps(seed, T=10, K=17, H=16, W=12):
    """Seeded bimodal Gaussian heatmaps plus noise, some maps flat zero (so
    topk_modes has to emit pad slots)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    out = np.zeros((T, K, H, W), np.float32)
    for t in range(T):
        for k in range(K):
            for amp in (1.0, rng.uniform(0.2, 0.9)):
                cx, cy = rng.uniform(0, W - 1), rng.uniform(0, H - 1)
                out[t, k] += amp * np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * 1.25 ** 2))
    out += rng.uniform(0, 0.02, out.shape).astype(np.float32)
    out[:, :2] = 0.0
    return out


@pytest.mark.parametrize("method", ["udp", "quarter", "argmax"])
def test_decode_heatmaps_matches_jax(method):
    hm = _heatmaps(0)
    want = np.asarray(jhm.decode_heatmaps(jnp.asarray(hm), method))
    got = thm.decode_heatmaps(torch.from_numpy(hm), method).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_modes_and_viterbi_match_jax(seed):
    hm = _heatmaps(seed)
    want = np.asarray(jhm.topk_modes(jnp.asarray(hm), k=4, suppress_radius=2.0))
    got = thm.topk_modes(torch.from_numpy(hm), k=4, suppress_radius=2.0).numpy()
    assert got.shape == (10, 17, 4, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got[..., 2] == 0, want[..., 2] == 0)      # pad slots
    assert (got[:, :2, :, 2] == 0).all()
    # Viterbi on the same modes: the same mode is selected in every frame.
    jtr = np.asarray(jhm.viterbi_track(jnp.asarray(want), lam=0.1))
    ttr = thm.viterbi_track(torch.from_numpy(want.copy()), lam=0.1).numpy()
    sel_j = np.abs(want - jtr[:, :, None]).sum(-1).argmin(-1)
    sel_t = np.abs(want - ttr[:, :, None]).sum(-1).argmin(-1)
    np.testing.assert_array_equal(sel_t, sel_j)
    np.testing.assert_allclose(ttr, jtr, atol=1e-4)


def test_keypoints_to_image_matches_jax():
    rng = np.random.default_rng(3)
    kp = rng.uniform(0, 12, (5, 17, 3)).astype(np.float32)
    boxes = rng.uniform(50, 300, (5, 4)).astype(np.float32)
    want = jhm.keypoints_to_image(jnp.asarray(kp), jnp.asarray(boxes), (16, 12),
                                  (64, 48))
    got = thm.keypoints_to_image(torch.from_numpy(kp), torch.from_numpy(boxes),
                                 (16, 12), (64, 48))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
