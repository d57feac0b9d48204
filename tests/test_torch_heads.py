"""The alignment encoder and the error classifier (with and without the
aligned reference and the secondary-mode features): the port against the
JAX package's flax models with the same weights, float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu.models import align as jalign
from golfaction_tpu.models import error as jerror
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models import error as terror
from golfaction_tpu_torch.models.align import AlignEncoder
from tests.torch_parity import sub_config, to_numpy

B, T, V = 2, 11, 17


def _skeletons(seed):
    rng = np.random.default_rng(seed)
    k = np.concatenate([rng.uniform(50, 400, (B, T, V, 2)), rng.uniform(0, 1, (B, T, V, 1))],
                       -1).astype(np.float32)
    valid = np.arange(T)[None] < np.array([[T], [7]])
    return k, valid


@pytest.mark.parametrize("hidden", [(8, 16), (16, 16, 32)])
def test_align_encoder_matches_flax(hidden):
    jc = jcfg.AlignConfig(embed_dim=16, hidden_channels=hidden, dtype="float32")
    k, valid = _skeletons(len(hidden))
    model = jalign.create_align_model(jc)
    params = model.init(jax.random.key(0), jnp.asarray(k), jnp.asarray(valid))
    want = np.asarray(model.apply(params, jnp.asarray(k), jnp.asarray(valid)))
    port = AlignEncoder(sub_config(tcfg.AlignConfig, jc))
    port.load_state_dict(weights.from_flax({"align": to_numpy(params)})["align"])
    with torch.no_grad():
        got = port(torch.from_numpy(k), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mode_features", [False, True])
@pytest.mark.parametrize("with_ref", [False, True])
def test_error_classifier_matches_flax(mode_features, with_ref):
    jc = jcfg.ErrorConfig(hidden_dim=32, dtype="float32", mode_features=mode_features)
    k, valid = _skeletons(3)
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(B, T, jc.num_phases)).astype(np.float32)
    ref = (k + rng.normal(0, 5, k.shape).astype(np.float32)) if with_ref else None
    aux = np.concatenate([rng.normal(0, 4, (B, T, V, 2)), rng.uniform(0, 3, (B, T, V, 1)),
                          rng.uniform(0, 6, (B, T, V, 1))], -1).astype(np.float32)
    aux = aux if mode_features else None
    j = [jnp.asarray(a) if a is not None else None for a in (k, logits, valid, ref, aux)]
    model = jerror.create_error_model(jc)
    params = model.init(jax.random.key(2), *j)
    want = np.asarray(model.apply(params, *j))
    port = terror.ErrorClassifier(sub_config(tcfg.ErrorConfig, jc))
    port.load_state_dict(weights.from_flax({"error": to_numpy(params)})["error"])
    t = [torch.from_numpy(a) if a is not None else None for a in (k, logits, valid, ref, aux)]
    with torch.no_grad():
        got = port(*t).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_angle_features_match_jax():
    k, _ = _skeletons(5)
    np.testing.assert_allclose(terror.angle_features(torch.from_numpy(k)).numpy(),
                               np.asarray(jerror.angle_features(jnp.asarray(k))),
                               rtol=1e-5, atol=1e-5)


def test_smooth_time_matches_jax():
    k, valid = _skeletons(6)
    for v in (None, valid):
        got = terror._smooth_time(torch.from_numpy(k),
                                  None if v is None else torch.from_numpy(v))
        want = jerror._smooth_time(jnp.asarray(k), None if v is None else jnp.asarray(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)


def test_feature_dim_matches_shipped_head():
    assert terror.feature_dim(tcfg.ErrorConfig(mode_features=True)) == 209
