"""The port's int8 GroupNorm+requant epilogue (ops.requant, plain version)
against the JAX package's Pallas kernel in interpret mode and against its jnp
oracle, on the same seeded inputs.

int8 outputs: equal except at most 1 LSB on under 0.5% of the elements (a
value on a rounding boundary falls either way with the sums' order; the JAX
suite allows its kernel the same against its oracle).  bfloat16 outputs:
within one bfloat16 ulp."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu.ops.pallas import requant_kernel as rk
from golfaction_tpu_torch.ops import launches_since, requant
from golfaction_tpu_torch.utils import profiling
from tests.test_torch_requant_geometry import assert_geometry_covers

CASES = [
    # residual, relu, out_scale, (n, h, w, c), groups
    ("none", True, 0.05, (2, 8, 16, 32), 8),
    ("none", False, 0.05, (2, 8, 16, 32), 8),
    ("none", True, None, (2, 8, 16, 32), 8),
    ("none", False, None, (2, 8, 16, 32), 8),
    ("int8", True, 0.04, (2, 8, 16, 32), 8),
    ("int8", False, 0.04, (2, 8, 16, 32), 4),
    ("int8", True, None, (2, 8, 16, 32), 8),
    ("conv", True, 0.04, (2, 8, 16, 32), 8),
    ("conv", False, 0.04, (2, 8, 16, 32), 4),
    ("conv", True, None, (2, 8, 16, 32), 4),
    ("none", True, 0.03, (1, 5, 7, 16), 4),
    ("conv", True, 0.03, (1, 5, 7, 16), 4),
]


def _inputs(seed, shape, residual):
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def vecs():
        return (rng.uniform(1e-4, 3e-4, (c,)).astype(np.float32),
                rng.normal(1.0, 0.1, (c,)).astype(np.float32),
                rng.normal(0.0, 0.1, (c,)).astype(np.float32))

    y = rng.integers(-20000, 20000, shape).astype(np.int32)
    sy, gamma, beta = vecs()
    kw = {}
    if residual == "int8":
        kw = {"residual": rng.integers(-127, 128, shape).astype(np.int8), "res_scale": 0.02}
    elif residual == "conv":
        rs, rg, rb = vecs()
        kw = {"residual": rng.integers(-20000, 20000, shape).astype(np.int32),
              "res_scale": rs, "res_gamma": rg, "res_beta": rb}
    return (y, sy, gamma, beta), kw


def _as(fn, args, kw):
    return ([fn(a) for a in args],
            {k: (fn(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("oracle", ["pallas_interpret", "jnp_reference"])
@pytest.mark.parametrize("residual,relu,out_scale,shape,groups", CASES)
def test_plain_epilogue_matches_jax(oracle, residual, relu, out_scale, shape, groups):
    args, kw = _inputs(sum(shape) + groups, shape, residual)
    targs, tkw = _as(torch.from_numpy, args, kw)
    got = requant.requant_epilogue(*targs, groups, relu=relu, out_scale=out_scale, **tkw)
    jargs, jkw = _as(jnp.asarray, args, kw)
    if oracle == "pallas_interpret":
        want = rk.requant_epilogue_pallas(*jargs, groups=groups, relu=relu,
                                          out_scale=out_scale, interpret=True, **jkw)
    else:
        want = rk.requant_epilogue_reference(*jargs, groups, relu=relu, out_scale=out_scale,
                                             **jkw)
    assert tuple(got.shape) == shape
    if out_scale is None:
        assert got.dtype == torch.bfloat16
        g = got.float().numpy()
        w = np.asarray(want.astype(jnp.float32))
        assert (np.abs(g - w) <= _bf16_ulp(w)).all()
    else:
        assert got.dtype == torch.int8
        diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
        assert diff.max() <= 1
        assert (diff != 0).mean() < 0.005


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    args, kw = _inputs(0, (2, 4, 6, 16), "conv")
    targs, tkw = _as(torch.from_numpy, args, kw)
    since = profiling.totals()
    a = requant.requant_epilogue(*targs, 4, out_scale=0.05, **tkw)
    b = requant.requant_epilogue_plain(*targs, 4, out_scale=0.05, **tkw)
    assert torch.equal(a, b)
    assert launches_since(since)["requant"] == 0


def test_group_norm_rows_matches_torch_group_norm():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 2, (3, 5, 7, 24)).astype(np.float32))
    g = torch.from_numpy(rng.normal(1, 0.1, 24).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, 24).astype(np.float32))
    want = torch.nn.functional.group_norm(x.permute(0, 3, 1, 2), 6, g, b, eps=1e-6)
    got = requant.group_norm_rows(x, 6, g, b).permute(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("R,C", [(12288, 64), (3072, 64), (768, 128), (192, 256), (48, 512),
                                 (35, 16), (7, 48), (1, 1024)])
def test_launch_geometry_covers_every_row(R, C):
    # Every residual mode and output type, at batch 1 and 64; the checks are
    # those of the 20 sites in tests/test_torch_requant_geometry.py.
    for N in (1, 64):
        for res_mode in (0, 1, 2):
            for out_int8 in (True, False):
                assert_geometry_covers(N, R, C, math.gcd(C, 32), res_mode, out_int8)


def test_residual_of_another_type_is_refused():
    args, _ = _inputs(0, (1, 2, 2, 8), "none")
    targs = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="int8 or int32"):
        requant.requant_epilogue(*targs, 4, residual=torch.zeros((1, 2, 2, 8)), out_scale=0.1)
