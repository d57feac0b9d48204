"""Faults of the port against the JAX package, repaired: the batched,
fixed-order `warp_by_path` against the JAX function; config fields the port
does not honour refused where they are set (and `mesh`, honoured since data
parallelism came, accepted and read); a refiner kept as an Orbax step
directory refused rather than dropped, and one kept as npz loaded."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu.ops import softdtw as jsd
from golfaction_tpu_torch import checkpoint, weights
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch.models.refine import KeypointRefiner
from golfaction_tpu_torch.ops import softdtw as tsd
from golfaction_tpu_torch.parallel import mesh as mesh_mod
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from tests import torch_parallel_ranks as ranks
from tests.torch_dp import run_ranks


def _paths(T, Tr, lengths, seed):
    """Hard-DTW paths [N, T+Tr-1, 2] of random tables over D[:la, :lb], cut
    to `lengths` where a length is shorter than the path (0 included)."""
    rng = np.random.default_rng(seed)
    N = len(lengths)
    D = torch.from_numpy(rng.uniform(0, 4, (N, T, Tr)).astype(np.float32))
    la = torch.from_numpy(rng.integers(T // 2, T + 1, N).astype(np.int32))
    lb = torch.from_numpy(rng.integers(Tr // 2, Tr + 1, N).astype(np.int32))
    path, n = tsd.dtw_path_masked(D, la, lb)
    length = torch.minimum(n, torch.tensor(lengths, dtype=torch.int32))
    return path, length


def _revisiting_path(T, Tr):
    """Clip frame 3 aligned to reference frames 1-6, frame 9 to 7-9: runs of
    several entries on one clip frame."""
    rows = [(0, 0), (1, 0), (2, 1), (3, 1), (3, 2), (3, 3), (3, 4), (3, 5), (3, 6), (4, 6),
            (5, 6), (6, 7), (7, 7), (8, 7), (9, 7), (9, 8), (9, 9)]
    L = T + Tr - 1
    path = np.full((L, 2), -1, np.int32)
    path[:len(rows)] = rows
    return torch.from_numpy(path), len(rows)


def _jax_warp(ref_vals, path, length, T):
    return np.stack([np.asarray(jsd.warp_by_path(jnp.asarray(ref_vals), jnp.asarray(p), int(n), T))
                     for p, n in zip(path, length)])


@pytest.mark.parametrize("T,Tr,lengths", [(16, 10, (25, 12, 0, 3)), (12, 12, (23, 1)),
                                          (20, 7, (26, 26, 26, 26, 26)), (5, 9, (0,))])
@pytest.mark.parametrize("extra", [(17, 3), ()])
def test_batched_warp_matches_jax(T, Tr, lengths, extra):
    path, length = _paths(T, Tr, lengths, seed=T * Tr)
    rev, n_rev = _revisiting_path(T, Tr) if T >= 10 and Tr >= 10 else (None, 0)
    if rev is not None:
        path = torch.cat([path, rev[None]])
        length = torch.cat([length, torch.tensor([n_rev], dtype=torch.int32)])
    ref_vals = np.random.default_rng(1).normal(0, 300, (Tr, *extra)).astype(np.float32)
    got = tsd.warp_by_path(torch.from_numpy(ref_vals), path, length, T)
    assert got.shape == (len(length), T, *extra)
    want = _jax_warp(ref_vals, path.numpy(), length.numpy(), T)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # One path at a time (the single-pair form) gives the same bits.
    for k in range(len(length)):
        one = tsd.warp_by_path(torch.from_numpy(ref_vals), path[k], length[k], T)
        assert torch.equal(one, got[k])
    if 0 in length.tolist():
        assert not got[length.tolist().index(0)].any()


def test_warp_averages_a_revisited_frame():
    path, n = _revisiting_path(12, 10)
    ref = torch.arange(10, dtype=torch.float32)[:, None]
    out = tsd.warp_by_path(ref, path, n, 12)
    assert out[3, 0] == pytest.approx((1 + 2 + 3 + 4 + 5 + 6) / 6)
    assert out[9, 0] == pytest.approx(8.0) and out[0, 0] == 0.0
    assert (out[10:] == 0).all()                    # frames the path never visits


@pytest.mark.parametrize("build", [
    lambda: tcfg.PipelineConfig(preprocess_dtype="float16"),
    lambda: tcfg.get_config("full_pipeline", preprocess_dtype="float64"),
    lambda: tcfg.apply_overrides(tcfg.get_config(), ["preprocess_dtype=int8"]),
    lambda: dataclasses.replace(tcfg.get_config(), preprocess_dtype="float16"),
])
def test_a_preprocess_dtype_other_than_float32_is_refused(build):
    """Every dtype but the two the crops come in (bfloat16 is accepted since
    kernel A has a bfloat16 variant) is refused, and the message names both."""
    with pytest.raises(ValueError, match="preprocess_dtype.*'float32', 'bfloat16'"):
        build()


MESH_OVERRIDES = ["mesh.data_parallel=2", "mesh.model_parallel=4", "mesh.data_axis='batch'",
                  "mesh.data_parallel=8"]


@pytest.fixture(scope="module")
def meshes_at_world_4(tmp_path_factory):
    """make_mesh of each override's mesh on every rank of a 4-rank gloo group."""
    return run_ranks(ranks.overrides_task, 4, str(tmp_path_factory.mktemp("mesh")),
                     (MESH_OVERRIDES,), timeout=240.0)


@pytest.mark.parametrize("n", range(len(MESH_OVERRIDES)))
def test_a_non_default_mesh_is_accepted_and_read_by_make_mesh(meshes_at_world_4, n):
    """The port honours `mesh` since it has data parallelism: the config
    takes any MeshConfig, and make_mesh lays a group out by it (raising
    where dp x mp exceeds the group, and on the ranks a smaller mesh leaves
    out)."""
    cfg = tcfg.apply_overrides(tcfg.get_config(), [MESH_OVERRIDES[n]])
    assert cfg.mesh != tcfg.MeshConfig()
    got = [r[n] for r in meshes_at_world_4]
    one = {"data": 1, "model": 1}
    if n == 0:        # 2x1 over ranks 0 and 1; ranks 2 and 3 are outside it
        assert got[:2] == [{"shape": dict(one, data=2), "data_index": r, "data_sum": 1.0,
                            "axes": ("data", "model")} for r in range(2)]
        assert got[2:] == [f"rank {r} lies outside the 2x1 mesh of a 4-rank group: start 2 "
                           "processes" for r in (2, 3)]
    elif n == 1:      # 1x4: one data shard, every rank its own data group
        assert got == [{"shape": dict(one, model=4), "data_index": 0, "data_sum": float(r),
                        "axes": ("data", "model")} for r in range(4)]
    elif n == 2:      # 4x1 along an axis named "batch"
        assert got == [{"shape": {"batch": 4, "model": 1}, "data_index": r, "data_sum": 6.0,
                        "axes": ("batch", "model")} for r in range(4)]
    else:
        assert got == ["mesh 8x1 needs 8 devices, have 4"] * 4


def test_the_defaults_are_still_accepted():
    cfg = tcfg.apply_overrides(tcfg.get_config(), ["preprocess_dtype='float32'",
                                                   "mesh.data_parallel=-1", "frame_batch=16"])
    assert cfg.preprocess_dtype == "float32" and cfg.mesh == tcfg.MeshConfig()
    assert cfg.frame_batch == 16


@pytest.mark.parametrize("override", MESH_OVERRIDES[:3])
def test_a_pipeline_without_a_mesh_refuses_a_non_default_mesh_config(override):
    """A config that asks for a mesh is not run on one device without a word."""
    cfg = tcfg.apply_overrides(tcfg.get_config(), [override])
    with pytest.raises(ValueError, match="asks for a mesh and none was given"):
        Pipeline(cfg, device="cpu")


def _mesh(dp, mp, data_axis="data"):
    """A mesh's layout alone (no process group): what the Pipeline checks
    before its first collective."""
    return mesh_mod.Mesh(group=None, data_group=None, data_ranks=tuple(range(dp)), dp=dp,
                         mp=mp, data_axis=data_axis, model_axis="model", rank=0,
                         device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("override, mesh", [
    ([], _mesh(2, 2)),                                 # mp 2 against the config's 1
    (["mesh.data_parallel=4"], _mesh(2, 1)),
    (["mesh.data_axis='batch'"], _mesh(2, 1)),
])
def test_a_pipeline_refuses_a_mesh_of_another_layout_than_its_config(override, mesh):
    cfg = tcfg.apply_overrides(tcfg.get_config(), override)
    with pytest.raises(ValueError, match="is not the layout of"):
        Pipeline(cfg, mesh=mesh)


def test_a_mesh_of_the_configs_layout_passes_the_check():
    for override, mesh in (([], _mesh(3, 1)), (["mesh.data_parallel=2"], _mesh(2, 1)),
                           (["mesh.data_axis='batch'", "mesh.model_parallel=2"],
                            _mesh(2, 2, "batch"))):
        mesh_mod.check_config(mesh, tcfg.apply_overrides(tcfg.get_config(), override).mesh)


def test_an_orbax_refiner_is_refused_naming_the_npz_conversion(tmp_path):
    (tmp_path / "params" / "refine" / "step_00000001").mkdir(parents=True)
    with pytest.raises(ValueError, match=r"npz.*refine\.npz|refine\.npz"):
        checkpoint.config_for_artifacts(tcfg.get_config(), str(tmp_path))
    with pytest.raises(ValueError, match="npz"):
        checkpoint.config_for_artifacts(
            tcfg.apply_overrides(tcfg.get_config(), ["refine.enabled=True"]), str(tmp_path))


def test_an_npz_refiner_is_enabled_and_loaded(tmp_path):
    (tmp_path / "params" / "refine").mkdir(parents=True)      # no step_* inside
    cfg = tcfg.get_config()
    assert checkpoint.config_for_artifacts(cfg, str(tmp_path)) == cfg
    model = KeypointRefiner(cfg.refine)
    gen = torch.Generator().manual_seed(3)
    weights.init_random(model, gen)
    checkpoint.save_params_npz(str(tmp_path / "params" / "refine.npz"),
                               weights.to_flax({"refine": model.state_dict()})["refine"])
    got = checkpoint.config_for_artifacts(cfg, str(tmp_path))
    assert got.refine.enabled and got == dataclasses.replace(
        cfg, refine=dataclasses.replace(cfg.refine, enabled=True))
    sd = weights.from_flax(checkpoint.load_params(str(tmp_path)))["refine"]
    for k, v in model.state_dict().items():     # float16 on disk, as every npz checkpoint
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4)
    # A refiner the config asks for is dropped only when the tree has none.
    (tmp_path / "params" / "refine.npz").unlink()
    on = tcfg.apply_overrides(cfg, ["refine.enabled=True"])
    assert not checkpoint.config_for_artifacts(on, str(tmp_path)).refine.enabled
