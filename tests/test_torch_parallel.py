"""Data parallelism of the port (golfaction_tpu_torch/parallel/,
ops/softdtw_sharded.py, Pipeline(mesh=)) on gloo ranks of this host, held
to the port's single-process runs and to the JAX package
(golfaction_tpu/parallel/, ops/softdtw_sharded.py) on its 8 virtual CPU
devices.

Each world size spawns once (a module fixture); its ranks run every check of
that size (tests/torch_parallel_ranks.py, which imports no JAX) and return
numpy.  The limits are the JAX package's: the train step as
tests/test_parallel.py holds it (loss rtol 1e-5, gradients and parameters
atol 1e-5), analyze_batch as MULTICHIP_r05.json records it (keypoints atol
1e-4, labels exact, error probabilities atol 1e-4, cost rtol 1e-4, path
exact), the soft-DTW as tests/test_softdtw_sharded.py (cost rtol 2e-5,
gradient atol 2e-5)."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu import types as jtypes
from golfaction_tpu.models import align as jalign
from golfaction_tpu.models import error as jerror
from golfaction_tpu.models import gcn as jgcn
from golfaction_tpu.ops import softdtw as jsdtw
from golfaction_tpu.ops.softdtw_sharded import softdtw_cost_sharded as jax_sharded
from golfaction_tpu.parallel import mesh as jmesh
from golfaction_tpu.pipeline import orchestrator as jorch
from golfaction_tpu.train import losses as jlosses
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import types as ttypes
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.ops import heatmap, softdtw
from golfaction_tpu_torch.parallel import mesh as mesh_mod
from golfaction_tpu_torch.pipeline import orchestrator as torch_orch
from golfaction_tpu_torch.pipeline import video_io as tvideo
from golfaction_tpu_torch.train import data as tdata
from golfaction_tpu_torch.train import loops
from tests import torch_dp
from tests import torch_parallel_ranks as ranks
from tests.torch_parity import port_config, port_params, sub_config, to_numpy

ROOT = Path(__file__).resolve().parent.parent
T = 16
J_GCN = jcfg.GCNConfig(block_channels=(8, 16), temporal_branches=((3, 1), (3, 2)),
                       dropout=0.0, dtype="float32")
J_ERR = jcfg.ErrorConfig(hidden_dim=16, dtype="float32", mode_features=True)
J_ALIGN = jcfg.AlignConfig(embed_dim=8, hidden_channels=(8,), dtype="float32")
# The JAX dry run's inference config (__graft_entry__.py): tracked decode,
# mode features, the refiner on.
J_PIPE = jcfg.PipelineConfig(
    pose=jcfg.PoseConfig(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
                         stage_channels=(8, 8, 16), deconv_channels=(8, 8), dtype="float32",
                         decode_tracking=3, track_suppress_radius=2.0),
    gcn=J_GCN, align=J_ALIGN, error=J_ERR,
    refine=jcfg.RefineConfig(enabled=True, block_channels=(8,), temporal_branches=((3, 1),),
                             dtype="float32"),
    frame_batch=4, length_buckets=(8,), video_hw=(96, 128))
MESH_CFGS = [jcfg.MeshConfig(), jcfg.MeshConfig(data_parallel=2, model_parallel=2),
             jcfg.MeshConfig(data_parallel=16, model_parallel=1)]
# tests/test_softdtw_sharded.py's cases: (shape, gamma, seed, high, col_chunks).
SDTW_CASES = [((64, 48), 0.1, 3, 2.0, None), ((64, 64), 1.0, 3, 2.0, None),
              ((61, 45), 0.3, 5, 3.0, None), ((32, 96), 0.5, 7, 1.0, 12)]
TIMEOUT = 240.0


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _state_np(sd: dict) -> dict:
    return {k: _np(v) for k, v in sd.items()}


def _jax_loss_fns(models):
    gcn, err, al = models

    def gcn_loss(p, batch):
        sk, labels, valid = batch
        return jlosses.phase_cross_entropy(gcn.apply(p["gcn"], sk, valid), labels, valid,
                                           label_smoothing=0.05)

    def skeleton_loss(p, batch):
        sk, kpts, labels, flags, prog, valid = batch
        logits = gcn.apply(p["gcn"], sk, valid)
        l_phase = jlosses.phase_cross_entropy(logits, labels, valid)
        l_err = jlosses.error_bce(err.apply(p["error"], kpts, logits, valid), flags)
        emb = al.apply(p["align"], sk, valid)
        emb_b, prog_b = jnp.roll(emb, 1, axis=0), jnp.roll(prog, 1, axis=0)
        div = jlosses.softdtw_divergence_batched(emb, emb_b, J_ALIGN.gamma,
                                                 use_pallas=False).mean()
        tcc = jlosses.alignment_contrastive_batch(emb, emb_b, prog, prog_b).mean()
        return l_phase + l_err + div + tcc

    return {"gcn": gcn_loss, "skeleton": skeleton_loss}


def _convert_grads(grads) -> dict:
    g = to_numpy(grads)
    out = {f"gcn.{k}": v for k, v in weights.gcn_state_dict(g["gcn"]).items()}
    if "error" in g:
        out.update({f"error.{k}": v for k, v in weights.error_state_dict(g["error"]).items()})
        out.update({f"align.{k}": v for k, v in weights.align_state_dict(
            g["align"], J_ALIGN.hidden_channels).items()})
    return {k: _np(v) for k, v in out.items()}


def _loss_inputs(cfgs: dict, state: dict, gcn_batch) -> dict:
    """Models, batches of 8 and the single-process values of the four
    trainers' losses (the pose net random from seed 0)."""
    pose = PoseNet(sub_config(tcfg.PoseConfig, J_PIPE.pose))
    weights.init_random(pose, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.uniform(-1, 13, (8, 17, 2)).astype(np.float32))
    targets, wts = heatmap.make_heatmap_targets(k, (16, 12), 2.0)
    tc = tcfg.TrainConfig(batch_size=8)
    spec = {"cfgs": dict(cfgs, pose=sub_config(tcfg.PoseConfig, J_PIPE.pose)),
            "state": dict(state, pose=_state_np(pose.state_dict())),
            "joint_weights": _np(loops.pose_joint_weights(2.0, "cpu")),
            "batches": {
                "pose": (rng.normal(size=(8, 64, 48, 3)).astype(np.float32), _np(targets),
                         _np(wts)),
                "gcn": gcn_batch,
                "align": tuple(_np(x) for x in loops.build_align_batch(
                    *loops.align_pairs(tc, T, 0), device="cpu")),
                "error": tuple(None if x is None else _np(x) for x in loops.build_error_batch(
                    *loops.error_samples(tc, T, 0), device="cpu"))}}
    models, fns = ranks.loss_models(spec), ranks.loss_fns(spec)
    single = {}
    for name, fn in fns.items():
        with torch.no_grad():
            loss, aux = fn(models[name], ranks.tensors(spec["batches"][name]), 0)
        single[name] = {k: float(v) for k, v in dict(aux, loss=loss).items()}
    return {"spec": spec, "single": single}


@pytest.fixture(scope="module")
def inputs():
    """Everything the ranks get, and the single-process references: the
    port's (loops.train_step, Pipeline.analyze_batch) and the JAX package's."""
    models = (jgcn.create_gcn_model(J_GCN), jerror.create_error_model(J_ERR),
              jalign.create_align_model(J_ALIGN))
    sk0, v0 = jnp.zeros((1, T, 17, 3)), jnp.ones((1, T), bool)
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    jparams = {"gcn": models[0].init(k1, sk0, v0),
               "error": models[1].init(k2, sk0, jnp.zeros((1, T, jcfg.NUM_PHASES)), v0),
               "align": models[2].init(k3, sk0, v0)}
    state = {"gcn": _state_np(weights.gcn_state_dict(to_numpy(jparams["gcn"]))),
             "error": _state_np(weights.error_state_dict(to_numpy(jparams["error"]))),
             "align": _state_np(weights.align_state_dict(to_numpy(jparams["align"]),
                                                         J_ALIGN.hidden_channels))}
    cfgs = {"gcn": sub_config(tcfg.GCNConfig, J_GCN), "error": sub_config(tcfg.ErrorConfig, J_ERR),
            "align": sub_config(tcfg.AlignConfig, J_ALIGN)}

    # GCN batch: valid lengths 16, 14, ..., 2 and the first four clips all
    # label 0, so every shard has its own valid count and loss.
    sk, labels, valid = loops.build_gcn_batch(tdata.make_swing_batch(8, T, seed=0), device="cpu")
    for n in range(8):
        valid[n, T - 2 * n:] = False
    labels[:4] = 0
    gcn_batch = (_np(sk), _np(labels), _np(valid))
    samples = tdata.make_swing_batch(8, T, seed=0, fault_prob=0.5)
    skeleton_batch = tuple(_np(x) for x in torch_dp.build_skeleton_batch(samples, device="cpu"))

    train = {"cfgs": cfgs, "state": state, "gcn_batch": gcn_batch,
             "skeleton_batch": skeleton_batch}
    losses = _loss_inputs(cfgs, state, gcn_batch)
    single = {}
    for name, loss_fn, batch, kinds in (("gcn", loops.gcn_loss, gcn_batch, ("sgd", "adamw")),
                                        ("skeleton", torch_dp.skeleton_loss, skeleton_batch,
                                         ("adamw",))):
        for kind in kinds:
            if name == "gcn":
                model = ActionSegmentationGCN(cfgs["gcn"])
                model.load_state_dict(ranks.tensors(state["gcn"]))
                model.train()
            else:
                model = ranks.skeleton_models(cfgs, state)
            opt, sched = ranks.optimizer_of(kind, model.parameters())
            aux = loops.train_step(model, opt, sched, loss_fn, ranks.tensors(batch), 0)
            res = ranks.step_result(model, aux)
            res["grads"] = {(f"gcn.{k}" if name == "gcn" else k): _np(v)
                            for k, v in res["grads"].items()}
            single[f"{name}_{kind}" if name == "gcn" else name] = res
    fns = _jax_loss_fns(models)
    jax_ref = {}
    for name, batch in (("gcn", gcn_batch), ("skeleton", skeleton_batch)):
        p = {"gcn": jparams["gcn"]} if name == "gcn" else jparams
        loss, grads = jax.jit(jax.value_and_grad(fns[name]))(
            p, tuple(jnp.asarray(b) for b in batch))
        jax_ref[name] = {"loss": float(loss), "grads": _convert_grads(grads)}

    # analyze_batch: six clips of 5-7 frames at 96x128, the JAX dry run's;
    # a reference unlike every clip (clip 0's keypoints moved by a seeded
    # offset: see ROADMAP reference behaviour (i)).
    jpipe = jorch.Pipeline(J_PIPE, seed=0)
    params = {k: _state_np(v) for k, v in port_params(jpipe.params).items()}
    tpipe = torch_orch.Pipeline(port_config(J_PIPE), ranks.tensors(params), device="cpu")
    rng = np.random.default_rng(0)
    clips = [rng.integers(0, 255, (5 + i % 3, 96, 128, 3)).astype(np.uint8) for i in range(6)]
    boxes = [tvideo.estimate_person_boxes(c, use_native=False) for c in clips]
    ref_k = _np(tpipe.analyze(clips[0], boxes=boxes[0]).keypoints).copy()
    ref_k[..., :2] += np.random.default_rng(7).normal(0, 2.0, ref_k[..., :2].shape).astype(
        np.float32)
    ref_v = np.ones(ref_k.shape[0], bool)
    jres = jpipe.analyze_batch(clips, boxes=boxes, reference=jtypes.Skeleton(
        keypoints=jnp.asarray(ref_k), valid=jnp.asarray(ref_v)))
    tres = tpipe.analyze_batch(clips, boxes=boxes, reference=ttypes.Skeleton(
        keypoints=torch.from_numpy(ref_k), valid=torch.from_numpy(ref_v)))
    analyze = {"cfg": port_config(J_PIPE), "params": params, "clips": clips, "boxes": boxes,
               "ref_kpts": ref_k, "ref_valid": ref_v}

    sdtw_cases = [(np.random.default_rng(seed).uniform(0, high, shape).astype(np.float32), g, cc)
                  for shape, g, seed, high, cc in SDTW_CASES]
    grad_D = np.random.default_rng(13).uniform(0, 2, (32, 24)).astype(np.float32)
    return {"train": train, "losses": losses, "analyze": analyze, "single": single, "jax": jax_ref,
            "jax_analyze": jres, "port_analyze": tres,
            "softdtw": {"cases": sdtw_cases, "grad_case": (grad_D, 0.5)},
            "exchange": {"z": np.random.default_rng(1).normal(size=5)}}


def _spawn(tmp_path_factory, world: int, tasks: dict) -> list:
    return torch_dp.run_ranks(ranks.rank_checks, world,
                              str(tmp_path_factory.mktemp(f"world{world}")), (tasks,),
                              timeout=TIMEOUT)


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    a = dict(inputs["analyze"], clips=inputs["analyze"]["clips"][:6])
    return _spawn(tmp_path_factory, 2, {"train": inputs["train"],
                                        "losses": inputs["losses"]["spec"],
                                        "forward": inputs["train"],
                                        "analyze": a, "softdtw": inputs["softdtw"]})


@pytest.fixture(scope="module")
def world3(inputs, tmp_path_factory):
    return _spawn(tmp_path_factory, 3, {"softdtw": inputs["softdtw"],
                                        "exchange": inputs["exchange"]})


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    a = dict(inputs["analyze"], clips=inputs["analyze"]["clips"][:5],
             boxes=inputs["analyze"]["boxes"][:5])
    return _spawn(tmp_path_factory, 4, {"mesh": [sub_config(tcfg.MeshConfig, c)
                                                 for c in MESH_CFGS],
                                        "train": inputs["train"],
                                        "losses": inputs["losses"]["spec"], "analyze": a,
                                        "softdtw": inputs["softdtw"]})


@pytest.fixture(params=[2, 3, 4])
def sdtw_world(request, world2, world3, world4):
    return {2: world2, 3: world3, 4: world4}[request.param]


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(len(MESH_CFGS)))
def test_make_mesh_matches_jax_over_four_devices(world4, n):
    cfg = MESH_CFGS[n]
    got = [r["mesh"][n] for r in world4]
    try:
        want = jmesh.make_mesh(cfg, devices=jax.devices()[:4])
    except ValueError as e:
        assert got == [str(e)] * 4
        return
    shape = dict(want.shape)
    mp = shape["model"]
    for rank, g in enumerate(got):
        assert g["shape"] == shape and g["axes"] == ("data", "model")
        assert g["data_index"] == rank // mp
        # The data group holds this rank's model index across data indices.
        assert g["data_sum"] == sum(d * mp + rank % mp for d in range(shape["data"]))


def test_make_mesh_runs_on_the_card_unless_asked_for_the_cpu(world4):
    """A gloo group's mesh takes the current card too when no device is
    named; without a card that raises, and the CPU is taken only with
    device="cpu" (as the other ranks' tasks pass it)."""
    got = [r["default_device"] for r in world4]
    if torch.cuda.is_available():
        assert all(g.startswith("cuda:") for g in got)
    else:
        assert all(g.startswith("RuntimeError: a CUDA device was requested") for g in got)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _assert_step(got: dict, want: dict, prefix: str = ""):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    assert {prefix + k for k in got["grads"]} == set(want["grads"])
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g, want["grads"][prefix + k], atol=1e-5, err_msg=k)
    for k, p in got["params"].items():
        np.testing.assert_allclose(p, want["params"][k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_dp_gcn_step_matches_the_single_process_step(world2, world4, inputs, world, kind):
    """Shards of unequal valid counts and labels: the step is the global
    batch's, not the mean of the shards' means."""
    want = inputs["single"][f"gcn_{kind}"]
    for r in {2: world2, 4: world4}[world]:
        _assert_step(r["train"][f"gcn_{kind}"], want, prefix="gcn.")


@pytest.mark.parametrize("world", [2, 4])
def test_dp_skeleton_step_matches_the_single_process_step(world2, world4, inputs, world):
    """The three-model loss, each clip paired with its neighbour across the
    shards (comm.roll)."""
    for r in {2: world2, 4: world4}[world]:
        _assert_step(r["train"]["skeleton"], inputs["single"]["skeleton"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["pose", "gcn", "align", "error"])
def test_loss_shares_add_up_to_the_global_loss(world2, world4, inputs, world, name):
    """loops.*_loss with mesh= on each shard: the loss and every aux value,
    summed over the shards, are the single process's on the global batch."""
    want = inputs["losses"]["single"][name]
    for r in {2: world2, 4: world4}[world]:
        got = r["losses"][name]
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_unequal_shards_would_differ_from_a_mean_of_means(inputs):
    """What the GCN check tells apart: the gradient of the mean of the two
    shards' own mean losses is far (over 100x the check's 1e-5) from the
    global batch's."""
    model = ActionSegmentationGCN(inputs["train"]["cfgs"]["gcn"])
    model.load_state_dict(ranks.tensors(inputs["train"]["state"]["gcn"]))
    model.train()
    sk, labels, valid = ranks.tensors(inputs["train"]["gcn_batch"])

    def grad(idx):
        model.zero_grad()
        loops.gcn_loss(model, (sk[idx], labels[idx], valid[idx]))[0].backward()
        return torch.cat([p.grad.reshape(-1) for p in model.parameters()])

    mean_of_means = 0.5 * (grad(slice(0, 4)) + grad(slice(4, 8)))
    assert float((mean_of_means - grad(slice(0, 8))).abs().max()) > 1e-3


@pytest.mark.parametrize("name", ["gcn", "skeleton"])
def test_single_process_step_matches_jax(inputs, name):
    got = inputs["single"][name if name == "skeleton" else "gcn_sgd"]
    want = inputs["jax"][name]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], g, atol=1e-5, err_msg=k)


def test_dp_forward_gathers_the_unsharded_output(world2, inputs):
    model = ActionSegmentationGCN(inputs["train"]["cfgs"]["gcn"])
    model.load_state_dict(ranks.tensors(inputs["train"]["state"]["gcn"]))
    model.eval()
    model.prepare()
    sk, _, valid = ranks.tensors(inputs["train"]["gcn_batch"])
    with torch.no_grad():
        want = model(sk, valid).numpy()
    for r in world2:
        np.testing.assert_allclose(r["forward"], want, atol=1e-5)


# ---------------------------------------------------------------------------
# Sharded analyze_batch
# ---------------------------------------------------------------------------

def _assert_results(got: list, want: list, what: str, kpt_atol=1e-4, cost_rtol=1e-4):
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["keypoints"], _np(w.keypoints), atol=kpt_atol,
                                   err_msg=f"{what} clip {n}")
        np.testing.assert_array_equal(g["phase_labels"], _np(w.phase_labels))
        np.testing.assert_allclose(g["error_probs"], _np(w.error_probs), atol=1e-4)
        np.testing.assert_allclose(g["cost"], _np(w.alignment.cost), rtol=cost_rtol)
        L = int(w.alignment.path_length)
        assert int(g["path_length"]) == L
        np.testing.assert_array_equal(g["path"][:L], _np(w.alignment.path)[:L])


# Against the JAX package, keypoints and cost are held to what its own two
# float32 programs of this config leave between them: jitted and op by op
# they differ by up to 0.0134 px and 1.7e-3 in cost on these clips, as far
# as the port lies from the jitted run (`python tools/f32_spread.py` prints
# both).  The tiny pose net's GroupNorms of one or two channels a group
# amplify float32 rounding.  Labels, probabilities and paths keep
# MULTICHIP_r05.json's limits.
JAX_KPT_ATOL, JAX_COST_RTOL = 2e-2, 3e-3


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("against", ["port", "jax"])
def test_sharded_analyze_batch_matches_one_device(world2, world4, inputs, world, against):
    """Six clips over two ranks, five over four (rank 0 takes clips 0 and
    4): every rank returns every clip, in input order."""
    out = {2: world2, 4: world4}[world]
    n = 6 if world == 2 else 5
    want = inputs[f"{against}_analyze"][:n]
    limits = {} if against == "port" else {"kpt_atol": JAX_KPT_ATOL, "cost_rtol": JAX_COST_RTOL}
    for rank, r in enumerate(out):
        results, stats, _ = r["analyze"]
        _assert_results(results, want, f"rank {rank} of {world}", **limits)
        assert stats["clips"] == n and stats["failures"] == 0


@pytest.mark.parametrize("world", [2, 4])
def test_a_failed_clip_comes_back_on_every_rank(world2, world4, world):
    for r in {2: world2, 4: world4}[world]:
        kinds, failures = r["analyze"][2]
        assert kinds[0] == kinds[2] == "AnalysisResult" and kinds[1] != "AnalysisResult"
        assert failures == 1


# ---------------------------------------------------------------------------
# Sharded soft-DTW and the exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(SDTW_CASES)))
def test_sharded_softdtw_matches_the_oracle(sdtw_world, inputs, case):
    D, gamma, _ = inputs["softdtw"]["cases"][case]
    want, _ = softdtw.softdtw_reference(D.astype(np.float64), gamma)
    for r in sdtw_world:
        np.testing.assert_allclose(r["softdtw"]["costs"][case], want, rtol=2e-5)


@pytest.mark.parametrize("case", range(len(SDTW_CASES)))
def test_sharded_softdtw_matches_jax_on_eight_devices(world2, world3, world4, inputs, case):
    D, gamma, cc = inputs["softdtw"]["cases"][case]
    want = float(jax_sharded(jnp.asarray(D), gamma, jmesh.make_mesh(jcfg.MeshConfig()),
                             col_chunks=cc))
    for out in (world2, world3, world4):
        for r in out:
            np.testing.assert_allclose(r["softdtw"]["costs"][case], want, rtol=2e-5)


def test_sharded_softdtw_gradient_sums_to_the_e_matrix(sdtw_world, inputs):
    """Each rank's gradient holds its own band's rows, zeros elsewhere."""
    D, gamma = inputs["softdtw"]["grad_case"]
    _, R = jsdtw.softdtw_reference(D.astype(np.float64), gamma)
    want = jsdtw.softdtw_grad_reference(D.astype(np.float64), R, gamma)
    grads = [r["softdtw"]["grad"] for r in sdtw_world]
    np.testing.assert_allclose(sum(grads), want, atol=2e-5)
    Ra = -(-D.shape[0] // len(grads))
    for p, g in enumerate(grads):
        outside = np.ones(D.shape[0], bool)
        outside[p * Ra:(p + 1) * Ra] = False
        assert not g[outside].any()


def test_exchange_moves_values_down_and_up(world3):
    for d, r in enumerate(world3):
        e = r["exchange"]
        np.testing.assert_array_equal(e["down"], np.full(3, float(d) if d else 0.0))
        np.testing.assert_array_equal(e["cyclic"], np.full(3, float((d - 1) % 3 + 1)))
        np.testing.assert_array_equal(e["up"], np.full(3, float(d + 2) if d < 2 else 0.0))


@pytest.mark.parametrize("mode", ["ends", "cyclic"])
def test_exchange_gradcheck_float64(world3, mode):
    assert all(r["exchange"][f"gradcheck_{mode}"] for r in world3)


def test_init_from_env_joins_torchruns_group_on_the_cpu_when_asked():
    """RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT as torchrun
    sets them, in a process of its own: device="cpu" takes gloo."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    code = ("from golfaction_tpu_torch.parallel import mesh\n"
            "m = mesh.init_from_env(device='cpu')\n"
            "print(m.shape, m.backend, m.device, m.data_index)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "{'data': 1, 'model': 1} gloo cpu 0"


def test_init_from_env_asks_for_the_card_by_default(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.init_from_env()
    assert not torch.distributed.is_initialized()


def test_a_failed_rank_fails_the_run(tmp_path):
    """Rank 1 raises while rank 0 waits for it in a collective: the run
    fails at once with rank 1's traceback, and rank 0 is killed."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        torch_dp.run_ranks(ranks.failing_rank, 2, str(tmp_path), timeout=TIMEOUT)

