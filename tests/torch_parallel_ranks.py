"""What each gloo rank of tests/test_torch_parallel.py and
tests/test_torch_port_repairs.py runs (tests/torch_dp.py:run_ranks).  This
module imports torch, numpy and the port only: a spawned rank imports it,
and no rank imports JAX.

`rank_checks(rank, world, tasks)` runs the named tasks in a fixed order,
every rank the same ones, and returns {task: result} with tensors as numpy.
The inputs are numpy arrays, configs and state dicts of numpy arrays that
the test process prepared."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import types
from golfaction_tpu_torch.models.align import AlignEncoder
from golfaction_tpu_torch.models.error import ErrorClassifier
from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.ops.softdtw_sharded import softdtw_cost_sharded
from golfaction_tpu_torch.parallel import comm, mesh as mesh_mod, train_step as ts
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from golfaction_tpu_torch.train import loops
from tests import torch_dp


def tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, (tuple, list)):
        return type(tree)(tensors(x) for x in tree)
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return tree


def skeleton_models(cfgs: dict, state: dict) -> torch.nn.ModuleDict:
    models = torch.nn.ModuleDict({"gcn": ActionSegmentationGCN(cfgs["gcn"]),
                                  "error": ErrorClassifier(cfgs["error"]),
                                  "align": AlignEncoder(cfgs["align"])})
    for name, sd in state.items():
        models[name].load_state_dict(tensors(sd))
    return models.train()


def optimizer_of(kind: str, params):
    """(optimizer, scheduler): SGD at 1e-2, or loops.make_optimizer's AdamW
    without warmup (a first step at the full learning rate)."""
    if kind == "sgd":
        opt = torch.optim.SGD(params, lr=1e-2)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda n: 1.0)
    return loops.make_optimizer(params, tcfg.TrainConfig(learning_rate=1e-3, warmup_steps=0,
                                                         total_steps=10))


def step_result(model, aux) -> dict:
    return {"loss": float(aux["loss"]), "grad_norm": float(aux["grad_norm"]),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()}}


def train_task(mesh, spec: dict) -> dict:
    """One data-parallel step of loops.gcn_loss with each optimizer and one
    of the skeleton loss (AdamW), on this rank's shard of the global batch."""
    out = {}
    for kind in ("sgd", "adamw"):
        model = ActionSegmentationGCN(spec["cfgs"]["gcn"])
        model.load_state_dict(tensors(spec["state"]["gcn"]))
        model.train()
        opt, sched = optimizer_of(kind, model.parameters())
        step = ts.make_dp_train_step(loops.gcn_loss, opt, mesh, sched)
        batch = mesh_mod.shard_batch(tensors(spec["gcn_batch"]), mesh)
        out[f"gcn_{kind}"] = step_result(model, step(model, batch, 0))
    models = skeleton_models(spec["cfgs"], spec["state"])
    opt, sched = optimizer_of("adamw", models.parameters())
    step = ts.make_dp_train_step(torch_dp.skeleton_loss, opt, mesh, sched)
    batch = mesh_mod.shard_batch(tensors(spec["skeleton_batch"]), mesh)
    out["skeleton"] = step_result(models, step(models, batch, 0))
    return out


def loss_models(spec: dict) -> dict:
    """The models of losses_task, in training mode."""
    cfgs, state = spec["cfgs"], spec["state"]
    models = {"pose": PoseNet(cfgs["pose"]), "gcn": ActionSegmentationGCN(cfgs["gcn"]),
              "align": AlignEncoder(cfgs["align"]), "error": ErrorClassifier(cfgs["error"])}
    for name, m in models.items():
        m.load_state_dict(tensors(state[name]))
        m.train()
    return models


def loss_fns(spec: dict) -> dict:
    jw = torch.from_numpy(spec["joint_weights"])
    return {"pose": functools.partial(loops.pose_loss, joint_weights=jw), "gcn": loops.gcn_loss,
            "align": loops.align_loss, "error": loops.error_loss}


def losses_task(mesh, spec: dict) -> dict:
    """Each loops.*_loss with mesh= on this rank's shard, its loss and aux
    values summed over the shards: the global batch's."""
    models, fns = loss_models(spec), loss_fns(spec)
    out = {}
    for name, fn in fns.items():
        with torch.no_grad():
            loss, aux = fn(models[name], mesh_mod.shard_batch(tensors(spec["batches"][name]), mesh),
                           0, mesh=mesh)
        out[name] = {k: float(mesh_mod.all_sum(v, mesh)) for k, v in dict(aux, loss=loss).items()}
    return out


def forward_task(mesh, spec: dict) -> np.ndarray:
    """make_dp_forward of the GCN, gathered."""
    model = ActionSegmentationGCN(spec["cfgs"]["gcn"])
    model.load_state_dict(tensors(spec["state"]["gcn"]))
    model.eval()
    model.prepare()
    sk, _, valid = tensors(spec["gcn_batch"])
    fwd = ts.make_dp_forward(lambda m, s, v: m(s, v), mesh, n_batch_args=2)
    with torch.no_grad():
        return mesh_mod.gather(fwd(model, sk, valid), mesh)


def analyze_task(mesh, spec: dict) -> tuple:
    """The sharded analyze_batch with a reference: (this rank's full list,
    last_batch_stats, (result types, failures) of a call with an unreadable
    clip)."""
    pipe = Pipeline(spec["cfg"], tensors(spec["params"]), mesh=mesh)
    ref = types.Skeleton(keypoints=torch.from_numpy(spec["ref_kpts"]),
                         valid=torch.from_numpy(spec["ref_valid"]))
    res = pipe.analyze_batch(spec["clips"], boxes=spec["boxes"], reference=ref)
    stats = pipe.last_batch_stats
    # A clip that cannot be read: its Exception comes back at its index on
    # every rank, whichever rank read it.
    bad = pipe.analyze_batch([spec["clips"][0], "no/such/clip.mp4", spec["clips"][2]],
                             boxes=[spec["boxes"][0], None, spec["boxes"][2]])
    return [{"keypoints": r.keypoints, "phase_labels": r.phase_labels,
             "error_probs": r.error_probs, "cost": r.alignment.cost, "path": r.alignment.path,
             "path_length": r.alignment.path_length} for r in res], stats, (
        [type(r).__name__ for r in bad], pipe.last_batch_stats["failures"])


def softdtw_task(mesh, spec: dict) -> dict:
    """Each case's sharded cost, and the gradient case's band gradient."""
    costs = [float(softdtw_cost_sharded(torch.from_numpy(D), gamma, mesh, col_chunks=cc))
             for D, gamma, cc in spec["cases"]]
    D, gamma = spec["grad_case"]
    Dg = torch.from_numpy(D).requires_grad_()
    softdtw_cost_sharded(Dg, gamma, mesh).backward()
    return {"costs": costs, "grad": Dg.grad}


class _Copy(torch.autograd.Function):
    """A replicated leaf's copy on this rank: identity forward, gradient
    summed over the ranks (the data-parallel step's all-reduce)."""

    @staticmethod
    def forward(ctx, z, mesh):
        ctx.mesh = mesh
        return z.clone()

    @staticmethod
    def backward(ctx, g):
        return mesh_mod.all_sum(g, ctx.mesh), None


class _Total(torch.autograd.Function):
    """The ranks' values summed, one value held on every rank: its copies
    count once, so the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh_mod.all_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def exchange_task(mesh, spec: dict) -> dict:
    """shift_down's values, and gradcheck (float64) of a function of one
    leaf replicated on every rank: each rank maps it with its own weights,
    shifts it down the mesh and the ranks' results are summed.  Every rank
    runs the same gradcheck in step, so the perturbed inputs move together
    and the checked function is the global one."""
    d = mesh.data_index
    x = torch.full((3,), float(d + 1))
    out = {"down": comm.shift_down(x, mesh), "cyclic": comm.shift_down(x, mesh, cyclic=True),
           "up": comm.exchange(x, mesh, -1)}
    z = torch.from_numpy(spec["z"]).requires_grad_()
    w = torch.linspace(0.5, 1.5, z.numel(), dtype=torch.float64) * (d + 1)
    for cyclic in (False, True):
        def fn(z, cyclic=cyclic):
            y = comm.shift_down(torch.sin(w * _Copy.apply(z, mesh)), mesh, cyclic)
            return _Total.apply(y * (d + 2), mesh)

        out[f"gradcheck_{'cyclic' if cyclic else 'ends'}"] = torch.autograd.gradcheck(
            fn, (z,), eps=1e-6, atol=1e-8, raise_exception=False)
    return out


def mesh_task(mesh_cfgs: list) -> list:
    """make_mesh of each config: (shape, data index, data group sum of the
    ranks, axis names) or the ValueError's message."""
    out = []
    for cfg in mesh_cfgs:
        try:
            m = mesh_mod.make_mesh(cfg, device="cpu")
        except ValueError as e:
            out.append(str(e))
            continue
        total = float(mesh_mod.all_sum(torch.tensor(float(dist.get_rank())), m))
        out.append({"shape": m.shape, "data_index": m.data_index, "data_sum": total,
                    "axes": (m.data_axis, m.model_axis)})
    return out


TASKS = {"train": train_task, "losses": losses_task, "forward": forward_task, "analyze": analyze_task,
         "softdtw": softdtw_task, "exchange": exchange_task}


def rank_checks(rank: int, world: int, tasks: dict) -> dict:
    out = {}
    if "mesh" in tasks:
        out["mesh"] = mesh_task(tasks["mesh"])
        try:                              # no device named: the card, or a RuntimeError
            out["default_device"] = str(mesh_mod.make_mesh().device)
        except RuntimeError as e:
            out["default_device"] = f"RuntimeError: {e}"
    mesh = mesh_mod.make_mesh(tcfg.MeshConfig(), device="cpu")
    for name, fn in TASKS.items():
        if name in tasks:
            out[name] = fn(mesh, tasks[name])
    return out


def overrides_task(rank: int, world: int, overrides: list) -> list:
    """Each override applied to the default config, then make_mesh of its
    mesh (mesh_task)."""
    return mesh_task([tcfg.apply_overrides(tcfg.get_config(), [o]).mesh for o in overrides])


def failing_rank(rank: int, world: int) -> None:
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()

