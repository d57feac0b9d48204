"""Data-parallel training and inference over a mesh.

The counterpart of golfaction_tpu/parallel/train_step.py.  There the loss is
written once over the global batch and XLA inserts the gradient psum; here
each rank holds the parameters (equal on every rank: `mesh.replicate`) and
its own shard of the batch, and two things are explicit:

  * the loss of the global batch: a rank's loss is its numerator over the
    global normalizer (train/losses.py with `mesh=`), so the ranks' losses
    add up to the global loss;
  * one all-reduce (SUM over the data shards) of the flattened gradients,
    which then are the global loss's gradients on every rank.

A DDP-style average of per-rank means would be the global mean only when
every rank had the same valid count, which clips of different lengths do
not have.  The all-reduce is one collective a step and needs no wrapper
around the model, so a loss may span several models.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from golfaction_tpu_torch.parallel import mesh as mesh_mod
from golfaction_tpu_torch.train import loops


def make_dp_train_step(loss_fn: Callable[..., tuple], optimizer, mesh: mesh_mod.Mesh,
                       scheduler=None) -> Callable:
    """-> step(model, local_batch, n=0) -> aux, the optimizer step of the
    global batch on every rank.

    loss_fn(model, local_batch, n, mesh=mesh) -> (this rank's share of the
    global loss, aux): loops.*_loss do this.  Every 0-dim tensor in aux is a
    share too; the step returns each summed over the shards, `aux["loss"]`
    the global loss and `aux["grad_norm"]` the norm of the reduced gradient.
    A parameter without a gradient on every rank keeps none, as in
    loops.train_step."""
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(model, batch, n: int = 0) -> dict:
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(model, batch, n, mesh=mesh)
        loss.backward()
        aux["loss"] = loss
        keys = [k for k, v in aux.items() if torch.is_tensor(v) and v.dim() == 0]
        has = [p.grad is not None for p in params]
        flat = torch.cat([(p.grad if h else torch.zeros_like(p)).reshape(-1).float()
                          for p, h in zip(params, has)]
                         + [torch.tensor(has, dtype=torch.float32, device=loss.device),
                            torch.stack([aux[k].detach().float() for k in keys])])
        flat = mesh_mod.wire(flat, mesh)
        dist.all_reduce(flat, group=mesh.data_group)
        flat = flat.to(loss.device)
        sizes = [p.numel() for p in params]
        grads = flat[:sum(sizes)].split(sizes)
        for p, g, h in zip(params, grads, flat[sum(sizes):sum(sizes) + len(params)].tolist()):
            p.grad = g.view_as(p).to(p.dtype) if h else None
        aux.update(zip(keys, flat[-len(keys):]))
        aux["grad_norm"] = loops.global_grad_norm(model)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return aux

    return step


def make_dp_forward(fn: Callable, mesh: mesh_mod.Mesh, n_batch_args: int = 1) -> Callable:
    """-> forward(params, *args): `fn(params, *args)` on this rank's shard of
    the first `n_batch_args` arguments (each the global batch, the same on
    every rank), the rest passed whole.  The output is this rank's shard and
    stays so until `mesh.gather` fetches it."""
    def forward(params, *args):
        local = mesh_mod.shard_batch(tuple(args[:n_batch_args]), mesh)
        return fn(params, *local, *args[n_batch_args:])

    return forward
