"""What the data-parallel tests (tests/test_torch_parallel.py,
tests/test_torch_port_repairs.py) and chip_smoke.py's `parallel` phase
share: spawning gloo ranks on one host, and the skeleton-side step of the
JAX package's multi-device dry run (__graft_entry__.py) as a batch and a
loss.  Imports torch, numpy and the port only: spawned ranks import it.

    results = run_ranks(fn, world=2, store_dir=tmp, args=(...,))

spawns `world` processes (spawn, not fork: the caller may hold a card and
threads), joins each to one gloo group through a `file://` store under
`store_dir`, calls fn(rank, world, *args) and returns the results in rank
order.  The ranks share the host, so each runs torch on one thread; ranks
that share a card pass it themselves (e.g. a mesh with device="cuda:0").
`fn` must be importable (a module-level function) and its result
picklable; tensors in it come back as numpy arrays.

A rank that raises, dies, or has not answered within `timeout` seconds
fails the call: the ones still running are killed and RuntimeError names
each failure.  Every collective times out after `timeout` too, so a rank
whose peer died does not wait forever.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection
import os
import time
import traceback
import uuid

import numpy as np
import torch
import torch.distributed as dist

from golfaction_tpu_torch.parallel import comm
from golfaction_tpu_torch.train import loops, losses


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _rank_main(rank, world, init_method, timeout, fn, args, conn):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        msg = ("ok", _to_host(fn(rank, world, *args)))
    except BaseException:                 # noqa: BLE001 — reported to the parent, which fails
        msg = ("error", traceback.format_exc())
    try:
        conn.send(msg)                    # before the group goes: a failure's cause comes first
    finally:
        conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, store_dir: str, args: tuple = (), timeout: float = 300.0) -> list:
    ctx = mp.get_context("spawn")
    init = "file://" + os.path.join(store_dir, f"store_{uuid.uuid4().hex}")
    procs, conns = [], []
    for rank in range(world):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank_main, args=(rank, world, init, timeout, fn, args, send),
                        daemon=True)
        p.start()
        send.close()
        procs.append(p)
        conns.append(recv)
    results, errors = [None] * world, {}
    waiting = dict(zip(conns, range(world)))
    deadline = time.monotonic() + timeout
    try:
        while waiting:
            # After a failure, a short grace for the other ranks' reports:
            # the first error may be a peer's broken connection, not the cause.
            left = 2.0 if errors else max(0.0, deadline - time.monotonic())
            ready = mp.connection.wait(list(waiting), left)
            if not ready:
                break
            for conn in ready:
                rank = waiting.pop(conn)
                try:
                    status, value = conn.recv()
                except EOFError:
                    procs[rank].join(5)
                    status, value = "error", f"exited with code {procs[rank].exitcode}"
                if status == "ok":
                    results[rank] = value
                else:
                    errors[rank] = value
        for rank in waiting.values():
            errors[rank] = ("killed after another rank failed" if errors
                            else f"no result within {timeout} s")
    finally:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()) if not errors else 1.0)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in conns:
            conn.close()
    if errors:
        raise RuntimeError(f"{len(errors)} of {world} ranks failed:\n" + "\n".join(
            f"--- rank {r}: {e}" for r, e in sorted(errors.items())))
    return results


def build_skeleton_batch(samples, device="cuda"):
    """Swing samples (same T) -> (skeletons_norm, keypoints RAW, labels,
    error flags, progress, valid), the dry run's batch."""
    sk, labels, valid = loops.build_gcn_batch(samples, device)
    dev = sk.device
    kpts = torch.from_numpy(np.stack([s.keypoints for s in samples])).to(dev)
    flags = torch.from_numpy(np.stack([s.error_flags for s in samples])).to(dev)
    prog = torch.from_numpy(np.stack([s.progress for s in samples])).to(dev)
    return sk, kpts, labels, flags, prog, valid


def skeleton_loss(models, batch, step: int = 0, mesh=None):
    """GCN phase cross entropy + error BCE + the alignment encoder's soft-DTW
    divergence and progress contrastive, each clip paired with its neighbour
    in the global batch (torch.roll by one; across shards through
    comm.roll).  `models`: {"gcn", "error", "align"}.  The JAX dry run's
    loss, with the divergence added so that a step runs the soft-DTW forward
    and backward."""
    sk, kpts, labels, flags, prog, valid = batch
    logits = models["gcn"](sk, valid)
    l_phase = losses.phase_cross_entropy(logits, labels, valid, mesh=mesh)
    l_err = losses.error_bce(models["error"](kpts, logits, valid), flags, mesh=mesh)
    emb = models["align"](sk, valid)
    if mesh is None:
        emb_b, prog_b = torch.roll(emb, 1, 0), torch.roll(prog, 1, 0)
    else:
        emb_b, prog_b = comm.roll(emb, mesh), comm.roll(prog, mesh)
    gamma = models["align"].cfg.gamma
    div = losses.batch_mean(losses.softdtw_divergence_batched(emb, emb_b, gamma), mesh)
    tcc = losses.batch_mean(losses.alignment_contrastive(emb, emb_b, prog, prog_b), mesh)
    loss = l_phase + l_err + div + tcc
    return loss, {"phase": l_phase.detach(), "error": l_err.detach(), "sdtw_div": div.detach(),
                  "tcc": tcc.detach()}
