"""Training losses for the four models.  All losses are masked
(padding-aware) and return float32 scalars (or one value per pair).

With `mesh=` (a parallel.mesh.Mesh) a normalizing loss returns this data
shard's share of the loss of the global batch: its own numerator over the
global normalizer (valid count, joint-weight sum or batch size, summed over
the shards).  The shards' shares add up to the global loss, and so do their
gradients.  mesh=None computes exactly what it did without one."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from golfaction_tpu_torch.ops import softdtw
from golfaction_tpu_torch.parallel import mesh as mesh_mod


def _global(x: torch.Tensor, mesh) -> torch.Tensor:
    """A normalizer of the global batch: `x` summed over the data shards."""
    return x if mesh is None else mesh_mod.all_sum(x, mesh)


def batch_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The mean of `x` over the global batch; with a mesh, this shard's
    share: its mean times its share of the global element count."""
    if mesh is None:
        return x.mean()
    n = x.new_tensor(float(x.numel()))
    return x.mean() * (n / _global(n, mesh))


def heatmap_mse(pred, target, joint_weights=None, mesh=None):
    """Pose loss: per-joint MSE over heatmaps [B, K, H, W]."""
    err = (pred.float() - target.float()) ** 2
    per_joint = err.mean(dim=(-2, -1))                  # [B, K]
    if joint_weights is not None:
        per_joint = per_joint * joint_weights
        return per_joint.sum() / _global(joint_weights.sum(), mesh).clamp(min=1.0)
    return batch_mean(per_joint, mesh)


def phase_cross_entropy(logits, labels, valid=None, label_smoothing: float = 0.0, mesh=None):
    """Segmentation loss: per-frame CE.  logits [B, T, P], labels [B, T]."""
    P = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), P).float()
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / P
    ce = -(onehot * logp).sum(-1)                       # [B, T]
    if valid is not None:
        v = valid.float()
        return (ce * v).sum() / _global(v.sum(), mesh).clamp(min=1.0)
    return batch_mean(ce, mesh)


def error_bce(logits, flags, fault_weights=None, mesh=None):
    """Multi-label fault loss.  logits [B, E], flags [B, E] in {0, 1};
    `fault_weights` [E] reweights each fault's term, so that a fault with a
    small signature is not drowned in the mean."""
    logits = logits.float()
    per = (logits.clamp(min=0) - logits * flags
           + torch.log1p(torch.exp(-logits.abs())))     # [B, E]
    if fault_weights is None:
        return batch_mean(per, mesh)
    w = torch.as_tensor(fault_weights, dtype=torch.float32, device=per.device)
    rows = per.shape[0] if mesh is None else _global(per.new_tensor(float(per.shape[0])), mesh)
    return (per * w).sum() / (rows * w.sum())


def softdtw_divergence_batched(emb_a, emb_b, gamma: float):
    """Soft-DTW divergence of embedding sequences emb [B, T, D] -> [B]:
    div(a, b) = sdtw(a, b) - (sdtw(a, a) + sdtw(b, b)) / 2, zero when the
    sequences traverse the same trajectory.  The three cost evaluations go
    through ONE batched `softdtw_cost` call, so a step is one launch of the
    forward wavefront and one of its backward."""
    D = torch.cat([softdtw.pairwise_sqdist(emb_a, emb_b),
                   softdtw.pairwise_sqdist(emb_a, emb_a),
                   softdtw.pairwise_sqdist(emb_b, emb_b)], dim=0)
    cost = softdtw.softdtw_cost(D, gamma)
    B = emb_a.shape[0]
    return cost[:B] - 0.5 * (cost[B:2 * B] + cost[2 * B:])


def alignment_contrastive(emb_a, emb_b, progress_a, progress_b, temperature: float = 0.1):
    """Auxiliary alignment loss: frames close in swing progress should have
    close embeddings across videos.  emb [B, T, D] unit-norm, progress [B, T]
    in [0, 1] -> [B]: each a-frame's soft nearest neighbour among the
    b-frames predicts its progress."""
    sim = torch.einsum("btd,bsd->bts", emb_a, emb_b) / temperature
    pred = torch.einsum("bts,bs->bt", torch.softmax(sim, dim=-1), progress_b)
    return ((pred - progress_a) ** 2).mean(dim=-1)
