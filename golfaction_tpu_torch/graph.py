"""Skeleton graph definition for the GCN action-segmentation trunk.

A COCO-17 joint graph with ST-GCN-style spatial partitioning (identity /
inward / outward relative to the body center) and degree-normalized
adjacency.  Numpy only; the arrays are built once and cached.
"""

from __future__ import annotations

import functools

import numpy as np

# COCO-17 keypoint names, in canonical order.
COCO_KEYPOINTS = (
    "nose",
    "left_eye",
    "right_eye",
    "left_ear",
    "right_ear",
    "left_shoulder",
    "right_shoulder",
    "left_elbow",
    "right_elbow",
    "left_wrist",
    "right_wrist",
    "left_hip",
    "right_hip",
    "left_knee",
    "right_knee",
    "left_ankle",
    "right_ankle",
)

NUM_JOINTS = len(COCO_KEYPOINTS)  # V = 17

# Undirected skeleton edges over COCO-17 (limbs + torso + head).
COCO_EDGES = (
    (15, 13), (13, 11), (16, 14), (14, 12),  # legs
    (11, 12),                                  # pelvis
    (5, 11), (6, 12),                          # torso sides
    (5, 6),                                    # shoulders
    (5, 7), (7, 9), (6, 8), (8, 10),           # arms
    (0, 1), (0, 2), (1, 3), (2, 4),            # head
    (3, 5), (4, 6),                            # ears->shoulders
)

# Joints defining the body "center" for the spatial partition strategy: the
# hips, the rotational pivot of a golf swing.
CENTER_JOINTS = (11, 12)

# Left/right joint index pairs, used for horizontal-flip augmentation.
FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16))


def _hop_distance(num_joints: int, edges) -> np.ndarray:
    """All-pairs hop distance over the undirected skeleton (BFS via matrix powers)."""
    adj = np.zeros((num_joints, num_joints), dtype=np.int64)
    for i, j in edges:
        adj[i, j] = 1
        adj[j, i] = 1
    dist = np.full((num_joints, num_joints), np.iinfo(np.int64).max, dtype=np.int64)
    np.fill_diagonal(dist, 0)
    reach = np.eye(num_joints, dtype=bool)
    frontier = np.eye(num_joints, dtype=bool)
    d = 0
    while frontier.any():
        d += 1
        nxt = (frontier @ adj.astype(bool)) & ~reach
        dist[nxt] = d
        reach |= nxt
        frontier = nxt
    return dist


@functools.lru_cache(maxsize=None)
def build_adjacency(strategy: str = "spatial") -> np.ndarray:
    """Build the stacked, normalized adjacency `A[P, V, V]`.

    strategy="spatial": ST-GCN spatial configuration with P=3 partitions —
      identity (self-loops), inward (neighbor closer to the body center),
      outward (neighbor farther from the center).  Ties go to inward.
    strategy="uniform": P=1, normalized (A + I).

    Each partition is column-normalized by the degree of the full (A + I)
    graph (ST-GCN's `D^-1 A`), so `sum_p A[p]` is a stochastic matrix.
    """
    V = NUM_JOINTS
    adj = np.zeros((V, V), dtype=np.float64)
    for i, j in COCO_EDGES:
        adj[i, j] = 1.0
        adj[j, i] = 1.0

    full = adj + np.eye(V)
    deg = full.sum(axis=0)
    dinv = 1.0 / deg  # every joint has a self-loop => deg >= 1

    if strategy == "uniform":
        return (full * dinv[None, :]).astype(np.float32)[None]

    if strategy != "spatial":
        raise ValueError(f"unknown graph strategy: {strategy!r}")

    hop = _hop_distance(V, COCO_EDGES)
    center_dist = np.min(hop[:, list(CENTER_JOINTS)], axis=1)  # [V]

    ident = np.eye(V)
    inward = np.zeros((V, V))
    outward = np.zeros((V, V))
    for i, j in COCO_EDGES:
        for a, b in ((i, j), (j, i)):
            # Edge a<-b contributes A[a, b]; partition by b's distance vs a's.
            if center_dist[b] <= center_dist[a]:
                inward[a, b] = 1.0
            else:
                outward[a, b] = 1.0

    parts = np.stack([ident, inward, outward])  # [3, V, V]
    parts = parts * dinv[None, None, :]
    return parts.astype(np.float32)
