"""COCO-17 skeleton graph and the GCN's ST-GCN spatial adjacency (numpy)."""

from __future__ import annotations

import numpy as np

NUM_JOINTS = 17

COCO_EDGES = (
    (15, 13), (13, 11), (16, 14), (14, 12),
    (11, 12),
    (5, 11), (6, 12),
    (5, 6),
    (5, 7), (7, 9), (6, 8), (8, 10),
    (0, 1), (0, 2), (1, 3), (2, 4),
    (3, 5), (4, 6),
)

# The hips: the body centre of the spatial partition.
CENTER_JOINTS = (11, 12)


def hop_distance(num_joints: int = NUM_JOINTS, edges=COCO_EDGES) -> np.ndarray:
    """All-pairs hop distance over the undirected skeleton, by breadth-first search."""
    nbrs: dict[int, list[int]] = {v: [] for v in range(num_joints)}
    for i, j in edges:
        nbrs[i].append(j)
        nbrs[j].append(i)
    dist = np.full((num_joints, num_joints), np.iinfo(np.int64).max, np.int64)
    for src in range(num_joints):
        dist[src, src] = 0
        frontier = [src]
        while frontier:
            nxt = []
            for a in frontier:
                for b in nbrs[a]:
                    if dist[src, b] > dist[src, a] + 1:
                        dist[src, b] = dist[src, a] + 1
                        nxt.append(b)
            frontier = nxt
    return dist


def spatial_adjacency() -> np.ndarray:
    """A[3, V, V]: identity, inward and outward partitions (ties inward), each
    column-normalized by the degree of A + I."""
    V = NUM_JOINTS
    adj = np.zeros((V, V))
    for i, j in COCO_EDGES:
        adj[i, j] = adj[j, i] = 1.0
    dinv = 1.0 / (adj + np.eye(V)).sum(axis=0)
    center = np.min(hop_distance()[:, list(CENTER_JOINTS)], axis=1)
    inward = np.zeros((V, V))
    outward = np.zeros((V, V))
    for i, j in COCO_EDGES:
        for a, b in ((i, j), (j, i)):
            if center[b] <= center[a]:
                inward[a, b] = 1.0
            else:
                outward[a, b] = 1.0
    return (np.stack([np.eye(V), inward, outward]) * dinv[None, None, :]).astype(np.float32)
