"""The general traffic generator: a traffic file's parameters and a seed ->
a pool of clips resident on the card and the order in which requests draw
from it.

Every seed gets the same set of clip lengths, spread evenly over each
bucket's range, and the same mix of requests; the seed changes which clip
gets which length, the rendered swing, the time reversals, the horizontal
shifts and the order.  So the work of a run does not depend on its seed.

Traffic file keys (JSON):
  render_frames      frames of the one rendered base clip (also the reference swing)
  image_hw           [H, W] of the frames
  lengths            [lo, hi]: clip lengths, inclusive
  buckets            padded lengths, ascending (a clip pads to the least >= its length)
  chunks             {bucket: distinct chunks of that bucket in the pool}
  clips_per_chunk    clips in a chunk (the system's clip_batch)
  request_clips      clips in one request: a whole chunk, or 1 (single clips)
  block              {bucket: times each request of that bucket appears in a block}
  in_flight          requests dispatched and not yet completed, at most
  shift_px           [lo, hi] horizontal shift of a clip, pixels
  trace_requests     requests in the traced window of a --trace 1 run
  check_requests     requests whose outputs the reference checks
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy Generator for `seed` (any size of integer) and a stream tag."""
    return np.random.default_rng([int(seed) % (2 ** 64), *stream])


@dataclasses.dataclass
class Clip:
    length: int        # valid frames
    bucket: int        # padded frames
    reverse: bool
    shift: int


@dataclasses.dataclass
class Plan:
    """What the seed decides: the pool's clips by chunk, and the request items."""
    chunks: list       # [(bucket, [Clip] * clips_per_chunk)]
    items: list        # request items of one block: (chunk, clip or None)


def bucket_of(length: int, buckets) -> int:
    return next(b for b in sorted(buckets) if b >= length)


def lengths_by_bucket(t: dict) -> dict:
    """{bucket: sorted lengths of its pool clips}: evenly spread over the
    bucket's share of [lo, hi], one per pool clip."""
    lo, hi = t["lengths"]
    out, prev = {}, lo - 1
    for b in sorted(int(k) for k in t["chunks"]):
        a, z = max(lo, prev + 1), min(hi, b)
        n = t["chunks"][str(b)] * t["clips_per_chunk"]
        out[b] = [int(v) for v in np.round(np.linspace(a, z, n))]
        prev = b
    return out


def plan(t: dict, seed: int) -> Plan:
    rng = seed_rng(seed, 1)
    chunks = []
    cpc = t["clips_per_chunk"]
    s_lo, s_hi = t["shift_px"]
    for b, lens in lengths_by_bucket(t).items():
        lens = list(rng.permutation(lens))
        for c in range(t["chunks"][str(b)]):
            clips = [Clip(int(L), b, bool((c * cpc + i) % 2), int(rng.integers(s_lo, s_hi + 1)))
                     for i, L in enumerate(lens[c * cpc:(c + 1) * cpc])]
            chunks.append((b, clips))
    items = []
    for ci, (b, clips) in enumerate(chunks):
        reps = t["block"][str(b)]
        if t["request_clips"] == t["clips_per_chunk"]:
            items += [(ci, None)] * reps
        elif t["request_clips"] == 1:
            items += [(ci, k) for k in range(len(clips))] * reps
        else:
            raise ValueError("request_clips is a whole chunk or 1")
    return Plan(chunks, items)


def request_order(items: list, seed: int):
    """Endless request items: each block the items once, in a seeded order."""
    rng = seed_rng(seed, 2)
    while True:
        for i in rng.permutation(len(items)):
            yield items[i]


def resample_index(n_src: int, n: int, reverse: bool) -> np.ndarray:
    """`n` frames spread evenly over a clip of `n_src` (a swing at another tempo)."""
    idx = np.round(np.linspace(0, n_src - 1, n)).astype(np.int64)
    return idx[::-1].copy() if reverse else idx


@torch.no_grad()
def build_chunk(base: torch.Tensor, base_boxes: torch.Tensor, clips: list):
    """The chunk's frames [N, Tb, H, W, 3] uint8, boxes [N, Tb, 4] and valid
    [N, Tb] on the base clip's device: each clip resampled from the base,
    shifted sideways (zeros fill, boxes moved alike) and padded to its
    bucket by repeating its last frame and box."""
    N, Tb = len(clips), clips[0].bucket
    _, H, W, C = base.shape
    dev = base.device
    frames = torch.zeros((N, Tb, H, W, C), dtype=torch.uint8, device=dev)
    boxes = torch.empty((N, Tb, 4), dtype=torch.float32, device=dev)
    valid = torch.zeros((N, Tb), dtype=torch.bool, device=dev)
    for n, c in enumerate(clips):
        idx = resample_index(base.shape[0], c.length, c.reverse)
        idx = np.concatenate([idx, np.full(Tb - c.length, idx[-1])])
        it = torch.from_numpy(idx).to(dev)
        s = c.shift
        dst = frames[n, :, :, max(s, 0):W + min(s, 0)]
        dst.copy_(base.index_select(0, it)[:, :, max(-s, 0):W - max(s, 0)])
        boxes[n] = base_boxes.index_select(0, it)
        boxes[n, :, 0] += float(s)
        valid[n, :c.length] = True
    return frames, boxes, valid
