"""The seeded traffic generator: the same work for every seed, in another order."""

from __future__ import annotations

import collections
import itertools

import numpy as np
import torch

from benchmark import traffic as gen
from benchmark.tests.conftest import load

BIG = 2 ** 31 + 12345


def test_every_seed_gets_the_same_lengths_in_another_order():
    t = load("traffic", "resident_chunks")
    a, b = gen.plan(t, 7), gen.plan(t, BIG)
    la = sorted(c.length for _, clips in a.chunks for c in clips)
    lb = sorted(c.length for _, clips in b.chunks for c in clips)
    assert la == lb
    assert [c.length for _, clips in a.chunks for c in clips] != \
        [c.length for _, clips in b.chunks for c in clips]
    assert min(la) == 40 and max(la) == 127
    for bucket, clips in a.chunks:
        assert len(clips) == t["clips_per_chunk"]
        assert all(c.bucket == bucket == gen.bucket_of(c.length, t["buckets"]) for c in clips)
        assert all(t["shift_px"][0] <= c.shift <= t["shift_px"][1] for c in clips)
    assert sum(c.reverse for _, clips in a.chunks for c in clips) == len(la) // 2


def test_the_same_seed_gives_the_same_plan_and_order():
    t = load("traffic", "single_swing")
    a, b = gen.plan(t, BIG), gen.plan(t, BIG)
    assert a == b
    oa = list(itertools.islice(gen.request_order(a.items, BIG), 300))
    ob = list(itertools.islice(gen.request_order(b.items, BIG), 300))
    assert oa == ob


def test_each_block_holds_every_item_once_with_the_stated_mix():
    t = load("traffic", "resident_chunks")
    p = gen.plan(t, 3)
    assert len(p.items) == 3 * 1 + 4 * 2
    order = gen.request_order(p.items, 3)
    for _ in range(4):
        block = [next(order) for _ in range(len(p.items))]
        assert collections.Counter(block) == collections.Counter(p.items)
    small = sum(1 for ci, _ in p.items if p.chunks[ci][0] == 64)
    assert small / len(p.items) == 3 / 11
    single = gen.plan(load("traffic", "single_swing"), 3)
    assert len(single.items) == 24 + 32 * 2 and all(k is not None for _, k in single.items)


def test_build_chunk_resamples_shifts_and_pads():
    T, H, W = 10, 4, 12
    base = torch.arange(T, dtype=torch.uint8)[:, None, None, None].expand(T, H, W, 3).clone()
    base[:, :, :, 1] = torch.arange(W, dtype=torch.uint8)       # column index in channel 1
    boxes = torch.tensor([[6.0, 2.0, 4.0, 3.0]]).repeat(T, 1)
    clips = [gen.Clip(5, 8, False, 3), gen.Clip(4, 8, True, -2)]
    frames, b, valid = gen.build_chunk(base, boxes, clips)
    assert frames.shape == (2, 8, H, W, 3) and valid.tolist() == [[1] * 5 + [0] * 3,
                                                                  [1] * 4 + [0] * 4]
    idx0 = gen.resample_index(T, 5, False)
    assert frames[0, :5, 0, 5, 0].tolist() == idx0.tolist()
    assert frames[0, 5:, 0, 5, 0].tolist() == [idx0[-1]] * 3          # padded: last frame
    assert frames[0, 0, 0, :3, 1].tolist() == [0, 0, 0]                # shifted right by 3
    assert frames[0, 0, 0, 3:6, 1].tolist() == [0, 1, 2]
    assert frames[1, 0, 0, :3, 1].tolist() == [2, 3, 4]                # shifted left by 2
    assert frames[1, :4, 0, 5, 0].tolist() == gen.resample_index(T, 4, True).tolist()
    assert b[0, :, 0].tolist() == [9.0] * 8 and b[1, :, 0].tolist() == [4.0] * 8


def test_seed_rng_takes_any_size_of_seed():
    for s in (0, 1, 2 ** 31 + 1, 2 ** 40, -5):
        assert gen.seed_rng(s, 1).integers(0, 10, 3).shape == (3,)
    assert not np.array_equal(gen.seed_rng(1, 1).random(4), gen.seed_rng(1, 2).random(4))
