"""Tiny cells for the benchmark's CPU tests: the full_pipeline and shipped
configuration files with narrow widths (the shipped one keeps its npz
weights), and a traffic of small frames and short clips."""

from __future__ import annotations

import copy
import json
import os

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_OVERRIDES = ["pose.stage_blocks=(1,1)", "pose.stage_channels=(16,32)",
                  "pose.deconv_channels=(16,)", "pose.input_hw=(64,48)",
                  "pose.heatmap_hw=(16,12)", "gcn.block_channels=(16,32)",
                  "error.hidden_dim=32", "align.hidden_channels=(16,32)", "align.embed_dim=16",
                  "frame_batch=16"]


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def tiny_pipeline(conf: dict) -> dict:
    conf = copy.deepcopy(conf)
    conf["overrides"] = list(TINY_OVERRIDES)
    p = conf["pipeline"]
    p["pose"].update(stage_blocks=[1, 1], stage_channels=[16, 32], deconv_channels=[16],
                     input_hw=[64, 48], heatmap_hw=[16, 12])
    p["gcn"]["block_channels"] = [16, 32]
    p["error"]["hidden_dim"] = 32
    p["align"].update(hidden_channels=[16, 32], embed_dim=16)
    p["frame_batch"] = 16
    return conf


def tiny_traffic(name: str = "resident_chunks") -> dict:
    t = load("traffic", name)
    t.update(render_frames=16, image_hw=[96, 128], lengths=[5, 15], buckets=[8, 16],
             chunks={"8": 1, "16": 1}, clips_per_chunk=2, shift_px=[-8, 8],
             block={"8": 1, "16": 1}, check_requests=3, trace_requests=2)
    if t["request_clips"] != 1:
        t["request_clips"] = 2
    return t


@pytest.fixture
def tiny_conf():
    return tiny_pipeline(load("configs", "full_pipeline"))


@pytest.fixture
def traffic():
    return tiny_traffic()


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
