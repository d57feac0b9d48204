"""The port's bench (`golfaction_tpu_torch/bench.py`) and `cli bench` on the
CPU at a tiny size: narrow random weights, one 8-frame clip at 270x480, two
e2e clips.  The card's numbers come from chip_smoke.py's `bench` phase."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from golfaction_tpu_torch import bench, cli
from golfaction_tpu_torch.config import apply_overrides, get_config
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline

ROOT = Path(__file__).resolve().parent.parent
NARROW = ["pose.input_hw=(64,48)", "pose.heatmap_hw=(16,12)", "pose.stage_blocks=(1,1,1)",
          "pose.stage_channels=(16,32,64)", "pose.deconv_channels=(32,32)"]
ARGS = ["--clip-frames", "8", "--height", "270", "--width", "480", "--clips", "1",
        "--e2e-clips", "2", "--iters", "1", "--repeats", "1", "--no-sol-check",
        "--artifacts", "none", *[a for s in NARROW for a in ("--set", s)]]
# The root bench's headline keys (bench.py:475-494, 506-510, 630-651) that a
# run without the speed-of-light probe carries.
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "device_fps", "device_fps_best",
            "device_fps_repeats", "fence_overhead_ms", "e2e_fps", "e2e_vs_baseline",
            "effective_tflops", "e2e_clips", "e2e_decode_s", "e2e_first_dispatch_s",
            "pose_fps", "gcn_fps", "softdtw_pairs_per_s", "elapsed_s"}


@pytest.fixture(scope="module")
def run():
    # One intra-op thread: the suite's workers already hold the cores, and a
    # second process with a full thread pool beside them slows both many-fold.
    proc = subprocess.run([sys.executable, "-m", "golfaction_tpu_torch.cli", "bench",
                           "--device", "cpu", *ARGS], capture_output=True, text=True,
                          cwd=ROOT, timeout=600, env={**os.environ, "OMP_NUM_THREADS": "1"})
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    return proc, lines


def test_cli_bench_on_the_cpu_exits_0_with_every_key(run):
    proc, lines = run
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = lines[-1]
    assert JAX_KEYS | {"flops_per_call", "mfu_vs_peak", "stages"} <= set(last)
    assert last["metric"] == "end_to_end_fps_1080p" and last["unit"] == "frames/sec/chip"
    assert last["device"] == "cpu" and last["mfu_vs_peak"] is None
    assert "failed_section" not in last and "skipped_sections" not in last
    for k in ("value", "e2e_fps", "pose_fps", "gcn_fps", "softdtw_pairs_per_s",
              "effective_tflops", "pose_single_crop_ms", "align_pair_ms"):
        assert last[k] > 0, k
    assert last["vs_baseline"] == pytest.approx(last["value"] / 300.0)
    assert last["e2e_clips"] == 2 and last["e2e_frames"] == 40 + 69
    assert set(last["gcn_fps_by_bucket"]) == {"64", "128", "256", "512"}
    assert set(last["gcn_tail_ms_by_bucket"].values()) == {None}          # no card here
    assert set(last["stages"]) == {"host_prep", "copy", "pose_pass", "core", "align"}
    assert all(v["count"] == 2 for v in last["stages"].values())          # two buckets
    # Each line enriches the last, from the headline on.
    assert lines[0]["value"] == last["value"] and len(lines) >= 9
    assert "[config 5]" in proc.stderr and "[config 3] GCN at T=512" in proc.stderr


def test_flops_per_call_is_the_plain_program_count(run):
    """The bench counts a float32 CPU copy; counted here over `_core_fn` at
    the pipeline's own dtype (bfloat16) at the headline's shapes."""
    _, lines = run
    cfg = apply_overrides(get_config("full_pipeline"),
                          ["video_hw=(270, 480)", "length_buckets=(8, 64, 128)", *NARROW])
    pipe = Pipeline(cfg, device="cpu", seed=0)
    frames = torch.zeros((1, 8, 270, 480, 3), dtype=torch.uint8)
    boxes = torch.tensor([240.0, 135.0, 80.0, 160.0]).expand(1, 8, 4).contiguous()
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        pipe._core_fn(frames, boxes, torch.ones((1, 8), dtype=torch.bool))
    assert cfg.pose.dtype == "bfloat16"
    assert lines[-1]["flops_per_call"] == counter.get_total_flops() > 0


def test_a_failing_section_exits_nonzero(monkeypatch, capsys):
    def boom(self):
        raise RuntimeError("headline failed on purpose")

    monkeypatch.setattr(bench.Bench, "headline", boom)
    assert bench.main(["--device", "cpu", *ARGS]) == 1
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last["failed_section"] == "config 5" and last["value"] is None
    assert "headline failed on purpose" in err and "[config 5] FAILED" in err


def test_impl_compare_refuses_the_cpu(monkeypatch, capsys):
    for name in ("headline", "flops", "e2e", "stages", "config2", "config3", "config4",
                 "config1"):
        monkeypatch.setattr(bench.Bench, name, lambda self: None)
    assert bench.main(["--device", "cpu", "--impl-compare", "--no-sol-check"]) == 1
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["failed_section"] == "impl-compare"
    assert "needs a card" in err


def test_cli_bench_asks_for_the_card_by_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is there")
    with pytest.raises(SystemExit) as exc:
        cli.main(["bench", "--no-sol-check"])
    assert exc.value.code == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err


def test_e2e_lengths_and_resample():
    assert bench.e2e_lengths(8) == [40, 69, 98, 127, 67, 96, 125, 65]
    clip = torch.arange(10).numpy()
    assert bench.resample(clip, 4).tolist() == [0, 3, 6, 9]
    assert bench.resample(clip, 4, reverse=True).tolist() == [9, 6, 3, 0]
