"""The port's profiling and logging utilities against the JAX package's
(`golfaction_tpu/utils/`), the trainers' TensorBoard mirror and the
Pipeline's `logger` option.  CPU only."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu.pipeline import orchestrator as jorch
from golfaction_tpu.utils import logging as jlogging
from golfaction_tpu.utils import profiling as jprofiling
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch.pipeline import orchestrator as torch_orch
from golfaction_tpu_torch.train import loops as tloops
from golfaction_tpu_torch.utils import logging as tlogging
from golfaction_tpu_torch.utils import profiling as tprofiling
from tests.golden.common import GOLDEN_CFG, fixture_clips
from tests.torch_parity import port_config, port_params


def test_stage_timer_keys_and_counts_match_jax():
    timers = {"port": tprofiling.StageTimer(), "jax": jprofiling.StageTimer()}
    fences = {"port": torch.ones(3), "jax": jnp.ones(3)}
    for name, timer in timers.items():
        for stage in ("prep", "pose", "prep"):
            with timer.stage(stage, fence=fences[name]):
                pass
        with timer.stage("unfenced"):
            pass
    got, want = timers["port"].breakdown(), timers["jax"].breakdown()
    assert set(got) == set(want) == {"prep", "pose", "unfenced"}
    for k in got:
        assert set(got[k]) == set(want[k]) == {"total_s", "count", "mean_ms"}
        assert got[k]["count"] == want[k]["count"]
        assert got[k]["mean_ms"] == pytest.approx(1e3 * got[k]["total_s"] / got[k]["count"])
    assert got["prep"]["count"] == 2
    assert json.loads(timers["port"].report()) == got


def test_stage_fence_picks_a_cuda_device_only():
    assert tprofiling._cuda_device(torch.ones(2)) is None
    assert tprofiling._cuda_device("cpu") is None
    assert tprofiling._cuda_device(None) is None
    assert tprofiling._cuda_device("cuda:1") == torch.device("cuda:1")
    assert tprofiling._cuda_device(torch.device("cuda")) == torch.device("cuda")


def test_value_fence_and_timed_blocked():
    out = {"keypoints": torch.full((2, 3), 0.5, dtype=torch.bfloat16), "other": None}
    assert tprofiling.value_fence(out) == 3.0
    calls = []
    dt = tprofiling.timed_blocked(lambda x: calls.append(x) or torch.ones(1), 7,
                                  warmup=2, iters=3)
    assert dt >= 0.0 and calls == [7] * 5


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprofiling.device_trace(None):
        torch.ones(4).sum()                    # a no-op without a log dir
    with tprofiling.device_trace(str(tmp_path / "trace")):
        with tprofiling.StageTimer().stage("annotated"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert any(e.get("name") == "annotated" for e in trace["traceEvents"])


def test_jsonl_logger_lines_match_jax(tmp_path):
    fields = {"frames": 40, "hw": [96, 128], "wall_ms": 12.5, "ok": True}
    port = tlogging.JsonlLogger(str(tmp_path / "port" / "events.jsonl"))
    jax_ = jlogging.JsonlLogger(str(tmp_path / "jax" / "events.jsonl"))
    port.log("analyze", **fields, bucket=torch.tensor(64), probs=torch.tensor([0.25, 0.5]),
             scale=np.float32(2.0))
    jax_.log("analyze", **fields, bucket=jnp.asarray(64), probs=jnp.asarray([0.25, 0.5]),
             scale=np.float32(2.0))
    port.log("done")
    jax_.log("done")
    port.close()
    jax_.close()
    got = [json.loads(x) for x in (tmp_path / "port" / "events.jsonl").read_text().splitlines()]
    want = [json.loads(x) for x in (tmp_path / "jax" / "events.jsonl").read_text().splitlines()]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert isinstance(g.pop("ts"), float) and isinstance(w.pop("ts"), float)
        assert g == w
    assert got[0]["probs"] == [0.25, 0.5] and got[0]["bucket"] == 64


def test_to_plain_takes_tensors_of_any_dtype():
    assert tlogging._to_plain({"a": torch.tensor(1.5, dtype=torch.bfloat16),
                               "b": (torch.arange(3),)}) == {"a": 1.5, "b": [[0, 1, 2]]}


def _scalars(logdir) -> dict:
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_write_events_and_none_is_inert(tmp_path):
    inert = tlogging.TensorBoardScalars(None)
    assert not inert.active
    inert.log(0, loss=1.0)
    inert.close()
    tb = tlogging.TensorBoardScalars(str(tmp_path))
    assert tb.active
    tb.log(3, loss=torch.tensor(0.5), grad_norm=2.0, note="skipped", flag=True)
    tb.close()
    got = _scalars(tmp_path)
    assert set(got) == {"loss", "grad_norm"}
    assert got["loss"] == [(3, 0.5)] and got["grad_norm"] == [(3, 2.0)]


def test_trainer_with_tb_logdir_writes_its_history(tmp_path):
    tc = tcfg.TrainConfig(batch_size=4, learning_rate=3e-3, warmup_steps=2, total_steps=3,
                          seed=0, tb_logdir=str(tmp_path / "tb"))
    _, history = tloops.train_error(tcfg.ErrorConfig(hidden_dim=16, dtype="float32"), tc,
                                    frames_per_clip=8, log_every=1, device="cpu")
    got = _scalars(tmp_path / "tb")
    assert set(got) == set(history[0]) - {"step"}
    assert [s for s, _ in got["loss"]] == [h["step"] for h in history]
    np.testing.assert_allclose([v for _, v in got["loss"]], [h["loss"] for h in history],
                               rtol=1e-6)


def test_pipeline_logger_event_matches_jax(tmp_path):
    clip_a, _ = fixture_clips()
    jlog = jlogging.JsonlLogger(str(tmp_path / "jax.jsonl"))
    tlog = tlogging.JsonlLogger(str(tmp_path / "port.jsonl"))
    jpipe = jorch.Pipeline(GOLDEN_CFG, seed=0, logger=jlog)
    tpipe = torch_orch.Pipeline(port_config(GOLDEN_CFG), port_params(jpipe.params),
                                device="cpu", logger=tlog)
    jpipe.analyze(clip_a)
    tpipe.analyze(clip_a)
    tpipe.analyze_batch([clip_a, clip_a[:9]])          # logs nothing, as in JAX
    jlog.close()
    tlog.close()
    (want,) = [json.loads(x) for x in (tmp_path / "jax.jsonl").read_text().splitlines()]
    (got,) = [json.loads(x) for x in (tmp_path / "port.jsonl").read_text().splitlines()]
    assert set(got) == set(want) == {"ts", "event", "frames", "bucket", "hw", "wall_ms"}
    assert {k: got[k] for k in ("event", "frames", "bucket", "hw")} == {
        k: want[k] for k in ("event", "frames", "bucket", "hw")} == {
        "event": "analyze", "frames": len(clip_a), "bucket": 16, "hw": [96, 128]}
    assert got["wall_ms"] > 0


def test_from_artifacts_passes_the_logger_through(tmp_path):
    log = tlogging.JsonlLogger(str(tmp_path / "events.jsonl"))
    pipe = torch_orch.Pipeline.from_artifacts(
        "artifacts", device="cpu", logger=log,
        overrides=["pose.dtype=float32", "video_hw=(96, 128)", "length_buckets=(16,)"])
    assert pipe.logger is log
