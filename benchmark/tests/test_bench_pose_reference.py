"""A configuration file names its own pose reference module, and the system's
configuration is checked against the file section by section.

The pose net's reference, its seeded weights and its FLOP count all come
from the module that the file's "pose_reference" names
(benchmark.reference.pose_reference); without the key it is
benchmark.reference.nets.  The configuration check accepts a key the file
leaves out only where the system holds it at its dataclass default."""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
import types

import pytest

from benchmark import check, counts, system
from benchmark import run as bench
from benchmark.reference import nets, pose_reference
from benchmark.reference.pipeline import Reference
from benchmark.tests.conftest import load, tiny_pipeline, tiny_traffic

CONFIGS = ["shipped", "full_pipeline"]
PROBE = "benchmark.reference._probe_pose"
PROBE_FLOPS = 1_000_003


def _plain(c) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(c)))


@pytest.mark.parametrize("name", CONFIGS)
def test_the_configurations_resolve_to_nets(name):
    conf = load("configs", name)
    assert "pose_reference" not in conf
    assert pose_reference(conf) is nets


@pytest.mark.parametrize("name", CONFIGS)
def test_tiny_cells_get_the_reference_modules_they_had(name):
    conf = tiny_pipeline(load("configs", name))
    stated, num = conf["pipeline"], nets.Numerics()
    before = {"pose": nets.PoseNet(stated["pose"], num), "gcn": nets.GCN(stated["gcn"], num),
              "align": nets.AlignEncoder(stated["align"], num),
              "error": nets.ErrorHead(stated["error"], num)}
    mods = system.reference_modules(conf)
    assert list(mods) == list(before)
    for m, mod in mods.items():
        assert type(mod) is type(before[m])
        shapes = {k: v.shape for k, v in mod.state_dict().items()}
        assert shapes == {k: v.shape for k, v in before[m].state_dict().items()}, m


def _probe_module(built: list, seen: list) -> types.ModuleType:
    """A pose reference module of the ResNet's layout (so the port loads its
    weights) that records what builds and runs it, with a count of its own."""

    class PoseNet(nets.PoseNet):
        def __init__(self, c, num):
            super().__init__(c, num)
            built.append(num)

        def forward(self, x):
            seen.append(x.shape[0])
            return super().forward(x)

    mod = types.ModuleType(PROBE)
    mod.PoseNet = PoseNet
    mod.pose_flops = lambda p: PROBE_FLOPS
    return mod


def test_a_named_module_is_built_weighted_checked_and_counted(monkeypatch):
    built, seen = [], []
    monkeypatch.setitem(sys.modules, PROBE, _probe_module(built, seen))
    conf = tiny_pipeline(load("configs", "full_pipeline"))
    conf["pose_reference"] = PROBE
    assert pose_reference(conf) is sys.modules[PROBE]

    # Weighted: the seeded state is drawn for the named net, and the port loads it.
    s = bench.Session(conf, tiny_traffic(), 2 ** 33 + 7, "cpu")
    assert len(built) == 1 and not seen
    assert set(s.state["pose"]) == set(nets.PoseNet(conf["pipeline"]["pose"]).state_dict())

    # Checked: the window's requests are held to the named net's heatmaps.
    s.warm_up()
    s.measure(0.3, False)
    numbers = s.judge([(d.item, d.out) for d in s.picked()])
    assert check.verdict(numbers, conf["limits"])[0], numbers
    assert len(built) == 2 and seen        # the check's Reference
    low = Reference(conf, s.state, "cpu", lowp=True)
    assert isinstance(low.pose_net, sys.modules[PROBE].PoseNet) and built[-1].lowp

    # Counted: Run carries the module's name, request_flops and step_mfu its count.
    stated = s.run.stated
    assert stated["pose_reference"] == PROBE
    fd = nets.error_feature_dim(stated["error"])
    lengths = [5, 15]
    plain = counts.request_flops(conf["pipeline"], lengths, 16, fd)
    per_frame = nets.pose_flops(stated["pose"])
    assert counts.request_flops(stated, lengths, 16, fd) == \
        plain + sum(lengths) * (PROBE_FLOPS - per_frame)

    from benchmark.metrics import step_mfu
    window = types.SimpleNamespace(window_s=lambda: 2.0)
    run = types.SimpleNamespace(trace=window, traced=[types.SimpleNamespace(lengths=lengths)],
                                peaks={"bf16_flops": 1e12}, stated=stated, ref_frames=16)
    want = 100.0 * counts.request_flops(stated, lengths, 16, fd) / 2e12
    assert step_mfu.read(run) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["benchmark.nets", "os.path", "benchmark.reference.",
                                  "benchmark.referencex.nets", 7])
def test_a_name_outside_the_reference_package_is_refused(name):
    with pytest.raises(ValueError, match="a module under 'benchmark.reference.'"):
        pose_reference({"pose_reference": name})


@pytest.mark.parametrize("lacks", ["PoseNet", "pose_flops"])
def test_a_module_that_lacks_a_function_is_refused(monkeypatch, lacks):
    mod = _probe_module([], [])
    delattr(mod, lacks)
    monkeypatch.setitem(sys.modules, PROBE, mod)
    with pytest.raises(ValueError, match=f"lacks {lacks}:"):
        pose_reference({"pose_reference": PROBE})


# ---------------------------------------------------------------------------
# The configuration check
# ---------------------------------------------------------------------------

def _with_backbone():
    """PipelineConfig as a later port would have it: a pose field that the
    configuration files do not state, whose default keeps the ResNet."""
    from golfaction_tpu_torch.config import PipelineConfig, PoseConfig

    pose = dataclasses.make_dataclass("PoseConfig", [("backbone", str, "resnet")],
                                      bases=(PoseConfig,), frozen=True)
    return pose, dataclasses.make_dataclass("PipelineConfig", [("pose", pose, pose())],
                                            bases=(PipelineConfig,), frozen=True)


def test_the_files_state_every_key_they_check():
    from golfaction_tpu_torch.config import get_config

    stated = load("configs", "full_pipeline")["pipeline"]
    assert system.check_config(get_config("full_pipeline"), stated) == {}


def test_an_unstated_key_at_its_default_passes(capsys):
    from golfaction_tpu_torch.config import PipelineConfig

    _, later = _with_backbone()
    stated = _plain(PipelineConfig())
    assert system.check_config(later(), stated) == {"pose.backbone": "resnet"}
    # A whole section left out, at its default; set-up names it on stderr.
    conf = tiny_pipeline(load("configs", "full_pipeline"))
    mesh = conf["pipeline"].pop("mesh")
    system.build(conf, 2 ** 31 + 5, "cpu", ".")
    assert f"[config] not stated, at their defaults: mesh={mesh!r}" in capsys.readouterr().err


def test_an_unstated_key_off_its_default_raises():
    from golfaction_tpu_torch.config import PipelineConfig

    pose, later = _with_backbone()
    stated = _plain(PipelineConfig())
    with pytest.raises(ValueError, match=r"\{'pose.backbone': 'vit'\}"):
        system.check_config(later(pose=pose(backbone="vit")), stated)
    cfg = dataclasses.replace(PipelineConfig(), box_refine_stride=4)
    del stated["box_refine_stride"]
    with pytest.raises(ValueError, match="box_refine_stride"):
        system.check_config(cfg, stated)


@pytest.mark.parametrize("where", ["top", "nested", "unknown"])
def test_a_stated_key_that_differs_raises(where):
    from golfaction_tpu_torch.config import get_config

    stated = copy.deepcopy(load("configs", "full_pipeline")["pipeline"])
    if where == "top":
        stated["frame_batch"] += 1
        key = "frame_batch"
    elif where == "nested":
        stated["pose"]["track_lambda"] *= 2
        key = "pose.track_lambda"
    else:                                   # a key the system does not have
        stated["pose"]["backbone"] = "resnet"
        key = "pose.backbone"
    with pytest.raises(ValueError, match=key):
        system.check_config(get_config("full_pipeline"), stated)
