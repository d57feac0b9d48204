"""The port's pose-front probes against the JAX package's scripts
(`scripts/_probe_common.py`, `probe_arm_gain.py`, `probe_heatmap_modes.py`,
`probe_heatmap_spread.py`; imported here through sys.path, which the port
itself never does), on the CPU at the tiny float32 widths of
tests/torch_cascade_tree.py with the port's seeded random parameters
carried into both packages:

* `render_pair` equal to the bit, the fault tables and `topk_modes` exact;
* `Pipeline._pose_heatmaps` held to `make_pose_heatmaps_fn` with the
  keypoint-seeded box refinement on: boxes within 1e-2 px (the box
  smoothing's float32 running sums round by the order of summation, ROADMAP
  reference behaviour (iii)), and heatmaps within 1e-4 of their peak (atol
  1e-4 on a heatmap of peak 1, the training targets' scale; these random
  weights give peaks of 4-5) of the JAX crop and pose net on the same
  boxes; from JAX's own boxes, within 1e-3 of the peak;
* the modes probe's per-frame records and summary, and the spread probe's
  rows and per-fault entry, equal to the scripts' lines replayed through
  the JAX library on the same heatmaps; its decoded keypoints within 1e-4
  px and its moments within 1e-4 heatmap px²;
* the arm-gain probe's JSON from the port and from the unchanged JAX script
  (run in this process by runpy) on the same tiny tree: the same keys, and
  every gain within 2e-3, two steps of the JSON's 3-decimal rounding.  The
  keypoints come through the tracked decode, which a near-tied mode can
  flip (reference behaviour (iv)); on this input the two agree to the last
  digit.
"""

import dataclasses
import functools
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu.ops import heatmap as jheatmap
from golfaction_tpu.ops import preprocess as jpre
from golfaction_tpu.pipeline import orchestrator as jorch
from golfaction_tpu_torch import _probe_common, probe_arm_gain, probe_heatmap_modes
from golfaction_tpu_torch import probe_heatmap_spread, weights
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline, init_params
from tests.torch_cascade_tree import POSE_META, ROOT, TINY, TINY_SET, build_tree

sys.path.insert(0, str(ROOT / "scripts"))
import _probe_common as jprobe  # noqa: E402
import probe_arm_gain as jarm  # noqa: E402
import probe_heatmap_modes as jmodes  # noqa: E402

FRAMES, HW, STRIDE, MIN_DEFL = 16, (96, 128), 4, 2.0
FAULT = "casting"
SETS = [*TINY_SET, "error.mode_features=True"]


def _cfgs(**over):
    """The tiny config with the shipped tree's decode, the probes' bucket and
    frame size, in both packages."""
    meta = [f"pose.{k}={v}" for k, v in POSE_META.items()]
    base = [f"video_hw={HW}", f"length_buckets=({FRAMES},)", *meta,
            *[f"{k}={v}" for k, v in over.items()]]
    tc = tcfg.apply_overrides(tcfg.get_config("full_pipeline"), [*SETS, *base])
    jc = jcfg.apply_overrides(TINY, base)
    return tc, jc


@pytest.fixture(scope="module")
def params():
    """The port's seeded random state dicts and the same as a JAX tree."""
    sd = init_params(_cfgs()[0], seed=5)
    return sd, weights.to_flax(sd)


def test_render_pair_is_the_scripts_to_the_bit():
    for fault, sev, seed in ((FAULT, 1.0, 881_000), ("swaying", 0.55, 17)):
        got = _probe_common.render_pair(fault, sev, seed, 12, HW)
        want = jprobe.render_pair(fault, sev, seed, 12, HW)
        for g, w in zip(got, want):
            for f in dataclasses.fields(w):
                a, b = getattr(g, f.name), getattr(w, f.name)
                assert (a is None and b is None) or np.array_equal(a, b), f.name
        assert not np.array_equal(got[0].keypoints, got[1].keypoints)


def test_fault_tables_and_pair_seeds_are_the_scripts():
    assert _probe_common.FAULT_JOINTS == jarm.FAULT_JOINTS
    assert _probe_common.ARM_FAULTS == jarm.ARM_FAULTS
    assert _probe_common.pair_seed(880_000, 2, FAULT) == (
        880_000 + 977 * 3 + 13 * jcfg.SWING_ERRORS.index(FAULT))


def test_topk_modes_is_the_scripts_exactly():
    rng = np.random.default_rng(0)
    maps = [rng.normal(size=(16, 12)).astype(np.float32),
            np.round(rng.random((16, 12)) * 3).astype(np.float32),     # ties
            np.zeros((16, 12), np.float32), -np.ones((8, 8), np.float32)]
    for hm in maps:
        for k, r in ((5, 3.0), (3, 1.5)):
            assert probe_heatmap_modes.topk_modes(hm, k, r) == jmodes.topk_modes(hm, k, r)


@pytest.fixture(scope="module")
def fronts(params):
    """Three (fault, clean) pairs of `FAULT` through both pose fronts with the
    box refinement on: {pair: [(sample, port (hm, boxes), JAX (hm, boxes))
    for the faulty and the clean clip]}."""
    sd, jp = params
    tc, jc = _cfgs(box_refine_stride=STRIDE)
    pipe = Pipeline(tc, sd, device="cpu")
    jpipe = jorch.Pipeline(jc, params=jp)
    fn = jprobe.make_pose_heatmaps_fn(jpipe)
    net = jax.jit(jpipe.pose_model.apply)
    out = {}
    for p in range(3):
        sev = 0.4 + 0.75 * p / 2
        pair = _probe_common.render_pair(FAULT, sev, _probe_common.pair_seed(880_000, p, FAULT),
                                         FRAMES, HW)
        out[p] = []
        for s in pair:
            frames_p, boxes_p, _ = jpipe._prepare(s.frames, None)
            jhm, jboxes = fn(jpipe.params, jnp.asarray(frames_p), jnp.asarray(boxes_p))
            thm, tboxes = _probe_common.heatmaps_of(pipe, s.frames)
            # The JAX crop and pose net on the port's own boxes.
            on_port_boxes = net(jp["pose"], jpre.crop_resize_normalize(
                jnp.asarray(frames_p), jnp.asarray(tboxes.numpy()), jc.pose.input_hw))
            out[p].append((s, (thm, tboxes), (np.asarray(jhm), np.asarray(jboxes)),
                           np.asarray(on_port_boxes)))
    return {"pairs": out, "cfg": tc, "sd": sd}


def test_pose_heatmaps_hold_to_make_pose_heatmaps_fn(fronts):
    gaps = []
    for clips in fronts["pairs"].values():
        for _, (thm, tboxes), (jhm, jboxes), on_port_boxes in clips:
            assert tuple(thm.shape) == jhm.shape == (FRAMES, 17, 16, 12)
            np.testing.assert_allclose(tboxes.numpy(), jboxes, rtol=0, atol=1e-2)
            peak = float(np.abs(on_port_boxes).max())
            np.testing.assert_allclose(thm.numpy(), on_port_boxes, rtol=0, atol=1e-4 * peak)
            gaps.append(float(np.abs(thm.numpy() - jhm).max()) / peak)
    # Against JAX's heatmaps from JAX's own boxes the box rounding adds its
    # share: a crop moved by 1e-4 px moves a sharp heatmap by more than
    # the nets' own float32 noise.
    assert max(gaps) < 1e-3
    # The refinement moved the boxes off the motion boxes' center-scale form.
    s, (_, tboxes), *_ = fronts["pairs"][0][0]
    plain = Pipeline(dataclasses.replace(fronts["cfg"], box_refine_stride=0), fronts["sd"],
                     device="cpu")
    _, unrefined = _probe_common.heatmaps_of(plain, s.frames)
    assert not torch.allclose(unrefined, tboxes, atol=1.0)


_to_heatmap = jax.jit(jheatmap.image_keypoints_to_heatmap, static_argnums=(2, 3))


def _jax_modes_records(p, hm, boxes, sf, sc, pc):
    """The modes script's per-frame loop, through the JAX library."""
    true_d = sf.keypoints[..., :2] - sc.keypoints[..., :2]
    gt_true = np.asarray(_to_heatmap(sf.keypoints, boxes, pc.heatmap_hw, pc.input_hw))
    gt_canon = np.asarray(_to_heatmap(sc.keypoints, boxes, pc.heatmap_hw, pc.input_hw))
    out = []
    for j in jarm.FAULT_JOINTS[FAULT]:
        mask = np.linalg.norm(true_d[:, j], axis=-1) >= MIN_DEFL
        for t in np.nonzero(mask)[0]:
            modes = jmodes.topk_modes(hm[t, j])
            if not modes:
                continue
            tx, ty = gt_true[t, j, :2]
            cx, cy = gt_canon[t, j, :2]
            d_true = [float(np.hypot(m[0] - tx, m[1] - ty)) for m in modes]
            d_canon = [float(np.hypot(m[0] - cx, m[1] - cy)) for m in modes]
            best = int(np.argmin(d_true))
            out.append({
                "pair": p, "frame": int(t), "joint": int(j),
                "true_defl_img_px": round(float(np.linalg.norm(true_d[t, j])), 1),
                "sep_hm_px": round(float(np.hypot(tx - cx, ty - cy)), 2),
                "peak_d_true": round(d_true[0], 2), "peak_d_canon": round(d_canon[0], 2),
                "best_mode_d_true": round(d_true[best], 2), "best_mode_rank": best,
                "best_mode_rel_mass": round(modes[best][2] / modes[0][2], 3),
                "n_modes": len(modes)})
    return out


def test_modes_records_and_summary_are_the_scripts_on_the_same_heatmaps(fronts):
    pc = fronts["cfg"].pose
    got, want = [], []
    for p, ((sf, _, (jhm, jboxes), _), (sc, *_)) in fronts["pairs"].items():
        gt_true = probe_heatmap_modes.gt_heatmap_px(sf.keypoints, torch.tensor(jboxes), pc)
        gt_canon = probe_heatmap_modes.gt_heatmap_px(sc.keypoints, torch.tensor(jboxes), pc)
        got += probe_heatmap_modes.frame_records(
            p, jhm, gt_true, gt_canon, sf.keypoints[..., :2] - sc.keypoints[..., :2],
            _probe_common.FAULT_JOINTS[FAULT], MIN_DEFL)
        want += _jax_modes_records(p, jhm, jboxes, sf, sc, pc)
    assert got == want and len(got) > 10
    # The summary's lines, as the script computes them.
    sep = np.array([f["sep_hm_px"] for f in want])
    well = sep >= 2.0
    bt = np.array([f["best_mode_d_true"] for f in want])
    pt = np.array([f["peak_d_true"] for f in want])
    summary = probe_heatmap_modes.summarize(FAULT, got)
    assert summary["frames"] == len(want) and summary["frames_well_separated"] == int(well.sum())
    if well.any():
        assert summary["true_mode_present_frac"] == round(float(np.mean(bt[well] <= 2.0)), 3)
        assert summary["median_peak_d_true"] == round(float(np.median(pt[well])), 2)
    assert list(summary) == ["fault", "frames", "frames_well_separated", "peak_nearer_canon_frac",
                             "true_mode_present_frac", "median_peak_d_true",
                             "median_best_mode_d_true", "median_best_mode_rel_mass"]
    fake = [dict(f, sep_hm_px=3.0) for f in got]       # every frame well separated
    s2 = probe_heatmap_modes.summarize(FAULT, fake)
    assert s2["frames_well_separated"] == len(fake)
    assert s2["median_best_mode_rel_mass"] == round(float(np.median(
        [f["best_mode_rel_mass"] for f in fake])), 3)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_front_stats(hm, boxes, heatmap_hw, input_hw, radius):
    return (jheatmap.keypoints_to_image(jheatmap.decode_heatmaps(hm, method="udp"), boxes,
                                        heatmap_hw, input_hw),
            jheatmap.moment_stats(hm, radius=radius))


def _jax_clip_stats(hm, boxes, pc, radius):
    """The spread script's clip_stats after the pose front, through JAX."""
    kpt, mom = _jax_front_stats(hm, boxes, pc.heatmap_hw, pc.input_hw, radius)
    return np.asarray(kpt), np.asarray(mom), boxes[:, 3] / pc.heatmap_hw[0]


def _jax_rows(p, fault_stats, clean_stats, true_d, joints, sigma0):
    """The spread script's row loop."""
    (kp_f, mom_f, sc_f), (kp_c, mom_c, sc_c) = fault_stats, clean_stats
    rows = []
    for j in joints:
        mag = np.linalg.norm(true_d[:, j], axis=-1)
        for t in np.nonzero(mag >= MIN_DEFL)[0]:
            u = true_d[t, j] / mag[t]
            dev = float((kp_f[t, j, :2] - kp_c[t, j, :2]) @ u)

            def excess(mom, sc):
                _, _, cxx, cxy, cyy = mom[t, j]
                s2 = sc[t] ** 2
                var_u = s2 * (u[0] * u[0] * cxx + 2 * u[0] * u[1] * cxy + u[1] * u[1] * cyy)
                return float(np.sqrt(max(var_u - (sigma0 * sc[t]) ** 2, 0.0)))

            rows.append((p, float(mag[t]), dev, excess(mom_f, sc_f), excess(mom_c, sc_c)))
    return rows


def test_spread_statistics_are_the_scripts_on_the_same_heatmaps(fronts):
    pc = fronts["cfg"].pose
    joints = _probe_common.FAULT_JOINTS[FAULT]
    rows = []
    for p, clips in fronts["pairs"].items():
        stats = []
        for s, _, (jhm, jboxes), _ in clips:
            got = probe_heatmap_spread.clip_stats(torch.tensor(jhm), torch.tensor(jboxes), pc,
                                                  8.0)
            want = _jax_clip_stats(jhm, jboxes, pc, 8.0)
            np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
            # cov = E[x²] − E[x]² over a 16 x 12 map: cancelling terms of up
            # to 16² = 256, whose float32 ulp is 3e-5, summed in another order.
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
            np.testing.assert_array_equal(got[2], want[2])
            stats.append(want)
        sf, sc = clips[0][0], clips[1][0]
        true_d = sf.keypoints[:, :, :2] - sc.keypoints[:, :, :2]
        got = probe_heatmap_spread.pair_rows(p, *stats, true_d, joints, MIN_DEFL, pc.sigma)
        assert got == _jax_rows(p, *stats, true_d, joints, pc.sigma)
        rows += got
    assert len({r[0] for r in rows}) >= 2 and len(rows) > 12
    entry = probe_heatmap_spread.fault_entry(rows, joints, 3)
    # The script's lines on the same rows.
    arr = np.asarray(rows, np.float64)
    tgt, dev, exf, exc = arr[:, 1], arr[:, 2], arr[:, 3], arr[:, 4]
    num = den = 0.0
    X = np.stack([dev, exf], 1)
    for p in range(3):
        tr, te = arr[:, 0] != p, arr[:, 0] == p
        if not te.any() or tr.sum() < 4:
            continue
        coef, *_ = np.linalg.lstsq(X[tr], tgt[tr], rcond=None)
        num += float((X[te] @ coef) @ tgt[te])
        den += float(tgt[te] @ tgt[te])
    denom = float(np.mean(np.maximum(dev * (tgt - dev), 0.0)))
    beta = float(np.clip((np.mean(exf ** 2) - np.mean(exc ** 2)) / max(denom, 1e-6), 0.0, 1.5))
    assert entry["gain_combo_lopo"] == round(num / den, 3)
    assert entry["gain_dev_only"] == round(float((dev @ tgt) / (tgt @ tgt)), 3)
    assert entry["beta"] == round(beta, 3) and entry["rows"] == len(rows)
    assert entry["per_joint_beta"] == {str(j): round(beta, 3) for j in joints}
    assert entry["excess_auc_vs_twin"] == round(float(np.mean(exf > exc)), 3)
    assert probe_heatmap_spread.fault_entry([], joints, 3) == {"rows": 0}


def test_spread_and_modes_probes_run_as_a_user_runs_them(params, tmp_path):
    tree = build_tree(tmp_path / "tree", params=params[1])
    common = ["--artifacts", tree, "--cpu", "--pairs", "2", "--frames", str(FRAMES), "--hw",
              *map(str, HW), *[a for s in TINY_SET for a in ("--set", s)]]
    rep = probe_heatmap_spread.main(["--out", str(tmp_path / "s.json"), "--faults", FAULT,
                                     "--min-defl-px", str(MIN_DEFL), *common])
    on_disk = json.loads((tmp_path / "s.json").read_text())
    assert on_disk == json.loads(json.dumps(rep))
    with open(ROOT / "artifacts" / "probe_heatmap_spread.json") as f:
        shipped = json.load(f)
    assert list(on_disk) == list(shipped) and list(on_disk["faults"]) == [FAULT]
    assert set(on_disk["faults"][FAULT]) == set(shipped["faults"][FAULT])
    res = probe_heatmap_modes.main(["--out", str(tmp_path / "m.json"), "--fault", FAULT,
                                    "--min-defl-px", str(MIN_DEFL), *common])
    assert json.loads((tmp_path / "m.json").read_text()) == json.loads(json.dumps(res))
    assert set(res) == {"summary", "frames"} and res["summary"]["fault"] == FAULT
    with pytest.raises(ValueError, match="artifacts"):
        probe_heatmap_modes.main(["--out", str(ROOT / "artifacts" / "x.json"), *common])


def test_arm_gain_json_is_the_scripts(params, tmp_path, monkeypatch):
    tree = build_tree(tmp_path / "tree", params=params[1])
    args = ["--artifacts", tree, "--pairs", "1", "--frames", str(FRAMES), "--hw", *map(str, HW),
            *[a for s in TINY_SET for a in ("--set", s)]]
    got = probe_arm_gain.main(["--out", str(tmp_path / "port.json"), "--cpu", *args])
    monkeypatch.setattr(sys, "argv", ["probe_arm_gain.py", "--out", str(tmp_path / "jax.json"),
                                      "--cpu", *args])
    # The script draws JAX's seed-0 weights and then replaces every one of
    # them with the tree's; skip the draw (seconds of compiles).
    monkeypatch.setattr(jorch.Pipeline, "init_params", lambda self, seed=0: dict(params[1]))
    runpy.run_path(str(ROOT / "scripts" / "probe_arm_gain.py"), run_name="__main__")
    want = json.loads((tmp_path / "jax.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert port == json.loads(json.dumps(got))
    with open(ROOT / "artifacts" / "probe_arm_gain.json") as f:
        shipped = json.load(f)
    assert list(port) == list(want) == list(shipped)
    assert list(port["faults"]) == list(want["faults"]) == list(shipped["faults"])
    for fault, w in want["faults"].items():
        g = port["faults"][fault]
        assert list(g) == list(w) and list(g["per_joint_gain"]) == list(w["per_joint_gain"])
        assert g["per_joint_gain"] == pytest.approx(w["per_joint_gain"], abs=2e-3), fault
        assert g["mean_gain"] == pytest.approx(w["mean_gain"], abs=2e-3)
        assert g["peak_true_defl_px"] == w["peak_true_defl_px"]
    for key in ("arm_mean_gain", "drift_mean_gain"):
        assert port[key] == pytest.approx(want[key], abs=2e-3)
    assert port["severity"] == want["severity"] and port["hw"] == want["hw"]


def test_an_orbax_pose_dir_is_refused(params, tmp_path):
    tree = build_tree(tmp_path / "tree", params=params[1])
    step = tmp_path / "cand" / "params" / "pose" / "step_00000010"
    step.mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        probe_arm_gain.main(["--artifacts", tree, "--out", str(tmp_path / "x.json"), "--cpu",
                             "--pose-dir", str(step), "--frames", str(FRAMES),
                             *[a for s in TINY_SET for a in ("--set", s)]])
    assert not os.path.exists(tmp_path / "x.json")
