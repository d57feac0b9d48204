"""The port's `train_eval` evaluation blocks against the JAX package's
`scripts/train_eval.py`, replayed through the same JAX library calls at the
tiny float32 widths of tests/torch_cascade_tree.py on the same parameters
(the port's seeded random ones, carried into the JAX package's tree by
`weights.to_flax`, which skips JAX's own initialization): the GCN's labels
exactly and its accuracy and F1, the error head's probabilities within
1e-5 and its detection metrics, the hard-DTW path exactly on the same cost
matrix and the progress error within 1e-6, and PCK@0.05 on the same
heatmaps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu.models import align as jalign
from golfaction_tpu.models import error as jerror
from golfaction_tpu.models import gcn as jgcn
from golfaction_tpu.models import pose as jpose
from golfaction_tpu.ops import affine as jaffine
from golfaction_tpu.ops import heatmap as jheatmap
from golfaction_tpu.ops import softdtw as jsoftdtw
from golfaction_tpu.train import data as jdata
from golfaction_tpu.train import loops as jloops
from golfaction_tpu.train import metrics as jmetrics
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import train_eval as te
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models.align import AlignEncoder
from golfaction_tpu_torch.models.error import ErrorClassifier
from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.ops import softdtw
from golfaction_tpu_torch.pipeline.orchestrator import init_params
from golfaction_tpu_torch.train import data as tdata
from golfaction_tpu_torch.train import loops
from tests.torch_cascade_tree import TINY, TINY_SET

CLIPS, FRAMES, POSE_HW = 4, 32, (96, 128)


@pytest.fixture(scope="module")
def setup():
    cfg = tcfg.apply_overrides(tcfg.get_config("full_pipeline"),
                               [*TINY_SET, "error.mode_features=True"])
    sd = init_params(cfg, seed=3)
    return weights.to_flax(sd), sd, cfg


def _model(cls, model_cfg, sd):
    model = cls(model_cfg)
    model.load_state_dict(sd)
    return model.eval()


def test_eval_gcn_is_the_scripts_block(setup):
    jp, sd, cfg = setup
    model = _model(ActionSegmentationGCN, cfg.gcn, sd["gcn"])
    got = te.eval_gcn(model, CLIPS, FRAMES, "cpu")

    jm = jgcn.create_gcn_model(TINY.gcn)
    sk, labels, valid = jloops.build_gcn_batch(jdata.make_swing_batch(CLIPS, FRAMES,
                                                                      seed=777_000))

    @jax.jit
    def block(p, s, lab, v):
        """The script's lines, one compiled program."""
        pred = jnp.argmax(jm.apply(p, s, v), -1)
        return (pred, jmetrics.phase_accuracy(pred, lab, v),
                jmetrics.phase_f1(pred, lab, jcfg.NUM_PHASES, v))

    pred, acc, f1 = block(jp["gcn"], sk, labels, valid)
    want = {"eval_acc": float(acc), "eval_f1": float(f1)}

    tsk, _, tv = loops.build_gcn_batch(tdata.make_swing_batch(CLIPS, FRAMES, seed=777_000),
                                       device="cpu")
    with torch.inference_mode():
        tpred = model(tsk, tv).argmax(-1)
    assert np.array_equal(tpred.numpy(), np.asarray(pred))
    assert got == pytest.approx(want, abs=1e-6)


def test_eval_error_is_the_scripts_block(setup):
    jp, sd, cfg = setup
    model = _model(ErrorClassifier, cfg.error, sd["error"])
    got = te.eval_error(model, CLIPS, FRAMES, "cpu")

    jm = jerror.create_error_model(TINY.error)
    fwd = jax.jit(lambda p, s, pl_, v, rw: jax.nn.sigmoid(jm.apply(p, s, pl_, v, rw)))
    samples = jdata.make_swing_batch(CLIPS, FRAMES, seed=778_000, fault_prob=0.5)
    refs = jdata.make_swing_batch(CLIPS, FRAMES, seed=779_000, fault_prob=0.0)
    tsamples = tdata.make_swing_batch(CLIPS, FRAMES, seed=778_000, fault_prob=0.5)
    trefs = tdata.make_swing_batch(CLIPS, FRAMES, seed=779_000, fault_prob=0.0)
    for key, r, tr in (("eval", None, None), ("eval_with_ref", refs, trefs)):
        sk, pl, flags, valid, rw = jloops.build_error_batch(samples, r)
        probs = fwd(jp["error"], sk, pl, valid, rw)
        want = {k: float(v) for k, v in jmetrics.error_detection_metrics(probs, flags).items()}
        assert got[key] == pytest.approx(want, abs=1e-6), key
        batch = loops.build_error_batch(tsamples, tr, device="cpu")
        with torch.inference_mode():
            tprobs = torch.sigmoid(model(batch[0], batch[1], batch[3], batch[4]))
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), rtol=0, atol=1e-5)


def _tie_rich(seed: int, Ta: int, Tb: int) -> np.ndarray:
    """A cost matrix of small integers: many equal predecessors."""
    return np.random.default_rng(seed).integers(0, 3, (Ta, Tb)).astype(np.float32)


def test_dtw_path_is_jaxs_exactly(setup):
    rng = np.random.default_rng(4)
    mats = [rng.random((11, 11)).astype(np.float32), _tie_rich(0, 11, 11),
            np.zeros((11, 11), np.float32), _tie_rich(1, 7, 16)]
    jpath_of = jax.jit(jsoftdtw.dtw_path)
    for D in mats:
        path, length = softdtw.dtw_path(torch.from_numpy(D))
        jpath, jlength = jpath_of(jnp.asarray(D))
        assert path.dtype == torch.int32 and tuple(path.shape) == (sum(D.shape) - 1, 2)
        assert np.array_equal(path.numpy(), np.asarray(jpath)), D.shape
        assert int(length) == int(jlength)
    batch = np.stack([_tie_rich(s, 11, 11) for s in range(3)])
    path, length = softdtw.dtw_path(torch.from_numpy(batch))
    for i, D in enumerate(batch):
        jpath, jlength = jpath_of(jnp.asarray(D))
        assert np.array_equal(path[i].numpy(), np.asarray(jpath))
        assert int(length[i]) == int(jlength)


def test_eval_align_is_the_scripts_block(setup):
    jp, sd, cfg = setup
    model = _model(AlignEncoder, cfg.align, sd["align"])
    got = te.eval_align(model, "cpu")

    jm = jalign.create_align_model(TINY.align)

    @jax.jit
    def pair(p, ka, kb, pa, pb):
        """The script's per-pair lines, one compiled program for all eight."""
        va = jnp.ones((1, 48), bool)
        ea = jm.apply(p, jgcn.normalize_skeleton(ka[None], va), va)[0]
        eb = jm.apply(p, jgcn.normalize_skeleton(kb[None], va), va)[0]
        D = jsoftdtw.pairwise_sqdist(ea, eb)
        path, length = jsoftdtw.dtw_path(D)
        return D, path, length, jmetrics.alignment_progress_error(path, length, pa, pb)

    errs = []
    for i in range(8):
        a = jdata.swing_keypoints(48, np.random.default_rng(779_000 + i), tempo_warp=-0.6)
        b = jdata.swing_keypoints(48, np.random.default_rng(779_500 + i), tempo_warp=0.6)
        D, path, length, err = pair(jp["align"], a.keypoints, b.keypoints, a.progress,
                                    b.progress)
        errs.append(float(err))
        tpath, tlength = softdtw.dtw_path(torch.from_numpy(np.array(D)))
        assert np.array_equal(tpath.numpy(), np.asarray(path)) and int(tlength) == int(length)
    assert abs(got - float(np.mean(errs))) <= 1e-6


def test_heatmap_pck_is_the_scripts_on_the_same_heatmaps(setup):
    jp, sd, cfg = setup
    jm = jpose.create_pose_model(TINY.pose)
    pc = TINY.pose

    @jax.jit
    def clip(p, frames, sboxes, gt):
        """The script's per-clip lines, one compiled program for all four."""
        boxes = jaffine.box_to_center_scale(sboxes, aspect_ratio=pc.input_hw[1] / pc.input_hw[0])
        hm = jm.apply(p, jloops.pose_eval_crops(frames, boxes, pc))
        kpts_img = jheatmap.keypoints_to_image(jheatmap.decode_heatmaps(hm, "udp"), boxes,
                                               pc.heatmap_hw, pc.input_hw)
        bbox = jnp.maximum(boxes[:, 2], boxes[:, 3])
        return hm, boxes, jmetrics.pck(kpts_img, gt, bbox, alpha=0.05)

    samples = jdata.make_swing_batch(4, 8, seed=780_000, image_hw=POSE_HW, render=True,
                                     scene_families=jdata.TRAIN_SCENE_FAMILIES)
    jpcks, tpcks = [], []
    for s in samples:
        hm, boxes, pck = clip(jp["pose"], s.frames, s.boxes, s.keypoints)
        jpcks.append(float(pck))
        tpcks.append(loops.heatmap_pck(torch.tensor(np.asarray(hm)),
                                       torch.tensor(np.asarray(boxes)), s.keypoints,
                                       cfg.pose))
    assert tpcks == pytest.approx(jpcks, abs=1e-7)
    assert len(set(tpcks)) > 1                        # not a degenerate input
    # End to end from the port's own crops and pose net: the same clips.
    for s, t in zip(samples, te.pose_eval_samples(POSE_HW)):
        assert np.array_equal(s.frames, t.frames)
    got = te.eval_pose(_model(PoseNet, cfg.pose, sd["pose"]), cfg.pose, POSE_HW)
    assert got == pytest.approx(float(np.mean(jpcks)), abs=1e-7)
