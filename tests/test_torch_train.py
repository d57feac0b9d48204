"""The port's training path against the JAX package's, on the CPU at narrow
widths: losses, metrics, the synthetic generator, the batch functions, the
optimizer and its schedule, one batch's loss and gradients and three
optimizer steps of every model from the same exported parameters, resume,
and the way back into the JAX package's checkpoint layout.  float32; each
tolerance is stated where it is used."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu.models import align as jalign
from golfaction_tpu.models import error as jerror
from golfaction_tpu.models import gcn as jgcn
from golfaction_tpu.models import pose as jpose
from golfaction_tpu.train import checkpoint as jckpt
from golfaction_tpu.train import data as jdata
from golfaction_tpu.train import loops as jloops
from golfaction_tpu.train import losses as jlosses
from golfaction_tpu.train import metrics as jmetrics
from golfaction_tpu_torch import checkpoint as tckpt
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models.align import AlignEncoder
from golfaction_tpu_torch.models.error import ErrorClassifier
from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.ops import gcn_tail, heatmap, preprocess, softdtw
from golfaction_tpu_torch.train import data as tdata
from golfaction_tpu_torch.train import loops as tloops
from golfaction_tpu_torch.train import losses as tlosses
from golfaction_tpu_torch.train import metrics as tmetrics
from tests.torch_parity import sub_config, to_numpy

# The narrow widths of tests/test_train.py.
TRAIN = dict(batch_size=4, learning_rate=3e-3, warmup_steps=2, total_steps=8, seed=0)
GCN = dict(block_channels=(8, 16), temporal_branches=((3, 1),), dropout=0.0, dtype="float32")
ERROR = dict(hidden_dim=16, dtype="float32")
ALIGN = dict(embed_dim=8, hidden_channels=(8,), dtype="float32")
POSE = dict(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
            stage_channels=(8, 8, 16), deconv_channels=(8, 8), dtype="float32")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(t):
    return None if t is None else jnp.asarray(t.numpy())


def test_train_config_matches_jax():
    assert dataclasses.asdict(tcfg.TrainConfig()) == dataclasses.asdict(jcfg.TrainConfig())


# ---------------------------------------------------------------------------
# Losses and metrics on random inputs, 1e-5
# ---------------------------------------------------------------------------

def _loss_case(name):
    rng = np.random.default_rng(11)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    if name.startswith("heatmap_mse"):
        args = [f(3, 17, 16, 12), f(3, 17, 16, 12)]
        if name.endswith("weighted"):
            args.append(rng.uniform(0, 2, (3, 17)).astype(np.float32))
        return jlosses.heatmap_mse, tlosses.heatmap_mse, args, {}
    if name.startswith("phase_cross_entropy"):
        args = [f(2, 9, 9) * 3, rng.integers(0, 9, (2, 9)).astype(np.int32)]
        kw = {}
        if name.endswith("masked"):
            args.append(np.arange(9)[None] < np.array([[9], [5]]))
            kw = {"label_smoothing": 0.05}
        return jlosses.phase_cross_entropy, tlosses.phase_cross_entropy, args, kw
    if name.startswith("error_bce"):
        args = [f(5, 8) * 4, (rng.uniform(size=(5, 8)) < 0.4).astype(np.float32)]
        if name.endswith("weighted"):
            args.append(rng.uniform(0.5, 3, 8).astype(np.float32))
        return jlosses.error_bce, tlosses.error_bce, args, {}
    emb = [f(3, 10, 6), f(3, 10, 6)]
    emb = [e / np.linalg.norm(e, axis=-1, keepdims=True) for e in emb]
    if name == "softdtw_divergence":
        return (lambda a, b: jlosses.softdtw_divergence_batch(a, b, 0.1),
                lambda a, b: tlosses.softdtw_divergence_batched(a, b, 0.1), emb, {})
    prog = [np.sort(rng.uniform(size=(3, 10)).astype(np.float32), axis=-1) for _ in range(2)]
    return (jlosses.alignment_contrastive_batch, tlosses.alignment_contrastive,
            emb + prog, {})


@pytest.mark.parametrize("name", ["heatmap_mse", "heatmap_mse_weighted", "phase_cross_entropy",
                                  "phase_cross_entropy_masked", "error_bce",
                                  "error_bce_weighted", "softdtw_divergence",
                                  "alignment_contrastive"])
def test_loss_matches_jax(name):
    jfn, tfn, args, kw = _loss_case(name)
    want = np.asarray(jfn(*[jnp.asarray(a) for a in args], **kw))
    got = tfn(*[_t(a) for a in args], **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_divergence_is_one_batched_cost_call(monkeypatch):
    calls = []
    real = softdtw.softdtw_cost
    monkeypatch.setattr(softdtw, "softdtw_cost", lambda D, g: calls.append(tuple(D.shape))
                        or real(D, g))
    e = torch.nn.functional.normalize(torch.randn(4, 7, 5), dim=-1)
    tlosses.softdtw_divergence_batched(e, e.flip(1), 0.1)
    assert calls == [(12, 7, 7)]


def _metric_case(name):
    rng = np.random.default_rng(7)
    labels = [rng.integers(0, 9, (3, 20)).astype(np.int32) for _ in range(2)]
    valid = np.arange(20)[None] < np.array([[20], [11], [1]])
    if name == "pck":
        gt = rng.uniform(0, 200, (4, 17, 3)).astype(np.float32)
        pred = gt + rng.normal(0, 6, gt.shape).astype(np.float32)
        return "pck", [pred, gt, rng.uniform(80, 200, 4).astype(np.float32)], \
            {"alpha": 0.05, "mask": (rng.uniform(size=(4, 17)) < 0.8)}
    if name == "phase_accuracy":
        return name, labels, {"valid": valid}
    if name in ("phase_f1", "phase_confusion"):
        return name, labels + [9], {"valid": valid}
    if name == "alignment_progress_error":
        path = np.stack([np.minimum(np.arange(30), 15), np.minimum(np.arange(30), 19)], -1)
        path[25:] = -1
        prog = [np.sort(rng.uniform(size=n).astype(np.float32)) for n in (16, 20)]
        return name, [path.astype(np.int32), np.int32(25)] + prog, {}
    probs = rng.uniform(size=(12, 8)).astype(np.float32)
    flags = (rng.uniform(size=(12, 8)) < 0.4).astype(np.float32)
    return name, [probs, flags], {"threshold": 0.4}


@pytest.mark.parametrize("name", ["pck", "phase_accuracy", "phase_f1", "phase_confusion",
                                  "alignment_progress_error", "error_detection_metrics"])
def test_metric_matches_jax(name):
    fn, args, kw = _metric_case(name)
    want = getattr(jmetrics, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                   for a in args],
                                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                    for k, v in kw.items()})
    got = getattr(tmetrics, fn)(*[_t(a) if isinstance(a, np.ndarray) else a for a in args],
                                **{k: _t(v) if isinstance(v, np.ndarray) else v
                                   for k, v in kw.items()})
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-5)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_host_metrics_match_jax():
    rng = np.random.default_rng(3)
    probs = rng.uniform(size=(40, 8)).astype(np.float32)
    flags = (rng.uniform(size=(40, 8)) < 0.3).astype(np.float32)
    thr = rng.uniform(0.3, 0.7, 8).astype(np.float32)
    assert (tmetrics.error_detection_per_fault(_t(probs), _t(flags), _t(thr))
            == jmetrics.error_detection_per_fault(probs, flags, thr))
    assert (tmetrics.calibrate_error_thresholds(_t(probs), _t(flags))
            == jmetrics.calibrate_error_thresholds(probs, flags))


# ---------------------------------------------------------------------------
# The generator and the batches
# ---------------------------------------------------------------------------

def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            assert (a is None) == (b is None), f.name
            if b is not None:
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("kw", [
    dict(batch=4, num_frames=20, seed=3, fault_prob=0.6, sev_range=(0.3, 1.0), arm_wander=0.1),
    dict(batch=2, num_frames=6, seed=5, image_hw=(96, 128), render=True, camera_jitter=0.02,
         scene_families=(0, 1, 4)),
    dict(batch=2, num_frames=4, seed=6, image_hw=(64, 96), render=True, render_style="blob"),
], ids=["keypoints", "photo", "blob"])
def test_make_swing_batch_is_the_jax_packages(kw):
    assert tdata.TRAIN_SCENE_FAMILIES == jdata.TRAIN_SCENE_FAMILIES
    _assert_samples_equal(tdata.make_swing_batch(**kw), jdata.make_swing_batch(**kw))


def test_fault_balanced_batch_and_progress_warp_are_the_jax_packages():
    got = tdata.make_fault_balanced_batch(1, 12, seed=2, image_hw=(96, 128))
    want = jdata.make_fault_balanced_batch(1, 12, seed=2, image_hw=(96, 128))
    _assert_samples_equal(got, want)
    np.testing.assert_array_equal(tdata.progress_align_reference(got[0], got[-1]),
                                  jdata.progress_align_reference(want[0], want[-1]))


def _assert_batches_close(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(g.numpy().astype(np.float64),
                                       np.asarray(w).astype(np.float64), atol=atol)


@pytest.mark.parametrize("name", ["gcn", "align", "error", "error_with_reference"])
def test_keypoint_batches_match_jax(name):
    s = tdata.make_swing_batch(3, 12, seed=1, fault_prob=0.5)
    r = tdata.make_swing_batch(3, 12, seed=2, fault_prob=0.0)
    if name == "gcn":
        got, want = tloops.build_gcn_batch(s, device="cpu"), jloops.build_gcn_batch(s)
    elif name == "align":
        got, want = tloops.build_align_batch(s, r, device="cpu"), jloops.build_align_batch(s, r)
    else:
        refs = r if name.endswith("reference") else None
        got = tloops.build_error_batch(s, refs, device="cpu")
        want = jloops.build_error_batch(s, refs)
    _assert_batches_close(got, want, atol=1e-5)        # the data exact, the normalize 1e-5


def test_trainer_sample_streams_match_jax():
    """The per-step samples of train_align and train_error are drawn as the
    JAX trainers draw them (their batch_fn bodies, from the same seeds)."""
    tc = tcfg.TrainConfig(**TRAIN)
    sa, sb = tloops.align_pairs(tc, 10, step=3)
    rng = np.random.default_rng(tc.seed + 3)
    for a, b in zip(sa, sb):
        wa, wb = rng.uniform(-0.8, 0.8, 2)
        ja = jdata.swing_keypoints(10, np.random.default_rng(rng.integers(1 << 31)), tempo_warp=wa)
        jb = jdata.swing_keypoints(10, np.random.default_rng(rng.integers(1 << 31)), tempo_warp=wb)
        _assert_samples_equal([a, b], [ja, jb])
    s, refs = tloops.error_samples(tc, 10, step=2)
    _assert_samples_equal(s, jdata.make_swing_batch(4, 10, seed=2, fault_prob=0.5,
                                                    sev_range=(0.3, 1.0)))
    _assert_samples_equal(refs, jdata.make_swing_batch(4, 10, seed=100_002, fault_prob=0.0))
    assert tloops.error_samples(tc, 10, step=3)[1] is None


def test_pose_batch_matches_jax():
    pj = jcfg.PoseConfig(**POSE)
    pt = sub_config(tcfg.PoseConfig, pj)
    s = tdata.make_swing_batch(2, 8, seed=4, image_hw=(96, 128), render=True,
                               scene_families=tdata.TRAIN_SCENE_FAMILIES)
    kw = dict(frame_stride=2, box_jitter=0.25, full_frame_prob=0.25)
    n0 = preprocess.crop_resize_normalize.launches
    got = tloops.build_pose_batch(s, pt, jitter_rng=np.random.default_rng(9), device="cpu", **kw)
    want = jloops.build_pose_batch(s, pj, jitter_rng=np.random.default_rng(9), **kw)
    assert preprocess.crop_resize_normalize.launches == n0
    _assert_batches_close(got, want, atol=1e-4)         # bilinear crops and targets
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))    # weights exact
    boxes = tloops._pose_boxes(s[0].boxes, pt, "cpu")
    np.testing.assert_allclose(
        tloops.pose_eval_crops(s[0].frames, boxes, pt).numpy(),
        np.asarray(jloops.pose_eval_crops(s[0].frames, jnp.asarray(boxes.numpy()), pj)),
        atol=1e-4)


# ---------------------------------------------------------------------------
# Optimizer and schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(3, 10), (0, 10), (4, 3)])
def test_adamw_and_schedule_match_optax(warmup, total):
    """Ten AdamW steps on a toy parameter tree under the warmup-cosine
    schedule: parameters within 1e-6, the learning rates within 1e-9."""
    jc = jcfg.TrainConfig(learning_rate=1e-2, weight_decay=1e-2, warmup_steps=warmup,
                          total_steps=total)
    tc = tcfg.TrainConfig(**dataclasses.asdict(jc))
    rng = np.random.default_rng(0)
    w0, b0 = rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=4).astype(np.float32)
    x, y = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(5, 4)).astype(np.float32)

    tx = jloops.make_optimizer(jc)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    opt_state = tx.init(params)
    loss = lambda p: jnp.sum((jnp.asarray(x) @ p["w"] + p["b"] - jnp.asarray(y)) ** 2)  # noqa: E731
    w, b = torch.nn.Parameter(_t(w0.copy())), torch.nn.Parameter(_t(b0.copy()))
    opt, sched = tloops.make_optimizer([w, b], tc)
    sched_j = optax.warmup_cosine_decay_schedule(0.0, jc.learning_rate, warmup,
                                                 max(total, warmup + 1))
    for n in range(10):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched_j(n)), atol=1e-9)
        updates, opt_state = tx.update(jax.grad(loss)(params), opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        ((_t(x) @ w + b - _t(y)) ** 2).sum().backward()
        opt.step()
        sched.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), atol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(params["b"]), atol=1e-6)


# ---------------------------------------------------------------------------
# One batch's loss and gradients, and three optimizer steps, per model
# ---------------------------------------------------------------------------

def _model_case(name):
    """(jax model, jax params, jax loss_fn(params, batch), port model, port
    loss_fn, three numpy-able batches as the port's build_*_batch functions make them)."""
    tc = tcfg.TrainConfig(**TRAIN)
    if name == "gcn":
        jc = jcfg.GCNConfig(**GCN)
        jm = jgcn.create_gcn_model(jc)
        params = jm.init(jax.random.key(0), jnp.zeros((1, 24, 17, 3)), jnp.ones((1, 24), bool))

        def jloss(p, batch):
            sk, labels, valid = batch
            logits = jm.apply(p, sk, valid, deterministic=False,
                              rngs={"dropout": jax.random.key(0)})
            return jlosses.phase_cross_entropy(logits, labels, valid, label_smoothing=0.05)

        tm = ActionSegmentationGCN(sub_config(tcfg.GCNConfig, jc))
        tm.load_state_dict(weights.gcn_state_dict(to_numpy(params)))
        batches = [tloops.build_gcn_batch(tdata.make_swing_batch(4, 24, seed=n), device="cpu")
                   for n in range(3)]
        return jm, params, jloss, tm, tloops.gcn_loss, batches
    if name == "align":
        jc = jcfg.AlignConfig(**ALIGN)
        jm = jalign.create_align_model(jc)
        params = jm.init(jax.random.key(0), jnp.zeros((1, 16, 17, 3)), jnp.ones((1, 16), bool))

        def jloss(p, batch):
            sk_a, sk_b, prog_a, prog_b = batch
            ones = jnp.ones(sk_a.shape[:2], bool)
            ea, eb = jm.apply(p, sk_a, ones), jm.apply(p, sk_b, ones)
            div = jlosses.softdtw_divergence_batched(ea, eb, jc.gamma).mean()
            tcc = jlosses.alignment_contrastive_batch(ea, eb, prog_a, prog_b).mean()
            return div + 10.0 * tcc

        tm = AlignEncoder(sub_config(tcfg.AlignConfig, jc))
        tm.load_state_dict(weights.align_state_dict(to_numpy(params), jc.hidden_channels))
        small = dataclasses.replace(tc, batch_size=2)
        batches = [tloops.build_align_batch(*tloops.align_pairs(small, 16, n), device="cpu")
                   for n in range(3)]
        return jm, params, jloss, tm, tloops.align_loss, batches
    if name == "error":
        jc = jcfg.ErrorConfig(**ERROR)
        jm = jerror.create_error_model(jc)
        params = jm.init(jax.random.key(0), jnp.zeros((1, 24, 17, 3)), jnp.zeros((1, 24, 9)),
                         jnp.ones((1, 24), bool))

        def jloss(p, batch):
            sk, phase_logits, flags, valid, ref_warp = batch
            return jlosses.error_bce(jm.apply(p, sk, phase_logits, valid, ref_warp), flags)

        tm = ErrorClassifier(sub_config(tcfg.ErrorConfig, jc))
        tm.load_state_dict(weights.error_state_dict(to_numpy(params)))
        # Every batch with a reference: one compiled JAX program serves all three.
        batches = [tloops.build_error_batch(*tloops.error_samples(tc, 24, 2 * n), device="cpu")
                   for n in range(3)]
        return jm, params, jloss, tm, tloops.error_loss, batches
    jc = jcfg.PoseConfig(**POSE)
    jm = jpose.create_pose_model(jc)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 64, 48, 3)))

    def jloss(p, batch):
        crops, targets, wts = batch
        return jlosses.heatmap_mse(jm.apply(p, crops), targets, wts)

    tm = PoseNet(sub_config(tcfg.PoseConfig, jc))
    tm.load_state_dict(weights.pose_state_dict(to_numpy(params)))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        k = _t(rng.uniform(-1, 13, (3, 17, 2)).astype(np.float32))
        t, w = heatmap.make_heatmap_targets(k, (16, 12), 2.0)
        batches.append((_t(rng.normal(size=(3, 64, 48, 3)).astype(np.float32)), t, w))
    return jm, params, jloss, tm, tloops.pose_loss, batches


_CONVERT = {"gcn": weights.gcn_state_dict, "error": weights.error_state_dict,
            "pose": weights.pose_state_dict,
            "align": lambda t: weights.align_state_dict(t, ALIGN["hidden_channels"])}


@pytest.fixture(scope="module", params=["gcn", "align", "error", "pose"])
def stepped(request):
    """Both packages take three optimizer steps from the same parameters on
    the same batches; the first step's loss and gradients are kept."""
    name = request.param
    jm, params, jloss, tm, tloss, batches = _model_case(name)
    jc = jcfg.TrainConfig(**TRAIN)
    tx = jloops.make_optimizer(jc)
    opt_state = tx.init(params)
    vg = jax.jit(jax.value_and_grad(jloss))
    out = {"name": name}
    for n, batch in enumerate(batches):
        loss, grads = vg(params, tuple(_j(b) for b in batch))
        if n == 0:
            out["jax_loss"], out["jax_grads"] = float(loss), _CONVERT[name](to_numpy(grads))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    out["jax_params"] = _CONVERT[name](to_numpy(params))

    tm.train()
    opt, sched = tloops.make_optimizer(tm.parameters(), tcfg.TrainConfig(**TRAIN))
    for n, batch in enumerate(batches):
        aux = tloops.train_step(tm, opt, sched, tloss, batch, n)
        if n == 0:
            out["loss"] = float(aux["loss"])
            out["grads"] = {k: p.grad.clone() for k, p in tm.named_parameters()}
            out["grad_norm"] = float(aux["grad_norm"])
    out["params"] = {k: p.detach() for k, p in tm.named_parameters()}
    return out


def test_first_batch_loss_matches_jax(stepped):
    np.testing.assert_allclose(stepped["loss"], stepped["jax_loss"], rtol=1e-5, atol=1e-5)


def test_first_batch_gradients_match_jax(stepped):
    """Every parameter's gradient: rtol 1e-3, with a floor at 1e-5 of the
    largest gradient entry of the model (float32 sums in another order)."""
    assert stepped["grads"].keys() == stepped["jax_grads"].keys()
    top = max(float(g.abs().max()) for g in stepped["jax_grads"].values())
    sq = 0.0
    for k, want in stepped["jax_grads"].items():
        np.testing.assert_allclose(stepped["grads"][k].numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-5 * top, err_msg=k)
        sq += float((want.double() ** 2).sum())
    np.testing.assert_allclose(stepped["grad_norm"], sq ** 0.5, rtol=1e-4)


def test_parameters_after_three_steps_match_jax(stepped):
    """1e-4 on every parameter.  A parameter whose gradient is zero in exact
    arithmetic (a bias that a LayerNorm or GroupNorm removes again) gets
    float noise for a gradient, which Adam normalises to a step of the
    learning rate's size in either package; such parameters are held to the
    three steps' summed learning rate instead."""
    top = max(float(g.abs().max()) for g in stepped["jax_grads"].values())
    lr_sum = TRAIN["learning_rate"] * (0 + 0.5 + 1.0)
    noise = 0
    for k, want in stepped["jax_params"].items():
        got = stepped["params"][k].numpy()
        if float(stepped["jax_grads"][k].abs().max()) < 1e-6 * top:
            noise += 1
            np.testing.assert_allclose(got, want.numpy(), atol=1.01 * lr_sum, err_msg=k)
        else:
            np.testing.assert_allclose(got, want.numpy(), atol=1e-4, err_msg=k)
    assert noise < len(stepped["jax_params"]) / 3


# ---------------------------------------------------------------------------
# The trainers themselves
# ---------------------------------------------------------------------------

def test_train_gcn_reduces_loss_and_leaves_no_stale_tail():
    cfg = tcfg.GCNConfig(**{**GCN, "dropout": 0.1})
    n0 = gcn_tail.gcn_block_tail.launches
    state, hist = tloops.train_gcn(cfg, tcfg.TrainConfig(**TRAIN), frames_per_clip=24,
                                   log_every=1, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] and state.step == 8 and len(hist) == 8
    assert all(np.isfinite(list(r.values())).all() for r in hist)
    assert gcn_tail.gcn_block_tail.launches == n0
    model = state.model
    assert not model.training and model.blocks[0].tail is None
    x, valid = torch.zeros(1, 8, 17, 3), torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(RuntimeError):
        model(x, valid)                              # trained weights, nothing packed
    model.prepare()
    with torch.no_grad():
        np.testing.assert_allclose(model(x, valid).numpy(), model(x, valid, fused=False).numpy(),
                                   atol=1e-4)


def test_train_error_reduces_loss():
    _, hist = tloops.train_error(tcfg.ErrorConfig(**ERROR), tcfg.TrainConfig(**TRAIN),
                                 frames_per_clip=24, log_every=1, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_train_align_reduces_loss():
    tc = tcfg.TrainConfig(**{**TRAIN, "batch_size": 2, "total_steps": 6})
    _, hist = tloops.train_align(tcfg.AlignConfig(**ALIGN), tc, frames_per_clip=16, log_every=1,
                                 device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert set(hist[0]) == {"step", "loss", "grad_norm", "sdtw_div", "tcc", "seconds"}
    assert all(b["seconds"] > a["seconds"] for a, b in zip(hist, hist[1:]))


def test_train_pose_reduces_loss_and_evaluates():
    pc = tcfg.PoseConfig(**POSE)
    tc = tcfg.TrainConfig(batch_size=2, learning_rate=1e-3, warmup_steps=2, total_steps=6)
    state, hist = tloops.train_pose(
        pc, tc, image_hw=(96, 128), clips_per_epoch=1, frames_per_clip=8, log_every=1,
        pool_clips=6, pool_fault_prob=0.7, fast_frame_boost=2.0, fault_frame_boost=2.0,
        fault_joint_boost=2.0, arm_wander=0.1, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]
    samples = tdata.make_swing_batch(2, 4, seed=780_000, image_hw=(96, 128), render=True,
                                     scene_families=tdata.TRAIN_SCENE_FAMILIES)
    n0 = heatmap.decode_heatmaps.launches
    pck = tloops.evaluate_pose(state.model, pc, samples)
    assert 0.0 <= pck <= 1.0 and heatmap.decode_heatmaps.launches == n0


def test_train_pose_without_a_pool_renders_each_step():
    tc = tcfg.TrainConfig(batch_size=2, learning_rate=1e-3, warmup_steps=1, total_steps=2)
    state, hist = tloops.train_pose(tcfg.PoseConfig(**POSE), tc, image_hw=(96, 128),
                                    clips_per_epoch=1, frames_per_clip=8, log_every=1,
                                    device="cpu")
    assert [r["step"] for r in hist] == [0, 1] and np.isfinite(hist[-1]["loss"])


def test_pose_batch_stream_is_a_function_of_seed_and_step(monkeypatch):
    """Two runs of the pooled pose trainer from one seed see the same losses
    (pool sampling, flips and photometric noise come from
    default_rng(seed + 7919 * step)); another seed sees others."""
    pc = tcfg.PoseConfig(**POSE)

    def losses_of(seed):
        tc = tcfg.TrainConfig(batch_size=2, warmup_steps=1, total_steps=3, seed=seed)
        _, hist = tloops.train_pose(pc, tc, image_hw=(96, 128), clips_per_epoch=1,
                                    frames_per_clip=4, log_every=1, pool_clips=2, device="cpu")
        return [r["loss"] for r in hist]

    a = losses_of(0)
    assert a == losses_of(0) and a != losses_of(1)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    # Dropout on: the masks are a function of (seed, step), so a resumed run
    # draws the ones the uninterrupted run drew.
    cfg = tcfg.GCNConfig(block_channels=(8,), temporal_branches=((3, 1),), dropout=0.1)
    tc = tcfg.TrainConfig(**{**TRAIN, "checkpoint_dir": str(tmp_path), "checkpoint_every": 4})
    full, _ = tloops.train_gcn(cfg, tc, frames_per_clip=16, log_every=4, checkpoint_tag="gcn",
                               device="cpu")
    assert (tmp_path / "gcn" / "step_00000008.pt").exists()
    resumed, hist = tloops.train_gcn(cfg, tc, frames_per_clip=16, log_every=4,
                                     resume_from=str(tmp_path / "gcn" / "step_00000004.pt"),
                                     device="cpu")
    assert hist[0]["step"] == 4 and resumed.step == 8
    for (k, a), (_, b) in zip(full.params.items(), resumed.params.items()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=k)
    assert (resumed.optimizer.state_dict()["state"][0]["step"]
            == full.optimizer.state_dict()["state"][0]["step"])


def test_port_trained_weights_load_in_the_jax_package(tmp_path):
    jc = jcfg.GCNConfig(**GCN)
    tc = tcfg.TrainConfig(**{**TRAIN, "total_steps": 3})
    state, _ = tloops.train_gcn(sub_config(tcfg.GCNConfig, jc), tc, frames_per_clip=16,
                                log_every=1, device="cpu")
    tree = weights.to_flax({"gcn": state.params})["gcn"]
    path = tckpt.save_params_npz(str(tmp_path / "gcn.npz"), tree)
    restored = jckpt.restore_params_npz(path)                    # the JAX package's loader
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 17, 3)).astype(np.float32)
    valid = np.arange(16)[None] < np.array([[16], [9]])
    want = np.asarray(jgcn.create_gcn_model(jc).apply(restored, jnp.asarray(x),
                                                      jnp.asarray(valid)))
    port = ActionSegmentationGCN(sub_config(tcfg.GCNConfig, jc))
    port.load_state_dict(weights.gcn_state_dict(tckpt.restore_params_npz(path)))
    with torch.no_grad():
        got = port(_t(x), _t(valid), fused=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # The file holds the trained weights to float16 rounding.
    for k, v in weights.gcn_state_dict(restored).items():
        np.testing.assert_allclose(v.numpy(), state.params[k].numpy(), rtol=2e-3, atol=1e-4,
                                   err_msg=k)


def test_gcn_training_mode():
    cfg = tcfg.GCNConfig(block_channels=(8, 16), dropout=0.5)
    model = ActionSegmentationGCN(cfg)
    weights.init_random(model, torch.Generator().manual_seed(0))
    assert not model.training                          # a new model is ready for inference
    model.prepare()
    x, valid = torch.randn(2, 8, 17, 3), torch.ones(2, 8, dtype=torch.bool)
    with torch.no_grad():
        ref = model(x, valid)
    model.train()
    assert model.blocks[0].tail is None and model.blocks[0].sgc._wbig is None
    with pytest.raises(ValueError):
        model(x, valid)                                # dropout needs a generator
    gen = torch.Generator().manual_seed(1)
    a, b = model(x, valid, generator=gen), model(x, valid, generator=gen)
    assert not torch.allclose(a, b) and not torch.allclose(a, ref)   # the generator advances
    a.sum().backward()
    assert model.blocks[0].sgc.kernel.grad.abs().sum() > 0           # the live weights
    model.eval()
    with pytest.raises(RuntimeError):
        model(x, valid)                                # train() then eval() without prepare()
    with torch.no_grad():
        np.testing.assert_allclose(model(x, valid, fused=False).numpy(), ref.numpy(), atol=1e-4)


def test_what_is_not_ported_raises():
    # Everything this test once found refused is ported now: the TensorBoard
    # mirror (test_torch_utils.py), data parallelism, whose non-default mesh
    # the config accepts (test_torch_parallel.py), and temporal context.
    assert tcfg.PipelineConfig(mesh=tcfg.MeshConfig(data_parallel=2)).mesh.data_parallel == 2
    three = tcfg.PoseConfig(**{**POSE, "in_frames": 3})
    s = tdata.make_swing_batch(1, 4, seed=0, image_hw=(64, 96), render=True, render_style="blob")
    # Temporal context (in_frames > 1) is ported: nine channels, not a raise.
    crops, _, _ = tloops.build_pose_batch(s, three, frame_stride=2, device="cpu")
    assert tuple(crops.shape) == (2, *three.input_hw, 9)
    boxes = torch.tensor([[48.0, 32.0, 40.0, 50.0]]).repeat(4, 1)
    assert tuple(tloops.pose_eval_crops(s[0].frames, boxes, three).shape) == (
        4, *three.input_hw, 9)


def test_trainers_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is there")
    with pytest.raises(RuntimeError):
        tloops.train_error(tcfg.ErrorConfig(**ERROR), tcfg.TrainConfig(**TRAIN), frames_per_clip=8)
    with pytest.raises(RuntimeError):
        tloops.build_gcn_batch(tdata.make_swing_batch(1, 8))
