"""The port's cascade fine-tune (golfaction_tpu_torch/cascade_finetune.py)
against the JAX package's `scripts/cascade_finetune.py`, on the CPU at the
tiny float32 widths of tests/torch_cascade_tree.py.

* Stages: the noise model, mode floor and blur excess equal to the script's
  lines evaluated with numpy; one AdamW step of each of the GCN, error-head
  and refiner losses against flax + optax.adamw as the script builds them
  (loss rtol 1e-5, parameters atol 1e-5); the refiner's batches equal to the
  bit to the script's construction.
* The whole script, unchanged, in this process (runpy, with its get_config
  answering the tiny config, its compile cache left off and its threshold
  calibration's inputs recorded), then the port's stages on a copy of the
  same tree given the script's collection: the GCN and error-head parameters
  after 3 and 4 steps at rtol 1e-4 / atol 1e-5, the calibration
  probabilities at atol 1e-4, the thresholds equal; once with the shipped
  mode-features head, once with a spread-features head.  (The script's
  `--spread` flag would re-initialize the head from JAX's seed-0 init, which
  torch cannot draw; a tree whose head is of the spread width runs the same
  spread path without it.)
"""

import dataclasses
import json
import pickle
import runpy
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu.models import error as jerror
from golfaction_tpu.models import gcn as jgcn
from golfaction_tpu.models import refine as jrefine
from golfaction_tpu.train import checkpoint as jckpt
from golfaction_tpu.train import data as jdata
from golfaction_tpu.train import losses as jlosses
from golfaction_tpu.train import metrics as jmetrics
from golfaction_tpu.utils import profiling as jprofiling
from golfaction_tpu_torch import cascade_finetune as cf
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models.error import ErrorClassifier
from golfaction_tpu_torch.models.gcn import normalize_skeleton
from tests.torch_cascade_tree import (ROOT, TINY, TINY_SET, build_tree, jax_params,
                                      tiny_get_config, tree_bytes)
from tests.torch_parity import sub_config, to_numpy

T, HW = 16, (96, 128)


# ---------------------------------------------------------------------------
# The measured noise model, against the script's lines (:219-266)
# ---------------------------------------------------------------------------

def _collection(seed: int = 0, n: int = 5):
    rng = np.random.default_rng(seed)
    gt = np.stack([s.keypoints for s in jdata.make_swing_batch(n, T, seed=seed, image_hw=HW)])
    pred = gt.copy()
    pred[..., :2] += rng.normal(0, 3, pred[..., :2].shape).astype(np.float32)
    aux = rng.uniform(0, 40, (n, T, 17, 4)).astype(np.float32)
    aux[rng.uniform(size=aux.shape) < 0.2] = 0.0
    return pred, gt, aux


@pytest.mark.parametrize("seed", [0, 1])
def test_noise_model_is_the_scripts(seed):
    pred_kpts, gt, _ = _collection(seed)
    resid = pred_kpts[..., :2] - gt[..., :2]
    sigma = float(np.median(np.abs(resid))) * 1.4826
    sigma_v = np.median(np.abs(resid), axis=(0, 1, 3)) * 1.4826
    sigma_v = np.maximum(sigma_v, 0.25 * sigma)[None, None, :, None]
    r0 = resid - resid.mean(axis=1, keepdims=True)
    rho = float(np.clip((r0[:, 1:] * r0[:, :-1]).sum() / max((r0 ** 2).sum(), 1e-9), 0.0, 0.99))
    got = cf.noise_model(pred_kpts, gt)
    assert (got.sigma, got.rho) == (sigma, rho) and got.innov == float(np.sqrt(1 - rho ** 2))
    np.testing.assert_array_equal(got.sigma_v, sigma_v)
    assert got.sigma_v.dtype == sigma_v.dtype


@pytest.mark.parametrize("seed", [0, 1])
def test_mode_floor_and_blur_excess_are_the_scripts(seed):
    _, _, pred_aux = _collection(seed)
    present = pred_aux[..., 3] > 0
    mode_miss = float(np.clip(1.0 - present.mean(), 0.0, 0.9))
    clean_rel = np.empty(17, np.float32)
    clean_sep = np.empty(17, np.float32)
    for j in range(17):
        m = present[..., j]
        clean_rel[j] = float(np.median(pred_aux[..., j, 2][m])) if m.any() else 0.1
        clean_sep[j] = float(np.median(pred_aux[..., j, 3][m])) if m.any() else 4.0
    miss, rel, sep = cf.mode_floor(pred_aux)
    assert miss == mode_miss
    np.testing.assert_array_equal(rel, clean_rel)
    np.testing.assert_array_equal(sep, clean_sep)
    iso_exc = np.maximum(0.5 * (pred_aux[..., 0] + pred_aux[..., 2]) - pred_aux[..., 3], 0.0)
    want = np.median(iso_exc, axis=(0, 1)).astype(np.float32)
    np.testing.assert_array_equal(cf.blur_excess(pred_aux), want)


# ---------------------------------------------------------------------------
# The refiner's batches, against the script's construction (:333-395)
# ---------------------------------------------------------------------------

def _script_refine_batch(i, rng_r, pred_kpts, gt, defl_rend, halfr, rho, innov, sigma_v,
                         fault_weight=3.0):
    """scripts/cascade_finetune.py's refine_batch, rebuilt with the JAX
    package's generator."""
    def _weights(defl):
        return 1.0 + fault_weight * np.minimum(defl / 15.0, 2.0) / 2.0

    idx = rng_r.choice(len(gt), size=halfr, replace=False)
    inp_r, tgt_r, w_r = np.asarray(pred_kpts)[idx], gt[idx], _weights(defl_rend[idx])
    inp_s, tgt_s, w_s = [], [], []
    for j in range(halfr):
        rd = np.random.default_rng(700_000 + i * 97 + j)
        faults = {}
        if rd.uniform() < 0.7:
            kk = rd.integers(1, 3)
            for name in rd.choice(jcfg.SWING_ERRORS, size=kk, replace=False):
                faults[str(name)] = float(rd.uniform(0.3, 1.0))
        tempo = float(rd.uniform(-0.8, 0.8))
        seed_b = 710_000 + i * 97 + j
        sf = jdata.swing_keypoints(T, np.random.default_rng(seed_b), tempo_warp=tempo,
                                   faults=faults)
        sc = jdata.swing_keypoints(T, np.random.default_rng(seed_b), tempo_warp=tempo)
        sf = jdata.place_in_image(sf, HW, person_height_px=0.65 * HW[0],
                                  rng=np.random.default_rng(seed_b + 1))
        sc = jdata.place_in_image(sc, HW, person_height_px=0.65 * HW[0],
                                  rng=np.random.default_rng(seed_b + 1))
        g = rd.uniform(0.35, 1.0, (1, 17, 1))
        inp1 = sc.keypoints + (sf.keypoints - sc.keypoints) * g
        nz1 = np.empty((T, 17, 2), np.float32)
        nz1[0] = rd.normal(0, 1.0, (17, 2))
        for tt in range(1, T):
            nz1[tt] = rho * nz1[tt - 1] + rd.normal(0, innov, (17, 2))
        inp1 = inp1.copy()
        inp1[..., :2] += nz1 * sigma_v[0]
        defl_on = (np.abs(sf.keypoints[..., :2] - sc.keypoints[..., :2]).sum(-1, keepdims=True)
                   > 1e-6)
        score = 1.0 - 0.6 * (1.0 - g) * defl_on + rd.normal(0, 0.05, (T, 17, 1))
        inp1[..., 2:] = np.clip(score, 0.05, 1.0)
        inp_s.append(inp1)
        tgt_s.append(sf.keypoints)
        w_s.append(_weights(sf.fault_defl))
    inp = np.asarray(jnp.asarray(np.concatenate([inp_r, np.stack(inp_s)])))
    tgt = np.asarray(jnp.asarray(np.concatenate([tgt_r, np.stack(tgt_s)])))
    w = np.asarray(jnp.asarray(np.concatenate([w_r, np.stack(w_s)])))
    return inp, tgt, w, np.ones(inp.shape[:2], bool)


def _refine_stream(seed: int = 0):
    pred, gt, _ = _collection(seed)
    defl = np.stack([s.fault_defl for s in jdata.make_swing_batch(len(gt), T, seed=seed,
                                                                   image_hw=HW)])
    noise = cf.noise_model(pred, gt)
    return cf.RefineStream(pred_kpts=pred, gt=gt, defl=defl, noise=noise,
                           rng=np.random.default_rng(77), half=2, hw=HW)


def test_refine_batches_are_the_scripts():
    st = _refine_stream()
    rng_r = np.random.default_rng(77)
    n = st.noise
    for i in range(3):
        got = cf.refine_batch(i, st)
        want = _script_refine_batch(i, rng_r, st.pred_kpts, st.gt, st.defl, st.half, n.rho,
                                    n.innov, n.sigma_v)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# One AdamW step of each loss, against flax + optax.adamw as the script has it
# ---------------------------------------------------------------------------

def _jax_step(jloss, params, batch, lr):
    tx = optax.adamw(lr, weight_decay=1e-4)
    loss, grads = jax.jit(jax.value_and_grad(jloss))(params, batch)
    updates, _ = tx.update(grads, tx.init(params), params)
    return float(loss), optax.apply_updates(params, updates)


def _assert_state(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_one_gcn_step_matches_the_scripts():
    jm = jgcn.create_gcn_model(TINY.gcn)
    params = jm.init(jax.random.key(0), jnp.zeros((1, T, 17, 3)), jnp.ones((1, T), bool))
    samples = jdata.make_swing_batch(6, T, seed=3, image_hw=HW)
    k = np.stack([s.keypoints for s in samples])
    labels = np.stack([s.phase_labels for s in samples])
    idx = np.random.default_rng(0).choice(6, size=4, replace=False)
    v = jnp.ones(labels.shape, bool)
    sk_j = jgcn.normalize_skeleton(jnp.asarray(k), v)

    def jloss(p, batch):
        s, lb, vv = batch
        return jlosses.phase_cross_entropy(jm.apply(p, s, vv), lb, vv, label_smoothing=0.05)

    want_loss, want = _jax_step(jloss, params, (sk_j[idx], jnp.asarray(labels)[idx], v[idx]),
                                3e-4)
    vt = torch.ones(labels.shape, dtype=torch.bool)
    sk_t = normalize_skeleton(torch.from_numpy(k), vt)
    state, hist = cf.finetune_gcn(sub_config(tcfg.GCNConfig, TINY.gcn),
                                  weights.gcn_state_dict(to_numpy(params)), sk_t,
                                  torch.from_numpy(labels).long(), vt, steps=1, batch_size=4,
                                  lr=3e-4, rng=np.random.default_rng(0), log=lambda m: None)
    np.testing.assert_allclose(hist[0], want_loss, rtol=1e-5)
    _assert_state(state, weights.gcn_state_dict(to_numpy(want)))


def test_one_error_step_matches_the_scripts():
    jm = jerror.create_error_model(TINY.error)
    rng = np.random.default_rng(4)
    B = 4
    k = np.stack([s.keypoints for s in jdata.make_swing_batch(B, T, seed=4, image_hw=HW)])
    rw = np.stack([s.keypoints for s in jdata.make_swing_batch(B, T, seed=5, image_hw=HW)])
    logits = rng.normal(0, 3, (B, T, 9)).astype(np.float32)
    flags = (rng.uniform(size=(B, 8)) < 0.3).astype(np.float32)
    aux = rng.uniform(0, 20, (B, T, 17, 4)).astype(np.float32)
    fw = np.ones(8, np.float32)
    fw[2] = 3.0
    v = np.ones((B, T), bool)
    params = jm.init(jax.random.key(11), jnp.asarray(k[:1]), jnp.asarray(logits[:1]),
                     jnp.asarray(v[:1]))

    def jloss(p, batch):
        s, pl, f, vv, r, sp = batch
        return jlosses.error_bce(jm.apply(p, s, pl, vv, r, sp), f, fault_weights=fw)

    batch = (k, logits, flags, v, rw, aux)
    want_loss, want = _jax_step(jloss, params, tuple(jnp.asarray(a) for a in batch), 3e-4)
    model = ErrorClassifier(sub_config(tcfg.ErrorConfig, TINY.error))
    model.load_state_dict(weights.error_state_dict(to_numpy(params)))
    opt = cf.adamw(model.parameters(), 3e-4)
    loss, _ = cf._step(model, opt, lambda m, b: cf.error_loss(m, b, fw),
                       tuple(torch.from_numpy(a) for a in batch))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    _assert_state(model.state_dict(), weights.error_state_dict(to_numpy(want)))


def test_one_refiner_step_matches_the_scripts():
    st = _refine_stream(1)
    jm = jrefine.create_refine_model(TINY.refine)
    params = jm.init(jax.random.key(7), jnp.zeros((1, T, 17, 3)), jnp.ones((1, T), bool))
    n = st.noise
    batch = _script_refine_batch(0, np.random.default_rng(77), st.pred_kpts, st.gt, st.defl,
                                 st.half, n.rho, n.innov, n.sigma_v)
    scale_px = 0.65 * HW[0] / 2.0

    def jloss(p, b):
        inp, tgt, w, vv = b
        out = jm.apply(p, inp, vv)
        err = ((out[..., :2] - tgt[..., :2]) / scale_px) ** 2
        return (err.sum(-1) * w * vv[..., None]).sum() / jnp.maximum((w * vv[..., None]).sum(),
                                                                      1.0)

    want_loss, want = _jax_step(jloss, params, tuple(jnp.asarray(a) for a in batch), 1e-3)
    state, hist = cf.train_refiner(sub_config(tcfg.RefineConfig, TINY.refine),
                                   weights.refine_state_dict(to_numpy(params)), st, 1, "cpu",
                                   log=lambda m: None)
    np.testing.assert_allclose(hist[0], want_loss, rtol=1e-5)
    _assert_state(state, weights.refine_state_dict(to_numpy(want)))
    assert float(state["head.weight"].abs().max()) > 0          # the step moved the head


def test_a_new_refiner_is_the_identity():
    cfg = sub_config(tcfg.RefineConfig, TINY.refine)
    fn = cf.refiner_fn(cfg, cf.new_refiner(cfg), "cpu")
    k = _collection()[0]
    np.testing.assert_array_equal(fn(k), k)


# ---------------------------------------------------------------------------
# The whole script against the port, on one collection
# ---------------------------------------------------------------------------

ARGS = ["--clips", "2", "--aug", "4", "--calib-clips", "1", "--frames", str(T), "--steps", "3",
        "--error-steps", "4", "--batch-size", "4", "--hw", str(HW[0]), str(HW[1])]


@pytest.fixture(scope="module", params=["modes", "spread"])
def both(request, tmp_path_factory):
    """The script in a tiny tree whose error head reads the mode features
    (the shipped variant) or the spread features (its width turns them on,
    with the spread synthesis, blur excess and beta profile), then the port
    on a copy of the tree as it was, given the script's collection."""
    tmp = tmp_path_factory.mktemp("cascade")
    spread = request.param == "spread"
    cfg = dataclasses.replace(TINY, error=dataclasses.replace(
        TINY.error, spread_features=spread, mode_features=not spread))
    src = build_tree(tmp / "jax_tree", jax_params(cfg))
    port_src = tmp / "port_tree"
    shutil.copytree(src, port_src)
    before = tree_bytes(port_src)
    rec = {}
    real = jmetrics.calibrate_error_thresholds

    def recording(probs, truth, log=None):
        rec["probs"], rec["truth"] = np.asarray(probs), np.asarray(truth)
        return real(probs, truth, log=log)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcfg, "get_config", tiny_get_config)
        mp.setattr(jprofiling, "enable_compile_cache", lambda *a, **k: None)
        mp.setattr(jmetrics, "calibrate_error_thresholds", recording)
        mp.setattr("sys.argv", ["cascade_finetune.py", "--artifacts", str(src), *ARGS,
                                "--collect-cache", str(tmp / "collection.pkl")])
        runpy.run_path(str(ROOT / "scripts" / "cascade_finetune.py"), run_name="__main__")
    with open(tmp / "collection.pkl", "rb") as f:
        collection = pickle.load(f)
    sets = [a for s in TINY_SET for a in ("--set", s)]
    port = cf.main(["--artifacts", str(port_src), "--out", str(tmp / "out"), *ARGS,
                    "--device", "cpu", *sets], collection=collection)
    trained = {name: to_numpy(jckpt.restore_params(
        jckpt.latest_step_dir(f"{src}/params/{name}"))) for name in ("gcn", "error")}
    with open(f"{src}/error_thresholds.json") as f:
        thresholds = json.load(f)
    return {"port": port, "jax_params": trained, "jax_thresholds": thresholds,
            "jax_calibration": rec, "port_src": port_src, "before": before,
            "out": tmp / "out"}


def _assert_close_state(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_gcn_after_three_steps_matches_the_script(both):
    assert len(both["port"]["losses"]["gcn"]) == 3
    _assert_close_state(both["port"]["params"]["gcn"],
                        weights.gcn_state_dict(both["jax_params"]["gcn"]))


def test_error_head_after_four_steps_matches_the_script(both):
    """Steps 0 and 2 carry reference warps, 1 and 3 none."""
    assert len(both["port"]["losses"]["error"]) == 4
    _assert_close_state(both["port"]["params"]["error"],
                        weights.error_state_dict(both["jax_params"]["error"]))


def test_calibration_probabilities_match_the_script(both):
    want = both["jax_calibration"]
    assert both["port"]["probs"].shape == want["probs"].shape == (20, 8)
    np.testing.assert_array_equal(both["port"]["truth"], want["truth"])
    np.testing.assert_allclose(both["port"]["probs"], want["probs"], atol=1e-4, rtol=0)


def test_thresholds_match_the_script(both):
    """Equal, except where a probability lies within 1e-4 of a grid value
    (there the two packages' float noise may pick either side)."""
    got, want = both["port"]["thresholds_values"], both["jax_thresholds"]
    assert got.keys() == want.keys()
    grid = np.linspace(0.20, 0.90, 15)
    probs = both["jax_calibration"]["probs"]
    for e, name in enumerate(tcfg.SWING_ERRORS):
        near = np.abs(probs[:, e, None] - grid[None]).min() < 1e-4
        assert got[name] == want[name] or near, name
    with open(both["port"]["thresholds"]) as f:
        assert json.load(f) == got


def test_the_port_leaves_its_source_tree_as_it_was(both):
    assert tree_bytes(both["port_src"]) == both["before"]
    assert both["port"]["clips"] == 6
    assert both["port"]["gcn_checkpoint"] == str(both["out"] / "params" / "gcn.npz")
