"""The port's visualization layer against the JAX package's: the same
skeleton, analysis overlay and aligned side-by-side images, equal to the
pixel, from numpy arrays and from tensors; and the written video decodes
to the same frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import types as jtypes
from golfaction_tpu.pipeline import visualize as jvis
from golfaction_tpu.train import data
from golfaction_tpu_torch import types as ttypes
from golfaction_tpu_torch.pipeline import visualize as tvis

cv2 = pytest.importorskip("cv2")


def _sample(t=6, hw=(120, 160), seed=0):
    rng = np.random.default_rng(seed)
    s = data.swing_keypoints(t, rng)
    s = data.place_in_image(s, hw, person_height_px=80, rng=rng)
    frames = rng.integers(0, 255, (t, *hw, 3), dtype=np.uint8)
    k = s.keypoints.astype(np.float32)
    k[:, ::5, 2] = 0.1                 # some joints below the score threshold
    return frames, k


@pytest.mark.parametrize("as_tensor", [False, True])
def test_draw_skeleton_equals_jax(as_tensor):
    frames, k = _sample()
    for t in range(len(frames)):
        kp = torch.from_numpy(k[t]) if as_tensor else k[t]
        got = tvis.draw_skeleton(frames[t], kp)
        np.testing.assert_array_equal(got, jvis.draw_skeleton(frames[t], k[t]))
        assert (got != frames[t]).any()


def test_render_analysis_equals_jax():
    frames, k = _sample(t=8, seed=1)
    labels = np.array([0, 1, 2, 3, 4, 5, -1, -1], np.int32)
    valid = np.arange(8) < 6
    common = dict(phase_logits=np.zeros((8, 9), np.float32), error_flags=np.zeros(8, bool),
                  error_probs=np.zeros(8, np.float32))
    want = jvis.render_analysis(frames, jtypes.AnalysisResult(
        keypoints=jnp.asarray(k), phase_labels=jnp.asarray(labels), valid=jnp.asarray(valid),
        **{n: jnp.asarray(v) for n, v in common.items()}))
    got = tvis.render_analysis(frames, ttypes.AnalysisResult(
        keypoints=torch.from_numpy(k), phase_labels=torch.from_numpy(labels),
        valid=torch.from_numpy(valid), **{n: torch.from_numpy(v) for n, v in common.items()}))
    assert got.shape == (6, 120, 160, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_pairs", [None, 4])
def test_render_comparison_equals_jax(max_pairs):
    fa, ka = _sample(t=6, hw=(120, 160), seed=2)
    fb, kb = _sample(t=5, hw=(100, 140), seed=3)        # the shorter image is padded
    path = np.array([[0, 0], [1, 0], [2, 1], [3, 2], [4, 3], [5, 4], [-1, -1]], np.int32)
    want = jvis.render_comparison(fa, ka, fb, kb, path, 6, max_pairs=max_pairs)
    got = tvis.render_comparison(fa, torch.from_numpy(ka), fb, torch.from_numpy(kb),
                                 torch.from_numpy(path), torch.tensor(6), max_pairs=max_pairs)
    assert got.shape == ((max_pairs or 6), 120, 300, 3)
    np.testing.assert_array_equal(got, want)


def _decode(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


def test_write_video_equals_jax(tmp_path):
    frames, k = _sample(t=4, seed=4)
    panels = tvis.render_comparison(frames, k, frames, k,
                                    np.stack([np.arange(4)] * 2, -1).astype(np.int32), 4)
    tvis.write_video(str(tmp_path / "port.mp4"), panels, fps=12)
    jvis.write_video(str(tmp_path / "jax.mp4"), panels, fps=12)
    got, want = _decode(str(tmp_path / "port.mp4")), _decode(str(tmp_path / "jax.mp4"))
    assert got.shape == (4, 120, 320, 3)
    np.testing.assert_array_equal(got, want)
