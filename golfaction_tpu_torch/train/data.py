"""Procedural golf-swing dataset generator: the port's own copy of the JAX
package's numpy generator, draw for draw, so both packages train on the same
data from the same seed.

A parametric golfer: a 2D COCO-17 skeleton articulated through the eight
swing phases with controllable tempo, style jitter and injectable swing
faults.  It provides ground truth for every model in the stack:

  * pose:   rendered frames with exact keypoint ground truth;
  * GCN:    per-frame phase labels from the generating schedule;
  * align:  the same swing resampled under two tempos, with the true
            time-correspondence as alignment ground truth;
  * error:  fault flags matching the injected perturbations.

Everything is NumPy (and OpenCV drawing) on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch import graph

# Canonical address-pose skeleton (x, y) in a unit body frame: y grows down,
# origin at mid-hip, torso height ~1.  Rough golfer proportions.
_ADDRESS = {
    "nose": (0.05, -1.05),
    "left_eye": (0.02, -1.10), "right_eye": (0.08, -1.10),
    "left_ear": (-0.02, -1.07), "right_ear": (0.12, -1.07),
    "left_shoulder": (-0.18, -0.85), "right_shoulder": (0.22, -0.85),
    "left_elbow": (-0.22, -0.55), "right_elbow": (0.28, -0.55),
    "left_wrist": (0.05, -0.30), "right_wrist": (0.09, -0.30),
    "left_hip": (-0.15, 0.0), "right_hip": (0.15, 0.0),
    "left_knee": (-0.17, 0.45), "right_knee": (0.19, 0.45),
    "left_ankle": (-0.18, 0.90), "right_ankle": (0.20, 0.90),
}

# Swing-phase schedule: (phase_name, fraction of clip).  The generator sweeps
# an arm-rotation parameter theta through the swing while hips/shoulders turn.
_PHASE_SCHEDULE = (
    ("address", 0.12),
    ("takeaway", 0.10),
    ("backswing", 0.16),
    ("top", 0.08),
    ("downswing", 0.12),
    ("impact", 0.06),
    ("follow_through", 0.16),
    ("finish", 0.20),
)

# Arm-swing angle (radians) at each phase boundary: 0 = arms hanging at
# address, negative = backswing side, positive = follow-through side.
_PHASE_THETA = {
    "address": 0.0,
    "takeaway": -0.7,
    "backswing": -2.0,
    "top": -2.6,
    "downswing": -0.8,
    "impact": 0.1,
    "follow_through": 1.8,
    "finish": 2.6,
}


@dataclasses.dataclass(frozen=True)
class SwingSample:
    keypoints: np.ndarray        # [T, 17, 3] image px (x, y, vis)
    phase_labels: np.ndarray     # [T] int32 indices into config.SWING_PHASES
    error_flags: np.ndarray      # [E] float32 0/1
    frames: Optional[np.ndarray] = None   # [T, H, W, 3] uint8 if rendered
    boxes: Optional[np.ndarray] = None    # [T, 4]
    progress: Optional[np.ndarray] = None  # [T] swing progress in [0, 1]
    fault_defl: Optional[np.ndarray] = None  # [T, 17] fault deflection
    # (unit body frame from swing_keypoints; pixels after place_in_image)


def _phase_curve(t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Map clip progress t∈[0,1] -> (theta, phase_index [T])."""
    bounds = np.cumsum([0.0] + [f for _, f in _PHASE_SCHEDULE])
    names = [n for n, _ in _PHASE_SCHEDULE]
    theta = np.zeros_like(t)
    labels = np.zeros(len(t), np.int32)
    keys = list(cfg_mod.SWING_PHASES)
    for i, name in enumerate(names):
        lo, hi = bounds[i], bounds[i + 1]
        in_seg = (t >= lo) & (t <= hi if i == len(names) - 1 else t < hi)
        seg_t = np.clip((t - lo) / max(hi - lo, 1e-6), 0, 1)
        th0 = _PHASE_THETA[name]
        th1 = _PHASE_THETA[names[i + 1]] if i + 1 < len(names) else th0
        # smoothstep easing within each phase
        ease = seg_t * seg_t * (3 - 2 * seg_t)
        theta = np.where(in_seg, th0 + (th1 - th0) * ease, theta)
        labels = np.where(in_seg, keys.index(name), labels)
    return theta, labels


def swing_keypoints(
    num_frames: int,
    rng: np.random.Generator,
    tempo_warp: float = 0.0,
    style_jitter: float = 0.02,
    noise: float = 0.003,
    faults: Optional[dict[str, float]] = None,
    arm_wander: float = 0.0,
) -> SwingSample:
    """Generate one swing in the unit body frame (no rendering).

    tempo_warp in [-1, 1]: power-law time warp (slow-start vs fast-start),
    the ground-truth correspondence used by alignment training.
    faults: {error_name: severity} perturbations matching config.SWING_ERRORS.
    arm_wander > 0 adds smooth low-frequency random displacement to the
    elbows/wrists on top of the canonical articulation (amplitude in body
    units, comparable to fault deflections at ~0.1).  Pose-pool-only
    augmentation: it makes "the arm is wherever the pixels say" the only
    consistent hypothesis, so the net cannot learn a canonical-arm prior
    (the measured failure mode behind chicken_wing transfer gain 0.11-0.21:
    predicted elbow 2-8 px from CANONICAL, 18-24 px from truth, while the
    deflection is clearly visible).  NOT counted in
    fault_defl: wander is on every pool clip, so plain supervision covers
    it, and letting it into fault_defl starves the rare real-fault
    frames/joints of the boost budget (poseE drift-transfer collapse).
    """
    V = graph.NUM_JOINTS
    t_lin = np.linspace(0, 1, num_frames)
    power = 2.0 ** tempo_warp
    t = t_lin**power
    theta, labels = _phase_curve(t)

    base = np.array([_ADDRESS[n] for n in graph.COCO_KEYPOINTS], np.float64)
    kpts = np.repeat(base[None], num_frames, axis=0)     # [T, V, 2]

    # Style: per-joint static offset (body proportions vary by subject).
    kpts += rng.normal(0, style_jitter, (1, V, 2))

    # Articulate: arms rotate about the shoulder midpoint with angle theta;
    # wrists travel furthest, elbows half-way (simple two-link approximation).
    sh_mid = kpts[:, [5, 6], :].mean(axis=1, keepdims=True)  # [T, 1, 2]
    for joints, gain in (([9, 10], 1.0), ([7, 8], 0.55)):
        rel = kpts[:, joints, :] - sh_mid
        c, s = np.cos(theta * gain), np.sin(theta * gain)
        rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)  # [T,2,2]
        kpts[:, joints, :] = sh_mid + np.einsum("tij,tvj->tvi", rot, rel)

    # Hip/shoulder turn: lateral compression proportional to theta.
    turn = 0.12 * np.sin(theta)
    kpts[:, [5, 6], 0] -= turn[:, None] * np.array([1.0, -1.0])
    kpts[:, [11, 12], 0] -= 0.5 * turn[:, None] * np.array([1.0, -1.0])

    # Head stays roughly still; knees flex slightly through the strike.
    kpts[:, [13, 14], 1] += 0.02 * np.abs(np.sin(theta))[:, None]

    # --- fault injection (matches config.SWING_ERRORS semantics) ---
    E = cfg_mod.NUM_ERRORS
    flags = np.zeros(E, np.float32)
    faults = faults or {}
    back = theta < -0.1     # backswing side frames
    down = (theta > -1.0) & (theta < 0.3)
    kpts_pre_fault = kpts.copy()
    for name, sev in faults.items():
        e = cfg_mod.SWING_ERRORS.index(name)
        flags[e] = 1.0
        if name == "swaying":
            kpts[:, [11, 12, 13, 14], 0] += sev * 0.15 * np.clip(-theta, 0, None)[:, None]
        elif name == "hanging_back":
            kpts[:, [11, 12], 0] -= sev * 0.12 * down[:, None]
        elif name == "early_extension":
            kpts[:, [11, 12], 1] -= sev * 0.10 * down[:, None]
        elif name == "over_the_top":
            kpts[:, [7, 9], 1] -= sev * 0.12 * down[:, None]
        elif name == "casting":
            kpts[:, [9, 10], 1] += sev * 0.15 * down[:, None]
        elif name == "reverse_spine":
            kpts[:, [0, 1, 2, 3, 4, 5, 6], 0] += sev * 0.10 * np.clip(-theta, 0, None)[:, None]
        elif name == "chicken_wing":
            fw = theta > 0.3
            kpts[:, [7], 1] -= sev * 0.15 * fw[:, None]
        elif name == "head_movement":
            kpts[:, [0, 1, 2, 3, 4], 0] += sev * 0.12 * np.sin(theta * 2)[:, None]

    # Per-frame/per-joint fault deflection — how far the injected faults
    # moved each joint off the canonical trajectory (unit body frame;
    # place_in_image scales it to pixels).  Pose training uses it to
    # oversample + upweight exactly the frames/joints a fault displaces:
    # faults like chicken_wing live in a handful of follow-through frames
    # and are otherwise drowned out by the canonical-pose prior.
    # Computed BEFORE arm_wander on purpose: poseE (wander counted in
    # fault_defl) collapsed hip-fault transfer (swaying 0.75->0.18,
    # early_extension went NEGATIVE) because ubiquitous wander frames ate
    # the entire fault-boost budget.  Wander needs no boost — it is on
    # every pool clip, so plain supervision already enforces "the arm is
    # wherever the pixels say".
    fault_defl = np.linalg.norm(kpts - kpts_pre_fault, axis=-1).astype(np.float32)

    if arm_wander > 0:
        # Smooth per-joint wander: a handful of control points cosine-free
        # linearly interpolated over the clip, amplitude jittered per clip.
        amp = arm_wander * rng.uniform(0.3, 1.0)
        n_ctrl = max(3, num_frames // 10)
        x = np.linspace(0, n_ctrl - 1, num_frames)
        for j in (7, 8, 9, 10):
            for d in (0, 1):
                ctrl = rng.normal(0.0, amp, n_ctrl)
                kpts[:, j, d] += np.interp(x, np.arange(n_ctrl), ctrl)

    # Measurement noise.
    kpts += rng.normal(0, noise, kpts.shape)
    vis = np.ones((num_frames, V, 1))
    return SwingSample(
        keypoints=np.concatenate([kpts, vis], axis=-1).astype(np.float32),
        phase_labels=labels.astype(np.int32),
        error_flags=flags,
        progress=t.astype(np.float32),
        fault_defl=fault_defl,
    )


def place_in_image(
    sample: SwingSample,
    image_hw: tuple[int, int] = (1080, 1920),
    person_height_px: float = 700.0,
    center: Optional[tuple[float, float]] = None,
    rng: Optional[np.random.Generator] = None,
) -> SwingSample:
    """Map unit-body-frame keypoints into image pixels + derive person boxes."""
    H, W = image_hw
    if center is None:
        rng = rng or np.random.default_rng(0)
        center = (
            float(rng.uniform(0.35, 0.65) * W),
            float(rng.uniform(0.45, 0.6) * H),
        )
    scale = person_height_px / 2.0  # body frame spans ~2 units vertically
    xy = sample.keypoints[..., :2] * scale + np.asarray(center)
    kpts = np.concatenate([xy, sample.keypoints[..., 2:]], axis=-1).astype(np.float32)

    lo = xy.min(axis=1)   # [T, 2]
    hi = xy.max(axis=1)
    c = (lo + hi) / 2
    wh = (hi - lo) * 1.15
    boxes = np.concatenate([c, wh], axis=-1).astype(np.float32)
    defl = sample.fault_defl
    if defl is not None:
        defl = (defl * scale).astype(np.float32)   # unit frame -> pixels
    return dataclasses.replace(sample, keypoints=kpts, boxes=boxes,
                               fault_defl=defl)


def render_frames(
    sample: SwingSample,
    image_hw: tuple[int, int],
    joint_radius: float = 6.0,
    rng: Optional[np.random.Generator] = None,
) -> SwingSample:
    """Render simple synthetic frames: dark background + bright joints/limbs.

    Good enough to train the pose net to locate joints (blob centers are the
    exact keypoints) while remaining cheap to generate on the host.
    """
    rng = rng or np.random.default_rng(0)
    H, W = image_hw
    T = sample.keypoints.shape[0]
    frames = rng.integers(20, 45, (T, H, W, 3)).astype(np.uint8)
    ys = np.arange(H, dtype=np.float32)[:, None]
    xs = np.arange(W, dtype=np.float32)[None, :]
    # Per-joint distinctive colors so the net can tell joints apart.
    colors = (rng.integers(120, 256, (graph.NUM_JOINTS, 3))).astype(np.float32)
    for tt in range(T):
        canvas = frames[tt].astype(np.float32)
        # Limb segments as capsule strokes.
        for a, b in graph.COCO_EDGES:
            pa, pb = sample.keypoints[tt, a, :2], sample.keypoints[tt, b, :2]
            n = max(int(np.linalg.norm(pb - pa) / (joint_radius * 0.9)), 1)
            for u in np.linspace(0, 1, n + 1):
                p = pa * (1 - u) + pb * u
                y0, y1 = int(max(p[1] - joint_radius, 0)), int(min(p[1] + joint_radius + 1, H))
                x0, x1 = int(max(p[0] - joint_radius, 0)), int(min(p[0] + joint_radius + 1, W))
                if y0 < y1 and x0 < x1:
                    d2 = (ys[y0:y1] - p[1]) ** 2 + (xs[:, x0:x1] - p[0]) ** 2
                    m = d2 < joint_radius**2
                    canvas[y0:y1, x0:x1][m] = 90.0
        # Joints on top.
        r = joint_radius * 1.4
        for v in range(graph.NUM_JOINTS):
            p = sample.keypoints[tt, v, :2]
            y0, y1 = int(max(p[1] - r, 0)), int(min(p[1] + r + 1, H))
            x0, x1 = int(max(p[0] - r, 0)), int(min(p[0] + r + 1, W))
            if y0 < y1 and x0 < x1:
                d2 = (ys[y0:y1] - p[1]) ** 2 + (xs[:, x0:x1] - p[0]) ** 2
                m = d2 < r**2
                canvas[y0:y1, x0:x1][m] = colors[v]
        frames[tt] = np.clip(canvas, 0, 255).astype(np.uint8)
    return dataclasses.replace(sample, frames=frames)


# ---------------------------------------------------------------------------
# Photoreal-adversarial rendering
# ---------------------------------------------------------------------------
#
# The environment has no real pose imagery (zero egress; the only bundled
# photograph is matplotlib's grace_hopper.jpg), so accuracy cannot be
# demonstrated on COCO val.  The honest fallback is to
# make the renderer adversarial to the pose model instead of cooperative:
# no per-joint color cheat, uniform clothing over capsule limbs, varied
# procedural + real-photo-composite backgrounds, occluders drawn OVER the
# body, a golf club distractor, lighting jitter, motion blur on fast frames,
# and optional camera shake.  The model must learn body *structure*.

# Scene families (cross-domain generalization protocol):
#   0 outdoor (sky/grass/trees)   1 indoor range (wall/floor/mat)
#   2 real-photo composite        3 dusk (warm cast, vignette, striped shirt)
#   4 procedural clutter (domain randomization: multi-scale noise + shapes)
# Training renders draw ONLY from TRAIN_SCENE_FAMILIES;
# family 2 is held out of ALL training (incl. cascade adaptation) and
# family 3 exists only for eval — e2e metrics on 2/3 therefore measure
# transfer to scene statistics the models have never seen.  Family 4 is a
# TRAIN family added when the first holdout run exposed background
# overfitting (family-2 PCK 0.51 vs 0.95 in-domain): its high-frequency
# random shapes/textures force the pose net onto body structure instead
# of the smooth family-0/1 background statistics.
TRAIN_SCENE_FAMILIES = (0, 1, 4)
HELDOUT_SCENE_FAMILY = 2
EVAL_ONLY_SCENE_FAMILY = 3
ALL_SCENE_FAMILIES = (0, 1, 2, 3, 4)

_SKIN_TONES = ((242, 206, 176), (224, 177, 132), (198, 134, 94),
               (141, 85, 56), (96, 57, 36))
_SHIRT_COLORS = ((200, 40, 40), (40, 90, 200), (240, 240, 240), (30, 30, 34),
                 (230, 180, 40), (60, 160, 80), (150, 60, 160), (90, 90, 95))
_PANTS_COLORS = ((40, 40, 46), (110, 110, 118), (160, 140, 110),
                 (235, 235, 235), (50, 60, 100))

_REAL_PHOTO_CACHE: list = []


def _real_photos() -> list:
    """Bundled real photographs usable as background composites."""
    if _REAL_PHOTO_CACHE:
        return _REAL_PHOTO_CACHE
    try:
        import matplotlib
        import matplotlib.image as mpimg
        import os
        p = os.path.join(matplotlib.get_data_path(), "sample_data",
                         "grace_hopper.jpg")
        img = mpimg.imread(p)
        if img is not None:
            _REAL_PHOTO_CACHE.append(np.asarray(img, np.uint8))
    except Exception:
        pass
    return _REAL_PHOTO_CACHE


def _value_noise(rng: np.random.Generator, hw, cells=8, lo=0.0, hi=1.0):
    """Smooth low-frequency noise field [H, W] via bilinear upsampling."""
    import cv2

    H, W = hw
    g = rng.uniform(lo, hi, (cells, cells)).astype(np.float32)
    return cv2.resize(g, (W, H), interpolation=cv2.INTER_CUBIC)


def _make_background(rng: np.random.Generator, hw,
                     family: Optional[int] = None) -> np.ndarray:
    """One background scene [H, W, 3] float32 (0..255).

    family: scene family index (see TRAIN_SCENE_FAMILIES above); None draws
    uniformly from families 0-2 (the earlier behavior, identical RNG
    stream)."""
    import cv2

    H, W = hw
    kind = int(family) if family is not None else int(rng.integers(0, 3))
    bg = np.zeros((H, W, 3), np.float32)
    if kind == 0:  # outdoor: sky gradient over textured grass + tree blobs
        horizon = int(H * rng.uniform(0.25, 0.55))
        sky_top = np.array([rng.uniform(120, 180), rng.uniform(160, 210),
                            rng.uniform(210, 250)])
        sky_bot = sky_top * rng.uniform(0.75, 0.95)
        ramp = np.linspace(0, 1, max(horizon, 1))[:, None, None]
        bg[:horizon] = sky_top + (sky_bot - sky_top) * ramp
        grass = np.array([rng.uniform(40, 80), rng.uniform(100, 150),
                          rng.uniform(30, 70)])
        bg[horizon:] = grass
        tex = _value_noise(rng, (H - horizon, W), cells=24, lo=0.8, hi=1.2)
        bg[horizon:] *= tex[..., None]
        for _ in range(rng.integers(0, 5)):  # distant trees / bushes
            cx, cy = rng.integers(0, W), horizon + rng.integers(-10, 25)
            r = int(rng.uniform(0.03, 0.10) * H)
            col = np.array([30, rng.uniform(60, 110), 35], np.float32)
            cv2.circle(bg, (int(cx), int(cy)), r, col.tolist(), -1)
    elif kind == 1:  # indoor range: wall + floor + mat
        wall = np.array([rng.uniform(120, 200)] * 3) * np.array(
            [1.0, rng.uniform(0.9, 1.05), rng.uniform(0.85, 1.05)])
        floor_y = int(H * rng.uniform(0.6, 0.8))
        bg[:floor_y] = wall
        bg[floor_y:] = wall * rng.uniform(0.45, 0.7)
        bg *= _value_noise(rng, (H, W), cells=12, lo=0.85, hi=1.15)[..., None]
        x0 = int(W * rng.uniform(0.1, 0.5))
        cv2.rectangle(bg, (x0, floor_y), (x0 + int(W * 0.35), H),
                      (rng.uniform(40, 90), rng.uniform(90, 140),
                       rng.uniform(40, 90)), -1)
    elif kind == 4:  # procedural clutter: multi-scale noise + random shapes
        tint = rng.uniform(0.6, 1.2, 3)
        bg = (_value_noise(rng, (H, W), cells=int(rng.integers(4, 16)),
                           lo=40, hi=200)[..., None] * tint).astype(np.float32)
        fine = _value_noise(rng, (H, W), cells=48, lo=0.75, hi=1.25)
        bg *= fine[..., None]
        for _ in range(rng.integers(8, 22)):
            col = tuple(float(v) for v in rng.uniform(20, 235, 3))
            sh = rng.integers(0, 3)
            if sh == 0:
                x0, y0 = rng.integers(0, W), rng.integers(0, H)
                cv2.rectangle(bg, (int(x0), int(y0)),
                              (int(x0 + rng.uniform(0.02, 0.25) * W),
                               int(y0 + rng.uniform(0.02, 0.25) * H)),
                              col, -1)
            elif sh == 1:
                cv2.circle(bg, (int(rng.integers(0, W)), int(rng.integers(0, H))),
                           int(rng.uniform(0.01, 0.12) * H), col, -1,
                           cv2.LINE_AA)
            else:
                cv2.line(bg, (int(rng.integers(0, W)), int(rng.integers(0, H))),
                         (int(rng.integers(0, W)), int(rng.integers(0, H))),
                         col, int(rng.uniform(1, 0.02 * H) + 1), cv2.LINE_AA)
        if rng.uniform() < 0.5:  # sometimes photo-like defocus
            k = 2 * int(rng.integers(1, 6)) + 1
            bg = cv2.GaussianBlur(bg, (k, k), 0)
    elif kind == 3:  # dusk: low sun, warm sky bands, dark textured ground
        horizon = int(H * rng.uniform(0.35, 0.6))
        # banded sunset sky: orange near the horizon fading to purple above
        top = np.array([rng.uniform(60, 100), rng.uniform(40, 70),
                        rng.uniform(100, 140)])          # purple
        bot = np.array([rng.uniform(220, 250), rng.uniform(120, 160),
                        rng.uniform(50, 90)])            # orange
        ramp = np.linspace(0, 1, max(horizon, 1))[:, None, None]
        bg[:horizon] = top + (bot - top) * ramp
        # sun disk just above the horizon
        sx = int(W * rng.uniform(0.1, 0.9))
        sy = horizon - int(H * rng.uniform(0.02, 0.12))
        cv2.circle(bg, (sx, sy), int(H * rng.uniform(0.03, 0.06)),
                   (255, 220, 160), -1, cv2.LINE_AA)
        ground = np.array([rng.uniform(30, 55), rng.uniform(35, 60),
                           rng.uniform(25, 45)])         # dim dusk grass
        bg[horizon:] = ground
        tex = _value_noise(rng, (H - horizon, W), cells=20, lo=0.7, hi=1.3)
        bg[horizon:] *= tex[..., None]
        for _ in range(rng.integers(1, 4)):  # tree silhouettes
            cx = rng.integers(0, W)
            r = int(rng.uniform(0.04, 0.12) * H)
            cv2.circle(bg, (int(cx), horizon - r // 2), r,
                       (15, 12, 20), -1, cv2.LINE_AA)
    else:  # cluttered real-photo composite (blurred, exposure-shifted)
        photos = _real_photos()
        if photos:
            img = photos[rng.integers(0, len(photos))]
            ph, pw = img.shape[:2]
            y0 = rng.integers(0, max(ph // 2, 1))
            x0 = rng.integers(0, max(pw // 2, 1))
            patch = img[y0: y0 + ph // 2, x0: x0 + pw // 2].astype(np.float32)
            bg = cv2.resize(patch, (W, H), interpolation=cv2.INTER_LINEAR)
            k = 2 * rng.integers(2, 8) + 1
            bg = cv2.GaussianBlur(bg, (k, k), 0) * rng.uniform(0.5, 1.0)
        else:  # pragma: no cover
            bg[:] = _value_noise(rng, (H, W), cells=6, lo=40, hi=180)[..., None]
    bg += rng.normal(0, 4.0, bg.shape)  # sensor noise
    return np.clip(bg, 0, 255)


def _shade(color, f):
    return tuple(float(np.clip(c * f, 0, 255)) for c in color)


def _draw_golfer(canvas: np.ndarray, kp: np.ndarray, look: dict,
                 alpha: float = 1.0) -> None:
    """Draw one golfer pose onto canvas (float32 RGB) with cv2 primitives.

    kp [17, 2] pixel coords.  `look` holds per-clip appearance.  alpha < 1
    blends the drawing (motion-blur ghost pass).
    """
    import cv2

    base = canvas.copy() if alpha < 1.0 else None
    mid_sh = (kp[5] + kp[6]) / 2
    mid_hip = (kp[11] + kp[12]) / 2
    scale = max(float(np.linalg.norm(mid_sh - mid_hip)), 4.0)
    skin, shirt, pants = look["skin"], look["shirt"], look["pants"]

    def capsule(a, b, r, color):
        pa, pb = tuple(np.int32(a)), tuple(np.int32(b))
        cv2.line(canvas, pa, pb, color, thickness=max(int(2 * r), 1),
                 lineType=cv2.LINE_AA)
        cv2.circle(canvas, pb, max(int(r), 1), color, -1, cv2.LINE_AA)

    # Painter's order: far(right)-side limbs, torso, near(left) limbs, head,
    # club.  Right side is shaded darker (consistent key light from the
    # golfer's left) — the only left/right cue, as in real footage.
    dark = look["side_shade"]
    # legs
    capsule(kp[12], kp[14], 0.13 * scale, _shade(pants, dark))
    capsule(kp[14], kp[16], 0.11 * scale, _shade(pants, dark))
    capsule(kp[11], kp[13], 0.13 * scale, pants)
    capsule(kp[13], kp[15], 0.11 * scale, pants)
    # shoes
    for ank, f in ((kp[16], dark), (kp[15], 1.0)):
        cv2.circle(canvas, tuple(np.int32(ank + [0.04 * scale, 0.05 * scale])),
                   max(int(0.09 * scale), 1), _shade(look["shoes"], f), -1,
                   cv2.LINE_AA)
    # torso quad (shoulders widened to hips)
    quad = np.stack([
        kp[5] + (kp[5] - kp[6]) * 0.18, kp[6] + (kp[6] - kp[5]) * 0.18,
        kp[12] + (kp[12] - kp[11]) * 0.22, kp[11] + (kp[11] - kp[12]) * 0.22,
    ]).astype(np.int32)
    cv2.fillConvexPoly(canvas, quad, shirt, cv2.LINE_AA)
    stripes = look.get("shirt_stripes")
    if stripes is not None:  # textured clothing (eval-only dusk family)
        mask = np.zeros(canvas.shape[:2], np.uint8)
        cv2.fillConvexPoly(mask, quad, 1)
        period = max(int(0.18 * scale), 2)
        y0, y1 = int(quad[:, 1].min()), int(quad[:, 1].max())
        band = np.zeros_like(mask)
        for y in range(y0, y1 + 1, 2 * period):
            band[max(y, 0): max(y + period, 0)] = 1
        canvas[(mask & band) > 0] = stripes
    # arms
    capsule(kp[6], kp[8], 0.10 * scale, _shade(shirt, dark))
    capsule(kp[8], kp[10], 0.08 * scale, _shade(skin, dark))
    capsule(kp[5], kp[7], 0.10 * scale, shirt)
    capsule(kp[7], kp[9], 0.08 * scale, skin)
    # hands
    for wr, f in ((kp[10], dark), (kp[9], 1.0)):
        cv2.circle(canvas, tuple(np.int32(wr)), max(int(0.07 * scale), 1),
                   _shade(skin, f), -1, cv2.LINE_AA)
    # head: skin ellipse oriented by the ear axis + hair/cap crescent
    head_c = (kp[1] + kp[2] + kp[3] + kp[4]) / 4
    ear_ax = kp[4] - kp[3]
    ang = float(np.degrees(np.arctan2(ear_ax[1], ear_ax[0])))
    axes = (max(int(0.30 * scale), 2), max(int(0.36 * scale), 2))
    cv2.ellipse(canvas, tuple(np.int32(head_c)), axes, ang, 0, 360, skin, -1,
                cv2.LINE_AA)
    cv2.ellipse(canvas, tuple(np.int32(head_c)), axes, ang, 180, 360,
                look["hair"], -1, cv2.LINE_AA)
    # subtle facial marks near the true eye/nose keypoints
    for j in (0, 1, 2):
        cv2.circle(canvas, tuple(np.int32(kp[j])),
                   max(int(0.035 * scale), 1), _shade(skin, 0.55), -1,
                   cv2.LINE_AA)
    # golf club: grip at mid-wrists, extending away from the shoulder centre
    grip = (kp[9] + kp[10]) / 2
    d = grip - mid_sh
    n = np.linalg.norm(d)
    if n > 1e-3:
        head_p = grip + d / n * look["club_len"] * scale
        cv2.line(canvas, tuple(np.int32(grip)), tuple(np.int32(head_p)),
                 (60, 60, 65), max(int(0.035 * scale), 1), cv2.LINE_AA)
        cv2.circle(canvas, tuple(np.int32(head_p)),
                   max(int(0.07 * scale), 1), (40, 40, 45), -1, cv2.LINE_AA)
    if base is not None:
        np.copyto(canvas, base * (1 - alpha) + canvas * alpha)


def render_frames_photo(
    sample: SwingSample,
    image_hw: tuple[int, int],
    rng: Optional[np.random.Generator] = None,
    camera_jitter: float = 0.0,
    occluder_prob: float = 0.5,
    scene_family: Optional[int] = None,
) -> SwingSample:
    """Adversarial photo-style rendering (see module comment above).

    camera_jitter: camera-shake amplitude as a fraction of image height
    (smooth random walk applied to the whole scene; ground-truth keypoints
    and boxes move with it — the moving-camera regime for box tracking).
    scene_family: force one scene family (see TRAIN_SCENE_FAMILIES); None
    draws from families 0-2 as before.  Family 3 (dusk) additionally gets
    a striped shirt, a warm color cast, and a vignette — appearance
    statistics absent from every training family.
    Returns the sample with frames AND keypoints/boxes updated to the
    jittered positions.
    """
    import cv2

    rng = rng or np.random.default_rng(0)
    H, W = image_hw
    T = sample.keypoints.shape[0]
    dusk = scene_family == EVAL_ONLY_SCENE_FAMILY

    look = dict(
        skin=tuple(float(c) for c in _SKIN_TONES[rng.integers(len(_SKIN_TONES))]),
        shirt=tuple(float(c) for c in _SHIRT_COLORS[rng.integers(len(_SHIRT_COLORS))]),
        pants=tuple(float(c) for c in _PANTS_COLORS[rng.integers(len(_PANTS_COLORS))]),
        shoes=(60.0, 55.0, 50.0),
        hair=tuple(float(c) for c in
                   ((40, 30, 25), (90, 70, 40), (200, 200, 205),
                    (25, 25, 28))[rng.integers(4)]),
        side_shade=float(rng.uniform(0.70, 0.85)),
        club_len=float(rng.uniform(1.2, 1.7)),
    )
    if dusk:
        look["shirt_stripes"] = tuple(
            float(c) for c in _SHIRT_COLORS[rng.integers(len(_SHIRT_COLORS))])

    bg = _make_background(rng, image_hw, scene_family)

    # occluders: drawn OVER the golfer (poles / bags), static per clip
    occluders = []
    if rng.uniform() < occluder_prob:
        for _ in range(rng.integers(1, 3)):
            if rng.uniform() < 0.5:  # vertical pole
                x = rng.integers(0, W)
                occluders.append(("pole", x, int(rng.uniform(0.01, 0.03) * W),
                                  tuple(float(v) for v in rng.uniform(30, 140, 3))))
            else:  # blob (bag / ball basket)
                occluders.append((
                    "blob", (int(rng.integers(0, W)),
                             int(rng.integers(int(H * 0.5), H))),
                    int(rng.uniform(0.04, 0.10) * H),
                    tuple(float(v) for v in rng.uniform(30, 160, 3))))

    # camera shake: smooth random walk, zero-mean
    if camera_jitter > 0:
        steps = rng.normal(0, camera_jitter * H * 0.25, (T, 2))
        shake = np.cumsum(steps, axis=0)
        shake -= shake.mean(axis=0)
        k = min(9, T if T % 2 else T - 1)
        if k >= 3:
            ker = np.ones(k) / k
            pad = k // 2
            for c in range(2):
                shake[:, c] = np.convolve(
                    np.pad(shake[:, c], pad, mode="edge"), ker, "valid")
    else:
        shake = np.zeros((T, 2))

    kpts_out = sample.keypoints.copy()
    frames = np.empty((T, H, W, 3), np.uint8)
    gain_t = 1.0 + 0.04 * _value_noise(rng, (1, T), cells=4, lo=-1, hi=1)[0]
    if dusk:  # golden-hour color cast + lens vignette, constant per clip
        cast = np.array([rng.uniform(1.05, 1.2), rng.uniform(0.9, 1.0),
                         rng.uniform(0.65, 0.85)], np.float32)
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        r2 = (((xx - W / 2) / (W / 2)) ** 2 + ((yy - H / 2) / (H / 2)) ** 2)
        vignette = (1.0 - float(rng.uniform(0.25, 0.45)) * r2 / 2)[..., None]
    blur_thresh = 0.12 * H  # wrist travel/frame above this gets motion blur
    for t in range(T):
        off = shake[t]
        kp = sample.keypoints[t, :, :2] + off
        kpts_out[t, :, :2] = kp
        canvas = np.roll(bg, (int(off[1]), int(off[0])), axis=(0, 1)).copy()
        # ground shadow under the ankles
        feet = (kp[15] + kp[16]) / 2
        mid_sh = (kp[5] + kp[6]) / 2
        sc = max(float(np.linalg.norm(mid_sh - (kp[11] + kp[12]) / 2)), 4.0)
        if feet[1] < H:
            mask = np.zeros((H, W), np.uint8)
            cv2.ellipse(mask, (int(feet[0]), int(feet[1] + 0.12 * sc)),
                        (int(0.9 * sc), int(0.16 * sc)), 0, 0, 360, 1, -1)
            canvas[mask > 0] *= 0.65
        if t > 0:
            travel = float(np.linalg.norm(
                sample.keypoints[t, 9, :2] - sample.keypoints[t - 1, 9, :2]))
            if travel > blur_thresh:  # ghost pass at the midpoint pose
                mid = (sample.keypoints[t, :, :2]
                       + sample.keypoints[t - 1, :, :2]) / 2 + off
                _draw_golfer(canvas, mid, look, alpha=0.35)
        _draw_golfer(canvas, kp, look)
        for occ in occluders:
            if occ[0] == "pole":
                _, x, w_, col = occ
                xs = int(x + off[0])
                cv2.rectangle(canvas, (xs, 0), (xs + w_, H), col, -1)
            else:
                _, (cx, cy), r, col = occ
                cv2.circle(canvas, (int(cx + off[0]), int(cy + off[1])), r,
                           col, -1, cv2.LINE_AA)
        canvas *= gain_t[t]
        if dusk:
            canvas = canvas * cast * vignette
        frames[t] = np.clip(canvas, 0, 255).astype(np.uint8)

    # recompute boxes from the jittered keypoints
    xy = kpts_out[..., :2]
    lo, hi = xy.min(axis=1), xy.max(axis=1)
    c = (lo + hi) / 2
    wh = (hi - lo) * 1.15
    boxes = np.concatenate([c, wh], axis=-1).astype(np.float32)
    return dataclasses.replace(sample, frames=frames,
                               keypoints=kpts_out.astype(np.float32),
                               boxes=boxes)


def make_fault_balanced_batch(
    per_fault: int,
    num_frames: int,
    seed: int = 0,
    image_hw: Optional[tuple[int, int]] = None,
    render: bool = False,
    sev_range: tuple[float, float] = (0.6, 1.0),
    clean: Optional[int] = None,
    scene_families: Optional[tuple] = None,
) -> list[SwingSample]:
    """Stratified eval/calibration set: `per_fault` single-fault clips for
    EVERY fault plus `clean` fault-free clips.

    Random fault draws (make_swing_batch) routinely leave a fault with zero
    positives in a small set, making per-fault metrics/thresholds
    meaningless (measured: two faults scored F1 0.00 purely because the
    24-clip calibration contained no examples of them).
    """
    return list(iter_fault_balanced(per_fault, num_frames, seed, image_hw, render, sev_range,
                                    clean, scene_families))


def iter_fault_balanced(
    per_fault: int,
    num_frames: int,
    seed: int = 0,
    image_hw: Optional[tuple[int, int]] = None,
    render: bool = False,
    sev_range: tuple[float, float] = (0.6, 1.0),
    clean: Optional[int] = None,
    scene_families: Optional[tuple] = None,
) -> Iterator[SwingSample]:
    """The clips of `make_fault_balanced_batch`, one at a time (the same
    draws in the same order), so that only one clip's frames are held."""
    clean = per_fault if clean is None else clean
    rng = np.random.default_rng(seed)
    specs = [
        {str(name): float(rng.uniform(*sev_range))}
        for name in cfg_mod.SWING_ERRORS
        for _ in range(per_fault)
    ] + [{} for _ in range(clean)]
    for i, faults in enumerate(specs):
        s = swing_keypoints(
            num_frames, np.random.default_rng(seed + 7919 * (i + 1)),
            tempo_warp=float(rng.uniform(-0.8, 0.8)), faults=faults,
        )
        if image_hw is not None:
            s = place_in_image(s, image_hw,
                               person_height_px=0.65 * image_hw[0], rng=rng)
            if render:
                fam = (int(rng.choice(scene_families))
                       if scene_families is not None else None)
                s = render_frames_photo(s, image_hw, rng=rng, scene_family=fam)
        yield s


def progress_align_reference(
    sample: SwingSample, ref: SwingSample
) -> np.ndarray:
    """Warp a reference swing onto a sample's timeline via true progress.

    Ground-truth version of the runtime's DTW-path warp
    (ops.softdtw.warp_by_path): for each sample frame t, the reference frame
    with the nearest swing progress.  Returns keypoints [T, V, 3].
    """
    j = np.abs(
        ref.progress[None, :] - sample.progress[:, None]
    ).argmin(axis=1)
    return ref.keypoints[j]


def make_swing_batch(
    batch: int,
    num_frames: int,
    seed: int = 0,
    fault_prob: float = 0.35,
    image_hw: Optional[tuple[int, int]] = None,
    render: bool = False,
    render_style: str = "photo",
    camera_jitter: float = 0.0,
    sev_range: tuple[float, float] = (0.6, 1.0),
    scene_families: Optional[tuple] = None,
    arm_wander: float = 0.0,
) -> list[SwingSample]:
    """Batch of varied swings (tempo, style, faults); optionally rendered.

    render_style: "photo" (adversarial photo-style scenes — the training
    default) or "blob" (the simple bright-marker renderer, kept for cheap
    motion-energy fixtures).  camera_jitter only applies to "photo".
    scene_families: restrict photo scenes to these families (training must
    pass TRAIN_SCENE_FAMILIES — cross-domain holdout); None = families 0-2.
    sev_range: fault severity draw; training streams widen the lower end
    (e.g. 0.3) because the pose front ATTENUATES fault deflections
    per-joint (measured: hips pass only ~0.43x of a hanging_back shift),
    so runtime patterns look like milder faults than the generator's.
    """
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        faults = {}
        if rng.uniform() < fault_prob:
            k = rng.integers(1, 3)
            for name in rng.choice(cfg_mod.SWING_ERRORS, size=k, replace=False):
                faults[str(name)] = float(rng.uniform(*sev_range))
        s = swing_keypoints(
            num_frames, rng,
            tempo_warp=float(rng.uniform(-0.8, 0.8)),
            faults=faults,
            arm_wander=arm_wander,
        )
        if image_hw is not None:
            s = place_in_image(s, image_hw, person_height_px=0.65 * image_hw[0], rng=rng)
            if render:
                if render_style == "photo":
                    fam = (int(rng.choice(scene_families))
                           if scene_families is not None else None)
                    s = render_frames_photo(s, image_hw, rng=rng,
                                            camera_jitter=camera_jitter,
                                            scene_family=fam)
                else:
                    s = render_frames(s, image_hw, joint_radius=max(3.0, 0.01 * image_hw[0]), rng=rng)
        out.append(s)
    return out
