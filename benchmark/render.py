"""Synthetic 1080p golf-swing clips for the benchmark's traffic: a
parametric swing skeleton (phases, tempo, style, injected faults) drawn as
a clothed golfer with a club over an outdoor, indoor-range or cluttered
backdrop, with occluders, lighting drift and motion blur.  Host numpy and
OpenCV, seeded by a numpy Generator; nothing of the system under test.

`render_swing(seed, frames, image_hw)` gives one clip: frames [T, H, W, 3]
uint8, keypoints [T, 17, 3] and person boxes [T, 4] (cx, cy, w, h).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Optional

import numpy as np

COCO_KEYPOINTS = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear", "left_shoulder",
    "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
    "left_hip", "right_hip", "left_knee", "right_knee", "left_ankle", "right_ankle",
)
SWING_PHASES = ("background", "address", "takeaway", "backswing", "top", "downswing",
                "impact", "follow_through", "finish")
SWING_ERRORS = ("swaying", "hanging_back", "early_extension", "over_the_top", "casting",
                "reverse_spine", "chicken_wing", "head_movement")
# Scene families drawn: outdoor, indoor range, procedural clutter.
SCENE_FAMILIES = (0, 1, 4)
RENDER_THREADS = 4


@dataclasses.dataclass(frozen=True)
class SwingSample:
    keypoints: np.ndarray
    phase_labels: np.ndarray
    error_flags: np.ndarray
    frames: Optional[np.ndarray] = None
    boxes: Optional[np.ndarray] = None


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


def _phase_curve(t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Map clip progress t∈[0,1] -> (theta, phase_index [T])."""
    bounds = np.cumsum([0.0] + [f for _, f in _PHASE_SCHEDULE])
    names = [n for n, _ in _PHASE_SCHEDULE]
    theta = np.zeros_like(t)
    labels = np.zeros(len(t), np.int32)
    keys = list(SWING_PHASES)
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
) -> SwingSample:
    """Generate one swing in the unit body frame (no rendering).

    tempo_warp in [-1, 1]: power-law time warp (slow-start vs fast-start),
    the ground-truth correspondence used by alignment training.
    faults: {error_name: severity} perturbations matching config.SWING_ERRORS.
    """
    V = len(COCO_KEYPOINTS)
    t_lin = np.linspace(0, 1, num_frames)
    power = 2.0 ** tempo_warp
    t = t_lin**power
    theta, labels = _phase_curve(t)

    base = np.array([_ADDRESS[n] for n in COCO_KEYPOINTS], np.float64)
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
    E = len(SWING_ERRORS)
    flags = np.zeros(E, np.float32)
    faults = faults or {}
    back = theta < -0.1     # backswing side frames
    down = (theta > -1.0) & (theta < 0.3)
    for name, sev in faults.items():
        e = SWING_ERRORS.index(name)
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

    # Measurement noise.    # Measurement noise.
    kpts += rng.normal(0, noise, kpts.shape)
    vis = np.ones((num_frames, V, 1))
    return SwingSample(
        keypoints=np.concatenate([kpts, vis], axis=-1).astype(np.float32),
        phase_labels=labels.astype(np.int32),
        error_flags=flags,
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
    return dataclasses.replace(sample, keypoints=kpts, boxes=boxes)


_SKIN_TONES = ((242, 206, 176), (224, 177, 132), (198, 134, 94),
               (141, 85, 56), (96, 57, 36))
_SHIRT_COLORS = ((200, 40, 40), (40, 90, 200), (240, 240, 240), (30, 30, 34),
                 (230, 180, 40), (60, 160, 80), (150, 60, 160), (90, 90, 95))
_PANTS_COLORS = ((40, 40, 46), (110, 110, 118), (160, 140, 110),
                 (235, 235, 235), (50, 60, 100))


def _value_noise(rng: np.random.Generator, hw, cells=8, lo=0.0, hi=1.0):
    """Smooth low-frequency noise field [H, W] via bilinear upsampling."""
    import cv2

    H, W = hw
    g = rng.uniform(lo, hi, (cells, cells)).astype(np.float32)
    return cv2.resize(g, (W, H), interpolation=cv2.INTER_CUBIC)


def _make_background(rng: np.random.Generator, hw, family: int) -> np.ndarray:
    """One background scene [H, W, 3] float32 (0..255).

    family: 0 outdoor, 1 indoor range, 4 procedural clutter."""
    import cv2

    H, W = hw
    kind = int(family)
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
    else:
        raise ValueError(f"scene family {kind}: one of {SCENE_FAMILIES}")
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


def render_frames_photo(sample: SwingSample, image_hw: tuple[int, int],
                        rng: np.random.Generator, scene_family: int,
                        occluder_prob: float = 0.5) -> SwingSample:
    """Photo-style frames of a placed swing from a static camera: a clothed
    golfer with a club over a backdrop of `scene_family`, occluders drawn
    over the golfer, lighting drift, a motion-blur ghost on fast frames."""
    import cv2

    H, W = image_hw
    T = sample.keypoints.shape[0]
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

    frames = np.empty((T, H, W, 3), np.uint8)
    gain_t = 1.0 + 0.04 * _value_noise(rng, (1, T), cells=4, lo=-1, hi=1)[0]
    blur_thresh = 0.12 * H  # wrist travel/frame above this gets motion blur

    def draw(t):
        kp = sample.keypoints[t, :, :2]
        canvas = bg.copy()
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
                mid = (sample.keypoints[t, :, :2] + sample.keypoints[t - 1, :, :2]) / 2
                _draw_golfer(canvas, mid, look, alpha=0.35)
        _draw_golfer(canvas, kp, look)
        for occ in occluders:
            if occ[0] == "pole":
                _, x, w_, col = occ
                cv2.rectangle(canvas, (int(x), 0), (int(x) + w_, H), col, -1)
            else:
                _, (cx, cy), r, col = occ
                cv2.circle(canvas, (int(cx), int(cy)), r, col, -1, cv2.LINE_AA)
        canvas *= gain_t[t]
        frames[t] = np.clip(canvas, 0, 255).astype(np.uint8)

    # Frames draw no random numbers: they are drawn on a few threads at once
    # (numpy and OpenCV release the interpreter lock), each the same bits.
    with concurrent.futures.ThreadPoolExecutor(max_workers=RENDER_THREADS) as ex:
        list(ex.map(draw, range(T)))
    # Boxes from the float32 keypoints, as the person box of each frame.
    xy = sample.keypoints[..., :2]
    lo, hi = xy.min(axis=1), xy.max(axis=1)
    boxes = np.concatenate([(lo + hi) / 2, (hi - lo) * 1.15], axis=-1).astype(np.float32)
    return dataclasses.replace(sample, frames=frames, boxes=boxes)


def render_swing(seed: int, num_frames: int, image_hw, fault_prob: float = 0.35) -> SwingSample:
    """One rendered swing drawn from `seed` (tempo, style, faults, look, scene)."""
    rng = np.random.default_rng(seed)
    faults = {}
    if rng.uniform() < fault_prob:
        for name in rng.choice(SWING_ERRORS, size=rng.integers(1, 3), replace=False):
            faults[str(name)] = float(rng.uniform(0.6, 1.0))
    s = swing_keypoints(num_frames, rng, tempo_warp=float(rng.uniform(-0.8, 0.8)),
                        faults=faults)
    s = place_in_image(s, tuple(image_hw), person_height_px=0.65 * image_hw[0], rng=rng)
    return render_frames_photo(s, tuple(image_hw), rng=rng,
                               scene_family=int(rng.choice(SCENE_FAMILIES)))
