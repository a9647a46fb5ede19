"""Deterministic procedural video fixtures — the stand-in datasets.

The port's own copy of ``eov_tpu/data/fixtures.py`` (numpy only), so the
two packages render the same uint8 clips from the same arguments.

SURVEY.md §2d: real video data (Kinetics-100, UCF101, UnrealAction) is not
present in the build environment, so every config in BASELINE.json:6-12 must
be exercisable on synthetic clips. Clips are procedurally generated, fully
determined by (class_id, clip_id, frame): each class gets a distinct
spatial grating frequency/orientation and motion velocity, each clip a
random phase — so clips of one class are near each other in any reasonable
feature space (random-projection backbones included) and episodes are
learnable, while generation is pure vectorized numpy (no decode deps).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_clip", "synthetic_virtual_clip", "class_motion_params"]


def class_motion_params(class_id: int) -> dict:
    """Per-class grating + motion parameters (deterministic)."""
    rng = np.random.default_rng(1_000_003 * (class_id + 1))
    return {
        "fx": rng.uniform(1.0, 6.0),          # cycles across width
        "fy": rng.uniform(1.0, 6.0),          # cycles across height
        "velocity": rng.uniform(0.05, 0.5),   # cycles per frame
        # Sparse color signature (Dirichlet): class identity must survive the
        # per-clip random phase, so the phase-invariant DC color carries most
        # of the class information (the grating adds structured variation).
        "hue": 0.15 + 0.85 * rng.dirichlet(np.full(3, 0.5)),
    }


def synthetic_clip(
    class_id: int,
    clip_id: int,
    num_frames: int,
    height: int = 128,
    width: int = 160,
) -> np.ndarray:
    """uint8 [F, H, W, 3] procedural clip, deterministic in all arguments."""
    p = class_motion_params(class_id)
    rng = np.random.default_rng((class_id + 1) * 7_368_787 + clip_id)
    phase = rng.uniform(0.0, 1.0)
    # Per-clip mild appearance jitter keeps clips distinct within a class.
    amp = rng.uniform(0.7, 1.0)

    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    t = np.arange(num_frames, dtype=np.float32)[:, None, None]

    arg = 2.0 * np.pi * (
        p["fx"] * x + p["fy"] * y + p["velocity"] * t + phase
    )  # [F, H, W]
    base = 0.75 + 0.25 * amp * np.sin(arg)  # DC-dominant: phase-robust
    frames = base[..., None] * p["hue"][None, None, None, :]  # [F, H, W, 3]

    # Moving bright square (class-dependent trajectory) on top.
    cx = (0.2 + 0.6 * ((p["velocity"] * t[:, 0, 0] + phase) % 1.0)) * width
    cy = (0.3 + 0.4 * ((0.5 * p["velocity"] * t[:, 0, 0]) % 1.0)) * height
    half = max(3, height // 10)
    for f in range(num_frames):
        y0, y1 = int(max(0, cy[f] - half)), int(min(height, cy[f] + half))
        x0, x1 = int(max(0, cx[f] - half)), int(min(width, cx[f] + half))
        frames[f, y0:y1, x0:x1] = 1.0 - 0.5 * frames[f, y0:y1, x0:x1]

    return np.clip(frames * 255.0, 0, 255).astype(np.uint8)


def synthetic_virtual_clip(
    class_id: int,
    clip_id: int,
    num_frames: int,
    height: int = 128,
    width: int = 160,
) -> np.ndarray:
    """Virtual-agent rendering of the same action class (UnrealAction analog).

    Same class signature (grating params + hue, so real and virtual clips of
    a class are feature-space neighbors) but a distinct rendering domain —
    clean/high-contrast, no appearance jitter, no occluding square, inverted
    background — modelling the paper's game-engine clips: noiseless
    renders of the same actions (SURVEY.md §2d, C9).
    """
    p = class_motion_params(class_id)
    rng = np.random.default_rng((class_id + 1) * 15_485_863 + clip_id)
    phase = rng.uniform(0.0, 1.0)

    y = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    t = np.arange(num_frames, dtype=np.float32)[:, None, None]
    arg = 2.0 * np.pi * (
        p["fx"] * x + p["fy"] * y + p["velocity"] * t + phase
    )
    # High-contrast clean render: square-ish wave, no jitter, no occluder.
    base = 0.65 + 0.35 * np.tanh(3.0 * np.sin(arg))
    frames = base[..., None] * p["hue"][None, None, None, :]
    return np.clip(frames * 255.0, 0, 255).astype(np.uint8)
