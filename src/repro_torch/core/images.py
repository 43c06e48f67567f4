"""Synthetic structured test images: a copy of ``repro.core.images``.

The paper's Lena and Cable-car images are not available offline, so the
reference synthesises a smooth, low-frequency image (``lena_like``) and an
edge-rich one (``cablecar_like``).  The port keeps its own copy so that it
imports nothing of ``repro``; the arrays are identical.
"""

from __future__ import annotations

import numpy as np


def _grid(h: int, w: int):
    y = np.linspace(0.0, 1.0, h, endpoint=False)[:, None]
    x = np.linspace(0.0, 1.0, w, endpoint=False)[None, :]
    return y, x


def lena_like(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth, low-frequency-dominated grayscale image (uint8)."""
    rng = np.random.default_rng(seed)
    y, x = _grid(h, w)
    img = np.zeros((h, w), dtype=np.float64)
    # large-scale luminance field: a few gaussian blobs
    for _ in range(6):
        cy, cx = rng.uniform(0.1, 0.9, size=2)
        sy, sx = rng.uniform(0.08, 0.35, size=2)
        amp = rng.uniform(-90.0, 110.0)
        img += amp * np.exp(-((y - cy) ** 2 / (2 * sy ** 2)
                              + (x - cx) ** 2 / (2 * sx ** 2)))
    # gentle sweeping gradient
    img += 60.0 * (0.5 * y + 0.5 * x)
    # soft sinusoidal texture (hair/feathers analogue)
    img += 9.0 * np.sin(2 * np.pi * (7 * x + 2 * y))
    img += 6.0 * np.sin(2 * np.pi * (3 * x - 9 * y))
    # mild sensor noise
    img += rng.normal(0.0, 2.0, size=(h, w))
    img = img - img.min()
    img = 235.0 * img / max(img.max(), 1e-9) + 12.0
    return np.clip(img, 0, 255).astype(np.uint8)


def cablecar_like(h: int, w: int, seed: int = 1) -> np.ndarray:
    """Edge-rich grayscale image with strong high-frequency energy (uint8)."""
    rng = np.random.default_rng(seed)
    y, x = _grid(h, w)
    img = 110.0 + 70.0 * y  # sky-to-ground gradient
    # hard-edged "buildings": rectangles of random intensity
    for _ in range(24):
        y0, x0 = rng.uniform(0.0, 0.85, size=2)
        hh, ww = rng.uniform(0.04, 0.3, size=2)
        amp = rng.uniform(-80.0, 80.0)
        mask = ((y >= y0) & (y < y0 + hh)) * ((x >= x0) & (x < x0 + ww))
        img = img + amp * mask
    # cable lines: thin high-contrast diagonals
    for k in range(5):
        d = np.abs((y - 0.15 - 0.12 * k) - 0.35 * x)
        img = img - 70.0 * (d < 0.004)
    # high-frequency texture + noise
    img = img + 14.0 * np.sign(np.sin(2 * np.pi * (23 * x + 17 * y)))
    img = img + rng.normal(0.0, 4.0, size=(h, w))
    img = img - img.min()
    img = 243.0 * img / max(img.max(), 1e-9) + 6.0
    return np.clip(img, 0, 255).astype(np.uint8)


# Image sizes from the paper's tables.
LENA_SIZES = [(3072, 3072), (2048, 2048), (1600, 1400), (1024, 814),
              (576, 720), (512, 512), (200, 200)]
CABLECAR_SIZES = [(544, 512), (512, 480), (448, 416), (384, 352), (320, 288)]
