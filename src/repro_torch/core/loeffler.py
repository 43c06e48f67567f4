"""Loeffler 8-point DCT flow graph and its transpose (a copy of
``repro.core.loeffler``).

Four serial stages, parallel inside each stage.  ``rotate_fn`` selects the
exact plane rotation or the CORDIC one, and ``quantize_fn`` rounds every
stage output to the fixed-point grid.  The order of every float32
operation follows the reference, so the CORDIC variant is bit-exact
against it; the CUDA kernels in ``repro_torch/kernels/csrc`` repeat the
same order.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

# Rotation angles used by the graph.
THETA_ODD_A = 3.0 * math.pi / 16.0   # rotates (d3, d0)
THETA_ODD_B = 1.0 * math.pi / 16.0   # rotates (d2, d1)
THETA_EVEN = math.pi / 8.0           # rotates (b2, b3) -> (X2, X6)

_SQRT2 = math.sqrt(2.0)
_INV_2SQRT2 = 1.0 / (2.0 * _SQRT2)


def exact_rotate(u: torch.Tensor, v: torch.Tensor, theta: float):
    """Plane rotation: (u, v) -> (u cos + v sin, -u sin + v cos)."""
    c, s = math.cos(theta), math.sin(theta)
    return u * c + v * s, -u * s + v * c


RotateFn = Callable[[torch.Tensor, torch.Tensor, float], tuple]


def _identity(t):
    return t


def loeffler_dct8(x: torch.Tensor, axis: int = -1,
                  rotate_fn: RotateFn = exact_rotate,
                  quantize_fn=None) -> torch.Tensor:
    """Orthonormal 8-point DCT-II along ``axis`` via the Loeffler graph."""
    q = quantize_fn or _identity
    x = torch.movedim(x, axis, 0)
    if x.shape[0] != 8:
        raise ValueError(f"loeffler_dct8 needs length-8 axis, got {x.shape}")
    x0, x1, x2, x3, x4, x5, x6, x7 = x.unbind(0)

    # stage 1: butterflies
    a0 = q(x0 + x7)
    a1 = q(x1 + x6)
    a2 = q(x2 + x5)
    a3 = q(x3 + x4)
    d3 = q(x3 - x4)
    d2 = q(x2 - x5)
    d1 = q(x1 - x6)
    d0 = q(x0 - x7)

    # stage 2: even butterflies, odd rotations
    b0 = q(a0 + a3)
    b1 = q(a1 + a2)
    b2 = q(a1 - a2)
    b3 = q(a0 - a3)
    r4, r7 = rotate_fn(d3, d0, THETA_ODD_A)
    r5, r6 = rotate_fn(d2, d1, THETA_ODD_B)

    # stage 3: even output butterfly + rotation, odd butterflies
    y0 = q(b0 + b1)
    y4 = q(b0 - b1)
    c4 = q(r4 + r6)
    c5 = q(r7 - r5)
    c6 = q(r4 - r6)
    c7 = q(r7 + r5)
    # z2 = b3 c + b2 s = 2 X2;  z6 = -b3 s + b2 c = -2 X6
    z2, z6 = rotate_fn(b3, b2, THETA_EVEN)

    # stage 4: output scalings
    out = [None] * 8
    out[0] = q(y0 * _INV_2SQRT2)
    out[4] = q(y4 * _INV_2SQRT2)
    out[2] = q(z2 * 0.5)
    out[6] = q(-z6 * 0.5)
    out[1] = q((c4 + c7) * _INV_2SQRT2)
    out[7] = q((c7 - c4) * _INV_2SQRT2)
    out[3] = q(c5 * 0.5)
    out[5] = q(c6 * 0.5)
    return torch.movedim(torch.stack(out, 0), 0, axis)


def loeffler_idct8(y: torch.Tensor, axis: int = -1,
                   rotate_fn: RotateFn = exact_rotate,
                   quantize_fn=None) -> torch.Tensor:
    """Inverse (DCT-III) via the transposed graph: stages reversed,
    butterflies transposed, rotations by the negated angles."""
    q = quantize_fn or _identity
    y = torch.movedim(y, axis, 0)
    if y.shape[0] != 8:
        raise ValueError(f"loeffler_idct8 needs length-8 axis, got {y.shape}")
    Y0, Y1, Y2, Y3, Y4, Y5, Y6, Y7 = y.unbind(0)

    # transpose of stage 4
    y0 = q(Y0 * _INV_2SQRT2)
    y4 = q(Y4 * _INV_2SQRT2)
    c4 = q((Y1 - Y7) * _INV_2SQRT2)
    c7 = q((Y1 + Y7) * _INV_2SQRT2)
    c5 = q(Y3 * 0.5)
    c6 = q(Y5 * 0.5)
    z2 = q(Y2 * 0.5)
    z6 = q(-Y6 * 0.5)

    # transpose of stage 3
    b0 = q(y0 + y4)
    b1 = q(y0 - y4)
    # (z2, z6) = R(t) @ (b3, b2)  =>  (b3, b2) = R(-t) @ (z2, z6)
    b3, b2 = rotate_fn(z2, z6, -THETA_EVEN)
    r4 = q(c4 + c6)
    r6 = q(c4 - c6)
    r7 = q(c7 + c5)
    r5 = q(c7 - c5)

    # transpose of stage 2
    a0 = q(b0 + b3)
    a3 = q(b0 - b3)
    a1 = q(b1 + b2)
    a2 = q(b1 - b2)
    d3, d0 = rotate_fn(r4, r7, -THETA_ODD_A)
    d2, d1 = rotate_fn(r5, r6, -THETA_ODD_B)

    # transpose of stage 1
    x0 = q(a0 + d0)
    x7 = q(a0 - d0)
    x1 = q(a1 + d1)
    x6 = q(a1 - d1)
    x2 = q(a2 + d2)
    x5 = q(a2 - d2)
    x3 = q(a3 + d3)
    x4 = q(a3 - d3)
    x = torch.stack([x0, x1, x2, x3, x4, x5, x6, x7], 0)
    return torch.movedim(x, 0, axis)


def loeffler_dct2d_8x8(blocks: torch.Tensor,
                       rotate_fn: RotateFn = exact_rotate,
                       quantize_fn=None) -> torch.Tensor:
    """2-D 8x8 DCT on (..., 8, 8) blocks: rows first, then columns."""
    once = loeffler_dct8(blocks, axis=-1, rotate_fn=rotate_fn,
                         quantize_fn=quantize_fn)
    return loeffler_dct8(once, axis=-2, rotate_fn=rotate_fn,
                         quantize_fn=quantize_fn)


def loeffler_idct2d_8x8(coeffs: torch.Tensor,
                        rotate_fn: RotateFn = exact_rotate,
                        quantize_fn=None) -> torch.Tensor:
    """Inverse of :func:`loeffler_dct2d_8x8`: columns first, then rows."""
    once = loeffler_idct8(coeffs, axis=-2, rotate_fn=rotate_fn,
                          quantize_fn=quantize_fn)
    return loeffler_idct8(once, axis=-1, rotate_fn=rotate_fn,
                          quantize_fn=quantize_fn)
