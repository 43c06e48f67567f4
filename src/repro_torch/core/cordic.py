"""CORDIC plane rotations: the paper's "Cordic based" ingredient.

A copy of ``repro.core.cordic``.  Each of the Loeffler graph's three plane
rotations becomes a short sequence of micro-rotations by ``2^-k`` plus a
signed power-of-two approximation of the ``1/K`` gain; with
``fixed_point_bits`` set, every micro-rotation result and every stage
output is rounded to the grid of step ``2^(12 - bits)``.  The schedule of
each static angle is resolved in Python, so the CUDA kernels receive it as
plain arguments.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch


@dataclasses.dataclass(frozen=True)
class CordicConfig:
    """Approximation budget for the CORDIC rotations.

    iterations: number of micro-rotations.
    gain_terms: number of signed power-of-two terms approximating 1/K.
    fixed_point_bits: word length of the emulated fixed-point datapath
      (grid step ``2^(12 - bits)``), or None for a float datapath.
    """
    iterations: int = 4
    gain_terms: int = 3
    fixed_point_bits: int | None = None


# The paper-faithful low-power configuration...
PAPER_CONFIG = CordicConfig(iterations=4, gain_terms=3, fixed_point_bits=8)
# ...and a high-precision configuration for sanity checks.
EXACT_CONFIG = CordicConfig(iterations=24, gain_terms=24,
                            fixed_point_bits=None)


@functools.lru_cache(maxsize=None)
def _schedule(theta: float, iterations: int, gain_terms: int):
    """Greedy CORDIC schedule for a static angle.

    Returns (sigmas, shifts, gain_approx): the micro-rotation signs, their
    2^-k shift amounts, and the shift-add approximation of 1/K.
    """
    z = theta
    sigmas, shifts = [], []
    for k in range(iterations):
        sigma = 1.0 if z >= 0 else -1.0
        z -= sigma * math.atan(2.0 ** -k)
        sigmas.append(sigma)
        shifts.append(2.0 ** -k)
    gain = 1.0
    for k in range(iterations):
        gain *= math.sqrt(1.0 + 4.0 ** -k)
    # Greedy signed power-of-two expansion of 1/K.
    target = 1.0 / gain
    approx = 0.0
    for _ in range(gain_terms):
        resid = target - approx
        if resid == 0.0:
            break
        mag = abs(resid)
        p = round(math.log2(mag))
        best = min((2.0 ** (p - 1), 2.0 ** p, 2.0 ** (p + 1)),
                   key=lambda c: abs(mag - c))
        approx += math.copysign(best, resid)
    return tuple(sigmas), tuple(shifts), approx


def grid_step(config: CordicConfig) -> float:
    """Fixed-point grid step ``2^(12 - bits)``; 0.0 for a float datapath."""
    if config.fixed_point_bits is None:
        return 0.0
    return 2.0 ** (12 - config.fixed_point_bits)


def fixed_quantizer(config: CordicConfig):
    """Stage-output rounding to the fixed-point grid, or None (float path)."""
    step = grid_step(config)
    if step == 0.0:
        return None
    inv = 1.0 / step

    def quantize(x):
        return torch.round(x * inv) * step
    return quantize


def cordic_rotate(u: torch.Tensor, v: torch.Tensor, theta: float,
                  config: CordicConfig = PAPER_CONFIG):
    """Approximate (u, v) -> (u cos(theta) + v sin(theta),
    -u sin(theta) + v cos(theta)), same convention as
    :func:`repro_torch.core.loeffler.exact_rotate`.

    The float32 arithmetic follows the reference step for step: the
    shift and the gain are float32 constants, and each product is
    rounded before the sum.
    """
    sigmas, shifts, gain = _schedule(float(theta), config.iterations,
                                     config.gain_terms)
    quantize = fixed_quantizer(config) or (lambda t: t)
    for sigma, shift in zip(sigmas, shifts):
        # rotation by -theta: invert sigma relative to canonical CORDIC
        s = -sigma * shift
        u, v = quantize(u - s * v), quantize(v + s * u)
    return quantize(u * gain), quantize(v * gain)


def make_cordic_rotate(config: CordicConfig = PAPER_CONFIG):
    """rotate_fn factory compatible with ``loeffler.RotateFn``."""
    def rotate(u, v, theta):
        return cordic_rotate(u, v, theta, config)
    return rotate
