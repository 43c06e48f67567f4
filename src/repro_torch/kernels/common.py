"""Helpers shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import cordic, dct, loeffler, quant


def edge_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Append ``ph`` rows and ``pw`` columns to the last two axes by
    repeating the last row and column (NumPy's ``mode="edge"``).

    Works for every dtype (uint8 included), on any device.
    """
    if ph:
        x = torch.cat([x, x[..., -1:, :].expand(*x.shape[:-2], ph,
                                                 x.shape[-1])], dim=-2)
    if pw:
        x = torch.cat([x, x[..., -1:].expand(*x.shape[:-1], pw)], dim=-1)
    return x


def pad2d_to_multiple(x: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """Edge-pad the last two dims up to multiples of (mh, mw); the input
    itself when no padding is needed."""
    h, w = x.shape[-2:]
    return edge_pad(x, (-h) % mh, (-w) % mw)


def as_batch(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> contiguous (N, H, W) with N the product of the
    leading axes (1 for a single image), 16-byte aligned for the
    kernels' vector accesses."""
    xb = x.reshape(-1, *x.shape[-2:]).contiguous()
    return xb.clone() if xb.data_ptr() % 16 else xb


def check_cuda_input(x: torch.Tensor, name: str, dtype=torch.float32):
    """Raise unless ``x`` is a contiguous (N, H, W) CUDA tensor of
    ``dtype`` with H and W positive multiples of 8, fitting int32 indexing.
    """
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (N, H, W) tensor, "
                         f"got shape {tuple(x.shape)}")
    n, h, w = x.shape
    if n < 1 or h < 8 or w < 8 or h % 8 or w % 8:
        raise ValueError(f"{name}: H and W must be positive multiples of 8, "
                         f"got {tuple(x.shape)}")
    if n > 65535 or h * w >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(x.shape)} exceeds the "
                         f"kernel's grid (N <= 65535, H*W < 2^31)")


# --- CORDIC schedule as the kernels take it (csrc/cordic_graph.cuh) -------

MAX_CORDIC_ITERS = 32   # REPRO_MAX_CORDIC_ITERS


class CordicRot(ctypes.Structure):
    _fields_ = [("s", ctypes.c_float * MAX_CORDIC_ITERS),
                ("gain", ctypes.c_float)]


class CordicParams(ctypes.Structure):
    _fields_ = [("rot", CordicRot * 6),
                ("iterations", ctypes.c_int),
                ("step", ctypes.c_float),
                ("inv_step", ctypes.c_float)]


@functools.lru_cache(maxsize=None)
def cordic_params(config: cordic.CordicConfig) -> CordicParams:
    """The schedule of the graph's three angles and their negations,
    resolved on the host by :func:`repro_torch.core.cordic._schedule`.

    Each micro-rotation passes ``s = -sigma * 2^-k`` and each angle its
    1/K approximation, rounded to float32 as the reference's float32
    arithmetic rounds them.  Callers must not mutate the result.

    Raises:
        ValueError: more micro-rotations than the kernels take.
    """
    if not 0 <= config.iterations <= MAX_CORDIC_ITERS:
        raise ValueError(f"CORDIC iterations must be in "
                         f"[0, {MAX_CORDIC_ITERS}], got {config.iterations}")
    angles = (loeffler.THETA_ODD_A, loeffler.THETA_ODD_B, loeffler.THETA_EVEN)
    params = CordicParams()
    for i, theta in enumerate(angles + tuple(-a for a in angles)):
        sigmas, shifts, gain = cordic._schedule(
            float(theta), config.iterations, config.gain_terms)
        for k, (sigma, shift) in enumerate(zip(sigmas, shifts)):
            params.rot[i].s[k] = -sigma * shift
        params.rot[i].gain = gain
    params.iterations = config.iterations
    step = cordic.grid_step(config)
    params.step = step
    params.inv_step = 1.0 / step if step else 0.0
    return params


@functools.lru_cache(maxsize=None)
def kron_on(device: torch.device) -> torch.Tensor:
    """``kron(C8, C8)`` on ``device``, made once per device (one
    host->device copy, not one per call).  Callers must not mutate it."""
    return dct.kron_dct_matrix(8, device=device)


@functools.lru_cache(maxsize=None)
def qtable_on(quality: int, device: torch.device) -> torch.Tensor:
    """The (8, 8) step table on ``device``, made once per quality and
    device.  Callers must not mutate it."""
    return quant.qtable(quality, device=device)


def cuda_stream(x: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``x``'s device."""
    return torch.cuda.current_stream(x.device).cuda_stream
