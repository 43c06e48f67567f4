"""Plain PyTorch version of the dct8x8 kernel (block-planar layout)."""

from __future__ import annotations

import torch

from repro_torch.core import dct


def _rows(x: torch.Tensor) -> torch.Tensor:
    *lead, h, w = x.shape
    return dct.to_blocks(x).reshape(*lead, h // 8, w // 8, 64)


def _planar(rows: torch.Tensor) -> torch.Tensor:
    return dct.from_blocks(rows.reshape(*rows.shape[:-1], 8, 8))


def dct8x8_ref(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H, W) blockwise DCT coefficients: each block's
    row-major vec times ``kron(C8, C8)^T``.  H, W multiples of 8."""
    t = dct.kron_dct_matrix(8, img.dtype, img.device)
    return _planar(_rows(img) @ t.T)


def idct8x8_ref(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dct8x8_ref` (T is orthonormal: inverse = T^T)."""
    t = dct.kron_dct_matrix(8, coeffs.dtype, coeffs.device)
    return _planar(_rows(coeffs) @ t)
