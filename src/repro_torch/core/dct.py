"""Exact orthonormal DCT-II matrices and the blockwise Kronecker transforms.

Same conventions as ``repro.core.dct``: orthonormal DCT-II, so the
inverse is the transpose, and vec() is row-major, so the 2-D transform
of one 8x8 block is ``vec(Y) = kron(C, C) @ vec(X)``.  The matrices are
built in NumPy float64 exactly as the reference builds them and cast
afterwards, so the float32 constants are identical.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _dct_matrix_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix C, shape (n, n):  X = C @ x."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    mat = np.cos(np.pi * k * (2.0 * i + 1.0) / (2.0 * n))
    mat *= np.sqrt(2.0 / n)
    mat[0] *= 1.0 / np.sqrt(2.0)
    return mat


def dct_matrix(n: int = 8, dtype=torch.float32, device=None) -> torch.Tensor:
    """Orthonormal DCT-II matrix of size (n, n)."""
    return torch.tensor(_dct_matrix_np(n), dtype=dtype, device=device)


def kron_dct_matrix(n: int = 8, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """(n*n, n*n) operator T with vec(Y) = T @ vec(X) for Y = C X C^T."""
    c = _dct_matrix_np(n)
    return torch.tensor(np.kron(c, c), dtype=dtype, device=device)


def to_blocks(img: torch.Tensor, block: int = 8) -> torch.Tensor:
    """(..., H, W) -> (..., H//b, W//b, b, b).  H, W must divide by b."""
    *lead, h, w = img.shape
    if h % block or w % block:
        raise ValueError(f"image {h}x{w} not divisible by block {block}")
    x = img.reshape(*lead, h // block, block, w // block, block)
    return x.transpose(-3, -2)


def from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_blocks`."""
    *lead, hb, wb, b, b2 = blocks.shape
    if b != b2:
        raise ValueError(f"blocks must be square, got {tuple(blocks.shape)}")
    return blocks.transpose(-3, -2).reshape(*lead, hb * b, wb * b)


def blockwise_dct2d_kron(img: torch.Tensor, block: int = 8) -> torch.Tensor:
    """Blockwise 2-D DCT: (..., H, W) -> (..., H//b, W//b, b, b) coeffs."""
    t = kron_dct_matrix(block, img.dtype, img.device)
    blocks = to_blocks(img, block)
    *lead, hb, wb, b, _ = blocks.shape
    out = blocks.reshape(*lead, hb, wb, b * b) @ t.T
    return out.reshape(*lead, hb, wb, b, b)


def blockwise_idct2d_kron(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`blockwise_dct2d_kron`, back to (..., H, W)."""
    *lead, hb, wb, b, _ = coeffs.shape
    t = kron_dct_matrix(b, coeffs.dtype, coeffs.device)
    out = coeffs.reshape(*lead, hb, wb, b * b) @ t
    return from_blocks(out.reshape(*lead, hb, wb, b, b))
