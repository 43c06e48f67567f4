"""JPEG-style quantisation (ITU-T T.81 Annex K luminance table, IJG scaling).

A copy of ``repro.core.quant``'s table rule: the step table is computed
in NumPy float64 as ``floor((Q*s + 50)/100)`` and cast afterwards, so the
float32 table is identical to the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ITU-T T.81 Annex K, Table K.1 (luminance).
JPEG_LUMA_QTABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float64)


@functools.lru_cache(maxsize=None)
def _scaled_qtable_np(quality: int) -> np.ndarray:
    """IJG quality scaling: quality clipped to [1, 100]."""
    quality = int(np.clip(quality, 1, 100))
    if quality < 50:
        scale = 5000.0 / quality
    else:
        scale = 200.0 - 2.0 * quality
    q = np.floor((JPEG_LUMA_QTABLE * scale + 50.0) / 100.0)
    return np.clip(q, 1.0, 255.0)


def qtable(quality: int = 50, dtype=torch.float32,
           device=None) -> torch.Tensor:
    """(8, 8) quantisation steps in [1, 255] for an IJG quality factor."""
    return torch.tensor(_scaled_qtable_np(quality), dtype=dtype,
                        device=device)


def quantize(coeffs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) coefficients -> int32 levels ``round(coeffs / q)``.

    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    return torch.round(coeffs / q).to(torch.int32)


def dequantize(qcoeffs: torch.Tensor, q: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """(..., 8, 8) levels -> coefficients ``qcoeffs * q``."""
    return qcoeffs.to(dtype) * q.to(dtype)


@functools.lru_cache(maxsize=None)
def _zigzag_perm(n: int = 8) -> np.ndarray:
    """Raster -> zig-zag permutation of block indices (length n*n)."""
    idx = sorted(((i + j, i if (i + j) % 2 else j, i, j)
                  for i in range(n) for j in range(n)))
    return np.array([i * n + j for (_, _, i, j) in idx], dtype=np.int64)


def zigzag(blocks: torch.Tensor) -> torch.Tensor:
    """(..., n, n) square blocks -> (..., n*n) in zig-zag order (DC
    first); the inverse is :func:`repro_torch.core.entropy.scan.
    zigzag_unscan`."""
    *lead, b, b2 = blocks.shape
    perm = torch.from_numpy(_zigzag_perm(b)).to(blocks.device)
    return blocks.reshape(*lead, b * b2)[..., perm]


def estimate_bits(qcoeffs: torch.Tensor) -> torch.Tensor:
    """JPEG-flavoured size *proxy* (bits) for quantised blocks, as the
    reference computes it in float32: per nonzero coefficient its
    magnitude-category bits plus 4 bits of Huffman overhead, plus 4 bits
    of EOB per block.  Only ``CompressedBatch.nbytes_estimate`` uses it,
    before the streams exist.

    Args:
        qcoeffs: (..., 8, 8) int quantised levels.

    Returns:
        Scalar float32 estimated bit count over all blocks.
    """
    mag = qcoeffs.abs().to(torch.float32)
    nz = mag > 0
    cat_bits = torch.where(nz, torch.ceil(torch.log2(mag + 1.0)), 0.0)
    huff_bits = torch.where(nz, 4.0, 0.0)
    per_block = (cat_bits + huff_bits).sum(dim=(-1, -2)) + 4.0
    return per_block.sum()
