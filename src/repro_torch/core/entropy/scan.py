"""Zig-zag scan and DC differential, as torch ops on the levels' device.

The port of ``repro.core.entropy.scan``.  Block order is raster order
over the block grid: block ``(i, j)`` of a ``(gh, gw, 8, 8)`` level
array is stream element ``i * gw + j``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import quant


def zigzag_perm(n: int = 8) -> np.ndarray:
    """Raster -> zig-zag permutation of flat block indices (length n*n)."""
    return quant._zigzag_perm(n)


def inverse_zigzag_perm(n: int = 8) -> np.ndarray:
    """Zig-zag -> raster permutation (the inverse of :func:`zigzag_perm`)."""
    return np.argsort(quant._zigzag_perm(n))


def zigzag_scan(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) coefficient blocks -> (..., 64) in zig-zag order."""
    return quant.zigzag(blocks)


def zigzag_unscan(z: torch.Tensor) -> torch.Tensor:
    """(..., 64) zig-zag vectors -> (..., 8, 8) raster blocks."""
    *lead, n2 = z.shape
    n = int(round(n2 ** 0.5))
    inv = torch.from_numpy(inverse_zigzag_perm(n)).to(z.device)
    return z[..., inv].reshape(*lead, n, n)


def block_stream(qcoeffs: torch.Tensor) -> torch.Tensor:
    """(gh, gw, 8, 8) quantised levels -> (gh*gw, 64) zig-zag stream."""
    gh, gw = qcoeffs.shape[:2]
    return zigzag_scan(qcoeffs).reshape(gh * gw, 64)


def unblock_stream(z: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(gh*gw, 64) zig-zag stream -> (gh, gw, 8, 8) quantised levels."""
    return zigzag_unscan(z).reshape(gh, gw, 8, 8)


def dc_differential(z: torch.Tensor) -> tuple:
    """Split a (n, 64) zig-zag stream into DC differences and the AC tail.

    Each block's DC is coded as its difference from the previous block's
    (predictor 0 for the first block), as in JPEG baseline.  The
    difference is taken in int64, as the reference's host encoder takes
    it, so no int32 level pair can wrap.

    Returns:
        ``(dc_diff, ac)``: (n,) int64 DC differences and the (n, 63) AC
        tail (a view of ``z``).
    """
    dc = z[:, 0].to(torch.int64)
    return torch.diff(dc, prepend=dc.new_zeros(1)), z[:, 1:]


def dc_integrate(dc_diff: torch.Tensor) -> torch.Tensor:
    """Invert :func:`dc_differential`'s DC leg: (n,) diffs -> (n,) DCs."""
    return torch.cumsum(dc_diff, dim=0)


def assemble_stream(dc: torch.Tensor, ac: torch.Tensor) -> torch.Tensor:
    """Recombine (n,) DCs and (n, 63) AC tails into a (n, 64) stream."""
    return torch.cat([dc[:, None].to(ac.dtype), ac], dim=1)
