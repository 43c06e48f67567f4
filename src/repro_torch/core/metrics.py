"""PSNR and MSE as the paper defines them (eqs. 23-24).

MAX is the maximum pixel value of the *original* image, not a fixed 255.
Both functions reduce over the last two axes, so a (B, H, W) batch gives
(B,) values and one (H, W) image a scalar.
"""

from __future__ import annotations

import torch


def mse(original: torch.Tensor, reconstructed: torch.Tensor) -> torch.Tensor:
    o = original.to(torch.float32)
    c = reconstructed.to(torch.float32)
    return ((o - c) ** 2).mean(dim=(-2, -1))


def psnr(original: torch.Tensor, reconstructed: torch.Tensor,
         max_val: float | None = None) -> torch.Tensor:
    """PSNR in dB per paper eq. (23)."""
    m = mse(original, reconstructed)
    if max_val is None:
        max_val = original.to(torch.float32).amax(dim=(-2, -1))
    return 20.0 * torch.log10(max_val / torch.sqrt(torch.clamp(m, min=1e-12)))
