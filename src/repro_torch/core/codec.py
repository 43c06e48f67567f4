"""The paper's pipeline: blockwise DCT -> quantise -> (dequantise) -> IDCT.

The port of ``repro.core.codec``.  ``transform`` selects:

* ``"exact"``    - orthonormal matrix DCT, through the ``dct8x8`` kernel,
* ``"cordic"``   - Cordic-based Loeffler DCT, through ``cordic_loeffler``,
* ``"loeffler"`` - Loeffler graph with exact rotations, plain PyTorch (the
  reference has no TPU kernel for it).

On a CPU tensor each kernel wrapper runs its plain PyTorch version.
Images whose sizes are not multiples of 8 are edge-padded and cropped
back on reconstruction.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import cordic, dct, loeffler, metrics, quant
from repro_torch.kernels.common import pad2d_to_multiple, qtable_on
from repro_torch.kernels.cordic_loeffler import (cordic_loeffler_dct,
                                                 cordic_loeffler_idct)
from repro_torch.kernels.dct8x8 import dct8x8, idct8x8

Transform = Literal["exact", "cordic", "loeffler"]


@dataclasses.dataclass
class CompressedImage:
    """Quantised DCT representation of a single grayscale image."""
    qcoeffs: torch.Tensor         # (H/8, W/8, 8, 8) int32 quantised levels
    quality: int
    transform: str
    orig_shape: tuple             # (H, W) before padding
    cordic_config: cordic.CordicConfig | None = None


def pad_to_block(img: torch.Tensor, block: int = 8) -> torch.Tensor:
    """Edge-replicate the trailing (H, W) axes up to block multiples; the
    input itself when no padding is needed."""
    return pad2d_to_multiple(img, block, block)


def _forward(img_f32: torch.Tensor, transform: str,
             cordic_config: cordic.CordicConfig) -> torch.Tensor:
    """(..., H, W) level-shifted pixels -> (..., H/8, W/8, 8, 8) coeffs."""
    if transform == "exact":
        return dct.to_blocks(dct8x8(img_f32))
    if transform == "cordic":
        return dct.to_blocks(cordic_loeffler_dct(img_f32,
                                                 config=cordic_config))
    if transform == "loeffler":
        return loeffler.loeffler_dct2d_8x8(dct.to_blocks(img_f32))
    raise ValueError(f"unknown transform {transform!r}")


def _inverse(coeffs: torch.Tensor, transform: str,
             cordic_config: cordic.CordicConfig) -> torch.Tensor:
    """(..., H/8, W/8, 8, 8) coeffs -> (..., H, W) level-shifted pixels."""
    if transform == "exact":
        return idct8x8(dct.from_blocks(coeffs))
    if transform == "cordic":
        return cordic_loeffler_idct(dct.from_blocks(coeffs),
                                    config=cordic_config)
    if transform == "loeffler":
        return dct.from_blocks(loeffler.loeffler_idct2d_8x8(coeffs))
    raise ValueError(f"unknown transform {transform!r}")


def compress_batch_blocks(imgs: torch.Tensor, transform: str, quality: int,
                          cordic_config: cordic.CordicConfig
                          ) -> torch.Tensor:
    """(B, H, W) uint8/float, H and W multiples of 8 ->
    (B, H/8, W/8, 8, 8) int32 quantised levels."""
    x = imgs.to(torch.float32) - 128.0    # JPEG level shift
    coeffs = _forward(x, transform, cordic_config)
    q = qtable_on(quality, imgs.device)
    return quant.quantize(coeffs, q).contiguous()


def decompress_batch_blocks(qcoeffs: torch.Tensor, transform: str,
                            quality: int,
                            cordic_config: cordic.CordicConfig
                            ) -> torch.Tensor:
    """(B, H/8, W/8, 8, 8) int32 levels -> (B, H, W) uint8.

    ``transform`` is the decoder's: a standards-compliant decode keeps
    "exact" whatever the encoder used.
    """
    q = qtable_on(quality, qcoeffs.device)
    x = _inverse(quant.dequantize(qcoeffs, q), transform, cordic_config)
    return torch.clamp(torch.round(x + 128.0), 0.0, 255.0).to(torch.uint8)


def compress(img, quality: int = 50, transform: Transform = "exact",
             cordic_config: cordic.CordicConfig = cordic.PAPER_CONFIG,
             device=None) -> CompressedImage:
    """Compress one (H, W) grayscale image (uint8 or float, NumPy or torch).

    Args:
        img: (H, W) image; sizes not divisible by 8 are edge-padded.
        quality: JPEG quality factor in [1, 100].
        transform: "exact", "cordic" or "loeffler".
        cordic_config: CORDIC config for ``transform == "cordic"``.
        device: where to run; None means "cuda" (raises without a GPU).

    Returns:
        A :class:`CompressedImage` with (H/8, W/8, 8, 8) int32 levels on
        ``device``.
    """
    img = as_tensor(img, resolve_device(device))
    orig_shape = tuple(img.shape[-2:])
    q = compress_batch_blocks(pad_to_block(img)[None], transform, quality,
                              cordic_config)[0]
    return CompressedImage(qcoeffs=q, quality=quality, transform=transform,
                           orig_shape=orig_shape, cordic_config=cordic_config)


def decompress(c: CompressedImage, mode: str = "standard") -> torch.Tensor:
    """Reconstruct the (H, W) uint8 image on the levels' device.

    mode="standard" decodes with the exact IDCT (a standards-compliant
    decoder); mode="matched" with the encoder's own transform.
    """
    cfg = c.cordic_config or cordic.PAPER_CONFIG
    dec_transform = "exact" if mode == "standard" else c.transform
    out = decompress_batch_blocks(c.qcoeffs[None], dec_transform, c.quality,
                                  cfg)[0]
    h, w = c.orig_shape
    return out[..., :h, :w]


def roundtrip(img, quality: int = 50, transform: Transform = "exact",
              cordic_config: cordic.CordicConfig = cordic.PAPER_CONFIG,
              mode: str = "standard", device=None):
    """The paper's experiment: compress, reconstruct, score.

    Returns:
        ``(reconstructed, psnr_db)``: the (H, W) uint8 reconstruction and
        its PSNR in dB against ``img`` (paper eq. 23).
    """
    img = as_tensor(img, resolve_device(device))
    c = compress(img, quality, transform, cordic_config, device=img.device)
    rec = decompress(c, mode=mode)
    return rec, float(metrics.psnr(img, rec))
