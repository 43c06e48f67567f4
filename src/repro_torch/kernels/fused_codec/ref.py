"""Plain PyTorch version of the fused_codec kernel: the same arithmetic
(exact: 64-term products against ``kron(C8, C8)``; cordic: the graph)
staged through memory."""

from __future__ import annotations

import torch

from repro_torch.core import cordic, quant
from repro_torch.kernels.cordic_loeffler.ref import cordic_loeffler_ref
from repro_torch.kernels.dct8x8.ref import dct8x8_ref, idct8x8_ref


def fused_codec_ref(img: torch.Tensor, quality: int = 50,
                    transform: str = "exact",
                    config: cordic.CordicConfig = cordic.PAPER_CONFIG):
    """(..., H, W) float32, H and W multiples of 8 ->
    (reconstruction float32 in [0, 255], levels int32 block-planar)."""
    x = img.to(torch.float32) - 128.0
    if transform == "exact":
        coef = dct8x8_ref(x)
    elif transform == "cordic":
        coef = cordic_loeffler_ref(x, config)
    else:
        raise ValueError(f"unknown transform {transform!r}")
    h, w = img.shape[-2:]
    q = quant.qtable(quality, device=img.device).repeat(h // 8, w // 8)
    qc = torch.round(coef / q)
    deq = qc * q
    if transform == "exact":
        rec = idct8x8_ref(deq)
    else:
        rec = cordic_loeffler_ref(deq, config, inverse=True)
    rec = torch.clamp(torch.round(rec + 128.0), 0.0, 255.0)
    return rec, qc.to(torch.int32)
