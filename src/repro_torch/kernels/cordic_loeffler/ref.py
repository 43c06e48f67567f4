"""Plain PyTorch version of the cordic_loeffler kernel."""

from __future__ import annotations

import torch

from repro_torch.core import cordic, dct, loeffler


def cordic_loeffler_ref(img: torch.Tensor,
                        config: cordic.CordicConfig = cordic.PAPER_CONFIG,
                        inverse: bool = False) -> torch.Tensor:
    """(..., H, W) -> (..., H, W) Cordic-Loeffler blockwise (I)DCT,
    block-planar.  H, W multiples of 8."""
    rot = cordic.make_cordic_rotate(config)
    qfn = cordic.fixed_quantizer(config)
    graph = (loeffler.loeffler_idct2d_8x8 if inverse
             else loeffler.loeffler_dct2d_8x8)
    return dct.from_blocks(graph(dct.to_blocks(img), rotate_fn=rot,
                                 quantize_fn=qfn))
