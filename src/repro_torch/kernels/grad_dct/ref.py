"""Plain PyTorch version of the grad_dct kernels (encode / decode).

Rows of 64 gradient samples are DCT'd with the orthonormal DCT-II,
truncated to the lowest ``keep`` frequencies and int8-quantised with one
f32 scale per row; decode reverses.  Products run in full fp32 (TF32 is
off, ``repro_torch/__init__.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import dct

BLOCK = 64


def quantise(kept: torch.Tensor):
    """Kept coefficients (..., keep) f32 -> (int8 codes, (..., 1) f32
    scales): ``scale = max(max|kept| / 127, 1e-30)``, codes rounded half
    to even and clipped to [-127, 127]."""
    scale = torch.clamp_min(kept.abs().amax(-1, keepdim=True) / 127.0,
                            1e-30)
    q = torch.clamp(torch.round(kept / scale), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantise(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Codes (..., keep) and scales (..., 1) -> (..., 64) samples: the
    coefficients zero-padded to 64 times C64 (C is orthonormal)."""
    c = dct.dct_matrix(BLOCK, device=q.device)
    kept = q.to(torch.float32) * s
    return F.pad(kept, (0, BLOCK - q.shape[-1])) @ c


def grad_dct_encode_ref(g: torch.Tensor, keep: int):
    """(R, 64) f32 -> ((R, keep) int8, (R, 1) f32)."""
    c = dct.dct_matrix(BLOCK, device=g.device)
    return quantise((g @ c.T)[:, :keep])


def grad_dct_decode_ref(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """((R, keep) int8, (R, 1) f32) -> (R, 64) f32."""
    return dequantise(q, s)


def grad_dct_roundtrip_ref(g: torch.Tensor, keep: int) -> torch.Tensor:
    """Encode + decode: the lossy projection the optimiser sees."""
    return grad_dct_decode_ref(*grad_dct_encode_ref(g, keep))
