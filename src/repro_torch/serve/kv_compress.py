"""DCT KV-cache compression (the paper's energy compaction on the time
axis), in plain torch, as the reference computes it outside any kernel.

Frozen cache blocks of 64 consecutive positions are DCT'd along time,
truncated to ``keep`` low-frequency coefficients and int8-quantised: the
grad_dct wire format (``repro_torch.kernels.grad_dct.ref``).

Layout, as the reference's code computes it: a dense-cache tensor
(L, B, T, H, D) is compressed per (L, B, H, D) column along T in blocks
of 64, to codes (L, B, H, D, T/64, keep) int8 and scales
(L, B, H, D, T/64, 1) f32.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dct
from repro_torch.kernels.grad_dct.ref import BLOCK, dequantise, quantise


@dataclasses.dataclass
class CompressedKV:
    codes: dict       # path -> int8 (L, B, H, D, nb, keep) codes
    scales: dict      # path -> f32 (L, B, H, D, nb, 1) scales
    keep: int
    t_compressed: int  # positions covered by compressed blocks


def compress_tensor(x: torch.Tensor, keep: int):
    """x (L, B, T, ...) -> (codes int8, scales f32) blocks along T."""
    xt = x.movedim(2, -1).to(torch.float32)            # (..., T)
    nb = xt.shape[-1] // BLOCK
    body = xt[..., :nb * BLOCK].reshape(*xt.shape[:-1], nb, BLOCK)
    c = dct.dct_matrix(BLOCK, device=x.device)
    return quantise((body @ c.T)[..., :keep])


def decompress_tensor(codes: torch.Tensor, scales: torch.Tensor,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`compress_tensor` -> (L, B, T_c, ...)."""
    body = dequantise(codes, scales)                    # (..., nb, BLOCK)
    xt = body.reshape(*body.shape[:-2], body.shape[-2] * BLOCK)
    return xt.movedim(-1, 2).to(out_dtype)


def compress_cache(cache: dict, keep: int, prefix_len: int) -> tuple:
    """Compress the first ``prefix_len - (prefix_len % 64)`` positions of
    every time-major cache tensor; return (CompressedKV, raw_tail_cache).

    The tail (ragged remainder + all future decode writes) stays raw.
    """
    t_c = (prefix_len // BLOCK) * BLOCK
    codes, scales, tails = {}, {}, {}
    for path, x in cache.items():
        if x.dim() >= 3 and x.shape[2] >= BLOCK:
            codes[path], scales[path] = compress_tensor(x[:, :, :t_c], keep)
            tails[path] = x[:, :, t_c:]
        else:
            tails[path] = x
    return CompressedKV(codes, scales, keep, t_c), tails


def reconstruct_cache(ckv: CompressedKV, tails: dict,
                      dtype=torch.bfloat16) -> dict:
    """Materialise a full cache from compressed blocks + raw tail (each
    tensor in its tail's dtype; ``dtype`` is kept for the reference's
    signature)."""
    out = {}
    for path, tail in tails.items():
        if path in ckv.codes:
            head = decompress_tensor(ckv.codes[path], ckv.scales[path],
                                     tail.dtype)
            out[path] = torch.cat([head, tail], dim=2)
        else:
            out[path] = tail
    return out


def wire_bytes(ckv: CompressedKV, tails: dict) -> int:
    """Device-memory bytes of the compressed representation."""
    total = 0
    for p in ckv.codes:
        total += ckv.codes[p].numel() + ckv.scales[p].numel() * 4
    for t in tails.values():
        total += t.numel() * t.element_size()
    return total
