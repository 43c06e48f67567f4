"""Plain PyTorch version of the pack_bits kernel (``csrc/pack_bits.cu``).

A field of width ``L <= 16`` starting at bit ``s`` lies inside the three
bytes from ``s // 8``; its MSB-first bits, shifted into that 24-bit
window, split into three byte contributions.  Fields never share a bit,
so the contributions to each byte are summed (``index_add_``) exactly.
The writer's 1-padding of the final partial byte is one more field.
"""

from __future__ import annotations

import torch


def pack_bits_ref(codes: torch.Tensor, lengths: torch.Tensor,
                  starts: torch.Tensor, total_bits: int) -> torch.Tensor:
    """MSB-first fields at their start bits -> payload bytes.

    Args:
        codes: (M,) int32 field values; only the low ``lengths`` bits
            count.
        lengths: (M,) int32 widths in [0, 16]; zero-width fields write
            nothing.
        starts: (M,) int64 start bits; fields must not overlap and must
            end at or before ``total_bits``.
        total_bits: payload length in bits.

    Returns:
        (ceil(total_bits / 8),) uint8 bytes on the inputs' device, the
        final partial byte padded with 1-bits.
    """
    dev = codes.device
    nbytes = (total_bits + 7) // 8
    pad = (-total_bits) % 8
    length = lengths.to(torch.int64)
    start = starts.to(torch.int64)
    code = codes.to(torch.int64) & ((1 << length) - 1)
    if pad:
        code = torch.cat([code, code.new_tensor([(1 << pad) - 1])])
        length = torch.cat([length, length.new_tensor([pad])])
        start = torch.cat([start, start.new_tensor([total_bits])])
    byte = start >> 3
    v = code << (24 - (start & 7) - length)
    out = torch.zeros(nbytes + 3, dtype=torch.int64, device=dev)
    for t in range(3):
        out.index_add_(0, byte + t, (v >> (16 - 8 * t)) & 0xFF)
    return out[:nbytes].to(torch.uint8)
