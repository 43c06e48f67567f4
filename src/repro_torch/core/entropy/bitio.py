"""MSB-first bit windows at the host edge (pure NumPy).

The reader half of ``repro.core.entropy.bitio``: :func:`bit_windows`
feeds the host's chain resolution after the ``unpack_bits`` kernel.
Packing runs in the ``pack_bits`` kernel.

Conventions (see docs/bitstream.md):

* bits are written MSB-first within each code and within each byte,
* the final partial byte is padded with 1-bits (JPEG's convention),
* no code or amplitude field is longer than 16 bits.
"""

from __future__ import annotations

import numpy as np

class TruncatedStream(ValueError):
    """Raised when decoding runs past the end of the payload."""


def bit_windows(payload: bytes) -> np.ndarray:
    """All 16-bit MSB-first windows of a payload, 1-padded past the end.

    ``bit_windows(p)[k]`` is the 16 bits starting at bit ``k``, computed
    for *every* bit position in one vectorised pass.  The host resolver
    of :mod:`repro_torch.kernels.unpack_bits` re-reads amplitudes from
    it.  The 1-padding past the payload end mirrors the writer, so "decodes
    but runs past the end" is detected by position arithmetic, never by
    bit pattern.

    Args:
        payload: packed bytes (as the ``pack_bits`` kernel writes them).

    Returns:
        (8*len(payload) + 17,) uint16 array (2 bytes per bit
        position); entries at and past the payload end see the writer's
        1-padding convention.
    """
    nbits = len(payload) * 8
    b = np.frombuffer(payload, dtype=np.uint8).astype(np.int32)
    b = np.concatenate([b, np.full(5, 0xFF, np.int32)])     # 1-padding
    # 24-bit rolling words; window at bit p is bits r..r+15 of the word
    # starting at byte p >> 3, where r = p & 7
    w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    shifts = np.arange(8, 0, -1, dtype=np.int32)
    return (((w24[:, None] >> shifts) & 0xFFFF)
            .astype(np.uint16).ravel()[:nbits + 17])
