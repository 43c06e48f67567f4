"""Codec core: DCT matrices, quantisation, CORDIC, the Loeffler graph,
metrics, test images and the single-image codec."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cordic import CordicConfig


@dataclasses.dataclass(frozen=True)
class CodecConstants:
    """All the state the pixels <-> levels path carries: it has no weights."""
    dct_c8: torch.Tensor          # (8, 8) float32 orthonormal DCT-II
    kron: torch.Tensor            # (64, 64) float32 kron(C8, C8)
    qtable: torch.Tensor          # (8, 8) float32 quality-scaled steps
    cordic_config: CordicConfig


def constants_from_reference(dct_c8, kron, qtable,
                             cordic_config_tuple) -> CodecConstants:
    """The port's constants from another implementation's plain values.

    Args:
        dct_c8: (8, 8) array-like, the orthonormal DCT-II matrix.
        kron: (64, 64) array-like, ``kron(C8, C8)``.
        qtable: (8, 8) array-like of quantisation steps.
        cordic_config_tuple: ``(iterations, gain_terms, fixed_point_bits)``
            with ``fixed_point_bits`` None for a float datapath.

    Returns:
        A :class:`CodecConstants` of float32 CPU tensors.

    Raises:
        ValueError: a shape or the config tuple is not as above.
    """
    arrays = {}
    for name, value, shape in (("dct_c8", dct_c8, (8, 8)),
                               ("kron", kron, (64, 64)),
                               ("qtable", qtable, (8, 8))):
        a = np.asarray(value, dtype=np.float32)
        if a.shape != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {a.shape}")
        arrays[name] = torch.from_numpy(a.copy())
    if len(cordic_config_tuple) != 3:
        raise ValueError("cordic_config_tuple must be "
                         "(iterations, gain_terms, fixed_point_bits)")
    iterations, gain_terms, bits = cordic_config_tuple
    config = CordicConfig(int(iterations), int(gain_terms),
                          None if bits is None else int(bits))
    return CodecConstants(cordic_config=config, **arrays)
