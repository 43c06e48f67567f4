"""Wrapper of the pack_bits CUDA kernel (``csrc/pack_bits.cu``)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.pack_bits.ref import pack_bits_ref

# Kernel launches, counted where the kernel is launched.
launches = {"encode": 0}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("pack_bits")
    p = ctypes.c_void_p
    lib.pack_bits_launch.argtypes = [p, p, p, ctypes.c_longlong,
                                     ctypes.c_longlong, p, p]
    lib.pack_bits_launch.restype = ctypes.c_int
    return lib


def _launch(codes, lengths, starts, total_bits: int) -> torch.Tensor:
    if codes.device.type != "cuda":
        raise ValueError(f"pack_bits: expected a CUDA tensor, got "
                         f"{codes.device}")
    codes, lengths, starts = (t.contiguous() for t in
                              (codes, lengths, starts))
    nbytes = (total_bits + 7) // 8
    words = torch.zeros((nbytes + 3) // 4, dtype=torch.int32,
                        device=codes.device)
    lib = _lib()
    with torch.cuda.device(codes.device):
        err = lib.pack_bits_launch(
            codes.data_ptr(), lengths.data_ptr(), starts.data_ptr(),
            codes.shape[0], total_bits, words.data_ptr(),
            common.cuda_stream(codes))
    _build.check(lib, err, "pack_bits")
    launches["encode"] += 1
    return words.view(torch.uint8)[:nbytes]


def pack_bits(codes: torch.Tensor, lengths: torch.Tensor,
              starts: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Pack MSB-first bit fields at their start bits into payload bytes.

    Args:
        codes: (M,) int32 field values (low ``lengths`` bits used).
        lengths: (M,) int32 widths in [0, 16].
        starts: (M,) int64 start bits (a prefix sum of the widths, or
            any layout in which fields do not overlap), each field
            ending at or before ``total_bits``.
        total_bits: payload length in bits.

    Returns:
        (ceil(total_bits / 8),) uint8 payload on the inputs' device,
        final partial byte 1-padded: the plain version on a CPU tensor,
        the kernel on a CUDA one.
    """
    if (codes.dtype, lengths.dtype, starts.dtype) != (
            torch.int32, torch.int32, torch.int64):
        raise TypeError(f"pack_bits takes int32 codes and lengths and "
                        f"int64 starts, got {codes.dtype}, {lengths.dtype}"
                        f" and {starts.dtype}")
    if not (codes.dim() == 1 and codes.shape == lengths.shape
            == starts.shape):
        raise ValueError("pack_bits takes three (M,) tensors of one shape")
    if total_bits < 0:
        raise ValueError(f"total_bits must be >= 0, got {total_bits}")
    if codes.device.type == "cpu":
        return pack_bits_ref(codes, lengths, starts, total_bits)
    if total_bits == 0:
        return torch.empty(0, dtype=torch.uint8, device=codes.device)
    return _launch(codes, lengths, starts, total_bits)
