"""Wrappers of the dct8x8 CUDA kernel (``csrc/dct8x8.cu``)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.dct8x8.ref import dct8x8_ref, idct8x8_ref

# Kernel launches by direction, counted where the kernel is launched.
launches = {"forward": 0, "inverse": 0}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dct8x8")
    for fn in (lib.dct8x8_forward, lib.dct8x8_inverse):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    xb = common.as_batch(x)
    common.check_cuda_input(xb, "dct8x8")
    n, h, w = xb.shape
    out = torch.empty_like(xb)
    lib = _lib()
    fn = lib.dct8x8_inverse if inverse else lib.dct8x8_forward
    with torch.cuda.device(xb.device):
        err = fn(xb.data_ptr(), common.kron_on(xb.device).data_ptr(),
                 out.data_ptr(), n, h, w, common.cuda_stream(xb))
    _build.check(lib, err, "dct8x8")
    launches["inverse" if inverse else "forward"] += 1
    return out.reshape(x.shape)


def _run(img: torch.Tensor, inverse: bool) -> torch.Tensor:
    if img.dtype != torch.float32:
        raise TypeError(f"dct8x8 takes float32, got {img.dtype}")
    h, w = img.shape[-2:]
    x = common.pad2d_to_multiple(img, 8, 8)
    if x.device.type == "cpu":
        out = (idct8x8_ref if inverse else dct8x8_ref)(x)
    else:
        out = _launch(x, inverse)
    return out[..., :h, :w]


def dct8x8(img: torch.Tensor) -> torch.Tensor:
    """Blockwise 8x8 2-D DCT, block-planar layout.  (..., H, W) float32;
    H and W are edge-padded to multiples of 8 and cropped back."""
    return _run(img, inverse=False)


def idct8x8(coeffs: torch.Tensor) -> torch.Tensor:
    """Blockwise 8x8 2-D inverse DCT, block-planar layout.  (..., H, W)."""
    return _run(coeffs, inverse=True)
