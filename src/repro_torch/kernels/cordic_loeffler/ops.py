"""Wrappers of the cordic_loeffler CUDA kernel
(``csrc/cordic_loeffler.cu``)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import cordic
from repro_torch.kernels import _build, common
from repro_torch.kernels.cordic_loeffler.ref import cordic_loeffler_ref

# Kernel launches by direction, counted where the kernel is launched.
launches = {"forward": 0, "inverse": 0}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("cordic_loeffler")
    for fn in (lib.cordic_loeffler_forward, lib.cordic_loeffler_inverse):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(common.CordicParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, config: cordic.CordicConfig,
            inverse: bool) -> torch.Tensor:
    xb = common.as_batch(x)
    common.check_cuda_input(xb, "cordic_loeffler")
    params = common.cordic_params(config)
    n, h, w = xb.shape
    out = torch.empty_like(xb)
    lib = _lib()
    fn = (lib.cordic_loeffler_inverse if inverse
          else lib.cordic_loeffler_forward)
    with torch.cuda.device(xb.device):
        err = fn(xb.data_ptr(), out.data_ptr(), n, h, w,
                 ctypes.byref(params), common.cuda_stream(xb))
    _build.check(lib, err, "cordic_loeffler")
    launches["inverse" if inverse else "forward"] += 1
    return out.reshape(x.shape)


def _run(img: torch.Tensor, config: cordic.CordicConfig,
         inverse: bool) -> torch.Tensor:
    if img.dtype != torch.float32:
        raise TypeError(f"cordic_loeffler takes float32, got {img.dtype}")
    h, w = img.shape[-2:]
    x = common.pad2d_to_multiple(img, 8, 8)
    if x.device.type == "cpu":
        out = cordic_loeffler_ref(x, config, inverse)
    else:
        out = _launch(x, config, inverse)
    return out[..., :h, :w]


def cordic_loeffler_dct(img: torch.Tensor, *,
                        config: cordic.CordicConfig = cordic.PAPER_CONFIG
                        ) -> torch.Tensor:
    """Paper-faithful Cordic-Loeffler blockwise DCT.  (..., H, W) float32,
    block-planar; H and W are edge-padded to multiples of 8 and cropped."""
    return _run(img, config, inverse=False)


def cordic_loeffler_idct(coeffs: torch.Tensor, *,
                         config: cordic.CordicConfig = cordic.PAPER_CONFIG
                         ) -> torch.Tensor:
    """Paper-faithful Cordic-Loeffler blockwise inverse DCT."""
    return _run(coeffs, config, inverse=True)
