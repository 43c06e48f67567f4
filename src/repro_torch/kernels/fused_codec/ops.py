"""Wrapper of the fused_codec CUDA kernel (``csrc/fused_codec.cu``)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import cordic
from repro_torch.kernels import _build, common
from repro_torch.kernels.fused_codec.ref import fused_codec_ref

# Kernel launches by transform, counted where the kernel is launched.
launches = {"exact": 0, "cordic": 0}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_codec")
    p = ctypes.c_void_p
    lib.fused_codec_exact.argtypes = [p, p, p, p, p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, p]
    lib.fused_codec_cordic.argtypes = [
        p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(common.CordicParams), p]
    lib.fused_codec_exact.restype = ctypes.c_int
    lib.fused_codec_cordic.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, quality: int, transform: str,
            config: cordic.CordicConfig):
    xb = common.as_batch(x)
    common.check_cuda_input(xb, "fused_codec")
    n, h, w = xb.shape
    rec = torch.empty_like(xb)
    levels = torch.empty(xb.shape, dtype=torch.int32, device=xb.device)
    qvec = common.qtable_on(quality, xb.device)
    lib = _lib()
    with torch.cuda.device(xb.device):
        stream = common.cuda_stream(xb)
        if transform == "exact":
            err = lib.fused_codec_exact(
                xb.data_ptr(), common.kron_on(xb.device).data_ptr(),
                qvec.data_ptr(), rec.data_ptr(), levels.data_ptr(), n, h, w,
                stream)
        else:
            err = lib.fused_codec_cordic(
                xb.data_ptr(), qvec.data_ptr(), rec.data_ptr(),
                levels.data_ptr(), n, h, w,
                ctypes.byref(common.cordic_params(config)), stream)
    _build.check(lib, err, f"fused_codec[{transform}]")
    launches[transform] += 1
    return rec.reshape(x.shape), levels.reshape(x.shape)


def fused_codec(img: torch.Tensor, *, quality: int = 50,
                transform: str = "exact",
                config: cordic.CordicConfig = cordic.PAPER_CONFIG):
    """One-pass codec roundtrip of (..., H, W) uint8 or float images.

    Returns (reconstruction uint8, quantised levels int32 block-planar),
    both (..., H, W); H and W are edge-padded to multiples of 8 for the
    transform and cropped back.
    """
    if transform not in ("exact", "cordic"):
        raise ValueError(f"unknown transform {transform!r}")
    h, w = img.shape[-2:]
    x = common.pad2d_to_multiple(img, 8, 8).to(torch.float32)
    if x.device.type == "cpu":
        rec, qc = fused_codec_ref(x, quality, transform, config)
    else:
        rec, qc = _launch(x, quality, transform, config)
    return rec[..., :h, :w].to(torch.uint8), qc[..., :h, :w]
