"""Wrappers of the grad_dct CUDA kernels (``csrc/grad_dct.cu``):
compress and decompress flat gradients of any length.

``encode``/``decode`` work on flat vectors: the tail that does not fill a
64-sample block is carried uncompressed (exact).  The kernels take the
body in place as (R, 64) rows and mask their ragged last tile
themselves, so nothing is padded or copied on the way in.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import dct
from repro_torch.kernels import _build, common
from repro_torch.kernels.grad_dct.ref import (BLOCK, grad_dct_decode_ref,
                                              grad_dct_encode_ref)

# Kernel launches by direction, counted where the kernel is launched.
launches = {"encode": 0, "decode": 0}

_MAX_GRID = 2 ** 31 - 1


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"grad_dct {what}: expected a CUDA tensor, got "
                         f"{x.device}")


@dataclasses.dataclass
class CompressedGrad:
    """DCT-compressed flat gradient."""
    q: torch.Tensor        # (R, keep) int8
    scale: torch.Tensor    # (R, 1) f32
    tail: torch.Tensor     # (T,) f32 uncompressed remainder (T < 64)
    n: int                 # original length

    def wire_bytes(self) -> int:
        """Bytes that would cross the interconnect."""
        return (self.q.numel() + 4 * self.scale.numel()
                + 4 * self.tail.numel())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("grad_dct")
    p = ctypes.c_void_p
    for fn in (lib.grad_dct_encode, lib.grad_dct_decode):
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _c64_on(device: torch.device) -> torch.Tensor:
    """C64 on ``device``, made once per device.  Callers must not mutate
    it."""
    return dct.dct_matrix(BLOCK, device=device)


def default_block_rows(r: int) -> int:
    """The kernels' tile: rows per thread block, a power of two in
    [64, 1024], small enough to give the card at least about 2048 blocks
    where there are rows for them.  No output depends on it."""
    return min(1024, max(64, 1 << max(0, (r // 2048) - 1).bit_length()))


def _check_block_rows(block_rows, r: int) -> int:
    if block_rows is None:
        return default_block_rows(r)
    if int(block_rows) < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if -(-r // int(block_rows)) > _MAX_GRID:
        raise ValueError(f"block_rows={block_rows} gives more than "
                         f"{_MAX_GRID} blocks for {r} rows")
    return int(block_rows)


def _launch_encode(body: torch.Tensor, keep: int, block_rows: int):
    """(R, 64) contiguous f32 CUDA rows, R >= 1 -> ((R, keep) int8,
    (R, 1) f32)."""
    _check_cuda(body, "encode")
    r = body.shape[0]
    q = torch.empty((r, keep), dtype=torch.int8, device=body.device)
    s = torch.empty((r, 1), dtype=torch.float32, device=body.device)
    lib = _lib()
    with torch.cuda.device(body.device):
        err = lib.grad_dct_encode(
            body.data_ptr(), _c64_on(body.device).data_ptr(), q.data_ptr(),
            s.data_ptr(), r, keep, block_rows, common.cuda_stream(body))
    _build.check(lib, err, "grad_dct encode")
    launches["encode"] += 1
    return q, s


def _launch_decode(q: torch.Tensor, s: torch.Tensor,
                   block_rows: int) -> torch.Tensor:
    """(R, keep) int8 and (R, 1) f32 contiguous CUDA tensors, R >= 1 ->
    (R, 64) f32."""
    _check_cuda(q, "decode")
    r, keep = q.shape
    out = torch.empty((r, BLOCK), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.grad_dct_decode(
            q.data_ptr(), s.data_ptr(), _c64_on(q.device).data_ptr(),
            out.data_ptr(), r, keep, block_rows, common.cuda_stream(q))
    _build.check(lib, err, "grad_dct decode")
    launches["decode"] += 1
    return out


def encode(g: torch.Tensor, keep: int = 16, *,
           block_rows: int | None = None) -> CompressedGrad:
    """Compress a flat gradient vector (cast to f32).

    Args:
        g: (n,) tensor of any float dtype, on the CPU or a CUDA device.
        keep: DCT coefficients kept of each 64-sample block, 1..64.
        block_rows: the CUDA kernel's tile (rows per thread block);
            ``None`` sizes it from the rows.  No output depends on it,
            and the plain version on the CPU has no tile.

    Returns:
        The compressed gradient on ``g``'s device: the plain version
        computed it for a CPU tensor, the kernel for a CUDA one.
    """
    if g.dim() != 1:
        raise ValueError(f"encode takes a flat (n,) gradient, got shape "
                         f"{tuple(g.shape)}")
    if not 1 <= keep <= BLOCK:
        raise ValueError(f"keep must be in [1, {BLOCK}], got {keep}")
    n = g.shape[0]
    r = n // BLOCK
    g = g.to(torch.float32)
    tail = g[r * BLOCK:].clone()
    if r == 0:
        return CompressedGrad(
            q=torch.zeros((0, keep), dtype=torch.int8, device=g.device),
            scale=torch.zeros((0, 1), dtype=torch.float32, device=g.device),
            tail=tail, n=n)
    block_rows = _check_block_rows(block_rows, r)
    body = g[:r * BLOCK].reshape(r, BLOCK)
    if g.device.type == "cpu":
        q, s = grad_dct_encode_ref(body, keep)
    else:
        q, s = _launch_encode(body.contiguous(), keep, block_rows)
    return CompressedGrad(q=q, scale=s, tail=tail, n=n)


def decode(cg: CompressedGrad, *,
           block_rows: int | None = None) -> torch.Tensor:
    """Reconstruct the flat f32 gradient (lossy in the compressed span)
    on ``cg``'s device; ``block_rows`` as in :func:`encode`."""
    r, keep = cg.q.shape
    if r == 0:
        return cg.tail[:cg.n]
    if cg.q.dtype != torch.int8 or cg.scale.dtype != torch.float32:
        raise TypeError(f"decode takes int8 codes and f32 scales, got "
                        f"{cg.q.dtype} and {cg.scale.dtype}")
    if tuple(cg.scale.shape) != (r, 1) or not 1 <= keep <= BLOCK:
        raise ValueError(f"decode takes (R, keep <= {BLOCK}) codes and "
                         f"(R, 1) scales, got {tuple(cg.q.shape)} and "
                         f"{tuple(cg.scale.shape)}")
    block_rows = _check_block_rows(block_rows, r)
    if cg.q.device.type == "cpu":
        body = grad_dct_decode_ref(cg.q, cg.scale)
    else:
        body = _launch_decode(cg.q.contiguous(), cg.scale.contiguous(),
                              block_rows)
    if cg.tail.numel() == 0:
        return body.reshape(-1)
    return torch.cat([body.reshape(-1), cg.tail])


def roundtrip(g: torch.Tensor, keep: int = 16) -> torch.Tensor:
    """encode + decode: the projection used inside train steps."""
    return decode(encode(g, keep))
