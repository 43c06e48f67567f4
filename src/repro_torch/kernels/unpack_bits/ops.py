"""Wrapper of the unpack_bits CUDA kernel (``csrc/unpack_bits.cu``) and
the payload decode built on it.

:func:`unpack_bits` decodes one entropy payload: the staging words come
from the kernel (or, for the CPU, its plain version) in one array, cross
to the host in one copy, and :func:`repro_torch.kernels.unpack_bits.ref.
resolve` walks the true chain there, as the reference's decoder does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.entropy import bitio, huffman
from repro_torch.kernels import _build, common
from repro_torch.kernels.unpack_bits.ref import (AC_LEN, MAX_CATEGORY,
                                                 resolve, unpack_words_ref)

# Kernel launches, counted where the kernel is launched.
launches = {"decode": 0}

#: Bit offsets each CTA resolves.  Any multiple of 32 from 32 to
#: MAX_TILE_BITS gives the same words; the CTA stages MARGIN_BITS more.
TILE_BITS = 2048
#: A block whose DC codeword starts in a tile ends within this many bits
#: (31 bits of DC unit + 63 AC units of 31 + a 16-bit EOB = 2000).
MARGIN_BITS = 2048
#: Shared memory per staged offset: an int32 AC word and 7 int16 pairs
#: of pointer-doubling levels; the CTA may have 227 KB.
MAX_TILE_BITS = (232448 - 2432) // 32 - MARGIN_BITS
#: Outcome words hold ``bit offset << 2`` in int32, as the reference's.
MAX_PAYLOAD_BITS = (1 << 29) - 1 - 2 * MARGIN_BITS


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("unpack_bits")
    p = ctypes.c_void_p
    lib.unpack_bits_launch.argtypes = [p, ctypes.c_longlong, p, p, p,
                                       ctypes.c_int, p]
    lib.unpack_bits_launch.restype = ctypes.c_int
    return lib


def table_params(table: huffman.CanonicalTable) -> tuple:
    """Canonical decode parameters for the bounds matcher.

    Returns ``(params (48,) int32, symbols (256,) int32)`` where
    ``params`` is ``mincode[16] | maxcode[16] | valptr[16]``: at code
    length ``L`` (1-based), valid codes are exactly ``mincode[L-1] ..
    maxcode[L-1]`` (``maxcode == -1`` when the table has no codes of
    that length) and the matching symbol is ``symbols[valptr[L-1] +
    code - mincode[L-1]]`` — the T.81 F.2.2.3 decoder state, evaluated
    for all 16 lengths at once since prefix-free codes make at most one
    length match.
    """
    params = np.full(48, -1, np.int32)
    syms = np.zeros(256, np.int32)
    syms[:len(table.symbols)] = table.symbols
    code = 0
    k = 0
    for i, c in enumerate(table.counts):
        if c:
            params[i] = code                # mincode
            params[16 + i] = code + c - 1   # maxcode
            params[32 + i] = k              # valptr
        else:
            params[i] = 0
            params[32 + i] = 0
        code = (code + c) << 1
        k += c
    return params, syms


def _launch(payload: torch.Tensor, params: torch.Tensor,
            syms: torch.Tensor, tile_bits: int) -> torch.Tensor:
    if payload.device.type != "cuda":
        raise ValueError(f"unpack_bits: expected a CUDA tensor, got "
                         f"{payload.device}")
    if not (32 <= tile_bits <= MAX_TILE_BITS and tile_bits % 32 == 0):
        raise ValueError(f"tile_bits must be a multiple of 32 in "
                         f"[32, {MAX_TILE_BITS}], got {tile_bits}")
    payload, params, syms = (t.contiguous() for t in (payload, params, syms))
    nbytes = payload.shape[0]
    words = torch.empty((3, 8 * nbytes + 1), dtype=torch.int32,
                        device=payload.device)
    lib = _lib()
    with torch.cuda.device(payload.device):
        err = lib.unpack_bits_launch(
            payload.data_ptr(), nbytes, params.data_ptr(), syms.data_ptr(),
            words.data_ptr(), tile_bits, common.cuda_stream(payload))
    _build.check(lib, err, "unpack_bits")
    launches["decode"] += 1
    return words


def unpack_words(payload: torch.Tensor, params: torch.Tensor,
                 syms: torch.Tensor, *,
                 tile_bits: int = TILE_BITS) -> torch.Tensor:
    """Staging words at every bit offset of a payload.

    Args:
        payload: (nbytes,) uint8 entropy payload.
        params: (96,) int32 :func:`table_params` of the DC table, then of
            the AC table.
        syms: (512,) int32 symbol lists of the two tables.
        tile_bits: bit offsets per CTA of the kernel; the words do not
            depend on it (the plain version has no tiles).

    Returns:
        (3, 8 * nbytes + 1) int32 DC unit, AC unit and AC outcome words
        on the payload's device (layouts in :mod:`.ref`): the plain
        version on a CPU tensor, the kernel on a CUDA one.

    Raises:
        NotImplementedError: the payload is too long for int32 outcome
            words (a limit of the port, not a malformed stream).
    """
    if (payload.dtype, params.dtype, syms.dtype) != (
            torch.uint8, torch.int32, torch.int32):
        raise TypeError(f"unpack_bits takes a uint8 payload and int32 "
                        f"tables, got {payload.dtype}, {params.dtype} and "
                        f"{syms.dtype}")
    if payload.dim() != 1 or params.shape != (96,) or syms.shape != (512,):
        raise ValueError("unpack_bits takes (nbytes,), (96,) and (512,) "
                         "tensors")
    if 8 * payload.shape[0] > MAX_PAYLOAD_BITS:
        raise NotImplementedError(
            f"payload of {8 * payload.shape[0]} bits exceeds "
            f"the {MAX_PAYLOAD_BITS} that int32 outcome words address")
    if payload.device.type == "cpu":
        return unpack_words_ref(payload, params, syms)
    return _launch(payload, params, syms, tile_bits)


def unpack_bits(payload: bytes, n_blocks: int,
                dc_table: huffman.CanonicalTable,
                ac_table: huffman.CanonicalTable, *, device: torch.device,
                tile_bits: int = TILE_BITS) -> tuple:
    """Decode one entropy payload into ``(dc_diff, ac)`` coefficients.

    Same contract as the reference's ``rle.decode_payload``: same
    values, same errors at the same bit offsets.

    Args:
        payload: MSB-first packed entropy bytes (1-padded tail).
        n_blocks: number of 8x8 blocks encoded in the payload.
        dc_table: magnitude-category Huffman table (symbols <= 15).
        ac_table: (run, size) Huffman table.
        device: where the staging runs ("cuda": the kernel).
        tile_bits: the kernel's tile, see :func:`unpack_words`.

    Returns:
        ``(dc_diff (n_blocks,) int32, ac (n_blocks, 63) int32)`` NumPy
        arrays.

    Raises:
        bitio.TruncatedStream: the payload ends mid-block.
        ValueError: an invalid Huffman prefix, a coefficient overrun, or
            a DC table coding a symbol above 15.
        NotImplementedError: see :func:`unpack_words`.
    """
    if dc_table.symbols and max(dc_table.symbols) > MAX_CATEGORY:
        raise ValueError(f"DC table codes symbol {max(dc_table.symbols)} "
                         f"> {MAX_CATEGORY}: not a magnitude-category "
                         f"alphabet")
    if n_blocks == 0:
        return np.zeros(0, np.int32), np.zeros((0, AC_LEN), np.int32)
    dc_params, dc_syms = table_params(dc_table)
    ac_params, ac_syms = table_params(ac_table)
    host = torch.from_numpy(np.concatenate(
        [dc_params, ac_params, dc_syms, ac_syms]))
    pay = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    pay, tabs = pay.to(device), host.to(device)
    words = unpack_words(pay, tabs[:96], tabs[96:], tile_bits=tile_bits)
    dcw, acw, outc = words.cpu().numpy()
    nbits = 8 * len(payload)
    return resolve(bitio.bit_windows(payload), nbits, n_blocks, nbits + 1,
                   lambda t: (dcw, acw, outc))
