"""Wrapper of the symbolize CUDA kernel (``csrc/symbolize.cu``) and the
prepared stream the container's table choice works from.

:class:`PreparedStream` symbolises one image's zig-zag stream on its
device and brings only the two 256-bin histograms (and the range guard's
two categories) to the host; :meth:`PreparedStream.payload` then gathers
the chosen tables' codewords and the bit offsets with torch ops on the
same device and packs them with the ``pack_bits`` kernel, so the payload
bytes are the only other thing that crosses to the host.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.entropy import huffman, rle
from repro_torch.kernels import _build, common
from repro_torch.kernels.pack_bits import pack_bits
from repro_torch.kernels.symbolize.ref import AC_LEN, SLOTS, STATS, \
    symbolize_ref

# Kernel launches, counted where the kernel is launched.
launches = {"encode": 0}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("symbolize")
    p = ctypes.c_void_p
    lib.symbolize_launch.argtypes = [p, p, ctypes.c_longlong,
                                     ctypes.c_longlong, p, p, p, p, p, p]
    lib.symbolize_launch.restype = ctypes.c_int
    return lib


def _check_inputs(dc_diff: torch.Tensor, ac: torch.Tensor) -> None:
    if dc_diff.dtype != torch.int64 or ac.dtype != torch.int32:
        raise TypeError(f"symbolize takes int64 DC differences and int32 "
                        f"AC levels, got {dc_diff.dtype} and {ac.dtype}")
    n = dc_diff.shape[0]
    if dc_diff.dim() != 1 or tuple(ac.shape) != (n, AC_LEN):
        raise ValueError(f"symbolize takes (n,) and (n, {AC_LEN}), got "
                         f"{tuple(dc_diff.shape)} and {tuple(ac.shape)}")
    if dc_diff.device != ac.device:
        raise ValueError("symbolize: inputs on different devices")


def _launch(dc_diff: torch.Tensor, ac: torch.Tensor) -> tuple:
    if dc_diff.device.type != "cuda":
        raise ValueError(f"symbolize: expected a CUDA tensor, got "
                         f"{dc_diff.device}")
    dc_diff = dc_diff.contiguous()
    if ac.stride(1) != 1:
        ac = ac.contiguous()
    n = dc_diff.shape[0]
    slots = torch.empty((3, n, SLOTS), dtype=torch.int16,
                        device=dc_diff.device)
    total = torch.empty(n, dtype=torch.int32, device=dc_diff.device)
    stats = torch.zeros(STATS, dtype=torch.int32, device=dc_diff.device)
    if n == 0:
        return slots, total, stats
    lib = _lib()
    with torch.cuda.device(dc_diff.device):
        err = lib.symbolize_launch(
            dc_diff.data_ptr(), ac.data_ptr(), ac.stride(0), n,
            slots[0].data_ptr(), slots[1].data_ptr(), slots[2].data_ptr(),
            total.data_ptr(), stats.data_ptr(), common.cuda_stream(ac))
    _build.check(lib, err, "symbolize")
    launches["encode"] += 1
    return slots, total, stats


def symbolize(dc_diff: torch.Tensor, ac: torch.Tensor) -> tuple:
    """Dense symbol slots of one stream, on the inputs' device.

    Args:
        dc_diff: (n,) int64 DC differences in block order.
        ac: (n, 63) int32 AC tails in zig-zag order (rows may be strided,
            e.g. a view of a (n, 64) zig-zag stream).

    Returns:
        ``(slots, total, stats)`` as
        :func:`repro_torch.kernels.symbolize.ref.symbolize_ref` returns
        them: the plain version on a CPU tensor, the kernel on a CUDA one.
    """
    _check_inputs(dc_diff, ac)
    if dc_diff.device.type == "cpu":
        return symbolize_ref(dc_diff, ac)
    return _launch(dc_diff, ac)


class PreparedStream:
    """One stream symbolised on its device: histograms now, payload on
    demand (the two phases the container's table choice needs).

    Attributes:
        dc_freq, ac_freq: (256,) int64 NumPy histograms of the two
            alphabets, as the reference's ``rle.symbol_frequencies``
            of the stream.

    Raises:
        repro_torch.core.entropy.rle.RangeError: some level needs an
            amplitude wider than 15 bits (the reference's message, DC
            checked first).
    """

    def __init__(self, dc_diff: torch.Tensor, ac: torch.Tensor):
        self._slots, self._total, stats = symbolize(dc_diff, ac)
        stats = stats.cpu().numpy().astype(np.int64)
        for what, cat in (("DC difference", stats[512]),
                          ("AC coefficient", stats[513])):
            if cat > rle.MAX_CATEGORY:
                raise rle.RangeError(
                    f"{what} magnitude needs category {int(cat)} > "
                    f"{rle.MAX_CATEGORY}; levels must fit 15-bit "
                    f"amplitudes")
        self.dc_freq = stats[:256]
        self.ac_freq = stats[256:512]

    def fields(self, dc_table: huffman.CanonicalTable,
               ac_table: huffman.CanonicalTable) -> tuple:
        """The stream's bit fields under the chosen tables, for
        ``pack_bits``: each symbol's code, then its amplitude field.

        The payload's bit count and the check that every symbol has a
        code come from the histograms on the host; the codeword gather
        over the stream's valid slots and the prefix sum of field widths
        run as torch ops on the stream's device.

        Returns:
            ``(codes, widths, starts, total_bits)``: (2k,) int32, int32
            and int64 tensors for the stream's k symbols, and the
            payload's length in bits.

        Raises:
            ValueError: a symbol of the stream has no code in its table.
        """
        dc_code, dc_len = huffman.encoder_luts(dc_table)
        ac_code, ac_len = huffman.encoder_luts(ac_table)
        if (((self.dc_freq > 0) & (dc_len == 0)).any()
                or ((self.ac_freq > 0) & (ac_len == 0)).any()):
            raise ValueError("symbol stream contains a symbol absent from "
                             "the Huffman table")
        sym = np.arange(256)
        # a DC symbol is its amplitude width; an AC symbol's is its low
        # nibble (0 for EOB and ZRL)
        total_bits = int((self.dc_freq * (dc_len + sym)).sum()
                         + (self.ac_freq * (ac_len + (sym & 15))).sum())
        n_syms = int(self.dc_freq.sum() + self.ac_freq.sum())
        dev = self._total.device
        lut = torch.from_numpy(np.stack([dc_code, dc_len, ac_code, ac_len])
                               ).to(device=dev, dtype=torch.int32)
        total = self._total.to(torch.int64)
        row = torch.repeat_interleave(
            torch.arange(total.shape[0], device=dev), total,
            output_size=n_syms)
        slot = (torch.arange(n_syms, device=dev)
                - (torch.cumsum(total, 0) - total)[row])
        flat = row * SLOTS + slot
        syms, amps, alens = (self._slots[i].reshape(-1)[flat].to(
            torch.int64) for i in range(3))
        table = torch.where(slot == 0, 0, 2)
        codes, clens = lut[table, syms], lut[table + 1, syms]
        codes = torch.stack([codes, amps.to(torch.int32)], 1).reshape(-1)
        widths = torch.stack([clens, alens.to(torch.int32)], 1).reshape(-1)
        starts = torch.cumsum(widths, 0, dtype=torch.int64) - widths
        return codes, widths, starts, total_bits

    def payload(self, dc_table: huffman.CanonicalTable,
                ac_table: huffman.CanonicalTable) -> bytes:
        """Huffman-code and pack the stream under the chosen tables
        (:meth:`fields`, then ``pack_bits``): the payload bytes."""
        return pack_bits(*self.fields(dc_table, ac_table)).cpu().numpy(
            ).tobytes()
