"""Entropy-coded bitstream stage: quantised levels <-> ``DCTZ`` bytes.

The port of ``repro.core.entropy``, with the reference's public names:

* :mod:`scan`      — zig-zag scan and DC differential (torch ops),
* :mod:`rle`       — the symbol alphabet, its helpers and the scalar
  oracles (NumPy),
* :mod:`huffman`   — canonical length-limited Huffman tables and the
  shared-table registry (a copy of the reference's),
* :mod:`bitio`     — MSB-first packing and 16-bit windows (NumPy),
* :mod:`container` — the ``DCTZ`` container, encoders and decoders.

Symbolisation, packing and unpacking run in the ``symbolize``,
``pack_bits`` and ``unpack_bits`` kernels (:mod:`repro_torch.kernels`).
"""

from repro_torch.core.entropy.bitio import TruncatedStream
from repro_torch.core.entropy.container import (BitstreamError,
                                                decode_image,
                                                decode_qcoeffs,
                                                decode_zigzag_host,
                                                encode_image,
                                                encode_qcoeffs,
                                                encode_zigzag_host,
                                                read_header, verify_crc)

__all__ = ["BitstreamError", "TruncatedStream", "decode_image",
           "decode_qcoeffs", "decode_zigzag_host", "encode_image",
           "encode_qcoeffs", "encode_zigzag_host", "read_header",
           "verify_crc"]
