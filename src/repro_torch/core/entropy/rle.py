"""DC-differential + run-length symbol alphabet: its constants and the
error for levels it cannot code.

The port's encode symbolises on the levels' device (the ``symbolize``
kernel) and its decode unpacks there (the ``unpack_bits`` kernel); the
scalar oracles of ``repro.core.entropy.rle`` stay in the reference,
where the tests take them from.

Symbol alphabet (docs/bitstream.md):

* DC: the magnitude category ``S`` of the DC difference (0..15), then
  ``S`` raw amplitude bits.
* AC: one byte ``(run << 4) | size`` per nonzero coefficient, where
  ``run`` is the number of zeros skipped (0..15) and ``size`` its
  magnitude category (1..15), then ``size`` amplitude bits.  Two
  specials: ``0x00`` (EOB) ends a block early, ``0xF0`` (ZRL) skips 16
  zeros without coding a coefficient.
* amplitudes use JPEG's one's-complement convention: ``v > 0`` codes as
  ``v``; ``v < 0`` codes as ``v + 2**size - 1``.
"""

EOB = 0x00
ZRL = 0xF0
MAX_CATEGORY = 15          # amplitudes are at most 15 bits
AC_LEN = 63                # zig-zag positions 1..63


class RangeError(ValueError):
    """A quantised level is too large for a 15-bit amplitude field."""
