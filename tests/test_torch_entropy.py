"""The port's entropy stage (``repro_torch.core.entropy``) against the JAX
package's, on the CPU.

Inputs are made with NumPy from seeds and handed to both packages.  The
entropy stage is lossless and integer-valued, so every comparison of
tables, bytes, levels and errors is exact; reconstructions decoded from
the same levels are bit-exact for cordic "matched" and within 3 elsewhere
(the exact-IDCT bound of ``tests/test_kernels.py``).
"""

import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import entropy as jentropy
from repro.core import images as jimages
from repro.core.entropy import bitio as jbitio
from repro.core.entropy import container as jcontainer
from repro.core.entropy import huffman as jhuffman
from repro.core.entropy import rle as jrle
from repro.core.entropy import scan as jscan
from repro_torch.core import codec as tcodec
from repro_torch.core import entropy as tentropy
from repro_torch.core.entropy import bitio as tbitio
from repro_torch.core.entropy import container as tcontainer
from repro_torch.core.entropy import huffman as thuffman
from repro_torch.core.entropy import rle as trle
from repro_torch.core.entropy import scan as tscan

DATA_DIR = pathlib.Path(__file__).parent / "data"
FIXTURES = sorted(p.name for p in DATA_DIR.glob("*.dctz"))
CPU = torch.device("cpu")
TRANSFORMS = ["exact", "cordic", "loeffler"]
TABLES = ["auto", "embedded", "shared"]
QUALITIES = [1, 50, 100]


def _table(t):
    return (t.counts, t.symbols)


def _outcome(fn):
    """("ok", value) or (exception class name, message)."""
    try:
        return ("ok", fn())
    except ValueError as e:
        return (type(e).__name__, str(e))


# --- huffman -----------------------------------------------------------------

def _fib(n):
    f = [1, 1]
    while len(f) < n:
        f.append(f[-1] + f[-2])
    return np.array(f[:n])


HISTOGRAMS = {
    "one_symbol": np.bincount([7], minlength=256),
    "two_symbols": np.array([5, 3]),
    "uniform_255": np.ones(255, np.int64),
    "skewed": np.arange(40) ** 3 % 97 + 1,
    # Fibonacci frequencies give a maximally deep Huffman tree: 30
    # symbols need depth 29, so the T.81 K.3 length limit must act
    "length_limit_fib30": _fib(30),
    "length_limit_pow2": 2 ** np.arange(24),
}


@pytest.mark.parametrize("name", sorted(HISTOGRAMS))
def test_build_table_matches_reference(name):
    freqs = HISTOGRAMS[name]
    want = jhuffman.build_table(freqs)
    got = thuffman.build_table(freqs)
    assert _table(got) == _table(want)
    assert got.to_segment() == want.to_segment()
    assert thuffman.build_table_memo(freqs) == got
    assert thuffman.coded_bits(got, freqs) == jhuffman.coded_bits(want,
                                                                  freqs)
    for g, w in zip(got.encoder_luts(), want.encoder_luts()):
        np.testing.assert_array_equal(g, w)
    assert list(got.code_lengths()) == list(want.code_lengths())
    if name.startswith("length_limit"):
        assert max(length for _, length in want.code_lengths()) == 16


@pytest.mark.parametrize("hist", [[0, 0, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                   0, 0, 0, 0, 0, 0, 3, 2],
                                  [0, 1, 1, 1] + [1] * 20 + [2]])
def test_limit_lengths_matches_reference(hist):
    assert thuffman._limit_lengths(list(hist)) == \
        jhuffman._limit_lengths(list(hist))


def test_annex_k_tables_and_registry_equal_reference():
    for tid in jhuffman.DEFAULT_TABLES.ids():
        assert _table(thuffman.DEFAULT_TABLES.get(tid)) == \
            _table(jhuffman.DEFAULT_TABLES.get(tid))
    assert thuffman.DEFAULT_TABLES.ids() == jhuffman.DEFAULT_TABLES.ids()
    assert (thuffman.STANDARD_DC_LUMA_ID, thuffman.STANDARD_AC_LUMA_ID) == \
        (jhuffman.STANDARD_DC_LUMA_ID, jhuffman.STANDARD_AC_LUMA_ID)
    assert thuffman.coded_bits(thuffman.STANDARD_DC_LUMA,
                               np.bincount([12], minlength=256)) is None


@pytest.mark.parametrize("seg", [
    b"\x00" * 5,                                  # counts truncated
    b"\x00\x02" + b"\x00" * 14 + b"\x01",          # a symbol missing
    b"\x00\x02" + b"\x00" * 14 + b"\x01\x01",      # duplicate symbol
    b"\x03" + b"\x00" * 15 + b"\x01\x02\x03"])     # Kraft sum > 1
def test_invalid_table_segments_raise_alike(seg):
    want = _outcome(lambda: _table(jhuffman.CanonicalTable.from_segment(
        seg)[0]))
    got = _outcome(lambda: _table(thuffman.CanonicalTable.from_segment(
        seg)[0]))
    assert got == want and want[0] == "InvalidTable"


# --- bitio, rle, scan --------------------------------------------------------

def test_bitio_matches_reference():
    rng = np.random.default_rng(0)
    for m in (0, 1, 300):
        lengths = rng.integers(0, 17, m)
        codes = rng.integers(0, 1 << 16, m)
        payload = jbitio.pack_bits(codes, lengths)
        np.testing.assert_array_equal(tbitio.bit_windows(payload),
                                      jbitio.bit_windows(payload))
    assert issubclass(tbitio.TruncatedStream, ValueError)
    assert issubclass(jbitio.TruncatedStream, ValueError)


def test_rle_helpers_match_reference():
    assert (trle.EOB, trle.ZRL, trle.MAX_CATEGORY, trle.AC_LEN) == \
        (jrle.EOB, jrle.ZRL, jrle.MAX_CATEGORY, jrle.AC_LEN)
    assert issubclass(trle.RangeError, ValueError)
    assert issubclass(jrle.RangeError, ValueError)


def test_scan_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.integers(-50, 50, (3, 5, 8, 8)).astype(np.int32)
    np.testing.assert_array_equal(tscan.zigzag_perm(), jscan.zigzag_perm())
    np.testing.assert_array_equal(tscan.inverse_zigzag_perm(),
                                  jscan.inverse_zigzag_perm())
    z = tscan.block_stream(torch.from_numpy(q))
    jz = np.asarray(jscan.block_stream(q))
    np.testing.assert_array_equal(z.numpy(), jz)
    np.testing.assert_array_equal(tscan.unblock_stream(z, 3, 5).numpy(), q)
    dc, ac = tscan.dc_differential(z)
    jdc, jac = jscan.dc_differential(jz)
    np.testing.assert_array_equal(dc.numpy(), np.asarray(jdc))
    np.testing.assert_array_equal(ac.numpy(), np.asarray(jac))
    np.testing.assert_array_equal(
        tscan.assemble_stream(tscan.dc_integrate(dc), ac).numpy(), jz)


# --- encode: byte parity -----------------------------------------------------

def _levels(transform, quality, seed=0, shape=(40, 52)):
    img = jimages.lena_like(*shape, seed=seed)
    return np.array(jcodec.compress(img, quality, transform).qcoeffs), \
        shape


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_encode_qcoeffs_bytes_match_reference(transform, quality):
    q, shape = _levels(transform, quality)
    for tables in TABLES:
        want = jcontainer.encode_qcoeffs(q, quality, transform, shape,
                                         tables=tables)
        got = tcontainer.encode_qcoeffs(torch.from_numpy(q), quality,
                                        transform, shape, tables=tables)
        assert got == want, tables
        # the host-side zig-zag sibling codes the same bytes
        z = np.asarray(jscan.block_stream(q))
        assert tcontainer.encode_zigzag_host(z, quality, transform, shape,
                                             tables=tables) == want


@pytest.mark.parametrize("tables", TABLES)
def test_wide_levels_encode_or_fail_alike(tables):
    # categories 12..15 the shared Annex K tables cannot code: "shared"
    # must raise the reference's error, the other policies embed
    rng = np.random.default_rng(2)
    q = rng.integers(-3, 4, (2, 3, 8, 8)).astype(np.int32)
    q[0, 0, 0, 0] = 4000
    q[1, 2, 3, 3] = -20000
    want = _outcome(lambda: jcontainer.encode_qcoeffs(
        q, 50, "exact", (16, 24), tables=tables))
    got = _outcome(lambda: tcontainer.encode_qcoeffs(
        q, 50, "exact", (16, 24), tables=tables))
    assert got == want
    assert (want[0] == "ValueError") == (tables == "shared")


@pytest.mark.parametrize("where", ["dc", "ac"])
def test_levels_out_of_range_raise_the_reference_error(where):
    q = np.zeros((1, 2, 8, 8), np.int32)
    if where == "dc":
        q[0, 1, 0, 0] = 1 << 15
    else:
        q[0, 0, 7, 7] = -(1 << 16)
    with pytest.raises(jrle.RangeError) as want:
        jcontainer.encode_qcoeffs(q, 50, "exact", (8, 16))
    with pytest.raises(trle.RangeError) as got:
        tcontainer.encode_qcoeffs(torch.from_numpy(q), 50, "exact", (8, 16))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs, match", [
    ({"quality": 0}, "quality"), ({"transform": "dct"}, "transform"),
    ({"tables": "mixed"}, "tables"), ({"orig_shape": (9, 16)}, "grid")])
def test_encode_argument_errors_match_reference(kwargs, match):
    q = np.zeros((1, 2, 8, 8), np.int32)
    args = {"quality": 50, "transform": "exact", "orig_shape": (8, 16),
            "tables": "auto", **kwargs}
    want = _outcome(lambda: jcontainer.encode_qcoeffs(q, **args))
    got = _outcome(lambda: tcontainer.encode_qcoeffs(torch.from_numpy(q),
                                                     **args))
    assert got == want and match in want[1]


def test_compressed_image_bytes_match_reference():
    img = jimages.cablecar_like(48, 40)
    c = tcodec.compress(img, 30, "cordic", device="cpu")
    jc = jcodec.compress(img, 30, "cordic")
    for tables in TABLES:
        assert c.to_bytes(tables=tables) == jc.to_bytes(tables=tables)
    assert c.nbytes == jc.nbytes
    assert c.compression_ratio() == jc.compression_ratio()
    assert tentropy.encode_image(img, 30, "cordic", device="cpu") == \
        jentropy.encode_image(img, 30, "cordic")


# --- decode: golden fixtures, cross streams, errors --------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_golden_fixtures_decode_to_reference_levels(name):
    data = (DATA_DIR / name).read_bytes()
    jq, jhdr = jcontainer.decode_qcoeffs(data)
    q, hdr = tcontainer.decode_qcoeffs(data, device="cpu")
    assert hdr == jhdr and tentropy.read_header(data) == \
        jentropy.read_header(data)
    assert q.dtype == torch.int32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert tentropy.verify_crc(data) and jentropy.verify_crc(data)
    c = tcodec.CompressedImage.from_bytes(data, device="cpu")
    assert c.nbytes == len(data) and c.orig_shape == (hdr["height"],
                                                      hdr["width"])
    for mode in ("standard", "matched"):
        rec = tentropy.decode_image(data, mode, device="cpu")
        want = np.asarray(jentropy.decode_image(data, mode))
        assert rec.shape == want.shape and rec.dtype == torch.uint8
        if hdr["transform"] == "cordic" and mode == "matched":
            np.testing.assert_array_equal(rec.numpy(), want)
        else:
            np.testing.assert_allclose(rec.numpy().astype(np.float32),
                                       want.astype(np.float32), atol=3)


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_streams_cross_both_ways(transform):
    q, shape = _levels(transform, 75, seed=3, shape=(64, 72))
    for tables in TABLES:
        ours = tcontainer.encode_qcoeffs(torch.from_numpy(q), 75, transform,
                                         shape, tables=tables)
        theirs = jcontainer.encode_qcoeffs(q, 75, transform, shape,
                                           tables=tables)
        np.testing.assert_array_equal(
            np.asarray(jcontainer.decode_qcoeffs(ours)[0]), q)
        np.testing.assert_array_equal(
            tcontainer.decode_qcoeffs(theirs, device="cpu")[0].numpy(), q)


def _reseal(data: bytes) -> bytes:
    """Recompute the CRC so a mutated body passes the framing check."""
    crc = zlib.crc32(data[4:24] + data[jcontainer.HEADER_NBYTES:])
    return data[:24] + struct.pack("<I", crc & 0xFFFFFFFF) + data[28:]


def _stream(tables):
    rng = np.random.default_rng(7)
    z = np.zeros((9, 64), np.int64)
    z[:, 0] = rng.integers(-300, 300, 9)
    nz = rng.random((9, 63)) < 0.2
    z[:, 1:][nz] = rng.integers(-40, 40, int(nz.sum()))
    return jentropy.encode_zigzag_host(z, 50, "exact", (24, 24),
                                       tables=tables)


def _decode_both(data):
    want = _outcome(lambda: jentropy.decode_zigzag_host(data)[0].tobytes())
    got = _outcome(lambda: tentropy.decode_zigzag_host(
        data, device="cpu")[0].tobytes())
    return got, want


@pytest.mark.parametrize("tables", ["embedded", "shared"])
def test_malformed_streams_raise_the_reference_errors(tables):
    data = _stream(tables)
    cases = [data[:cut] for cut in (0, 3, 20, 27, 28, 40, len(data) - 1)]
    cases += [data + b"\x00", data + b"junk"]               # trailing
    cases += [data[:-1] + bytes([data[-1] ^ 0x10])]         # CRC
    cases += [data[:5] + b"\x01" + data[6:], b"JPEG" + data[4:],
              data[:4] + b"\x07" + data[5:]]                # header
    seen = set()
    for bad in cases:
        got, want = _decode_both(bad)
        assert got == want
        assert want[0] == "BitstreamError"
        seen.add(want[1].split(":")[0])
    assert {"truncated header", "truncated payload", "CRC mismatch"} <= seen


@pytest.mark.parametrize("tables", ["embedded", "shared"])
def test_resealed_bit_flips_decode_or_fail_like_the_reference(tables):
    # every bit of the tables and payload, flipped and resealed with a
    # fresh CRC, so the corruption reaches the entropy decoders
    data = _stream(tables)
    kinds = set()
    for byte in range(jcontainer.HEADER_NBYTES, len(data)):
        for bit in range(8):
            b = bytearray(data)
            b[byte] ^= 1 << bit
            got, want = _decode_both(_reseal(bytes(b)))
            assert got == want, (byte, bit)
            kinds.add(want[0] if want[0] == "ok" else
                      want[1].split(":")[0])
    assert "ok" in kinds and "bad entropy payload" in kinds


def test_dc_table_coding_a_symbol_above_15_is_rejected_alike():
    data = _stream("embedded")
    hdr = jentropy.read_header(data)
    assert hdr["dc_table_id"] == 0
    off = jcontainer.HEADER_NBYTES
    nsym = sum(data[off:off + 16])
    # rename the DC table's last symbol to 16 (still a valid table)
    last = off + 16 + nsym - 1
    bad = _reseal(data[:last] + bytes([16]) + data[last + 1:])
    got, want = _decode_both(bad)
    assert got == want
    assert "magnitude-category" in want[1]


# --- wrapper rules -----------------------------------------------------------

def test_decoders_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = (DATA_DIR / FIXTURES[0]).read_bytes()
    for call in (lambda: tentropy.decode_zigzag_host(data),
                 lambda: tentropy.decode_qcoeffs(data),
                 lambda: tentropy.decode_image(data),
                 lambda: tcodec.CompressedImage.from_bytes(data)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
