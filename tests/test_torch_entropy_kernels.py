"""The port's entropy kernels (symbolize, pack_bits, unpack_bits) against
the JAX package's Pallas kernels and scalar oracles, on the CPU.

On the CPU each wrapper runs its plain PyTorch version; the reference's
Pallas kernels run in interpret mode, as ``tests/test_symbolize.py`` and
``tests/test_unpack_bits.py`` run them, on small inputs (at most about
100 blocks).  Every comparison here is exact: symbols, histograms, bytes
and words are integers.  The CUDA kernels are held against the plain
versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.entropy import bitio as jbitio
from repro.core.entropy import huffman as jhuffman
from repro.core.entropy import rle as jrle
from repro.kernels.pack_bits import pack_bits as j_pack_bits
from repro.kernels.symbolize import kernel as j_sym_kernel
from repro.kernels.symbolize import ref as j_sym_ref
from repro.kernels.unpack_bits import kernel as j_unpack_kernel
from repro.kernels.unpack_bits import ops as j_unpack_ops
from repro_torch.core.entropy import bitio as tbitio
from repro_torch.core.entropy import container as tcontainer
from repro_torch.core.entropy import huffman as thuffman
from repro_torch.core.entropy import rle as trle
from repro_torch.kernels import _build
from repro_torch.kernels import pack_bits as t_pack
from repro_torch.kernels import symbolize as t_sym
from repro_torch.kernels import unpack_bits as t_unpack

DENSITIES = (0.02, 0.15, 0.6)


def _rand_blocks(n, seed, density, max_mag=255):
    rng = np.random.default_rng(seed)
    dc_diff = rng.integers(-max_mag, max_mag + 1, n)
    ac = rng.integers(-max_mag, max_mag + 1, (n, 63))
    ac[rng.uniform(size=ac.shape) >= density] = 0
    return dc_diff, ac


def _adversarial():
    """Blocks hitting every structural edge: all-zero, three ZRLs and no
    EOB, dense, leading and trailing nonzeros, +-32767 amplitudes."""
    ac = np.stack([
        np.zeros(63, np.int64),
        np.r_[np.zeros(62, np.int64), 7],
        np.ones(63, np.int64),
        np.r_[5, np.zeros(61, np.int64), -1],
        np.full(63, 32767, np.int64),
        np.full(63, -32767, np.int64),
        np.r_[np.zeros(16, np.int64), 3, np.zeros(31, np.int64), -2,
              np.zeros(14, np.int64)],
    ])
    dc = np.array([0, 32767, -32767, 1, -1, 16, -16384], np.int64)
    return dc, ac


def _blocks(case):
    if case == "adversarial":
        return _adversarial()
    n, seed, density = case
    return _rand_blocks(n, seed, density)


def _sym(dc_diff, ac):
    return t_sym.symbolize(torch.from_numpy(np.asarray(dc_diff, np.int64)),
                           torch.from_numpy(np.asarray(ac, np.int32)))


CASES = ["adversarial", (1, 0, 0.15), (37, 1, 0.02), (64, 2, 0.15),
         (90, 3, 0.6)]


# --- symbolize ---------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=str)
def test_symbolize_matches_pallas(case):
    dc_diff, ac = _blocks(case)
    n = dc_diff.shape[0]
    # pad to the TPU kernel's tile: rows past nrows are padding, with no
    # histogram weight and total 0
    n_pad = -(-n // 32) * 32 + 32
    dc_p = np.zeros((n_pad, 1), np.int32)
    dc_p[:n, 0] = dc_diff
    ac_p = np.zeros((n_pad, 63), np.int32)
    ac_p[:n] = ac
    syms, amps, lens, total, dc_h, ac_h = (np.asarray(a) for a in
                                           j_sym_kernel.symbolize_pallas(
        dc_p, ac_p, np.array([n], np.int32), tile_blocks=32,
        interpret=True))
    slots, t_total, stats = _sym(dc_diff, ac)
    assert slots.dtype == torch.int16 and t_total.dtype == torch.int32
    np.testing.assert_array_equal(t_total.numpy(), total[:n, 0])
    assert (total[n:] == 0).all()
    np.testing.assert_array_equal(stats[:256].numpy(), dc_h[0])
    np.testing.assert_array_equal(stats[256:512].numpy(), ac_h[0])
    valid = np.arange(64)[None, :] < total[:n]
    for got, want in zip(slots.numpy(), (syms, amps, lens)):
        np.testing.assert_array_equal(got[valid], want[:n][valid])
    assert (stats[512:].numpy() <= trle.MAX_CATEGORY).all()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_symbolize_matches_staged_reference_and_oracle(case):
    dc_diff, ac = _blocks(case)
    want = j_sym_ref.symbolize_dense(dc_diff, ac)
    slots, total, stats = _sym(dc_diff, ac)
    np.testing.assert_array_equal(total.numpy(), want.total)
    np.testing.assert_array_equal(stats[:256].numpy(), want.dc_freq)
    np.testing.assert_array_equal(stats[256:512].numpy(), want.ac_freq)
    # the whole dense layout: empty slots keep (EOB, 0, 0), as the
    # staged reference leaves them
    for got, w in zip(slots.numpy(), (want.syms, want.amp_vals,
                                      want.amp_lens)):
        np.testing.assert_array_equal(got, w)
    # compacted, the slots are the scalar oracle's stream
    is_dc, syms, vals, lens = jrle.symbolize_reference(dc_diff, ac)
    valid = np.arange(64)[None, :] < total.numpy()[:, None]
    np.testing.assert_array_equal(slots[0].numpy()[valid], syms)
    np.testing.assert_array_equal(slots[1].numpy()[valid], vals)
    np.testing.assert_array_equal(slots[2].numpy()[valid], lens)
    np.testing.assert_array_equal(
        np.broadcast_to(np.arange(64) == 0, valid.shape)[valid], is_dc)


@pytest.mark.parametrize("where", ["dc", "ac"])
@pytest.mark.parametrize("level", [1 << 15, -(1 << 15), 1 << 20,
                                   -(2 ** 31)])
def test_symbolize_range_error_matches_oracle(where, level):
    dc = np.zeros(3, np.int64)
    ac = np.zeros((3, 63), np.int64)
    if where == "dc":
        dc[1] = level
    else:
        ac[2, 40] = level
        dc[0] = 1 << 16         # DC is checked first, as the oracle does
    with pytest.raises(jrle.RangeError) as oracle:
        jrle.symbolize_reference(dc, ac)
    with pytest.raises(trle.RangeError) as port:
        t_sym.PreparedStream(torch.from_numpy(dc),
                             torch.from_numpy(ac.astype(np.int32)))
    assert str(port.value) == str(oracle.value)


def test_dc_difference_wider_than_int32_keeps_its_category():
    # int64 differences: the category of -(2**32 - 1) is 32, not wrapped
    dc = np.array([2 ** 31 - 1, -(2 ** 31) + 0], np.int64)
    dc_diff = np.diff(dc, prepend=0)
    with pytest.raises(jrle.RangeError) as oracle:
        jrle.symbolize_reference(dc_diff, np.zeros((2, 63), np.int64))
    with pytest.raises(trle.RangeError) as port:
        t_sym.PreparedStream(torch.from_numpy(dc_diff),
                             torch.zeros((2, 63), dtype=torch.int32))
    assert str(port.value) == str(oracle.value)


def test_prepared_payload_matches_reference_payload():
    dc_diff, ac = _rand_blocks(40, 7, 0.15)
    prep = t_sym.PreparedStream(torch.from_numpy(dc_diff),
                                torch.from_numpy(ac.astype(np.int32)))
    stream = jrle.symbolize_reference(dc_diff, ac)
    jdc, jac = jrle.symbol_frequencies(stream[0], stream[1])
    np.testing.assert_array_equal(prep.dc_freq, jdc)
    np.testing.assert_array_equal(prep.ac_freq, jac)
    for build in ("embedded", "shared"):
        if build == "embedded":
            dc_t, ac_t = (jhuffman.build_table(jdc),
                          jhuffman.build_table(jac))
        else:
            dc_t, ac_t = jhuffman.STANDARD_DC_LUMA, jhuffman.STANDARD_AC_LUMA
        want = jrle.encode_payload(*stream, dc_t, ac_t)
        got = prep.payload(*(thuffman.CanonicalTable(t.counts, t.symbols)
                             for t in (dc_t, ac_t)))
        assert got == want


def test_prepared_payload_uncodable_symbol_error_matches():
    dc_diff = np.array([3], np.int64)
    ac = np.zeros((1, 63), np.int64)
    tiny = jhuffman.build_table(np.bincount([jrle.EOB], minlength=256))
    with pytest.raises(ValueError) as oracle:
        jrle.encode_payload(*jrle.symbolize_reference(dc_diff, ac), tiny,
                            tiny)
    prep = t_sym.PreparedStream(torch.from_numpy(dc_diff),
                                torch.zeros((1, 63), dtype=torch.int32))
    t_tiny = thuffman.CanonicalTable(tiny.counts, tiny.symbols)
    with pytest.raises(ValueError) as port:
        prep.payload(t_tiny, t_tiny)
    assert str(port.value) == str(oracle.value)


# --- pack_bits ---------------------------------------------------------------

def _fields(m, seed, max_len=16):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len + 1, m)
    codes = rng.integers(0, 1 << 16, m)     # stray high bits are masked
    return codes, lengths


@pytest.mark.parametrize("m, seed, max_len", [
    (1, 0, 16), (7, 1, 3), (200, 2, 16), (333, 3, 9), (64, 4, 0)])
def test_pack_bits_matches_pallas_and_bitio(m, seed, max_len):
    codes, lengths = _fields(m, seed, max_len)
    want = jbitio.pack_bits(codes, lengths)
    total = int(lengths.sum())
    if total:
        assert j_pack_bits(codes, lengths, backend="pallas", tile_bits=64,
                           interpret=True) == want
    starts = np.cumsum(lengths) - lengths
    got = t_pack.pack_bits(torch.from_numpy(codes.astype(np.int32)),
                           torch.from_numpy(lengths.astype(np.int32)),
                           torch.from_numpy(starts), total)
    assert got.dtype == torch.uint8
    assert got.numpy().tobytes() == want


def test_pack_bits_does_not_need_a_prefix_sum_layout():
    # only non-overlap matters: fields given out of order, with gaps
    # filled by other fields, pack to the same bytes
    codes, lengths = _fields(50, 5)
    starts = np.cumsum(lengths) - lengths
    perm = np.random.default_rng(6).permutation(50)
    t = lambda a, dt: torch.from_numpy(np.asarray(a)[perm].astype(dt))
    got = t_pack.pack_bits(t(codes, np.int32), t(lengths, np.int32),
                           t(starts, np.int64), int(lengths.sum()))
    assert got.numpy().tobytes() == jbitio.pack_bits(codes, lengths)


# --- unpack_bits -------------------------------------------------------------

def _payload(dc_diff, ac, std_tables):
    stream = jrle.symbolize_reference(dc_diff, ac)
    if std_tables:
        dc_t, ac_t = jhuffman.STANDARD_DC_LUMA, jhuffman.STANDARD_AC_LUMA
    else:
        f = jrle.symbol_frequencies(stream[0], stream[1])
        dc_t, ac_t = jhuffman.build_table(f[0]), jhuffman.build_table(f[1])
    return jrle.encode_payload(*stream, dc_t, ac_t), dc_t, ac_t


def _port_tables(dc_t, ac_t):
    return (thuffman.CanonicalTable(dc_t.counts, dc_t.symbols),
            thuffman.CanonicalTable(ac_t.counts, ac_t.symbols))


def _words(payload, dc_t, ac_t):
    (dp, ds), (ap, as_) = (t_unpack.table_params(t)
                           for t in _port_tables(dc_t, ac_t))
    return t_unpack.unpack_words(
        torch.from_numpy(np.frombuffer(payload, np.uint8).copy()),
        torch.from_numpy(np.concatenate([dp, ap])),
        torch.from_numpy(np.concatenate([ds, as_]))).numpy()


def _pallas_words(payload, dc_t, ac_t, tile_bits):
    nbits = 8 * len(payload)
    window = tile_bits + 2048
    n_tiles = -(-(nbits + 1) // tile_bits)
    win = jbitio.bit_windows(payload)
    col = np.full((n_tiles * tile_bits + window, 1), 0xFFFF, np.int32)
    col[:win.size, 0] = win
    (dp, ds), (ap, as_) = (j_unpack_ops.table_params(t)
                           for t in (dc_t, ac_t))
    return [np.asarray(a) for a in j_unpack_kernel.unpack_bits_pallas(
        np.array([nbits], np.int32), np.concatenate([dp, ap]), col,
        ds.reshape(1, -1), as_.reshape(1, -1), n_tiles=n_tiles,
        tile_bits=tile_bits, window=window, interpret=True)]


UNPACK_CASES = {
    "random": lambda: (*_rand_blocks(60, 11, 0.15, 1000), True),
    "zrl_chains": lambda: (np.zeros(40, np.int64),
                           np.r_[np.zeros(62), 7][None].repeat(40, 0)
                           .astype(np.int64), False),
    "max_category": lambda: (np.full(12, -32767, np.int64),
                             np.full((12, 63), 32767, np.int64), False),
    "dense": lambda: (*_rand_blocks(6, 12, 1.0, 500), True),
}


@pytest.mark.parametrize("case", sorted(UNPACK_CASES))
def test_unpack_words_match_pallas(case):
    dc_diff, ac, std = UNPACK_CASES[case]()
    payload, dc_t, ac_t = _payload(dc_diff, ac, std)
    got = _words(payload, dc_t, ac_t)
    nbits = 8 * len(payload)
    assert got.shape == (3, nbits + 1) and got.dtype == np.int32
    # a small tile, so that blocks straddle the Pallas kernel's tiles;
    # every offset lies in the tile part of exactly one Pallas window
    tile = 64
    pallas = _pallas_words(payload, dc_t, ac_t, tile)
    p = np.arange(nbits + 1)
    for k in range(3):
        np.testing.assert_array_equal(got[k], pallas[k][p // tile,
                                                        p % tile])


@pytest.mark.parametrize("case", sorted(UNPACK_CASES))
def test_unpack_bits_decodes_like_the_oracles(case):
    dc_diff, ac, std = UNPACK_CASES[case]()
    payload, dc_t, ac_t = _payload(dc_diff, ac, std)
    n = dc_diff.shape[0]
    want = jrle.decode_payload_reference(payload, n, dc_t, ac_t)
    got = t_unpack.unpack_bits(payload, n, *_port_tables(dc_t, ac_t),
                               device=torch.device("cpu"))
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(want[0], dc_diff)
    for g, w in zip(jrle.decode_payload(payload, n, dc_t, ac_t), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tile_bits", [1, 5, 64, 257, 4096])
def test_resolve_output_does_not_depend_on_the_tile(tile_bits):
    # the port's resolver, fed the Pallas kernel's words tile by tile:
    # blocks straddle tiles in every phase, the values stay the oracle's
    dc_diff, ac = _rand_blocks(50, 13, 0.15, 1000)
    payload, dc_t, ac_t = _payload(dc_diff, ac, True)
    nbits = 8 * len(payload)
    words = _words(payload, dc_t, ac_t)
    win = tbitio.bit_windows(payload)

    def get_tile(t):
        return tuple(w[t * tile_bits:] for w in words)

    got = t_unpack.resolve(win, nbits, 50, tile_bits, get_tile)
    want = jrle.decode_payload_reference(payload, 50, dc_t, ac_t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _outcome(fn):
    try:
        dc, ac = fn()
        return ("ok", dc.tobytes(), ac.tobytes())
    except (jbitio.TruncatedStream, tbitio.TruncatedStream, ValueError) as e:
        return (type(e).__name__, str(e))


def test_unpack_errors_match_the_reference_decoder():
    dc_diff, ac = _rand_blocks(20, 14, 0.15, 1000)
    payload, dc_t, ac_t = _payload(dc_diff, ac, True)
    tables = _port_tables(dc_t, ac_t)
    cpu = torch.device("cpu")
    cases = [(payload[:cut], 20) for cut in
             (0, 1, 2, len(payload) // 2, len(payload) - 1)]
    cases += [(payload, 21)]                     # walks into the padding
    rng = np.random.default_rng(15)
    for _ in range(20):                          # flipped bits
        b = bytearray(payload)
        b[int(rng.integers(len(b)))] ^= 1 << int(rng.integers(8))
        cases.append((bytes(b), 20))
    seen = set()
    for data, n in cases:
        want = _outcome(lambda: jrle.decode_payload(data, n, dc_t, ac_t))
        got = _outcome(lambda: t_unpack.unpack_bits(data, n, *tables,
                                                    device=cpu))
        assert got == want
        seen.add(want[0])
    assert {"TruncatedStream", "ValueError"} <= seen


def test_unpack_rejects_an_out_of_spec_dc_table():
    bad_dc = jhuffman.build_table(np.bincount([0, 1, 16, 16], minlength=17))
    with pytest.raises(ValueError) as oracle:
        jrle.decode_payload(b"\x00", 1, bad_dc, jhuffman.STANDARD_AC_LUMA)
    with pytest.raises(ValueError) as port:
        t_unpack.unpack_bits(b"\x00", 1, *_port_tables(
            bad_dc, jhuffman.STANDARD_AC_LUMA), device=torch.device("cpu"))
    assert str(port.value) == str(oracle.value)


@pytest.mark.parametrize("table", ["dc", "ac", "built"])
def test_table_params_match_reference(table):
    t = {"dc": jhuffman.STANDARD_DC_LUMA, "ac": jhuffman.STANDARD_AC_LUMA,
         "built": jhuffman.build_table(np.arange(40) ** 3 % 97 + 1)}[table]
    for got, want in zip(t_unpack.table_params(
            thuffman.CanonicalTable(t.counts, t.symbols)),
            j_unpack_ops.table_params(t)):
        np.testing.assert_array_equal(got, want)


# --- wrapper rules -----------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = [dict(m.launches) for m in (t_sym, t_pack, t_unpack)]
    dc_diff, ac = _rand_blocks(5, 16, 0.3)
    slots, total, stats = _sym(dc_diff, ac)
    ref = t_sym.symbolize_ref(torch.from_numpy(dc_diff),
                              torch.from_numpy(ac.astype(np.int32)))
    assert all(torch.equal(a, b) for a, b in zip((slots, total, stats), ref))
    t_pack.pack_bits(torch.ones(3, dtype=torch.int32),
                     torch.ones(3, dtype=torch.int32),
                     torch.arange(3), 3)
    payload, dc_t, ac_t = _payload(dc_diff, ac, True)
    t_unpack.unpack_bits(payload, 5, *_port_tables(dc_t, ac_t),
                         device=torch.device("cpu"))
    assert [m.launches for m in (t_sym, t_pack, t_unpack)] == before


@pytest.mark.parametrize("call", [
    lambda d: t_sym.symbolize(torch.zeros(2, dtype=torch.int64, device=d),
                              torch.zeros(2, 63, dtype=torch.int32,
                                          device=d)),
    lambda d: t_pack.pack_bits(torch.zeros(2, dtype=torch.int32, device=d),
                               torch.ones(2, dtype=torch.int32, device=d),
                               torch.arange(2, device=d), 2),
    lambda d: t_unpack.unpack_words(
        torch.zeros(2, dtype=torch.uint8, device=d),
        torch.zeros(96, dtype=torch.int32, device=d),
        torch.zeros(512, dtype=torch.int32, device=d)),
], ids=["symbolize", "pack_bits", "unpack_bits"])
def test_non_cpu_tensor_without_kernel_raises(call):
    # a tensor that is not on the CPU never takes the plain version
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        call("meta")


def test_wrappers_reject_other_dtypes():
    with pytest.raises(TypeError, match="int64 DC differences"):
        t_sym.symbolize(torch.zeros(2, dtype=torch.int32),
                        torch.zeros(2, 63, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32 AC"):
        t_sym.symbolize(torch.zeros(2, dtype=torch.int64),
                        torch.zeros(2, 63, dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\(n, 63\)"):
        t_sym.symbolize(torch.zeros(2, dtype=torch.int64),
                        torch.zeros(3, 63, dtype=torch.int32))
    with pytest.raises(TypeError, match="int64 starts"):
        t_pack.pack_bits(torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32), 0)
    with pytest.raises(TypeError, match="uint8 payload"):
        t_unpack.unpack_words(torch.zeros(2, dtype=torch.int8),
                              torch.zeros(96, dtype=torch.int32),
                              torch.zeros(512, dtype=torch.int32))


def test_unpack_words_bound_their_payload(monkeypatch):
    monkeypatch.setattr(t_unpack.ops, "MAX_PAYLOAD_BITS", 64)
    with pytest.raises(NotImplementedError, match="int32 outcome"):
        t_unpack.unpack_words(torch.zeros(9, dtype=torch.uint8),
                              torch.zeros(96, dtype=torch.int32),
                              torch.zeros(512, dtype=torch.int32))


def test_payload_cap_is_not_reported_as_a_corrupt_stream(monkeypatch):
    # a valid stream past the port's int32 cap: the decoder says so, and
    # does not call the stream malformed
    img = np.random.default_rng(3).integers(0, 256, (40, 40), np.uint8)
    data = tcontainer.encode_image(img, 50, "exact", device="cpu")
    monkeypatch.setattr(t_unpack.ops, "MAX_PAYLOAD_BITS", 8)
    with pytest.raises(NotImplementedError, match="int32 outcome"):
        tcontainer.decode_zigzag_host(data, device="cpu")


def test_byte_path_kernels_are_built_from_the_tree():
    for name in ("symbolize", "pack_bits", "unpack_bits"):
        assert name in _build.KERNEL_SOURCES
        assert (_build.CSRC / f"{name}.cu").is_file()
