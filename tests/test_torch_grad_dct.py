"""The port's grad_dct wrappers and plain version against the JAX
package's grad_dct Pallas kernels, on the CPU.

Inputs are made with NumPy from a seed and handed to both packages; the
reference's kernels run in interpret mode, as ``tests/test_kernels.py``
runs them.  Bounds are the reference's own (``tests/test_kernels.py``,
``TestGradDctKernel``): codes equal, scales rtol 1e-6, decode atol 1e-5,
relative error < 0.05 on a smooth signal, wire ratio > 10 at keep=16,
relative error < 0.01 at keep=64.

One exception, with its reason: XLA and torch sum the 64 products of a
coefficient in different orders, so where ``kept / scale`` sits at .5 a
code may round the other way.  Codes may therefore differ by +-1, on at
most 1 in 10^4 of them (:func:`assert_codes_close`); at these sizes that
is one code per input at most.  The CUDA kernel is held against the
plain version on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

from repro.kernels import grad_dct as jgd
from repro_torch.kernels import _build
from repro_torch.kernels import grad_dct as tgd

KEEPS = (8, 16, 32, 48)
BLOCK_ROWS = (64, 128, 256, 512, 1024)
LENGTHS = (1, 5, 63, 64, 65, 127, 128, 200, 255, 333, 447, 500)


def _t(x):
    """A reference array as a (writable) tensor."""
    return torch.from_numpy(np.array(x))


def _grad(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def assert_codes_close(q, q_ref):
    """Codes within +-1, on at most 1 in 10^4 of them (module docstring);
    returns the mask of codes that differ."""
    q, q_ref = np.asarray(q).astype(np.int32), np.asarray(q_ref).astype(
        np.int32)
    assert q.shape == q_ref.shape
    diff = np.abs(q - q_ref)
    assert diff.max(initial=0) <= 1
    assert int((diff > 0).sum()) <= math.ceil(1e-4 * q.size)
    return diff > 0


def _assert_matches_reference(g, keep, block_rows=None):
    """Port encode/decode against the reference on one flat input."""
    want = jgd.encode(g, keep=keep, block_rows=block_rows)
    got = tgd.encode(torch.from_numpy(g), keep, block_rows=block_rows)
    assert got.n == want.n == g.shape[0]
    flipped = assert_codes_close(got.q, want.q)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    if not flipped.any():
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                                   rtol=1e-6)
    assert np.array_equal(got.tail.numpy(), np.asarray(want.tail))
    # decode from the reference's own codes: atol 1e-5
    same = tgd.CompressedGrad(_t(want.q), _t(want.scale), _t(want.tail),
                              want.n)
    np.testing.assert_allclose(
        tgd.decode(same, block_rows=block_rows).numpy(),
        np.asarray(jgd.decode(want, block_rows=block_rows)), rtol=0,
        atol=1e-5)
    return got


def test_encode_decode_match_reference():
    g = _grad(8192, 8)
    got = _assert_matches_reference(g, 16)
    q_ref, s_ref = jgd.grad_dct_encode_ref(g.reshape(-1, 64), 16)
    assert_codes_close(got.q, q_ref)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(s_ref),
                               rtol=1e-6)


def test_plain_version_matches_reference_oracle_on_many_rows():
    # 4096 rows x 16 codes: enough codes for the 1e-4 share to mean
    # something (at most 7 may flip)
    g = _grad(4096 * 64, 11).reshape(-1, 64)
    q, s = tgd.grad_dct_encode_ref(torch.from_numpy(g), 16)
    q_ref, s_ref = jgd.grad_dct_encode_ref(g, 16)
    flipped = assert_codes_close(q, q_ref)
    rows = ~flipped.any(axis=1)
    np.testing.assert_allclose(s.numpy()[rows], np.asarray(s_ref)[rows],
                               rtol=1e-6)
    np.testing.assert_allclose(
        tgd.grad_dct_decode_ref(_t(q_ref), _t(s_ref)).numpy(),
        np.asarray(jgd.grad_dct_decode_ref(q_ref, s_ref)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("keep", KEEPS)
def test_arbitrary_lengths(n, keep):
    g = _grad(n, n)
    got = _assert_matches_reference(g, keep)
    dec = tgd.decode(got)
    assert dec.shape == (n,) and dec.dtype == torch.float32
    tail = n % 64
    if tail:
        assert np.array_equal(dec[-tail:].numpy(), g[-tail:])


def test_no_full_block_carries_everything_in_the_tail():
    g = _grad(40, 3)
    got, want = tgd.encode(torch.from_numpy(g), 16), jgd.encode(g, keep=16)
    assert tuple(got.q.shape) == tuple(want.q.shape) == (0, 16)
    assert tuple(got.scale.shape) == tuple(want.scale.shape) == (0, 1)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert np.array_equal(tgd.decode(got).numpy(), g)
    assert got.wire_bytes() == want.wire_bytes() == 4 * 40


@pytest.mark.parametrize("block_rows", BLOCK_ROWS)
def test_block_rows_invariant(block_rows):
    # as tests/test_tile_invariance.py::test_grad_dct_block_rows_invariant
    g = _grad(200 * 64 + 9, block_rows)
    want = tgd.encode(torch.from_numpy(g), block_rows=BLOCK_ROWS[-1])
    got = _assert_matches_reference(g, 16, block_rows)
    assert torch.equal(got.q, want.q) and torch.equal(got.scale, want.scale)
    assert torch.equal(got.tail, want.tail)
    assert torch.equal(tgd.decode(want, block_rows=block_rows),
                       tgd.decode(want, block_rows=BLOCK_ROWS[-1]))


def test_smooth_signal_compacts():
    t = np.linspace(0, 4 * np.pi, 4096).astype(np.float32)
    g = torch.from_numpy(np.sin(t) + 0.5 * np.cos(2 * t))
    dec = tgd.roundtrip(g, keep=16)
    assert float(torch.linalg.norm(dec - g) / torch.linalg.norm(g)) < 0.05


def test_wire_bytes_ratio():
    g = torch.from_numpy(_grad(65536, 9))
    cg = tgd.encode(g, keep=16)
    assert g.numel() * 4 / cg.wire_bytes() > 10.0
    assert cg.wire_bytes() == jgd.encode(g.numpy(), keep=16).wire_bytes()
    assert g.numel() * 4 / cg.wire_bytes() == 256 / 20


def test_keep_64_is_near_lossless_modulo_quant():
    g = torch.from_numpy(_grad(4096, 10))
    dec = tgd.roundtrip(g, keep=64)
    assert float(torch.linalg.norm(dec - g) / torch.linalg.norm(g)) < 0.01


def test_roundtrip_matches_reference_roundtrip():
    g = _grad(64 * 50 + 17, 12)
    got = tgd.roundtrip(torch.from_numpy(g), keep=16).numpy()
    want = np.asarray(jgd.roundtrip(g, keep=16))
    cg = tgd.encode(torch.from_numpy(g), 16)
    flipped = assert_codes_close(cg.q, jgd.encode(g, keep=16).q)
    # a flipped code moves its row by one quantisation step
    ok = np.repeat(~flipped.any(axis=1), 64)
    np.testing.assert_allclose(got[:ok.size][ok], want[:ok.size][ok],
                               rtol=0, atol=1e-5)
    assert np.array_equal(got[ok.size:], want[ok.size:])


def test_wrapper_rules():
    g = torch.zeros(256)
    with pytest.raises(TypeError):
        tgd.encode(g, interpret=True)
    with pytest.raises(TypeError):
        tgd.decode(tgd.encode(g), interpret=True)
    for keep in (0, 65):
        with pytest.raises(ValueError, match="keep"):
            tgd.encode(g, keep)
    with pytest.raises(ValueError, match="flat"):
        tgd.encode(g.reshape(4, 64))
    with pytest.raises(ValueError, match="block_rows"):
        tgd.encode(g, block_rows=0)
    before = dict(tgd.launches)
    tgd.decode(tgd.encode(torch.randn(1000)))
    assert tgd.launches == before          # the plain version on the CPU


@pytest.mark.parametrize("what", ["encode", "decode"])
def test_non_cpu_tensor_without_kernel_raises(what):
    # a tensor that is not on the CPU never takes the plain version
    g = torch.empty(256, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        if what == "encode":
            tgd.encode(g)
        else:
            tgd.decode(tgd.CompressedGrad(
                torch.empty(4, 16, dtype=torch.int8, device="meta"),
                torch.empty(4, 1, device="meta"), torch.empty(0), 256))


def test_kernel_is_built_from_the_tree():
    assert "grad_dct" in _build.KERNEL_SOURCES
    src = (_build.CSRC / "grad_dct.cu").read_text()
    for needle in ("kernel.py:61", ":81", "REPRO_EXPORT int grad_dct_encode",
                   "REPRO_EXPORT int grad_dct_decode", "rintf"):
        assert needle in src
