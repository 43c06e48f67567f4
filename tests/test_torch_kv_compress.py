"""The port's KV-cache compression (``repro_torch.serve.kv_compress``)
against the JAX package's (``repro.serve.kv_compress``), on the CPU.

Caches are synthetic (L, B, T, H, D) tensors made with NumPy from a seed,
smooth along T as attention keys and values are.  The layout is the one
the reference's code computes (its module docstring says otherwise):
codes (L, B, H, D, T/64, keep) int8, scales (L, B, H, D, T/64, 1) f32.

Bounds, as for grad_dct (``tests/test_torch_grad_dct.py``): codes within
+-1 on at most 1 in 10^4 of them, because XLA and torch sum a
coefficient's products in different orders; scales rtol 1e-6 where the
codes agree; reconstructions from the same codes within atol 1e-5 in
f32, and within one bf16 step (2^-8 relative) once cast to bf16.
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.serve import kv_compress as jkv
from repro_torch.serve import kv_compress as tkv

SHAPE = (2, 2, 200, 3, 8)          # (L, B, T, H, D): 3 blocks + 8


def _cache_np(shape=SHAPE, seed=0):
    """Keys varying smoothly along T: a slow sinusoid per column plus a
    little noise, in bf16."""
    rng = np.random.default_rng(seed)
    l, b, t, h, d = shape
    omega = rng.uniform(0.005, 0.05, (l, b, 1, h, d))
    phase = rng.uniform(0, 2 * np.pi, (l, b, 1, h, d))
    amp = rng.normal(size=(l, b, 1, h, d))
    x = amp * np.sin(omega * np.arange(t)[None, None, :, None, None] + phase)
    x += 0.01 * rng.normal(size=shape)
    return x.astype(np.float32).astype(ml_dtypes.bfloat16)


def _torch(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _assert_codes_close(codes, scales, want_codes, want_scales):
    got, want = codes.numpy().astype(np.int32), np.asarray(
        want_codes).astype(np.int32)
    assert got.shape == want.shape and codes.dtype == torch.int8
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1
    assert int((diff > 0).sum()) <= math.ceil(1e-4 * got.size)
    agree = ~(diff > 0).any(-1, keepdims=True)
    assert scales.dtype == torch.float32
    assert tuple(scales.shape) == np.asarray(want_scales).shape
    np.testing.assert_allclose(scales.numpy()[agree],
                               np.asarray(want_scales)[agree], rtol=1e-6)


@pytest.mark.parametrize("keep", [8, 16, 32])
def test_compress_tensor_layout_and_values(keep):
    x = _cache_np()
    codes, scales = tkv.compress_tensor(_torch(x), keep)
    want_c, want_s = jkv.compress_tensor(jnp.asarray(x), keep)
    l, b, t, h, d = SHAPE
    assert tuple(codes.shape) == (l, b, h, d, t // 64, keep)
    assert tuple(scales.shape) == (l, b, h, d, t // 64, 1)
    _assert_codes_close(codes, scales, want_c, want_s)


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_decompress_from_the_same_codes(out_dtype):
    x = _cache_np(seed=1)
    want_c, want_s = jkv.compress_tensor(jnp.asarray(x), 16)
    want = jkv.decompress_tensor(want_c, want_s, getattr(jnp, out_dtype))
    got = tkv.decompress_tensor(_torch(want_c), _torch(want_s),
                                getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    assert tuple(got.shape) == want.shape == (2, 2, 192, 3, 8)
    rtol = 2.0 ** -8 if out_dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=1e-5)


def test_smooth_cache_reconstructs_closely():
    x = _cache_np(seed=2)
    ckv, tails = tkv.compress_cache({"k": _torch(x)}, 16, SHAPE[2])
    rec = tkv.reconstruct_cache(ckv, tails)["k"]
    assert rec.dtype == torch.bfloat16 and tuple(rec.shape) == SHAPE
    err = np.linalg.norm(_f32(rec) - _f32(x)) / np.linalg.norm(_f32(x))
    assert err < 0.05


@pytest.mark.parametrize("prefix_len", [40, 64, 150, 200])
def test_compress_cache_matches_reference(prefix_len):
    # prefix_len < 64 compresses nothing; 150 leaves a ragged prefix
    cache = {"k": _cache_np(seed=3), "v": _cache_np(seed=4),
             "pos": np.arange(5, dtype=np.int32),          # not time-major
             "short": _cache_np((1, 1, 40, 2, 4), seed=5)}  # T < 64
    want_ckv, want_tails = jkv.compress_cache(
        {p: jnp.asarray(a) for p, a in cache.items()}, 16, prefix_len)
    got_ckv, got_tails = tkv.compress_cache(
        {p: _torch(a) for p, a in cache.items()}, 16, prefix_len)
    t_c = prefix_len // 64 * 64
    assert got_ckv.t_compressed == want_ckv.t_compressed == t_c
    assert got_ckv.keep == 16
    assert sorted(got_ckv.codes) == sorted(want_ckv.codes) == ["k", "v"]
    for p in ("k", "v"):
        _assert_codes_close(got_ckv.codes[p], got_ckv.scales[p],
                            want_ckv.codes[p], want_ckv.scales[p])
    for p, tail in got_tails.items():
        assert np.array_equal(_f32(tail), _f32(want_tails[p]))
    assert tkv.wire_bytes(got_ckv, got_tails) == jkv.wire_bytes(
        want_ckv, want_tails)

    rec = tkv.reconstruct_cache(got_ckv, got_tails)
    want_rec = jkv.reconstruct_cache(want_ckv, want_tails)
    for p, a in cache.items():
        assert tuple(rec[p].shape) == a.shape
        assert rec[p].dtype == _torch(a).dtype
        if p in ("k", "v"):
            # raw tail exact; the head within the bounds above when the
            # codes agree
            assert np.array_equal(_f32(rec[p][:, :, t_c:]),
                                  _f32(a[:, :, t_c:]))
            if np.array_equal(got_ckv.codes[p].numpy(),
                              np.asarray(want_ckv.codes[p])):
                np.testing.assert_allclose(_f32(rec[p]), _f32(want_rec[p]),
                                           rtol=2.0 ** -8, atol=1e-5)
        else:
            assert np.array_equal(_f32(rec[p]), _f32(a))


def test_wire_bytes_counts_codes_scales_and_raw_tails():
    x = _torch(_cache_np())
    ckv, tails = tkv.compress_cache({"k": x}, 16, 150)
    nb_cols = 2 * 2 * 3 * 8 * 2          # columns x compressed blocks
    assert tkv.wire_bytes(ckv, tails) == (nb_cols * 16 + nb_cols * 4
                                          + 2 * 2 * 72 * 3 * 8 * 2)

