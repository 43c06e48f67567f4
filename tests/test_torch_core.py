"""The PyTorch port's core modules against the JAX package, on the CPU.

Inputs are made with NumPy from a seed and handed to both packages;
bounds are stated per test.  CORDIC paths must be bit-exact (the port
repeats the reference's float32 operations in order); exact-DCT products
may differ in summation order.
"""

import ast
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import cordic as jcordic
from repro.core import dct as jdct
from repro.core import images as jimages
from repro.core import loeffler as jloeffler
from repro.core import metrics as jmetrics
from repro.core import quant as jquant
from repro_torch import resolve_device
from repro_torch.core import codec as tcodec
from repro_torch.core import constants_from_reference
from repro_torch.core import cordic as tcordic
from repro_torch.core import dct as tdct
from repro_torch.core import images as timages
from repro_torch.core import loeffler as tloeffler
from repro_torch.core import metrics as tmetrics
from repro_torch.core import quant as tquant

ROOT = pathlib.Path(__file__).resolve().parents[1]
QUALITIES = [1, 10, 50, 90, 100]
CONFIGS = {"paper": (jcordic.PAPER_CONFIG, tcordic.PAPER_CONFIG),
           "exact": (jcordic.EXACT_CONFIG, tcordic.EXACT_CONFIG)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _coeffs(shape, seed):
    return np.random.default_rng(seed).normal(scale=60, size=shape).astype(
        np.float32)


# --- package rules ---------------------------------------------------------

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    banned = ("jax", "jaxlib", "repro")
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, (
                f"{path.name}:{node.lineno} imports {name}")


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcodec.roundtrip(np.zeros((8, 8), np.uint8))
    assert resolve_device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# --- constants ---------------------------------------------------------------

@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_constants_equal_reference(quality, config):
    jcfg, tcfg = CONFIGS[config]
    ref = constants_from_reference(
        np.asarray(jdct.dct_matrix(8)), np.asarray(jdct.kron_dct_matrix(8)),
        np.asarray(jquant.qtable(quality)),
        (jcfg.iterations, jcfg.gain_terms, jcfg.fixed_point_bits))
    assert torch.equal(tdct.dct_matrix(8), ref.dct_c8)
    assert torch.equal(tdct.kron_dct_matrix(8), ref.kron)
    assert torch.equal(tquant.qtable(quality), ref.qtable)
    assert ref.cordic_config == tcfg


def test_constants_from_reference_rejects_bad_shapes():
    with pytest.raises(ValueError, match="kron"):
        constants_from_reference(np.eye(8), np.eye(8), np.ones((8, 8)),
                                  (4, 3, 8))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("angle", ["THETA_ODD_A", "THETA_ODD_B",
                                   "THETA_EVEN"])
def test_cordic_schedule_equals_reference(config, sign, angle):
    jcfg, tcfg = CONFIGS[config]
    theta = sign * getattr(jloeffler, angle)
    assert theta == sign * getattr(tloeffler, angle)
    assert tcordic._schedule(theta, tcfg.iterations, tcfg.gain_terms) == \
        jcordic._schedule(theta, jcfg.iterations, jcfg.gain_terms)


@pytest.mark.parametrize("size", [(40, 56), (64, 48)])
@pytest.mark.parametrize("kind", ["lena_like", "cablecar_like"])
def test_images_equal_reference(kind, size):
    np.testing.assert_array_equal(getattr(timages, kind)(*size),
                                  getattr(jimages, kind)(*size))
    assert timages.LENA_SIZES == jimages.LENA_SIZES
    assert timages.CABLECAR_SIZES == jimages.CABLECAR_SIZES


# --- transforms, quantisation, metrics -------------------------------------

def test_blockwise_kron_matches_reference():
    # summation order differs from XLA's dot: atol 2e-3 as
    # tests/test_kernels.py holds the reference's own kernels to
    x = _coeffs((2, 16, 24), 0)
    fwd = tdct.blockwise_dct2d_kron(torch.from_numpy(x))
    np.testing.assert_allclose(_np(fwd),
                               _np(jdct.blockwise_dct2d_kron(jnp.asarray(x))),
                               atol=2e-3)
    inv = tdct.blockwise_idct2d_kron(fwd)
    np.testing.assert_allclose(_np(inv), x, atol=2e-3)
    np.testing.assert_array_equal(_np(tdct.from_blocks(tdct.to_blocks(
        torch.from_numpy(x)))), x)


def test_quantize_rounds_half_to_even_like_reference():
    q = np.asarray(jquant.qtable(50))
    # exact ties (k + 0.5) * q and random values
    ties = (np.arange(64).reshape(8, 8) - 32 + 0.5) * q
    coeffs = np.stack([ties, _coeffs((8, 8), 1) * 4]).astype(np.float32)
    got = tquant.quantize(torch.from_numpy(coeffs), tquant.qtable(50))
    want = jquant.quantize(jnp.asarray(coeffs), jquant.qtable(50))
    np.testing.assert_array_equal(_np(got), _np(want))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(tquant.dequantize(got, tquant.qtable(50))),
        _np(jquant.dequantize(want, jquant.qtable(50))))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cordic_rotate_bit_exact(config):
    jcfg, tcfg = CONFIGS[config]
    u, v = _coeffs((2, 256), 2)
    for theta in (jloeffler.THETA_ODD_A, -jloeffler.THETA_EVEN):
        got = tcordic.cordic_rotate(torch.from_numpy(u), torch.from_numpy(v),
                                    theta, tcfg)
        want = jcordic.cordic_rotate(jnp.asarray(u), jnp.asarray(v), theta,
                                     jcfg)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("inverse", [False, True])
def test_loeffler_cordic_graph_bit_exact(config, inverse):
    jcfg, tcfg = CONFIGS[config]
    blocks = _coeffs((3, 2, 8, 8), 3)
    tfn = tloeffler.loeffler_idct2d_8x8 if inverse else \
        tloeffler.loeffler_dct2d_8x8
    jfn = jloeffler.loeffler_idct2d_8x8 if inverse else \
        jloeffler.loeffler_dct2d_8x8
    got = tfn(torch.from_numpy(blocks), tcordic.make_cordic_rotate(tcfg),
              tcordic.fixed_quantizer(tcfg))
    want = jfn(jnp.asarray(blocks), jcordic.make_cordic_rotate(jcfg),
               jcordic.fixed_quantizer(jcfg))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_loeffler_exact_rotation_matches_reference():
    # float round-off only: the graph is the same, rotations exact
    blocks = _coeffs((4, 8, 8), 4)
    got = tloeffler.loeffler_dct2d_8x8(torch.from_numpy(blocks))
    want = jloeffler.loeffler_dct2d_8x8(jnp.asarray(blocks))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    back = tloeffler.loeffler_idct2d_8x8(got)
    np.testing.assert_allclose(_np(back), blocks, atol=1e-3)


def test_psnr_and_mse_match_reference():
    rng = np.random.default_rng(5)
    orig = rng.integers(0, 240, (32, 40)).astype(np.uint8)
    rec = np.clip(orig + rng.integers(-6, 7, orig.shape), 0, 255).astype(
        np.uint8)
    t_o, t_r = torch.from_numpy(orig), torch.from_numpy(rec)
    assert math.isclose(float(tmetrics.mse(t_o, t_r)),
                        float(jmetrics.mse(orig, rec)), rel_tol=1e-6)
    # MAX is the original's maximum (paper eq. 23), here 239, not 255
    assert abs(float(tmetrics.psnr(t_o, t_r))
               - float(jmetrics.psnr(jnp.asarray(orig), rec))) < 1e-4
    batch = tmetrics.psnr(torch.stack([t_o, t_o]), torch.stack([t_r, t_o]))
    assert batch.shape == (2,) and float(batch[1]) > 100.0


# --- single-image codec ------------------------------------------------------

@pytest.mark.parametrize("mode", ["standard", "matched"])
@pytest.mark.parametrize("transform", ["exact", "cordic", "loeffler"])
def test_roundtrip_matches_reference(transform, mode):
    img = jimages.cablecar_like(40, 52)       # 52: not a multiple of 8
    rec, p = tcodec.roundtrip(img, 50, transform, mode=mode, device="cpu")
    jrec, jp = jcodec.roundtrip(img, 50, transform, mode=mode)
    c = tcodec.compress(img, 50, transform, device="cpu")
    jc = jcodec.compress(img, 50, transform)
    assert rec.shape == (40, 52) and rec.dtype == torch.uint8
    assert c.qcoeffs.shape == (5, 7, 8, 8) and c.orig_shape == (40, 52)
    if transform == "cordic":
        # bit-exact levels, hence bit-exact reconstructions
        np.testing.assert_array_equal(_np(c.qcoeffs), _np(jc.qcoeffs))
        np.testing.assert_array_equal(_np(rec), _np(jrec))
        assert abs(p - jp) < 1e-3
    else:
        diff = np.abs(_np(c.qcoeffs) - _np(jc.qcoeffs))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        np.testing.assert_allclose(_np(rec).astype(np.float32),
                                   _np(jrec).astype(np.float32), atol=3)
        assert abs(p - jp) < 0.05


def test_roundtrip_exact_config_bit_exact():
    img = jimages.lena_like(32, 32)
    c = tcodec.compress(img, 75, "cordic", tcordic.EXACT_CONFIG,
                        device="cpu")
    jc = jcodec.compress(img, 75, "cordic", jcordic.EXACT_CONFIG)
    np.testing.assert_array_equal(_np(c.qcoeffs), _np(jc.qcoeffs))
    np.testing.assert_array_equal(
        _np(tcodec.decompress(c, mode="matched")),
        _np(jcodec.decompress(jc, mode="matched")))


def test_unknown_transform_raises():
    with pytest.raises(ValueError, match="unknown transform"):
        tcodec.compress(np.zeros((8, 8), np.uint8), 50, "bogus",
                        device="cpu")
