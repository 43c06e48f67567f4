"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the reference runs
its Pallas kernel in interpret mode (``common.interpret_default()``), as
``tests/test_kernels.py`` does.  The CUDA kernels themselves are held
against the plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.

Bounds: CORDIC paths bit-exact; exact-DCT coefficients within atol 2e-3,
levels within +-1 on fewer than 1e-3 of coefficients, reconstructions
within atol 3 (the reference's own bounds, tests/test_kernels.py).
"""

import ctypes

import numpy as np
import pytest
import torch

from repro.core import cordic as jcordic
from repro.core import images as jimages
from repro.kernels.cordic_loeffler import (cordic_loeffler_dct as j_cl_dct,
                                           cordic_loeffler_idct as j_cl_idct,
                                           cordic_loeffler_ref as j_cl_ref)
from repro.kernels.dct8x8 import dct8x8 as j_dct8x8
from repro.kernels.dct8x8 import idct8x8 as j_idct8x8
from repro.kernels.fused_codec import fused_codec as j_fused
from repro_torch.core import cordic as tcordic
from repro_torch.core import loeffler as tloeffler
from repro_torch.kernels import _build, common
from repro_torch.kernels import cordic_loeffler as t_cl
from repro_torch.kernels import dct8x8 as t_dct
from repro_torch.kernels import fused_codec as t_fused

CONFIGS = {"paper": (jcordic.PAPER_CONFIG, tcordic.PAPER_CONFIG),
           "exact": (jcordic.EXACT_CONFIG, tcordic.EXACT_CONFIG)}


def _img(shape, seed):
    return np.random.default_rng(seed).normal(scale=50, size=shape).astype(
        np.float32)


def _assert_exact_bounds(levels, ref_levels, rec, ref_rec):
    diff = np.abs(np.asarray(levels, np.int64) - np.asarray(ref_levels))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(np.asarray(rec, np.float32),
                               np.asarray(ref_rec, np.float32), atol=3)


# --- plain versions against the Pallas kernels (CPU) -----------------------

@pytest.mark.parametrize("shape", [(16, 64), (24, 40), (2, 16, 16),
                                   (20, 36)])
def test_dct8x8_matches_pallas(shape):
    x = _img(shape, 0)
    fwd = t_dct.dct8x8(torch.from_numpy(x))
    np.testing.assert_allclose(fwd.numpy(), np.asarray(j_dct8x8(x)),
                               atol=2e-3)
    inv = t_dct.idct8x8(fwd)
    np.testing.assert_allclose(inv.numpy(),
                               np.asarray(j_idct8x8(fwd.numpy())), atol=2e-3)
    assert fwd.shape == shape and inv.shape == shape


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("shape", [(16, 24), (2, 16, 16), (12, 20)])
def test_cordic_loeffler_bit_exact_with_pallas(shape, config):
    jcfg, tcfg = CONFIGS[config]
    x = _img(shape, 1)
    fwd = t_cl.cordic_loeffler_dct(torch.from_numpy(x), config=tcfg)
    inv = t_cl.cordic_loeffler_idct(fwd, config=tcfg)
    pallas_fwd = np.asarray(j_cl_dct(x, config=jcfg))
    pallas_inv = np.asarray(j_cl_idct(fwd.numpy(), config=jcfg))
    # the reference's own op-by-op graph: bit-exact in both configs
    h, w = shape[-2:]
    for got, inverse, arg in ((fwd, False, x), (inv, True, fwd.numpy())):
        pad = [(0, 0)] * (len(shape) - 2) + [(0, -h % 8), (0, -w % 8)]
        want = np.asarray(j_cl_ref(np.pad(arg, pad, mode="edge"), jcfg,
                                   inverse=inverse))[..., :h, :w]
        np.testing.assert_array_equal(got.numpy(), want)
    if jcfg.fixed_point_bits is not None:
        np.testing.assert_array_equal(fwd.numpy(), pallas_fwd)
        np.testing.assert_array_equal(inv.numpy(), pallas_inv)
    else:
        # float datapath: XLA:CPU contracts a product and the following
        # sum into one FMA once jitted, so the Pallas kernel differs from
        # the reference's own op-by-op graph by float32 round-off
        # (1.5e-5 here); with the fixed-point grid a rounding sits between
        # them and the two agree bit for bit
        np.testing.assert_allclose(fwd.numpy(), pallas_fwd, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(inv.numpy(), pallas_inv, rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_fused_codec_exact_matches_pallas(quality):
    img = jimages.lena_like(32, 40)
    rec, qc = t_fused.fused_codec(torch.from_numpy(img), quality=quality)
    jrec, jqc = j_fused(img, quality=quality)
    assert rec.dtype == torch.uint8 and qc.dtype == torch.int32
    _assert_exact_bounds(qc.numpy(), jqc, rec.numpy(), jrec)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fused_codec_cordic_bit_exact_with_pallas(config):
    jcfg, tcfg = CONFIGS[config]
    img = jimages.cablecar_like(24, 36)       # 36: padded to 40, cropped
    rec, qc = t_fused.fused_codec(torch.from_numpy(img), quality=50,
                                  transform="cordic", config=tcfg)
    jrec, jqc = j_fused(img, quality=50, transform="cordic", config=jcfg)
    assert rec.shape == (24, 36) and qc.shape == (24, 36)
    np.testing.assert_array_equal(qc.numpy(), np.asarray(jqc))
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))


def test_fused_codec_batched_matches_per_image():
    imgs = np.stack([jimages.lena_like(16, 24, seed=i) for i in range(3)])
    rec, qc = t_fused.fused_codec(torch.from_numpy(imgs), transform="cordic")
    for i in range(3):
        r, q = t_fused.fused_codec(torch.from_numpy(imgs[i]),
                                   transform="cordic")
        assert torch.equal(rec[i], r) and torch.equal(qc[i], q)


# --- wrapper rules -----------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (dict(t_dct.launches), dict(t_cl.launches),
              dict(t_fused.launches))
    x = torch.from_numpy(_img((16, 16), 2))
    torch.testing.assert_close(t_dct.dct8x8(x), t_dct.dct8x8_ref(x),
                               rtol=0, atol=0)
    assert torch.equal(t_cl.cordic_loeffler_dct(x),
                       t_cl.cordic_loeffler_ref(x))
    t_fused.fused_codec(x + 128)
    assert (t_dct.launches, t_cl.launches, t_fused.launches) == before


@pytest.mark.parametrize("call", [
    lambda x: t_dct.dct8x8(x),
    lambda x: t_cl.cordic_loeffler_idct(x),
    lambda x: t_fused.fused_codec(x),
], ids=["dct8x8", "cordic_loeffler", "fused_codec"])
def test_non_cpu_tensor_without_kernel_raises(call):
    # a tensor that is not on the CPU never takes the plain version
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        call(torch.empty(16, 16, device="meta"))


def test_wrappers_reject_other_dtypes():
    with pytest.raises(TypeError, match="float32"):
        t_dct.dct8x8(torch.zeros(8, 8, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32"):
        t_cl.cordic_loeffler_dct(torch.zeros(8, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="unknown transform"):
        t_fused.fused_codec(torch.zeros(8, 8), transform="loeffler")


def test_edge_pad_matches_numpy():
    x = np.arange(2 * 5 * 7, dtype=np.uint8).reshape(2, 5, 7)
    got = common.pad2d_to_multiple(torch.from_numpy(x), 8, 8)
    want = np.pad(x, ((0, 0), (0, 3), (0, 1)), mode="edge")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cordic_params_carry_the_schedule(config):
    _, tcfg = CONFIGS[config]
    p = common.cordic_params(tcfg)
    assert p.iterations == tcfg.iterations
    assert p.step == tcordic.grid_step(tcfg)
    sigmas, shifts, gain = tcordic._schedule(
        -tloeffler.THETA_EVEN, tcfg.iterations, tcfg.gain_terms)
    assert p.rot[5].gain == np.float32(gain)
    assert [p.rot[5].s[k] for k in range(tcfg.iterations)] == [
        -s * k for s, k in zip(sigmas, shifts)]
    assert ctypes.sizeof(p) == 6 * (32 + 1) * 4 + 12


def test_cordic_params_reject_too_many_iterations():
    with pytest.raises(ValueError, match="iterations"):
        common.cordic_params(tcordic.CordicConfig(33, 3, 8))


# --- the build ---------------------------------------------------------------

def test_build_flags_keep_ieee_float32():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags


def test_library_path_is_keyed_by_content():
    paths = {_build.library_path(n) for n in _build.KERNEL_SOURCES}
    assert len(paths) == len(_build.KERNEL_SOURCES)
    for p in paths:
        assert p.parent == _build.BUILD_DIR and p.suffix == ".so"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("dct8x8")
