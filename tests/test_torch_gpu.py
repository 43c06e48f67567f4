"""The port's CUDA kernels on the card, against their plain PyTorch
versions and against the port's own CPU path.

Every test here is marked ``gpu`` and skips where no CUDA device is
present; this file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch:

    python -m pytest -q -p no:cacheprovider tests/test_torch_gpu.py

Bounds: CORDIC paths bit-exact; exact-DCT coefficients within atol 2e-3,
levels within +-1 on fewer than 1e-3 of coefficients, reconstructions
within atol 3.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import cordic, images
from repro_torch.kernels import cordic_loeffler as t_cl
from repro_torch.kernels import dct8x8 as t_dct
from repro_torch.kernels import fused_codec as t_fused
from repro_torch.serve import codec_engine as teng

pytestmark = pytest.mark.gpu

CONFIGS = {"paper": cordic.PAPER_CONFIG, "exact": cordic.EXACT_CONFIG}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _img(shape, seed):
    return np.random.default_rng(seed).normal(scale=50, size=shape).astype(
        np.float32)


def _assert_exact_bounds(levels, ref_levels, rec, ref_rec):
    diff = (levels.long() - ref_levels.long()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() < 1e-3
    assert (rec.float() - ref_rec.float()).abs().max().item() <= 3


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_kernels_match_plain_versions(cuda, config):
    cfg = CONFIGS[config]
    # 264 columns: one full 256-column strip and a ragged one
    x = torch.from_numpy(_img((3, 72, 264), 3)).to(cuda)
    torch.testing.assert_close(t_dct.dct8x8(x), t_dct.dct8x8_ref(x),
                               rtol=0, atol=2e-3)
    torch.testing.assert_close(t_dct.idct8x8(x), t_dct.idct8x8_ref(x),
                               rtol=0, atol=2e-3)
    for inverse in (False, True):
        fn = t_cl.cordic_loeffler_idct if inverse else t_cl.cordic_loeffler_dct
        assert torch.equal(fn(x, config=cfg),
                           t_cl.cordic_loeffler_ref(x, cfg, inverse))
    pixels = torch.clamp(torch.round(x + 128), 0, 255)
    rec, qc = t_fused.fused_codec(pixels, transform="cordic", config=cfg)
    ref_rec, ref_qc = t_fused.fused_codec_ref(pixels, 50, "cordic", cfg)
    assert torch.equal(qc, ref_qc) and torch.equal(rec.float(), ref_rec)
    rec, qc = t_fused.fused_codec(pixels)
    ref_rec, ref_qc = t_fused.fused_codec_ref(pixels, 50, "exact")
    _assert_exact_bounds(qc, ref_qc, rec, ref_rec)
    torch.cuda.synchronize()


def test_wrappers_count_their_launches(cuda):
    x = torch.zeros(1, 16, 16, device=cuda)
    before = t_dct.launches["forward"], t_fused.launches["cordic"]
    t_dct.dct8x8(x)
    t_fused.fused_codec(x, transform="cordic")
    assert (t_dct.launches["forward"], t_fused.launches["cordic"]) == (
        before[0] + 1, before[1] + 1)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError, match="float32"):
        t_dct.dct8x8(torch.zeros(8, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="iterations"):
        t_cl.cordic_loeffler_dct(torch.zeros(8, 8, device=cuda),
                                 config=cordic.CordicConfig(40, 3, 8))


@pytest.mark.parametrize("transform, mode", [
    ("exact", "standard"), ("cordic", "matched"), ("cordic", "standard"),
    ("loeffler", "standard")])
def test_engine_on_the_card_matches_its_cpu_path(cuda, transform, mode):
    imgs = [images.lena_like(72, 100), images.cablecar_like(40, 264, seed=2),
            images.lena_like(64, 64, seed=3)]
    rec, psnr = teng.roundtrip_batch(imgs, 50, transform, mode=mode)
    ref, ref_psnr = teng.roundtrip_batch(imgs, 50, transform, mode=mode,
                                         device="cpu")
    for r, c in zip(rec, ref):
        assert r.device.type == "cuda" and r.shape == c.shape
        if transform == "cordic":
            assert torch.equal(r.cpu(), c)
        else:
            assert (r.cpu().int() - c.int()).abs().max().item() <= 3
    bound = 1e-3 if transform == "cordic" else 0.05
    np.testing.assert_allclose(psnr, ref_psnr, rtol=0, atol=bound)
