"""The port's batched codec engine against the JAX package's, on the CPU.

The reference engine runs its staged path here (its fused route is for
TPUs only); the port takes the route it takes on the card, with each
kernel's plain version.  Bounds: CORDIC levels and reconstructions
bit-exact and PSNR within 1e-3 dB; exact levels within +-1 on fewer than
1e-3 of coefficients, reconstructions within atol 3, PSNR within 0.05 dB.
"""

import numpy as np
import pytest
import torch

from repro.core import images as jimages
from repro.serve import codec_engine as jeng
from repro_torch.kernels import cordic_loeffler as t_cl
from repro_torch.kernels import dct8x8 as t_dct
from repro_torch.kernels import fused_codec as t_fused
from repro_torch.serve import codec_engine as teng

MODES = ["standard", "matched"]
TRANSFORMS = ["exact", "cordic", "loeffler"]


def _stacked(n=3, h=40, w=52):
    # 52: not a multiple of 8, the paper's 1024x814 case in small
    return np.stack([jimages.lena_like(h, w, seed=i) if i % 2 == 0
                     else jimages.cablecar_like(h, w, seed=i)
                     for i in range(n)])


def _ragged():
    # two share the (64, 64) bucket, one goes to (128, 64)
    return [jimages.lena_like(40, 52), jimages.cablecar_like(72, 24, seed=2),
            jimages.lena_like(64, 60, seed=3)]


def _assert_close(transform, rec, jrec, psnr, jpsnr):
    rec = np.asarray(rec.cpu() if isinstance(rec, torch.Tensor) else rec)
    jrec = np.asarray(jrec)
    assert rec.shape == jrec.shape
    if transform == "cordic":
        np.testing.assert_array_equal(rec, jrec)
        np.testing.assert_allclose(psnr, jpsnr, rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(rec.astype(np.float32),
                                   jrec.astype(np.float32), atol=3)
        np.testing.assert_allclose(psnr, jpsnr, rtol=0, atol=0.05)


def _assert_levels(transform, q, jq):
    q, jq = q.numpy().astype(np.int64), np.asarray(jq)
    assert q.shape == jq.shape
    if transform == "cordic":
        np.testing.assert_array_equal(q, jq)
    else:
        diff = np.abs(q - jq)
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_roundtrip_batch_stacked_matches_reference(transform, mode):
    batch = _stacked()
    rec, psnr = teng.roundtrip_batch(batch, 50, transform, mode=mode,
                                     device="cpu")
    jrec, jpsnr = jeng.roundtrip_batch(batch, 50, transform, mode=mode)
    assert rec.dtype == torch.uint8 and psnr.shape == (3,)
    _assert_close(transform, rec, jrec, psnr, jpsnr)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("transform", ["exact", "cordic"])
def test_roundtrip_batch_ragged_matches_reference(transform, mode):
    imgs = _ragged()
    rec, psnr = teng.roundtrip_batch(imgs, 50, transform, mode=mode,
                                     device="cpu")
    jrec, jpsnr = jeng.roundtrip_batch(imgs, 50, transform, mode=mode)
    assert [tuple(r.shape) for r in rec] == [im.shape for im in imgs]
    for r, jr, p, jp in zip(rec, jrec, psnr, jpsnr):
        _assert_close(transform, r, jr, p, jp)


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_compress_decompress_batch_matches_reference(transform):
    imgs = _ragged()
    cb = teng.compress_batch(imgs, 50, transform, device="cpu")
    jcb = jeng.compress_batch(imgs, 50, transform)
    assert len(cb.groups) == len(jcb.groups) == 2
    for g, jg in zip(cb.groups, jcb.groups):
        assert g.indices == jg.indices
        assert g.orig_shapes == jg.orig_shapes
        assert g.qcoeffs.dtype == torch.int32
        _assert_levels(transform, g.qcoeffs, jg.qcoeffs)
    for mode in MODES:
        rec = teng.decompress_batch(cb, mode=mode)
        jrec = jeng.decompress_batch(jcb, mode=mode)
        for r, jr in zip(rec, jrec):
            _assert_close(transform, r, jr, 0.0, 0.0)


def test_compress_batch_stacked_layout():
    batch = _stacked(n=2, h=24, w=36)
    cb = teng.compress_batch(batch, 75, "cordic", device="cpu")
    jcb = jeng.compress_batch(batch, 75, "cordic")
    (g,), (jg,) = cb.groups, jcb.groups
    assert cb.stacked and cb.n_images == 2
    assert tuple(g.qcoeffs.shape) == (2, 3, 5, 8, 8)
    np.testing.assert_array_equal(g.qcoeffs.numpy(), np.asarray(jg.qcoeffs))
    rec = teng.decompress_batch(cb, mode="matched")
    assert tuple(rec.shape) == (2, 24, 36)
    np.testing.assert_array_equal(
        rec.numpy(), np.asarray(jeng.decompress_batch(jcb, mode="matched")))


def test_group_inputs_matches_reference():
    imgs = _ragged() + [jimages.lena_like(8, 130, seed=4)]
    groups, stacked = teng._group_inputs(teng._to_device(imgs, "cpu"))
    jgroups, jstacked = jeng._group_inputs(imgs)
    assert stacked is jstacked is False
    assert [(g[1], g[2]) for g in groups] == [(g[1], g[2]) for g in jgroups]
    for (padded, _, _), (jpadded, _, _) in zip(groups, jgroups):
        np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    assert teng.SHAPE_BUCKET == jeng.SHAPE_BUCKET
    assert [teng._bucket_dim(d) for d in (1, 64, 65, 130)] == \
        [jeng._bucket_dim(d) for d in (1, 64, 65, 130)]


def test_outputs_come_back_in_input_order_and_cropped():
    imgs = _ragged()
    rec, _ = teng.roundtrip_batch(imgs, 90, "cordic", mode="matched",
                                  device="cpu")
    for im, r in zip(imgs, rec):
        single, _ = teng.roundtrip_batch(im[None], 90, "cordic",
                                         mode="matched", device="cpu")
        assert torch.equal(r, single[0])


def test_roundtrip_batch_routes_like_the_card(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    from repro_torch.core import codec as tcodec
    monkeypatch.setattr(teng, "fused_codec", spy("fused", teng.fused_codec))
    monkeypatch.setattr(tcodec, "dct8x8", spy("dct8x8", tcodec.dct8x8))
    monkeypatch.setattr(tcodec, "idct8x8", spy("idct8x8", tcodec.idct8x8))
    monkeypatch.setattr(tcodec, "cordic_loeffler_dct",
                        spy("cl_dct", tcodec.cordic_loeffler_dct))
    monkeypatch.setattr(tcodec, "cordic_loeffler_idct",
                        spy("cl_idct", tcodec.cordic_loeffler_idct))
    batch = _stacked(n=1, h=16, w=16)
    launches = [dict(m.launches) for m in (t_dct, t_cl, t_fused)]
    routes = {}
    for transform, mode in [("exact", "standard"), ("cordic", "matched"),
                            ("cordic", "standard"), ("loeffler", "matched")]:
        calls.clear()
        teng.roundtrip_batch(batch, 50, transform, mode=mode, device="cpu")
        routes[transform, mode] = list(calls)
    assert routes == {("exact", "standard"): ["fused"],
                      ("cordic", "matched"): ["fused"],
                      ("cordic", "standard"): ["cl_dct", "idct8x8"],
                      ("loeffler", "matched"): []}
    # CPU tensors never count as kernel launches
    assert [m.launches for m in (t_dct, t_cl, t_fused)] == launches


@pytest.mark.parametrize("bad, match", [
    (np.zeros((0, 16, 16), np.uint8), "empty batch"),
    ([], "empty batch"),
    (np.zeros((16, 16), np.uint8), "must be \\(B, H, W\\)"),
    ([np.zeros((2, 8, 8), np.uint8)], "must be 2-D"),
])
def test_bad_batches_raise(bad, match):
    with pytest.raises(ValueError, match=match):
        teng.compress_batch(bad, device="cpu")


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.roundtrip_batch(_stacked(n=1, h=8, w=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.compress_batch(_stacked(n=1, h=8, w=8))


def test_with_psnr_false_returns_none():
    rec, psnr = teng.roundtrip_batch(_stacked(n=1, h=8, w=8), 50, "exact",
                                     with_psnr=False, device="cpu")
    assert psnr is None and rec.shape == (1, 8, 8)
