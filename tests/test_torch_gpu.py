"""The port's CUDA kernels on the card, against their plain PyTorch
versions and against the port's own CPU path.

Every test here is marked ``gpu`` and skips where no CUDA device is
present; this file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch:

    python -m pytest -q -p no:cacheprovider tests/test_torch_gpu.py

Bounds: CORDIC paths bit-exact; exact-DCT coefficients within atol 2e-3,
levels within +-1 on fewer than 1e-3 of coefficients, reconstructions
within atol 3.  The byte path's kernels (symbolize, pack_bits,
unpack_bits) are integer functions and must agree exactly; the card's
streams must be byte-identical to the CPU path's.  grad_dct: the kernel
sums a coefficient's 64 products in another order than the plain
version's matmul, so codes may differ by +-1 on at most 1 in 10^4 of
them, and scales by rtol 1e-6 or the f32 rounding bound of the two sums;
decode from the same codes within atol 1e-5.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import codec, cordic, dct, images
from repro_torch.core.entropy import BitstreamError, container, rle, scan
from repro_torch.kernels import cordic_loeffler as t_cl
from repro_torch.kernels import dct8x8 as t_dct
from repro_torch.kernels import fused_codec as t_fused
from repro_torch.kernels import grad_dct as t_gd
from repro_torch.kernels import pack_bits as t_pack
from repro_torch.kernels import symbolize as t_sym
from repro_torch.kernels import unpack_bits as t_unpack
from repro_torch.optim import grad_compress as t_gc
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


# --- the byte path -----------------------------------------------------------

def _blocks(n, seed, density, max_mag=255):
    rng = np.random.default_rng(seed)
    dc_diff = rng.integers(-max_mag, max_mag + 1, n)
    ac = rng.integers(-max_mag, max_mag + 1, (n, 63))
    ac[rng.uniform(size=ac.shape) >= density] = 0
    ac[:3, 62] = 0                       # blocks with three ZRLs
    ac[:3, 61] = 9
    ac[3, :] = 32767                     # a dense block of category 15
    return (torch.from_numpy(dc_diff), torch.from_numpy(ac.astype(np.int32)))


@pytest.mark.parametrize("n, density", [(1, 0.5), (37, 0.02), (5000, 0.15),
                                        (777, 0.9)])
def test_symbolize_matches_plain_version(cuda, n, density):
    dc_diff, ac = _blocks(max(n, 4), n, density)
    z = torch.cat([torch.zeros(ac.shape[0], 1, dtype=torch.int32), ac], 1)
    # a strided AC view, as the encoder passes it
    got = t_sym.symbolize(dc_diff.to(cuda), z.to(cuda)[:, 1:])
    want = t_sym.symbolize_ref(dc_diff, ac)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("level", [1 << 15, -(2 ** 31)])
def test_symbolize_range_guard_on_the_card(cuda, level):
    dc_diff, ac = _blocks(8, 1, 0.2)
    ac[5, 20] = level
    with pytest.raises(rle.RangeError) as cpu:
        t_sym.PreparedStream(dc_diff, ac)
    with pytest.raises(rle.RangeError) as card:
        t_sym.PreparedStream(dc_diff.to(cuda), ac.to(cuda))
    assert str(card.value) == str(cpu.value)


@pytest.mark.parametrize("m", [1, 1000, 300_000])
def test_pack_bits_matches_plain_version(cuda, m):
    rng = np.random.default_rng(m)
    lengths = torch.from_numpy(rng.integers(0, 17, m).astype(np.int32))
    codes = torch.from_numpy(rng.integers(0, 1 << 16, m).astype(np.int32))
    starts = torch.cumsum(lengths, 0) - lengths
    total = int(lengths.sum())
    got = t_pack.pack_bits(codes.to(cuda), lengths.to(cuda),
                           starts.to(cuda), total)
    assert torch.equal(got.cpu(), t_pack.pack_bits_ref(codes, lengths,
                                                       starts, total))


def test_unpack_words_match_plain_version_at_every_tile(cuda):
    q = codec.compress(images.cablecar_like(200, 264), 90, "cordic",
                       device="cpu").qcoeffs
    data = container.encode_qcoeffs(q, 90, "cordic", (200, 264),
                                    tables="embedded")
    hdr = container.read_header(data)
    dc_t, ac_t, off = container._resolve_tables(data, hdr)
    (dp, ds), (ap, as_) = (t_unpack.table_params(t) for t in (dc_t, ac_t))
    args = [torch.from_numpy(a) for a in (
        np.frombuffer(data[off:], np.uint8).copy(),
        np.concatenate([dp, ap]), np.concatenate([ds, as_]))]
    want = t_unpack.unpack_words_ref(*args)
    for tile in (32, 64, 2048, t_unpack.ops.MAX_TILE_BITS // 32 * 32):
        got = t_unpack.unpack_words(*(a.to(cuda) for a in args),
                                    tile_bits=tile)
        assert torch.equal(got.cpu(), want), tile


@pytest.mark.parametrize("transform", ["exact", "cordic"])
def test_byte_path_on_the_card_matches_its_cpu_path(cuda, transform):
    imgs = [images.lena_like(72, 100), images.cablecar_like(40, 264, seed=2),
            images.lena_like(64, 64, seed=3)]
    counts = (t_sym.launches["encode"], t_pack.launches["encode"],
              t_unpack.launches["decode"])
    for tables in ("auto", "embedded", "shared"):
        blobs = teng.encode_batch(imgs, 50, transform, tables=tables)
        assert blobs == teng.encode_batch(imgs, 50, transform,
                                          tables=tables, device="cpu")
    assert (t_sym.launches["encode"], t_pack.launches["encode"]) == (
        counts[0] + 9, counts[1] + 9)
    for mode in ("standard", "matched"):
        rec = teng.decode_batch(blobs, mode)
        want = teng.decompress_batch(teng.compress_batch(imgs, 50,
                                                         transform), mode)
        for r, w in zip(rec, want):
            assert r.device.type == "cuda" and torch.equal(r, w)
    assert t_unpack.launches["decode"] == counts[2] + 6
    c = codec.CompressedImage.from_bytes(blobs[1])
    assert c.qcoeffs.device.type == "cuda" and c.nbytes == len(blobs[1])
    assert c.to_bytes(tables="shared") == blobs[1]


def test_malformed_streams_raise_on_the_card_as_on_the_cpu(cuda):
    blob = teng.encode_batch([images.lena_like(48, 40)], 50, "exact",
                             tables="embedded")[0]
    payload_bit = (len(blob) - 6) * 8
    flipped = bytearray(blob)
    flipped[payload_bit // 8] ^= 0x40
    import struct
    import zlib
    resealed = bytes(flipped)
    crc = zlib.crc32(resealed[4:24] + resealed[28:]) & 0xFFFFFFFF
    resealed = resealed[:24] + struct.pack("<I", crc) + resealed[28:]
    for bad in (blob[:-3], resealed, blob + b"\x00"):
        outcomes = []
        for device in ("cpu", "cuda"):
            try:
                outcomes.append(container.decode_zigzag_host(
                    bad, device=device)[0].tobytes())
            except BitstreamError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]


def test_zigzag_and_dc_differential_on_the_card(cuda):
    q = torch.randint(-40, 40, (5, 7, 8, 8), dtype=torch.int32)
    z = scan.block_stream(q.to(cuda))
    assert torch.equal(z.cpu(), scan.block_stream(q))
    dc, ac = scan.dc_differential(z)
    assert dc.dtype == torch.int64 and torch.equal(
        scan.unblock_stream(scan.assemble_stream(scan.dc_integrate(dc), ac),
                            5, 7).cpu(), q)


# --- grad_dct ----------------------------------------------------------------

def _assert_grad_codes_close(body, q, s, q_ref, s_ref):
    """Kernel codes and scales of (R, 64) rows ``body`` against the plain
    version's (module docstring)."""
    diff = (q.long() - q_ref.long()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).sum().item() <= max(1, int(1e-4 * diff.numel()))
    c = dct.dct_matrix(64, device=body.device)
    sums = body.abs() @ c[:q.shape[1]].abs().T
    slack = 2 * 64 * 2.0 ** -24 * sums.amax(1, keepdim=True) / 127
    assert ((s - s_ref).abs() <= 1e-6 * s_ref + slack).all()


@pytest.mark.parametrize("n, block_rows", [
    (1, None), (64 * 3 + 5, 64), (4096 * 64 + 17, 256),
    (4096 * 64 + 17, 1024), (1_000_003, None), (1_000_003, 100)])
def test_grad_dct_matches_plain_version(cuda, n, block_rows):
    g = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(
        np.float32)).to(cuda)
    before = dict(t_gd.launches)
    cg = t_gd.encode(g, 16, block_rows=block_rows)
    r = n // 64
    assert tuple(cg.q.shape) == (r, 16) and tuple(cg.scale.shape) == (r, 1)
    assert torch.equal(cg.tail, g[r * 64:])
    dec = t_gd.decode(cg, block_rows=block_rows)
    assert dec.shape == g.shape and torch.equal(dec[r * 64:], g[r * 64:])
    launched = 1 if r else 0
    assert t_gd.launches == {"encode": before["encode"] + launched,
                             "decode": before["decode"] + launched}
    if r:
        body = g[:r * 64].reshape(r, 64)
        q_ref, s_ref = t_gd.grad_dct_encode_ref(body, 16)
        _assert_grad_codes_close(body, cg.q, cg.scale, q_ref, s_ref)
        torch.testing.assert_close(
            dec[:r * 64].reshape(r, 64),
            t_gd.grad_dct_decode_ref(cg.q, cg.scale), rtol=0, atol=1e-5)
        # no output depends on the tile
        other = t_gd.encode(g, 16, block_rows=64)
        assert torch.equal(other.q, cg.q) and torch.equal(other.scale,
                                                          cg.scale)
        assert torch.equal(t_gd.decode(cg, block_rows=1000), dec)


@pytest.mark.parametrize("keep", [1, 8, 33, 64])
def test_grad_dct_every_keep(cuda, keep):
    g = torch.from_numpy(np.random.default_rng(keep).standard_normal(
        (3000, 64)).astype(np.float32)).to(cuda)
    cg = t_gd.encode(g.reshape(-1), keep)
    q_ref, s_ref = t_gd.grad_dct_encode_ref(g, keep)
    _assert_grad_codes_close(g, cg.q, cg.scale, q_ref, s_ref)
    torch.testing.assert_close(t_gd.decode(cg).reshape(-1, 64),
                               t_gd.grad_dct_decode_ref(cg.q, cg.scale),
                               rtol=0, atol=1e-5)


def test_project_tree_step_on_the_card(cuda):
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((96, 70)).astype(np.float32),
            "e": rng.standard_normal((5000,)).astype(np.float32),
            "h": rng.standard_normal((80, 64)).astype(np.float32),
            "norm": rng.standard_normal((64,)).astype(np.float32)}
    grads = t_gc.from_numpy_tree(tree)
    grads["h"] = grads["h"].to(torch.bfloat16)
    ef = {p: torch.from_numpy(rng.standard_normal(g.shape).astype(
        np.float32)).to(cuda) for p, g in grads.items()}
    cfg = t_gc.GradCompressConfig(enabled=True, keep=16)
    before = dict(t_gd.launches)
    new_g, new_ef = t_gc.project_tree(grads, ef, cfg)
    assert t_gd.launches == {"encode": before["encode"] + 3,
                             "decode": before["decode"] + 3}
    assert new_g["norm"] is grads["norm"] and new_ef["norm"] is ef["norm"]
    for p in ("w", "e", "h"):
        corrected = grads[p].float() + ef[p]
        proj = t_gc.project_leaf(corrected, 16)
        assert new_g[p].device.type == "cuda"
        assert new_g[p].dtype == grads[p].dtype
        assert torch.equal(new_ef[p], corrected - proj)
        assert torch.equal(new_g[p], proj.to(grads[p].dtype))
