#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (into ``build/repro_torch/``), holds every kernel against its
plain PyTorch version on the card and times both, drives
``repro_torch.serve.codec_engine`` at the paper's image sizes and at a
64 x 512 x 512 batch along two paths -- pixels -> levels -> pixels
(``roundtrip_batch``, ``compress_batch``, ``decompress_batch``) and the
byte path (``encode_batch`` -> ``DCTZ`` streams -> ``decode_batch``) --
checks the PSNR the JAX reference reports (RESULTS.md: lena 512x512 at
quality 50, 37.900 dB exact and 35.784 dB cordic), checks that the card's
streams are byte-identical to the port's CPU path, drives the training
step's gradient compression (``repro_torch.optim.grad_compress.
project_tree`` with error feedback, 5 steps) over SmolLM-360M's full
gradient tree through the grad_dct kernel, compresses SmolLM-360M's
full-width KV cache (``repro_torch.serve.kv_compress``), runs the CPU
column of the paper's CPU-versus-GPU comparison, counts the kernel
launches of each path, and profiles where the time of each path goes.
Every phase prints JSON lines; any failed check or error exits non-zero.
The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

It exits non-zero, with no result, where no CUDA device is present or the
port's sources are not beside it.
"""

from __future__ import annotations

import cProfile
import json
import math
import pathlib
import pstats
import struct
import subprocess
import sys
import time
import zlib

ROOT = pathlib.Path(__file__).resolve().parent

# NVIDIA's H100 SXM data sheet, at the 700 W power limit: HBM3 bandwidth
# and fp32 outside the tensor cores (the kernels use no TF32).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# The byte path's kernels do int32 work on the CUDA cores: 64 int32 lanes
# per SM (half the fp32 lanes; NVIDIA's Hopper white paper), 132 SMs,
# 1.98 GHz boost clock.
PEAK_INT32_PER_S = 64 * 132 * 1.98e9

QUALITY = 50
# RESULTS.md, Table 3 (lena 512x512, quality 50), from the JAX reference.
REFERENCE_PSNR = {"exact": 37.900, "cordic": 35.784}
PSNR_BOUND = {"exact": 0.05, "cordic": 1e-3}


# SmolLM-360M (src/repro/configs/smollm_360m.py) at full width: each
# parameter's gradient shape, all f32, as the reference's
# models.registry.param_specs gives them, and its KV cache
# (L, B, T, H_kv, D) at batch 8 and 2048 positions in bf16.
SMOLLM_360M_GRADS = {
    "embed/tokens": (49152, 960),
    "blocks/attn_norm": (32, 960),
    "blocks/attn/wq": (32, 960, 960),
    "blocks/attn/wk": (32, 960, 320),
    "blocks/attn/wv": (32, 960, 320),
    "blocks/attn/wo": (32, 960, 960),
    "blocks/mlp_norm": (32, 960),
    "blocks/mlp/wi_gate": (32, 960, 2560),
    "blocks/mlp/wi_up": (32, 960, 2560),
    "blocks/mlp/wo": (32, 2560, 960),
    "final_norm": (960,),
}
SMOLLM_360M_KV = (32, 8, 2048, 5, 64)
GRAD_KEEP = 16


class CheckFailed(Exception):
    pass


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


# --- measurement helpers -----------------------------------------------------

def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(torch, fn):
    """Host wall time of one call that ends in a synchronise, and its
    result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


# Least work of each function per pixel: (bytes, fp32 operations).
# Bytes count each input read once and each output written once, float32
# and int32 alike.  Operations are the function's own minimum, not what
# its plain version or its kernel happens to do:
# - exact 2-D transform, forward or inverse: separable, 8 multiply-adds
#   per output in each of two passes, 2 * 8 * 2 = 32 per pixel;
# - CORDIC 2-D transform: counted from its graph in cordic_ops_per_px;
# - codec around the two transforms: level shift, divide, round,
#   dequantise, shift back, round, and the two sides of the clip: 8.
CODEC_OPS = 8
EXACT_OPS = 32


def cordic_ops_per_px(config) -> float:
    """fp32 operations per pixel of one 2-D CORDIC Loeffler transform,
    forward or inverse (the transposed graph has the same counts).

    One 8-point graph has 29 sums, products and negations outside its
    rotations and three rotations of 4 operations per micro-rotation plus
    2 gain products.  With the fixed-point grid each of its 26 stage
    outputs and each rotation output (2 per micro-rotation, 2 after the
    gain) is rounded to the grid: a product, a round and a product.  Two
    passes of 8 graphs cover 64 pixels: 2 graphs per 8 pixels."""
    i = config.iterations
    rounding = 0 if config.fixed_point_bits is None else 3
    graph = 29 + 3 * (4 * i + 2) + rounding * (26 + 3 * (2 * i + 2))
    return 2 * graph / 8


def work_per_px(kernel: str, variant: str, config):
    if kernel == "fused_codec":
        transform = EXACT_OPS if variant == "exact" else \
            cordic_ops_per_px(config)
        return 12, CODEC_OPS + 2 * transform   # f32 in; f32 and int32 out
    if kernel == "dct8x8":
        return 8, EXACT_OPS
    return 8, cordic_ops_per_px(config)        # cordic_loeffler


# Least work of the byte path's integer functions, counted from this run's
# streams (bytes, int32 operations):
# - symbolize, per block: reads the 8-byte DC difference and 63 int32
#   levels and writes 3 x 64 int16 slots and an int32 count (648 B); one
#   zero test per level and about 10 operations per symbol it emits;
# - pack_bits, per field: reads its 4-byte width and, if it is kept
#   (width > 0), its 4-byte code and 8-byte start, and writes the payload
#   once; about 6 operations per kept field (mask, shift, split, swap,
#   OR);
# - unpack_bits, per bit offset: reads the payload once and writes three
#   int32 words (12 B); about 40 operations per offset (a window, one
#   table lookup and its classification per table, seven doubling
#   levels).
def byte_work(kernel: str, st: dict):
    if kernel == "symbolize":
        return 648 * st["blocks"], 63 * st["blocks"] + 10 * st["symbols"]
    if kernel == "pack_bits":
        return (4 * st["fields"] + 12 * st["kept"] + st["payload_bytes"],
                6 * st["kept"])
    n_pos = 8 * st["payload_bytes"] + 1
    return 12 * n_pos + st["payload_bytes"], 40 * n_pos


def bound(nbytes: int, ops: int, peak_ops: float = PEAK_FP32_PER_S):
    """Least time in ms for the work, and whether bytes or operations
    set it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# --- phases ------------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)


def phase_build(build):
    t0 = time.perf_counter()
    results = build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries={r.name: {"seconds": r.seconds, "path": str(
             r.path.relative_to(ROOT)), "ptxas": list(r.ptxas)}
             for r in results})


def make_inputs(np, images):
    """Paper-size test images (LENA_SIZES, CABLECAR_SIZES) and a
    64 x 512 x 512 batch, made from seeds on the host."""
    t0 = time.perf_counter()
    singles = [("lena", (h, w), images.lena_like(h, w))
               for h, w in images.LENA_SIZES]
    singles += [("cablecar", (h, w), images.cablecar_like(h, w))
                for h, w in images.CABLECAR_SIZES]
    batch = np.stack([images.lena_like(512, 512, seed=i) if i % 2 == 0
                      else images.cablecar_like(512, 512, seed=i)
                      for i in range(64)])
    emit(phase="data", seconds=time.perf_counter() - t0,
         singles=len(singles), batch=list(batch.shape))
    return singles, batch


KERNELS = {
    # name: (source, TPU kernel it replaces)
    "fused_codec": ("src/repro_torch/kernels/csrc/fused_codec.cu",
                    "src/repro/kernels/fused_codec/kernel.py:78"),
    "dct8x8": ("src/repro_torch/kernels/csrc/dct8x8.cu",
               "src/repro/kernels/dct8x8/kernel.py:70"),
    "cordic_loeffler": ("src/repro_torch/kernels/csrc/cordic_loeffler.cu",
                        "src/repro/kernels/cordic_loeffler/kernel.py:54"),
    "symbolize": ("src/repro_torch/kernels/csrc/symbolize.cu",
                  "src/repro/kernels/symbolize/kernel.py:204"),
    "pack_bits": ("src/repro_torch/kernels/csrc/pack_bits.cu",
                  "src/repro/kernels/pack_bits/kernel.py:111"),
    "unpack_bits": ("src/repro_torch/kernels/csrc/unpack_bits.cu",
                    "src/repro/kernels/unpack_bits/kernel.py:179"),
    "grad_dct": ("src/repro_torch/kernels/csrc/grad_dct.cu",
                 "src/repro/kernels/grad_dct/kernel.py:61"),
}
# grad_dct's two directions replace two pallas_calls
GRAD_DCT_REPLACES = {"encode": "src/repro/kernels/grad_dct/kernel.py:61",
                     "decode": "src/repro/kernels/grad_dct/kernel.py:81"}


def phase_kernels(torch, pixels, label):
    """Each kernel against its plain version on ``pixels`` (N, H, W)
    float32 on the card: agreement, kernel ms, plain ms, bound ms."""
    from repro_torch.core import cordic, dct
    from repro_torch.kernels import cordic_loeffler as cl
    from repro_torch.kernels import dct8x8 as d8
    from repro_torch.kernels import fused_codec as fc

    cfg = cordic.PAPER_CONFIG
    n, h, w = pixels.shape
    px = n * h * w
    shifted = pixels - 128.0
    coef_exact = d8.dct8x8_ref(shifted)
    coef_cordic = cl.cordic_loeffler_ref(shifted, cfg)
    t = dct.kron_dct_matrix(8, device=pixels.device)
    rows = dct.to_blocks(shifted).reshape(-1, 64).contiguous()
    rows_coef = dct.to_blocks(coef_exact).reshape(-1, 64).contiguous()
    fast, slow = (20, 5) if px <= 20_000_000 else (10, 3)
    out = []

    def record(name, variant, max_err, tolerance, ms, plain_ms,
               library_ms=None, **extra):
        bytes_px, ops_px = work_per_px(name, variant, cfg)
        nbytes, ops = bytes_px * px, ops_px * px
        b_ms, b_by = bound(nbytes, ops)
        row = dict(name=f"{name}[{variant}] {label}", kernel=name,
                   variant=variant, shape=label, route="cuda",
                   source=KERNELS[name][0], replaces=KERNELS[name][1],
                   max_abs_err=max_err, tolerance=tolerance, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms, bytes=nbytes, ops=ops, **extra)
        emit(phase="kernel", **row)
        out.append(row)

    # fused_codec, exact: levels within +-1 on < 1e-3, rec within 3
    rec, lv = fc.fused_codec(pixels, quality=QUALITY)
    ref_rec, ref_lv = fc.fused_codec_ref(pixels, QUALITY, "exact")
    diff = (lv - ref_lv).abs()
    err = (rec.float() - ref_rec).abs().max().item()
    share = (diff > 0).float().mean().item()
    check(diff.max().item() <= 1 and share < 1e-3 and err <= 3,
          f"fused_codec[exact] {label}: levels off by {diff.max().item()} "
          f"on {share}, rec off by {err}")
    record("fused_codec", "exact", err, "levels +-1 on < 1e-3, rec atol 3",
           time_ms(torch, lambda: fc.ops._launch(pixels, QUALITY, "exact",
                                                 cfg), fast),
           time_ms(torch, lambda: fc.fused_codec_ref(pixels, QUALITY,
                                                     "exact"), slow),
           levels_max_diff=diff.max().item(), levels_differing_share=share)

    # fused_codec, cordic: bit-exact
    rec, lv = fc.fused_codec(pixels, quality=QUALITY, transform="cordic")
    ref_rec, ref_lv = fc.fused_codec_ref(pixels, QUALITY, "cordic", cfg)
    check(torch.equal(lv, ref_lv) and torch.equal(rec.float(), ref_rec),
          f"fused_codec[cordic] {label} is not bit-exact")
    record("fused_codec", "cordic", 0.0, "bit-exact",
           time_ms(torch, lambda: fc.ops._launch(pixels, QUALITY, "cordic",
                                                 cfg), fast),
           time_ms(torch, lambda: fc.fused_codec_ref(pixels, QUALITY,
                                                     "cordic", cfg), slow))

    # dct8x8: coefficients within atol 2e-3
    for variant, inverse, arg, ref_fn, lib_fn in (
            ("forward", False, shifted, d8.dct8x8_ref,
             lambda: torch.matmul(rows, t.T)),
            ("inverse", True, coef_exact, d8.idct8x8_ref,
             lambda: torch.matmul(rows_coef, t))):
        got = (d8.idct8x8 if inverse else d8.dct8x8)(arg)
        err = (got - ref_fn(arg)).abs().max().item()
        check(err <= 2e-3, f"dct8x8[{variant}] {label}: off by {err}")
        record("dct8x8", variant, err, "atol 2e-3",
               time_ms(torch, lambda: d8.ops._launch(arg, inverse), fast),
               time_ms(torch, lambda: ref_fn(arg), slow),
               library_ms=time_ms(torch, lib_fn, fast))

    # cordic_loeffler: bit-exact
    for variant, inverse, arg in (("forward", False, shifted),
                                  ("inverse", True, coef_cordic)):
        fn = cl.cordic_loeffler_idct if inverse else cl.cordic_loeffler_dct
        ref = cl.cordic_loeffler_ref(arg, cfg, inverse)
        check(torch.equal(fn(arg, config=cfg), ref),
              f"cordic_loeffler[{variant}] {label} is not bit-exact")
        record("cordic_loeffler", variant, 0.0, "bit-exact",
               time_ms(torch, lambda: cl.ops._launch(arg, cfg, inverse),
                       fast),
               time_ms(torch, lambda: cl.cordic_loeffler_ref(arg, cfg,
                                                             inverse), slow))
    return out


def real_streams(torch, eng, imgs, transform="exact"):
    """The byte path's per-image streams of a (B, H, W) batch on the
    card, as ``encode_batch`` codes them: (DC differences, AC view) and
    the prepared stream with its "auto" tables."""
    from repro_torch.core.entropy import container, huffman, scan
    from repro_torch.kernels import symbolize as sy

    q = eng.compress_batch(imgs, QUALITY, transform).groups[0].qcoeffs
    out = []
    for z in scan.zigzag_scan(q).reshape(q.shape[0], -1, 64):
        dc_diff, ac = scan.dc_differential(z)
        prep = sy.PreparedStream(dc_diff, ac)
        tables = [container._choose_table(freq, tid, "auto", what)[1]
                  for freq, tid, what in (
                      (prep.dc_freq, huffman.STANDARD_DC_LUMA_ID, "DC"),
                      (prep.ac_freq, huffman.STANDARD_AC_LUMA_ID, "AC"))]
        out.append((dc_diff, ac, prep, tables))
    return out


def phase_byte_kernels(torch, np, eng, imgs, label):
    """symbolize, pack_bits and unpack_bits on the real streams of
    ``imgs`` (one stream per image): exact agreement with their plain
    versions on the card, kernel ms, plain ms and bound ms, per stream
    and summed over the streams."""
    from repro_torch.kernels import pack_bits as pb
    from repro_torch.kernels import symbolize as sy
    from repro_torch.kernels import unpack_bits as ub

    streams = real_streams(torch, eng, imgs)
    n_streams = len(streams)
    work = {"blocks": 0, "symbols": 0, "fields": 0, "kept": 0,
            "payload_bytes": 0}
    calls = {"symbolize": [], "pack_bits": [], "unpack_bits": []}
    for dc_diff, ac, prep, (dt, at) in streams:
        got = sy.ops._launch(dc_diff, ac)
        want = sy.symbolize_ref(dc_diff, ac)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"symbolize {label} differs from its plain version")
        fields = prep.fields(dt, at)
        payload = pb.ops._launch(*fields)
        check(torch.equal(payload, pb.pack_bits_ref(*fields)),
              f"pack_bits {label} differs from its plain version")
        (dp, ds), (ap, as_) = ub.table_params(dt), ub.table_params(at)
        tabs = torch.from_numpy(np.concatenate([dp, ap, ds, as_])).to(
            payload.device)
        uargs = (payload, tabs[:96], tabs[96:])
        got = ub.ops._launch(*uargs, ub.TILE_BITS)
        check(torch.equal(got, ub.unpack_words_ref(*uargs)),
              f"unpack_bits {label} differs from its plain version")
        work["blocks"] += dc_diff.shape[0]
        work["symbols"] += int(prep.dc_freq.sum() + prep.ac_freq.sum())
        work["fields"] += fields[0].shape[0]
        work["kept"] += int((fields[1] > 0).sum())
        work["payload_bytes"] += payload.shape[0]
        calls["symbolize"].append(((dc_diff, ac), sy.ops._launch,
                                   sy.symbolize_ref))
        calls["pack_bits"].append((fields, pb.ops._launch,
                                   pb.pack_bits_ref))
        calls["unpack_bits"].append(
            (uargs, lambda *a: ub.ops._launch(*a, ub.TILE_BITS),
             ub.unpack_words_ref))

    fast, slow = (10, 3) if n_streams == 1 else (5, 2)
    rows = []
    for name, variant in (("symbolize", "encode"), ("pack_bits", "encode"),
                          ("unpack_bits", "decode")):
        def run(which, name=name):
            for args, kernel, plain in calls[name]:
                (kernel if which == "kernel" else plain)(*args)
        nbytes, ops = byte_work(name, work)
        b_ms, b_by = bound(nbytes, ops, PEAK_INT32_PER_S)
        ms = time_ms(torch, lambda: run("kernel"), fast)
        row = dict(name=f"{name}[{variant}] {label}", kernel=name,
                   variant=variant, shape=label, route="cuda",
                   source=KERNELS[name][0], replaces=KERNELS[name][1],
                   max_abs_err=0, tolerance="exact", ms=ms,
                   plain_ms=time_ms(torch, lambda: run("plain"), slow),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   bytes=nbytes, ops=ops, streams=n_streams,
                   ms_per_stream=ms / n_streams, **work)
        emit(phase="kernel", **row)
        rows.append(row)
    return rows


# Least work of grad_dct per 64-sample row at ``keep`` coefficients
# (bytes, fp32 operations): both directions read or write the 256 B of
# f32 samples and the keep + 4 B of wire once; the truncated product is
# 64 x keep multiply-adds (2 operations each); encode adds an absolute
# value, a max, a division and a round per kept coefficient, decode a
# dequantising product.
def grad_work(rows: int, keep: int, variant: str):
    ops = 2 * 64 * keep + (4 * keep if variant == "encode" else keep)
    return rows * (256 + keep + 4), rows * ops


def grad_scale_slack(torch, g, keep):
    """The f32 rounding bound on two computations of a row's largest kept
    coefficient (64-term sums in any order), carried to its scale:
    2 * 64 * 2^-24 * max_k sum_j |g_j C_kj| / 127."""
    from repro_torch.core import dct
    c = dct.dct_matrix(64, device=g.device)[:keep].abs()
    return 2 * 64 * 2.0 ** -24 * (g.abs() @ c.T).amax(1, keepdim=True) / 127


def phase_grad_kernels(torch, rows_n, label):
    """grad_dct encode and decode at keep=16 on (rows_n, 64) seeded
    gradient rows on the card, against their plain versions: codes within
    +-1 on at most 1 in 10^4 (the kernel sums in another order than the
    plain matmul), scales within rtol 1e-6 or the f32 rounding bound,
    decode from the same codes within atol 1e-5; kernel ms, plain ms,
    bound ms, and the truncated product alone (torch.matmul) as
    matmul_ms, for context."""
    from repro_torch.core import dct
    from repro_torch.kernels import grad_dct as gd

    keep = GRAD_KEEP
    gen = torch.Generator(device="cuda").manual_seed(rows_n)
    g = torch.randn((rows_n, 64), generator=gen, device="cuda")
    br = gd.default_block_rows(rows_n)
    q, s = gd.ops._launch_encode(g, keep, br)
    q_ref, s_ref = gd.grad_dct_encode_ref(g, keep)
    diff = (q.int() - q_ref.int()).abs()
    flips = int((diff > 0).sum())
    code_err = int(diff.max())
    slack = grad_scale_slack(torch, g, keep)
    scale_ok = bool(((s - s_ref).abs() <= 1e-6 * s_ref + slack).all())
    scale_rel = float(((s - s_ref).abs() / s_ref).max())
    check(code_err <= 1 and flips <= max(1, int(1e-4 * q.numel()))
          and scale_ok, f"grad_dct[encode] {label}: codes off by "
          f"{code_err} on {flips} of {q.numel()}, scales within bound: "
          f"{scale_ok}")
    dec = gd.ops._launch_decode(q, s, br)
    dec_err = float((dec - gd.grad_dct_decode_ref(q, s)).abs().max())
    check(dec_err <= 1e-5, f"grad_dct[decode] {label}: off by {dec_err}")

    c = dct.dct_matrix(64, device=g.device)
    c_t = c[:keep].T.contiguous()
    c_k = c[:keep].contiguous()
    kept = q.float() * s
    fast, slow = (20, 5) if rows_n <= 1_000_000 else (10, 3)
    out = []
    for variant, max_err, tolerance, run, plain, product in (
            ("encode", code_err, "codes +-1 on <= 1e-4, scales rtol 1e-6 "
             "or the f32 rounding bound",
             lambda: gd.ops._launch_encode(g, keep, br),
             lambda: gd.grad_dct_encode_ref(g, keep),
             lambda: torch.matmul(g, c_t)),
            ("decode", dec_err, "atol 1e-5",
             lambda: gd.ops._launch_decode(q, s, br),
             lambda: gd.grad_dct_decode_ref(q, s),
             lambda: torch.matmul(kept, c_k))):
        nbytes, ops = grad_work(rows_n, keep, variant)
        b_ms, b_by = bound(nbytes, ops)
        row = dict(name=f"grad_dct[{variant}] {label}", kernel="grad_dct",
                   variant=variant, shape=label, route="cuda",
                   source=KERNELS["grad_dct"][0],
                   replaces=GRAD_DCT_REPLACES[variant], max_abs_err=max_err,
                   tolerance=tolerance, ms=time_ms(torch, run, fast),
                   plain_ms=time_ms(torch, plain, slow), bound_ms=b_ms,
                   bound_by=b_by, library_ms=None,
                   matmul_ms=time_ms(torch, product, fast), bytes=nbytes,
                   ops=ops, rows=rows_n, keep=keep, block_rows=br)
        if variant == "encode":
            row.update(codes_differing=flips, codes=q.numel(),
                       scale_max_rel_diff=scale_rel)
        emit(phase="kernel", **row)
        out.append(row)
    return out


def hold_projection(torch, gd, proj, corrected, keep, label):
    """One leaf's projection from the card against the plain roundtrip
    of the same corrected gradient on the card: the sub-row tail exact;
    rows within atol 1e-5, except that a code may flip by +-1 (the
    kernel sums in another order than the plain matmul) on at most 1 in
    10^4 codes, and a row with such a code moves by at most one
    quantisation step (its scale).  Returns the rows off by more than
    1e-5."""
    flat = proj.reshape(-1)
    corrected = corrected.reshape(-1)
    r = flat.numel() // 64
    check(torch.equal(flat[r * 64:], corrected[r * 64:]),
          f"{label}: tail not exact")
    q, s = gd.grad_dct_encode_ref(corrected[:r * 64].view(r, 64), keep)
    row_err = (flat[:r * 64].view(r, 64).float()
               - gd.grad_dct_decode_ref(q, s)).abs().amax(1)
    off = row_err > 1e-5
    n_off = int(off.sum())
    check(n_off <= math.ceil(1e-4 * r * keep) and bool(
        (row_err[off] <= s[off, 0] * (1 + 1e-6)).all()),
        f"{label}: {n_off} of {r} rows off the plain roundtrip, worst "
        f"{float(row_err.max())}")
    return n_off


def phase_gradients(torch, gd, gc, steps=5):
    """The training step's compression stage over SmolLM-360M's full
    gradient tree on the card: ``project_tree`` with error feedback for
    ``steps`` steps on seeded gradients.  Checks 10 encode and 10 decode
    launches per step, every compressed leaf's projection against the
    plain roundtrip on the first and the last step
    (``hold_projection``), ``new_ef == corrected - proj`` exactly on one
    leaf, ``final_norm`` passed through untouched, finite projections;
    reports ms per step, peak memory and the wire ratio of the
    compressed leaves (worked out from their shapes, so that no encode
    outside the steps is launched)."""
    cfg = gc.GradCompressConfig(enabled=True, keep=GRAD_KEEP)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw():
        return {p: torch.randn(shape, generator=gen, device="cuda")
                for p, shape in SMOLLM_360M_GRADS.items()}

    grads = draw()
    ef = gc.init_error_feedback(grads)
    small = [p for p, g in grads.items() if g.numel() < cfg.min_size]
    n_big = len(grads) - len(small)
    floats = sum(g.numel() for g in grads.values()
                 if g.numel() >= cfg.min_size)
    check(n_big == 10, f"{n_big} compressed leaves, want 10")
    probe = "blocks/mlp/wo"
    step_ms, flipped, peak = [], {}, 0
    for step in range(steps):
        if step:
            grads = draw()
        before = dict(gd.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, (new_g, new_ef) = wall_ms(torch, lambda: gc.project_tree(
            grads, ef, cfg))
        step_ms.append(ms)
        peak = max(peak, torch.cuda.max_memory_allocated())
        grew = {k: gd.launches[k] - before[k] for k in before}
        check(grew == {"encode": n_big, "decode": n_big},
              f"project_tree step {step}: launches grew by {grew}")
        for p in small:
            check(new_g[p] is grads[p] and new_ef[p] is ef[p],
                  f"{p} did not pass through untouched")
        if step in (0, steps - 1):
            for p in grads:
                if p not in small:
                    flipped[(step, p)] = hold_projection(
                        torch, gd, new_g[p], grads[p] + ef[p], cfg.keep,
                        f"step {step} {p}")
        corrected = grads[probe] + ef[probe]
        check(torch.equal(new_ef[probe], corrected - new_g[probe]),
              f"step {step}: new_ef != corrected - proj on {probe}")
        check(all(bool(torch.isfinite(new_g[p]).all()) and
                  new_g[p].shape == grads[p].shape for p in grads),
              f"step {step}: projection not finite or misshapen")
        rel = float(torch.linalg.norm(corrected - new_g[probe])
                    / torch.linalg.norm(corrected))
        del corrected
        ef = new_ef
    raw = wire = 0
    for p, g in grads.items():
        if g.numel() >= cfg.min_size:
            r, tail = divmod(g.numel(), 64)
            raw += 4 * g.numel()
            # CompressedGrad.wire_bytes(): codes, f32 scales, f32 tail
            wire += r * cfg.keep + 4 * r + 4 * tail
    # the least a projection step must move: read g and ef, write the
    # projection and the new ef, 16 B per compressed float
    b_ms, _ = bound(16 * floats, 0)
    row = dict(phase="gradients", model="smollm-360m", keep=cfg.keep,
               leaves=sorted(grads), compressed_leaves=n_big,
               exact_leaves=small, floats=floats, rows=floats // 64,
               steps=steps, step_ms=step_ms,
               ms_per_step_median=sorted(step_ms)[steps // 2],
               bound_ms_per_step=b_ms, peak_memory_bytes=peak,
               wire_ratio=raw / wire, raw_bytes=raw, wire_bytes=wire,
               ef_checked_on=probe, last_step_relative_residual=rel,
               rows_off_plain={f"{st} {p}": n
                               for (st, p), n in flipped.items()},
               launches_per_step={"encode": n_big, "decode": n_big})
    emit(**row)
    check(abs(raw / wire - 256 / (cfg.keep + 4)) < 1e-9,
          f"wire ratio {raw / wire}")
    return row


def phase_kv(torch, kv, keep=16):
    """compress_cache -> reconstruct_cache on SmolLM-360M's full-width KV
    cache (bf16), with a whole and a ragged prefix: synthetic keys and
    values that vary smoothly along T, made from a seed on the card.
    Checks shapes, finiteness, the raw tail kept exact, relative error
    < 0.05, and the card's codes against the CPU's on a small slice
    (+-1 on at most 1 in 10^4)."""
    l, b, t, h, d = SMOLLM_360M_KV
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def smooth():
        col = (l, b, 1, h, d)
        omega = 0.005 + 0.045 * torch.rand(col, generator=gen, device=dev)
        phase = 2 * torch.pi * torch.rand(col, generator=gen, device=dev)
        amp = torch.randn(col, generator=gen, device=dev)
        pos = torch.arange(t, device=dev, dtype=torch.float32).view(
            1, 1, t, 1, 1)
        x = amp * torch.sin(omega * pos + phase)
        x += 0.01 * torch.randn((l, b, t, h, d), generator=gen, device=dev)
        return x.to(torch.bfloat16)

    cache = {"k": smooth(), "v": smooth()}
    raw = sum(x.numel() * x.element_size() for x in cache.values())
    small = cache["k"][:2, :1].contiguous()
    codes, scales = kv.compress_tensor(small, keep)
    want, _ = kv.compress_tensor(small.cpu(), keep)
    diff = (codes.cpu().int() - want.int()).abs()
    check(int(diff.max()) <= 1 and int((diff > 0).sum()) <= max(
        1, int(1e-4 * diff.numel())), "kv codes: card differs from CPU")
    kv.reconstruct_cache(*kv.compress_cache(cache, keep, t))     # warm
    for prefix in (t, t - 48):
        t_c = prefix // 64 * 64
        c_ms, (ckv, tails) = wall_ms(torch, lambda: kv.compress_cache(
            cache, keep, prefix))
        r_ms, rec = wall_ms(torch, lambda: kv.reconstruct_cache(ckv, tails))
        errs = {}
        for p, x in cache.items():
            check(tuple(ckv.codes[p].shape) == (l, b, h, d, t_c // 64, keep)
                  and ckv.codes[p].dtype == torch.int8,
                  f"kv {p} codes {tuple(ckv.codes[p].shape)}")
            check(rec[p].shape == x.shape and rec[p].dtype == x.dtype
                  and bool(torch.isfinite(rec[p]).all()),
                  f"kv {p} prefix {prefix}: reconstruction misshapen")
            check(torch.equal(rec[p][:, :, t_c:], x[:, :, t_c:]),
                  f"kv {p} prefix {prefix}: raw tail changed")
            errs[p] = float(torch.linalg.norm(rec[p].float() - x.float())
                            / torch.linalg.norm(x.float()))
            check(errs[p] < 0.05, f"kv {p} prefix {prefix}: relative "
                  f"error {errs[p]}")
        wire = kv.wire_bytes(ckv, tails)
        emit(phase="kv", model="smollm-360m", shape=list(SMOLLM_360M_KV),
             dtype="bfloat16", keep=keep, prefix_len=prefix,
             t_compressed=t_c, compress_ms=c_ms, reconstruct_ms=r_ms,
             raw_bytes=raw, wire_bytes=wire, raw_over_dct=raw / wire,
             relative_error=errs, small_slice_codes_differing=int(
                 (diff > 0).sum()))


def reset_launches(modules):
    for m in modules:
        for k in m.launches:
            m.launches[k] = 0


def snapshot(modules):
    return {f"{m.__name__.rsplit('.', 1)[-1]}[{k}]": v
            for m in modules for k, v in m.launches.items()}


def phase_main_path(torch, np, eng, singles, batch, modules):
    """The engine at every paper size, the batch and a ragged list."""
    gpu_psnr = {}
    for kind, (h, w), img in singles:
        for transform in ("exact", "cordic"):
            for mode in ("standard", "matched"):
                run = lambda: eng.roundtrip_batch(  # noqa: E731
                    img[None], QUALITY, transform, mode=mode)
                before = snapshot(modules)
                first_ms, _ = wall_ms(torch, run)
                ms, (rec, psnr) = wall_ms(torch, run)
                after = snapshot(modules)
                p = float(psnr[0])
                check(tuple(rec.shape) == (1, h, w)
                      and rec.dtype == torch.uint8 and np.isfinite(p),
                      f"roundtrip {kind} {h}x{w} {transform} {mode}")
                gpu_psnr[kind, (h, w), transform, mode] = (p, rec[0])
                emit(phase="main", image=kind, size=[h, w],
                     transform=transform, mode=mode, psnr_db=p,
                     first_ms=first_ms, ms=ms,
                     route=sorted(k for k in after if after[k] > before[k]))
    for transform in ("exact", "cordic"):
        p = gpu_psnr["lena", (512, 512), transform, "standard"][0]
        want = REFERENCE_PSNR[transform]
        emit(phase="main", check="lena 512x512 PSNR vs RESULTS.md",
             transform=transform, psnr_db=p, reference_db=want,
             bound_db=PSNR_BOUND[transform])
        check(abs(p - want) <= PSNR_BOUND[transform],
              f"lena 512x512 {transform}: {p} dB, reference {want} dB")

    # the 64 x 512 x 512 batch, through each route
    batch_rec = {}
    for transform, mode in (("exact", "standard"), ("cordic", "matched"),
                            ("cordic", "standard")):
        eng.roundtrip_batch(batch, QUALITY, transform, mode=mode)  # warm
        ms, (rec, psnr) = wall_ms(torch, lambda: eng.roundtrip_batch(
            batch, QUALITY, transform, mode=mode))
        check(tuple(rec.shape) == batch.shape and np.isfinite(psnr).all(),
              f"batch {transform} {mode}")
        batch_rec[transform, mode] = rec
        emit(phase="main", image="batch", size=list(batch.shape),
             transform=transform, mode=mode, ms=ms,
             images_per_s=batch.shape[0] / ms * 1e3,
             psnr_db_mean=float(psnr.mean()), psnr_db_min=float(psnr.min()))

    # compress_batch -> decompress_batch through the staged kernels
    for transform, mode in (("exact", "standard"), ("cordic", "matched")):
        ms, rec = wall_ms(torch, lambda: eng.decompress_batch(
            eng.compress_batch(batch, QUALITY, transform), mode=mode))
        fused = batch_rec[transform, mode]
        diff = (rec.int() - fused.int()).abs().max().item()
        check(diff == 0 if transform == "cordic" else diff <= 3,
              f"staged vs fused {transform}: off by {diff}")
        emit(phase="main", image="batch", path="compress_batch -> "
             "decompress_batch", transform=transform, mode=mode, ms=ms,
             max_abs_diff_vs_roundtrip_batch=diff)

    # one ragged list: results in input order, each as when sent alone
    ragged = [img for kind, _, img in singles
              if img.shape in ((512, 512), (544, 512), (200, 200),
                               (320, 288), (1024, 814))]
    for transform in ("exact", "cordic"):
        ms, (recs, psnr) = wall_ms(torch, lambda: eng.roundtrip_batch(
            ragged, QUALITY, transform))
        for img, rec in zip(ragged, recs):
            kind = next(k for k, _, im in singles if im is img)
            alone = gpu_psnr[kind, img.shape, transform, "standard"][1]
            check(torch.equal(rec, alone),
                  f"ragged {transform} {img.shape} differs from alone")
        emit(phase="main", image="ragged",
             sizes=[list(im.shape) for im in ragged], transform=transform,
             ms=ms, psnr_db=[float(p) for p in psnr])
    return gpu_psnr


def reseal(data: bytes) -> bytes:
    """A stream with its CRC recomputed, so a corrupted body reaches the
    entropy decoder."""
    crc = zlib.crc32(data[4:24] + data[28:]) & 0xFFFFFFFF
    return data[:24] + struct.pack("<I", crc) + data[28:]


def phase_byte_path(torch, np, eng, singles, batch):
    """encode_batch -> DCTZ -> decode_batch at every paper size and on
    the batch, exact and cordic: bytes identical to the port's CPU path,
    decoded images identical to decompress_batch(compress_batch(x)),
    PSNR from the bytes, the golden fixtures and malformed streams."""
    from repro_torch.core import metrics
    from repro_torch.core.entropy import BitstreamError, container

    dev = torch.device("cuda")
    warm = eng.encode_batch(singles[-1][2][None], QUALITY)   # first calls
    eng.decode_batch(warm)
    for kind, (h, w), img in singles + [("batch", batch.shape[1:], batch)]:
        imgs = img if kind == "batch" else img[None]
        n = imgs.shape[0]
        for transform in ("exact", "cordic"):
            policies = (("auto", "embedded", "shared") if (h, w) == (512, 512)
                        and kind != "batch" else ("auto",))
            for tables in policies:
                enc_ms, blobs = wall_ms(torch, lambda: eng.encode_batch(
                    imgs, QUALITY, transform, tables=tables))
                cpu = eng.encode_batch(imgs, QUALITY, transform,
                                       tables=tables, device="cpu")
                check(blobs == cpu, f"{kind} {h}x{w} {transform} {tables}: "
                      "card bytes differ from the CPU path's")
                row = dict(phase="bytes", image=kind, size=[n, h, w],
                           transform=transform, tables=tables,
                           bytes_per_image=[len(b) for b in blobs][:4],
                           bytes_total=sum(len(b) for b in blobs),
                           bpp=8 * sum(len(b) for b in blobs) / (n * h * w),
                           encode_ms=enc_ms, identical_to_cpu=True)
                if tables == "auto":
                    dec_ms, rec = wall_ms(torch, lambda: eng.decode_batch(
                        blobs))
                    want = eng.decompress_batch(eng.compress_batch(
                        imgs, QUALITY, transform))
                    check(all(torch.equal(r, x) for r, x in zip(rec, want)),
                          f"{kind} {h}x{w} {transform}: decode_batch differs"
                          " from decompress_batch(compress_batch(x))")
                    psnr = metrics.psnr(torch.from_numpy(imgs).to(dev),
                                        torch.stack(rec)).cpu().numpy()
                    row.update(decode_ms=dec_ms, lossless=True,
                               psnr_db=float(psnr.mean()),
                               images_per_s_encode=n / enc_ms * 1e3,
                               images_per_s_decode=n / dec_ms * 1e3)
                    if (kind, h, w) == ("lena", 512, 512):
                        want_db = REFERENCE_PSNR[transform]
                        check(abs(psnr[0] - want_db) <= PSNR_BOUND[transform],
                              f"lena 512x512 {transform} from bytes: "
                              f"{psnr[0]} dB, reference {want_db} dB")
                        row.update(reference_db=want_db)
                emit(**row)

    for path in sorted((ROOT / "tests" / "data").glob("*.dctz")):
        data = path.read_bytes()
        q, hdr = container.decode_qcoeffs(data)
        want, _ = container.decode_qcoeffs(data, device="cpu")
        check(torch.equal(q.cpu(), want), f"golden {path.name}: card levels "
              "differ from the CPU path's")
        emit(phase="bytes", golden=path.name, levels_identical=True,
             version=hdr["version"])

    blob = eng.encode_batch(next(img for kind, s, img in singles if s ==
                                 (512, 512))[None], QUALITY)[0]
    bad = [blob[:-5]]
    for pos in range(len(blob) - 1, 28, -7):      # a flip the CPU rejects
        flipped = bytearray(blob)
        flipped[pos] ^= 0x24
        flipped = reseal(bytes(flipped))
        try:
            container.decode_zigzag_host(flipped, device="cpu")
        except BitstreamError:
            bad.append(flipped)
            break
    check(len(bad) == 2, "no resealed bit flip was rejected")
    for data in bad:
        msgs = []
        for device in ("cpu", "cuda"):
            try:
                container.decode_zigzag_host(data, device=device)
                msgs.append(None)
            except BitstreamError as e:
                msgs.append(str(e))
        check(msgs[0] is not None and msgs[0] == msgs[1],
              f"malformed stream: card {msgs[1]!r}, CPU {msgs[0]!r}")
        emit(phase="bytes", malformed=msgs[1])


def phase_cpu_column(torch, eng, singles, gpu_psnr):
    """The paper's CPU column: the port's own path on the host CPU,
    asked for explicitly, beside the GPU's numbers."""
    for kind, (h, w), img in singles:
        if (h, w) not in ((512, 512), (200, 200)) or kind != "lena":
            continue
        for transform in ("exact", "cordic"):
            t0 = time.perf_counter()
            rec, psnr = eng.roundtrip_batch(img[None], QUALITY, transform,
                                            device="cpu")
            cpu_ms = (time.perf_counter() - t0) * 1e3
            gpu_p, gpu_rec = gpu_psnr[kind, (h, w), transform, "standard"]
            diff = (rec[0].int() - gpu_rec.cpu().int()).abs().max().item()
            check(diff == 0 if transform == "cordic" else diff <= 3,
                  f"CPU vs GPU {transform} {h}x{w}: off by {diff}")
            emit(phase="cpu_column", image=kind, size=[h, w],
                 transform=transform, cpu_ms=cpu_ms,
                 cpu_psnr_db=float(psnr[0]), gpu_psnr_db=gpu_p,
                 max_abs_diff_vs_gpu=diff)


def device_profile(torch, fn):
    """torch.profiler over one call of ``fn`` ending in a synchronise:
    the window, device busy time, and the largest device and host
    (operator) items."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    device, host = [], {}
    for e in prof.events():
        kind = getattr(e.device_type, "name", str(e.device_type))
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0][:72]
        if kind == "CUDA":
            device.append((e.time_range.start, e.time_range.end, name))
        elif e.cpu_parent is None:
            host[name] = host.get(name, 0.0) + e.time_range.elapsed_us()
    busy = 0.0
    last = -1.0
    for start, end, _ in sorted(device):
        busy += max(0.0, end - max(start, last))
        last = max(last, end)
    by_kernel = {}
    for start, end, name in device:
        by_kernel[name] = by_kernel.get(name, 0.0) + (end - start)
    return dict(window_us=window_us, device_busy_us=busy,
                device_idle_share=1 - busy / window_us,
                device_top=sorted(by_kernel.items(),
                                  key=lambda kv: -kv[1])[:8],
                host_top=sorted(host.items(), key=lambda kv: -kv[1])[:8])


def python_profile(fn, top=8):
    """cProfile over one call: the host's largest Python functions by
    their own time (the table choice, framing and chain resolution are
    host work the operator profile does not name)."""
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [(f"{pathlib.Path(f).name}:{line}:{func}", tt * 1e3, ct * 1e3)
            for (f, line, func), (_, _, tt, ct, _) in rows]


def phase_profile(torch, eng, batch, singles):
    """Where each path's time goes: one roundtrip_batch call, and one
    encode_batch and one decode_batch call, at 3072x3072 and on the
    batch."""
    big = next(img for kind, s, img in singles if s == (3072, 3072))
    for label, imgs in (("3072x3072", big[None]), ("64x512x512", batch)):
        for transform, mode in (("exact", "standard"),
                                ("cordic", "standard")):
            row = device_profile(torch, lambda: eng.roundtrip_batch(
                imgs, QUALITY, transform, mode=mode))
            check(row["device_busy_us"] > 0, f"profile {label} {transform}:"
                  " the profiler recorded no device time")
            emit(phase="profile", images=label, call="roundtrip_batch",
                 transform=transform, mode=mode, **row)
        blobs = eng.encode_batch(imgs, QUALITY)
        for call, fn in (
                ("encode_batch", lambda: eng.encode_batch(imgs, QUALITY)),
                ("decode_batch", lambda: eng.decode_batch(blobs))):
            row = device_profile(torch, fn)
            check(row["device_busy_us"] > 0, f"profile {label} {call}: "
                  "the profiler recorded no device time")
            emit(phase="profile", images=label, call=call,
                 transform="exact", python_top_ms=python_profile(
                     lambda: (fn(), torch.cuda.synchronize())), **row)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import images
    from repro_torch.kernels import _build
    from repro_torch.kernels import cordic_loeffler as cl
    from repro_torch.kernels import dct8x8 as d8
    from repro_torch.kernels import fused_codec as fc
    from repro_torch.kernels import grad_dct as gd
    from repro_torch.kernels import pack_bits as pb
    from repro_torch.kernels import symbolize as sy
    from repro_torch.kernels import unpack_bits as ub
    from repro_torch.optim import grad_compress as gc
    from repro_torch.serve import codec_engine as eng
    from repro_torch.serve import kv_compress as kv

    t_start = time.perf_counter()
    phase_device()
    phase_build(_build)
    singles, batch = make_inputs(np, images)
    dev = torch.device("cuda")
    big = next(img for kind, s, img in singles if s == (3072, 3072))
    rows = phase_kernels(torch, torch.from_numpy(big[None]).to(dev).float(),
                         "3072x3072")
    rows += phase_kernels(torch, torch.from_numpy(batch).to(dev).float(),
                          "64x512x512")
    rows += phase_byte_kernels(torch, np, eng, big[None], "3072x3072")
    rows += phase_byte_kernels(torch, np, eng, batch, "64x512x512")
    tree_rows = sum(math.prod(s) // 64 for s in SMOLLM_360M_GRADS.values()
                    if math.prod(s) >= gc.GradCompressConfig().min_size)
    rows += phase_grad_kernels(torch, tree_rows, f"{tree_rows}x64")
    rows += phase_grad_kernels(torch, 65_536, "65536x64")

    # each path is driven with every count at 0 just before it and read
    # just after; its own kernels must have been launched in that run
    modules = (fc, d8, cl, sy, pb, ub, gd)
    launches = {}
    for path, run, own in (
            ("pixels", lambda: phase_main_path(torch, np, eng, singles,
                                               batch, modules), (fc, d8, cl)),
            ("bytes", lambda: phase_byte_path(torch, np, eng, singles,
                                              batch), (sy, pb, ub)),
            ("gradients", lambda: phase_gradients(torch, gd, gc), (gd,))):
        reset_launches(modules)
        out = run()
        torch.cuda.synchronize()
        counts = snapshot(modules)
        emit(phase="launches", path=path, counts=counts)
        mine = snapshot(own)
        missing = [k for k, v in mine.items() if v == 0]
        check(not missing, f"kernels never launched on the {path} path: "
              f"{missing}")
        launches.update(mine)
        if path == "pixels":
            gpu_psnr = out

    phase_kv(torch, kv)
    phase_cpu_column(torch, eng, singles, gpu_psnr)
    phase_profile(torch, eng, batch, singles)

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "bytes")
    for row in rows:
        row["launches"] = launches[f"{row['kernel']}[{row['variant']}]"]
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **({"matmul_ms": r["matmul_ms"]} if "matmul_ms" in r else {})}
        for r in rows]}))
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
