#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` (into ``build/repro_torch/``), holds every kernel against its
plain PyTorch version on the card and times both, drives
``repro_torch.serve.codec_engine`` at the paper's image sizes and at a
64 x 512 x 512 batch, checks the PSNR the JAX reference reports
(RESULTS.md: lena 512x512 at quality 50, 37.900 dB exact and 35.784 dB
cordic), runs the CPU column of the paper's CPU-versus-GPU comparison,
counts the kernel launches of the main path, and profiles where the time
of the main path goes.  Every phase prints JSON lines; any failed check
or error exits non-zero.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

It exits non-zero, with no result, where no CUDA device is present or the
port's sources are not beside it.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# NVIDIA's H100 SXM data sheet, at the 700 W power limit: HBM3 bandwidth
# and fp32 outside the tensor cores (the kernels use no TF32).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

QUALITY = 50
# RESULTS.md, Table 3 (lena 512x512, quality 50), from the JAX reference.
REFERENCE_PSNR = {"exact": 37.900, "cordic": 35.784}
PSNR_BOUND = {"exact": 0.05, "cordic": 1e-3}


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


def bound(nbytes: int, ops: int):
    """Least time in ms for the work, and whether bytes or operations
    set it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
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
}


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


def phase_profile(torch, eng, batch, singles):
    """Where the main path's time goes: torch.profiler over one
    roundtrip_batch call, device busy time against the host window."""
    from torch.profiler import ProfilerActivity, profile

    big = next(img for kind, s, img in singles if s == (3072, 3072))
    for label, imgs in (("3072x3072", big[None]), ("64x512x512", batch)):
        for transform, mode in (("exact", "standard"),
                                ("cordic", "standard")):
            eng.roundtrip_batch(imgs, QUALITY, transform, mode=mode)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.roundtrip_batch(imgs, QUALITY, transform, mode=mode)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
            device, host = [], {}
            for e in prof.events():
                kind = getattr(e.device_type, "name", str(e.device_type))
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.split("(")[0][:72]
                if kind == "CUDA":
                    device.append((e.time_range.start, e.time_range.end,
                                   name))
                elif e.cpu_parent is None:
                    host[name] = host.get(name, 0.0) + \
                        e.time_range.elapsed_us()
            check(bool(device), f"profile {label} {transform}: the profiler "
                  "recorded no device time")
            busy = 0.0
            last = -1.0
            for start, end, _ in sorted(device):
                busy += max(0.0, end - max(start, last))
                last = max(last, end)
            by_kernel = {}
            for start, end, name in device:
                by_kernel[name] = by_kernel.get(name, 0.0) + (end - start)
            emit(phase="profile", images=label, transform=transform,
                 mode=mode, window_us=window_us,
                 device_busy_us=busy, device_idle_share=1 - busy / window_us,
                 device_top=sorted(by_kernel.items(),
                                   key=lambda kv: -kv[1])[:8],
                 host_top=sorted(host.items(), key=lambda kv: -kv[1])[:8])


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
    from repro_torch.serve import codec_engine as eng

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

    modules = (fc, d8, cl)
    reset_launches(modules)
    gpu_psnr = phase_main_path(torch, np, eng, singles, batch, modules)
    torch.cuda.synchronize()
    launches = snapshot(modules)
    emit(phase="launches", main_path=launches)
    missing = [k for k, v in launches.items() if v == 0]
    check(not missing, f"kernels never launched on the main path: {missing}")

    phase_cpu_column(torch, eng, singles, gpu_psnr)
    phase_profile(torch, eng, batch, singles)

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    for row in rows:
        row["launches"] = launches[f"{row['kernel']}[{row['variant']}]"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
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
