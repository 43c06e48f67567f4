"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own into
``build/repro_torch/lib<name>_<hash>.so`` at the root of the checkout, at
first use.  The hash covers the source, every header in ``csrc/`` and the
flags, so an edit rebuilds and an unchanged tree reuses the library.  The
libraries have a plain C interface: pointers and the stream are passed as
``c_void_p``, and every entry point returns ``cudaGetLastError()`` after
its launch, which :func:`check` turns into an exception.

A build that fails raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch")

# --fmad=false keeps nvcc from contracting a*b+c into one FMA, so the
# CORDIC graph rounds after every product and sum, as the reference does;
# explicit fmaf() calls in the exact products are still FMAs.  No
# --use_fast_math: division and rintf must stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v")

KERNEL_SOURCES = ("dct8x8", "cordic_loeffler", "fused_codec", "symbolize",
                  "pack_bits", "unpack_bits", "grad_dct")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: pathlib.Path
    seconds: float          # 0.0 when an earlier build was reused
    ptxas: tuple            # register / spill lines from ``-Xptxas -v``


def nvcc_path() -> str:
    """The ``nvcc`` to build with.

    Raises:
        RuntimeError: no CUDA compiler is installed.
    """
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def source_hash(name: str) -> str:
    """Content hash of ``csrc/<name>.cu``, the shared headers and flags."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}_{source_hash(name)}.so"


def _ptxas_lines(log: str) -> tuple:
    keep = ("Compiling entry function", "registers", "spill")
    return tuple(line.strip() for line in log.splitlines()
                 if any(k in line for k in keep))


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless its library already exists.

    Raises:
        RuntimeError: ``nvcc`` is missing or the compile fails.
    """
    if name not in KERNEL_SOURCES:
        raise ValueError(f"unknown kernel source {name!r}")
    out = library_path(name)
    log_path = out.with_suffix(".log")
    if out.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return BuildResult(name, out, 0.0, _ptxas_lines(log))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)     # atomic: a concurrent loader sees all or none
    return BuildResult(name, out, seconds, _ptxas_lines(log))


def build_all(names=KERNEL_SOURCES) -> list:
    """Build several sources at once, one ``nvcc`` process each."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu``'s library (once per
    process).  The caller sets ``argtypes`` on the functions it uses."""
    lib = ctypes.CDLL(str(build(name).path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
