"""PyTorch/CUDA port of the DCT codec (``repro``), for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
``torch`` and numpy only, never ``jax`` or ``repro``.  Every TPU kernel on
the ported path has a hand-written CUDA counterpart under
``repro_torch/kernels/csrc``, built with ``nvcc`` at first use.

Public entry points take ``device=None``, which means ``"cuda"``; they
raise when no GPU is present unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

# The exact-DCT bounds (coefficients within 2e-3, levels within +-1 on
# fewer than 1e-3 of them) need full fp32 products; TF32 keeps about
# three decimal digits and would break them.  Matmul TF32 is off by
# default, cuDNN's is on, so both are set explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises:
        RuntimeError: a CUDA device was asked for (or implied by
            ``None``) and none is present; the port never carries on
            quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A NumPy array or tensor as a tensor on ``device`` (no copy when it
    is already there)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)
