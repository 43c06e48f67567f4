"""DCT gradient compression with error feedback, on dicts from a
parameter's path to its gradient tensor.

Per leaf:
  1. residual-corrected gradient  g' = g + ef          (error feedback)
  2. DCT-domain projection        p  = IDCT(trunc_k(DCT(g')))  [+ int8 quant]
  3. new error feedback           ef' = g' - p
The projection is the grad_dct kernel's encode/decode pair, so what the
optimiser applies is what would cross the interconnect.  Leaves smaller
than ``min_size`` stay exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.grad_dct import ops as gd


@dataclasses.dataclass(frozen=True)
class GradCompressConfig:
    enabled: bool = False
    keep: int = 16                 # of 64 DCT coefficients
    axis: str = "pod"              # mesh axis whose traffic is compressed
    min_size: int = 4096           # leaves smaller than this stay exact

    @property
    def ratio(self) -> float:
        """wire-bytes ratio vs f32 (per 64-float block: keep int8 + 1 f32)."""
        return (self.keep * 1 + 4) / (64 * 4)


def project_leaf(g: torch.Tensor, keep: int) -> torch.Tensor:
    """Lossy DCT projection of one gradient leaf (any shape), in its
    dtype."""
    proj = gd.roundtrip(g.reshape(-1).to(torch.float32), keep=keep)
    return proj.reshape(g.shape).to(g.dtype)


def init_error_feedback(params: dict) -> dict:
    """Zero f32 error feedback of each leaf's shape, on its device."""
    return {path: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for path, p in params.items()}


def project_tree(grads: dict, ef: dict, cfg: GradCompressConfig):
    """Apply the EF-corrected DCT projection to every leaf of at least
    ``cfg.min_size`` elements.

    Returns:
        ``(projected_grads, new_ef)``; a smaller leaf passes through, and
        its error feedback with it, as the same tensors.
    """
    new_g, new_ef = {}, {}
    for path, g in grads.items():
        if g.numel() < cfg.min_size:
            new_g[path] = g
            new_ef[path] = ef[path]
            continue
        corrected = g.to(torch.float32) + ef[path]
        proj = project_leaf(corrected, cfg.keep)
        new_g[path] = proj.to(g.dtype)
        new_ef[path] = corrected - proj
    return new_g, new_ef


def from_numpy_tree(tree: dict, device=None) -> dict:
    """A dict of NumPy arrays (the reference's gradients or error
    feedback, brought to the host) as tensors on ``device`` (``None``
    means ``"cuda"``), copied, so the port owns them.  bfloat16 arrays
    (``ml_dtypes``, as JAX hands them out) keep their bits."""
    dev = resolve_device(device)
    out = {}
    for path, a in tree.items():
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[path] = t.to(dev)
    return out
