"""Batched codec pipeline on one GPU: the port of
``repro.serve.codec_engine``'s array half (pixels <-> levels <-> pixels).

* ``compress_batch`` / ``decompress_batch`` / ``roundtrip_batch`` take a
  stacked ``(B, H, W)`` batch or a ragged list of mixed-size images;
* a stacked batch is edge-padded to the 8-block like the single-image
  API; ragged images are edge-padded to **bucketed** shapes (next multiple
  of :data:`SHAPE_BUCKET`) and equal buckets run together, with the same
  grouping as the reference;
* ``roundtrip_batch`` sends ``transform="exact"`` and matched CORDIC
  roundtrips to the one-pass ``fused_codec`` kernel (it reconstructs with
  the encoder's own transform, so it serves only the roundtrips whose
  semantics agree with it); every other combination runs compress then
  decompress through the ``dct8x8`` and ``cordic_loeffler`` kernels.

The route depends only on (transform, mode): on the CPU the same route
runs each kernel's plain PyTorch version.  The reference's pow2 batch
padding and ``shard_map`` exist for XLA's compile cache and its device
mesh; one GPU running eager PyTorch needs neither.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import codec, cordic, metrics
from repro_torch.kernels.common import edge_pad
from repro_torch.kernels.fused_codec import fused_codec

SHAPE_BUCKET = 64      # ragged H/W round up to this (multiple of the block)


@dataclasses.dataclass
class CompressedGroup:
    """Images sharing one padded bucket shape, compressed together."""
    qcoeffs: torch.Tensor          # (n, bh/8, bw/8, 8, 8) int32
    indices: tuple                 # positions in the original input order
    orig_shapes: tuple             # per-image (H, W) before padding


@dataclasses.dataclass
class CompressedBatch:
    """Quantised DCT representation of a batch of grayscale images."""
    groups: list
    n_images: int
    quality: int
    transform: str
    cordic_config: cordic.CordicConfig
    stacked: bool                  # input was a single (B, H, W) array


def _bucket_dim(d: int) -> int:
    return d + (-d) % SHAPE_BUCKET


def _to_device(imgs, device: torch.device):
    """The input as one tensor (stacked) or a list of tensors (ragged),
    on ``device``."""
    if isinstance(imgs, (np.ndarray, torch.Tensor)):
        return as_tensor(imgs, device)
    return [as_tensor(im, device) for im in imgs]


def _group_inputs(imgs):
    """[(padded, indices, orig_shapes)] bucket groups, and whether the
    input was stacked.  ``imgs`` comes from :func:`_to_device`."""
    if isinstance(imgs, torch.Tensor):
        if imgs.dim() != 3:
            raise ValueError(f"stacked batch must be (B, H, W), "
                             f"got {tuple(imgs.shape)}")
        if imgs.shape[0] == 0:
            raise ValueError("empty batch: nothing to compress")
        b, h, w = imgs.shape
        return [(codec.pad_to_block(imgs), tuple(range(b)),
                 tuple((h, w) for _ in range(b)))], True

    if not len(imgs):
        raise ValueError("empty batch: nothing to compress")
    buckets: dict = {}
    for i, im in enumerate(imgs):
        if im.dim() != 2:
            raise ValueError(f"image {i} must be 2-D (H, W), "
                             f"got {tuple(im.shape)}")
        h, w = im.shape
        buckets.setdefault((_bucket_dim(h), _bucket_dim(w)), []).append(
            (i, im))
    groups = []
    for (bh, bw), members in buckets.items():
        padded = torch.stack([edge_pad(im, bh - im.shape[0],
                                       bw - im.shape[1])
                              for _, im in members])
        groups.append((padded, tuple(i for i, _ in members),
                       tuple(tuple(im.shape) for _, im in members)))
    return groups, False


def _reassemble(per_group: list, groups: list, n: int, stacked: bool):
    """Per-group outputs back in input order, each cropped to its size."""
    if stacked:
        ((_, _, shapes),) = groups
        h, w = shapes[0]
        return per_group[0][:, :h, :w]
    out = [None] * n
    for imgs_out, (_, indices, orig_shapes) in zip(per_group, groups):
        for j, (idx, (h, w)) in enumerate(zip(indices, orig_shapes)):
            out[idx] = imgs_out[j, :h, :w]
    return out


def compress_batch(imgs, quality: int = 50,
                   transform: codec.Transform = "exact",
                   cordic_config: cordic.CordicConfig = cordic.PAPER_CONFIG,
                   device=None) -> CompressedBatch:
    """Compress a (B, H, W) batch or a ragged list of grayscale images.

    Args:
        imgs: a stacked (B, H, W) uint8/float array or tensor, or a list
            of 2-D (H, W) images of mixed sizes.
        quality: JPEG quality factor in [1, 100].
        transform: encoder transform ("exact"/"cordic"/"loeffler").
        cordic_config: CORDIC config for ``transform == "cordic"``.
        device: where to run; None means "cuda" (raises without a GPU).

    Returns:
        A :class:`CompressedBatch` whose groups hold (n, bh/8, bw/8, 8, 8)
        int32 levels per bucket shape on ``device``.
    """
    groups, stacked = _group_inputs(_to_device(imgs, resolve_device(device)))
    out = [CompressedGroup(
        qcoeffs=codec.compress_batch_blocks(padded, transform, quality,
                                            cordic_config),
        indices=indices, orig_shapes=orig_shapes)
        for padded, indices, orig_shapes in groups]
    return CompressedBatch(groups=out,
                           n_images=sum(len(g.indices) for g in out),
                           quality=quality, transform=transform,
                           cordic_config=cordic_config, stacked=stacked)


def decompress_batch(cb: CompressedBatch, mode: str = "standard"):
    """Reconstruct every image, on the levels' device.

    Args:
        cb: a :class:`CompressedBatch` from :func:`compress_batch`.
        mode: "standard" (exact IDCT, standards-compliant) or "matched"
            (the encoder's own transform).

    Returns:
        (B, H, W) uint8 tensor when the input was stacked, else a list of
        (H, W) uint8 tensors in input order, each cropped to its size.
    """
    dec_transform = "exact" if mode == "standard" else cb.transform
    per_group = [codec.decompress_batch_blocks(g.qcoeffs, dec_transform,
                                               cb.quality, cb.cordic_config)
                 for g in cb.groups]
    groups = [(None, g.indices, g.orig_shapes) for g in cb.groups]
    return _reassemble(per_group, groups, cb.n_images, cb.stacked)


def _fused_ok(transform: str, mode: str) -> bool:
    """The fused kernel reconstructs with the encoder's own transform, so
    it serves exact roundtrips (both modes coincide) and matched CORDIC
    ones.  ("loeffler" has no fused kernel, in the reference either.)"""
    return transform == "exact" or (transform == "cordic"
                                    and mode == "matched")


def roundtrip_batch(imgs, quality: int = 50,
                    transform: codec.Transform = "exact",
                    cordic_config: cordic.CordicConfig = cordic.PAPER_CONFIG,
                    mode: str = "standard", with_psnr: bool = True,
                    device=None):
    """Batched form of :func:`repro_torch.core.codec.roundtrip`.

    Args:
        imgs: stacked (B, H, W) array or ragged list of (H, W) images.
        quality: JPEG quality factor in [1, 100].
        transform: encoder transform ("exact"/"cordic"/"loeffler").
        cordic_config: CORDIC config for ``transform == "cordic"``.
        mode: decode mode, see :func:`decompress_batch`.
        with_psnr: also score each reconstruction against its input.
        device: where to run; None means "cuda" (raises without a GPU).

    Returns:
        ``(reconstructed, psnr)``: ``reconstructed`` is a (B, H, W) uint8
        tensor for stacked input (a list for ragged input) on ``device``;
        ``psnr`` is a (B,) float32 NumPy array of dB values, or None when
        ``with_psnr=False``.
    """
    dev = resolve_device(device)
    imgs = _to_device(imgs, dev)
    if _fused_ok(transform, mode):
        groups, stacked = _group_inputs(imgs)
        per_group = [fused_codec(padded, quality=quality,
                                 transform=transform, config=cordic_config)[0]
                     for padded, _, _ in groups]
        n = sum(len(g[1]) for g in groups)
        rec = _reassemble(per_group, groups, n, stacked)
    else:
        cb = compress_batch(imgs, quality, transform, cordic_config,
                            device=dev)
        rec = decompress_batch(cb, mode=mode)

    if not with_psnr:
        return rec, None
    if isinstance(rec, list):
        psnr = torch.stack([metrics.psnr(im, r) for im, r in zip(imgs, rec)])
    else:
        psnr = metrics.psnr(imgs, rec)
    return rec, psnr.cpu().numpy()
