"""Plain PyTorch version of the symbolize kernel (``csrc/symbolize.cu``).

The same function, staged through memory over a **dense per-block
layout**: every 8x8 block owns 64 symbol slots (slot 0 is its DC symbol;
a block never emits more than 64 symbols), so symbolisation is
fixed-shape tensor arithmetic:

1. **categories** of the DC differences and AC levels (bit lengths, by
   ``frexp`` as the reference takes them);
2. **runs**: each nonzero's previous nonzero position is an exclusive
   running maximum (``cummax``), giving its zero run, its ZRL expansions
   and its ``(run, size)`` symbol;
3. **slots**: an inclusive ``cumsum`` of per-coefficient unit counts
   places every ZRL and coded symbol at its dense slot, filled by
   scatter; untouched slots keep ``(EOB, 0, 0)``;
4. **histograms** by ``bincount``, and the largest DC and AC
   categories, from which the wrapper raises the reference's
   ``RangeError``.
"""

from __future__ import annotations

import torch

AC_LEN = 63
SLOTS = 64                      # dense symbol slots per block
MAX_ZRL = (AC_LEN - 1) // 16    # a run skips at most 62 zeros: 3 ZRLs
MAX_CATEGORY = 15
EOB = 0x00
ZRL = 0xF0
STATS = 2 * 256 + 2             # DC histogram | AC histogram | max cats


def _category(v: torch.Tensor) -> torch.Tensor:
    """Bit length of |v| per element (0 for v == 0), exact below 2**53."""
    mag = v.abs().to(torch.float64)
    return torch.where(mag == 0, 0, torch.frexp(mag).exponent.to(
        torch.int64))


def _amplitude(v: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
    """One's-complement amplitude field of category ``cat``."""
    return torch.where(v >= 0, v, v + (1 << cat) - 1)


def symbolize_ref(dc_diff: torch.Tensor, ac: torch.Tensor) -> tuple:
    """Blocks -> dense symbol slots, per-block counts and statistics.

    Args:
        dc_diff: (n,) int64 DC differences in block order.
        ac: (n, 63) int32 AC tails in zig-zag order.

    Returns:
        ``(slots, total, stats)`` on the inputs' device: (3, n, 64) int16
        slots (symbols, amplitude values, amplitude widths; empty slots
        hold ``(EOB, 0, 0)``), (n,) int32 symbol counts per block, and
        (514,) int32 statistics: the DC and AC 256-bin histograms, then
        the largest DC and AC magnitude categories.  Where a category
        exceeds 15 the slots and histograms clamp it; the caller raises.
    """
    dev = dc_diff.device
    n = dc_diff.shape[0]
    dc = dc_diff.to(torch.int64)
    acl = ac.to(torch.int64)
    dc_cat = _category(dc)
    ac_cat = _category(acl)
    stats = torch.zeros(STATS, dtype=torch.int64, device=dev)
    if n:
        stats[512] = dc_cat.max()
        stats[513] = ac_cat.max()
    dc_cat = dc_cat.clamp(max=MAX_CATEGORY)
    ac_cat = ac_cat.clamp(max=MAX_CATEGORY)

    nz = acl != 0
    col = torch.arange(AC_LEN, device=dev).expand(n, AC_LEN)
    run_max = torch.cummax(torch.where(nz, col, -1), dim=1).values
    prev = torch.cat([torch.full((n, 1), -1, dtype=torch.int64,
                                 device=dev), run_max[:, :-1]], dim=1)
    run = col - prev - 1
    zrl = run >> 4
    unit = torch.where(nz, zrl + 1, 0)
    cu = torch.cumsum(unit, dim=1)
    start = cu - unit + 1                # slot of the unit's first symbol
    eob = run_max[:, -1] != AC_LEN - 1
    total = (1 + cu[:, -1] + eob.to(torch.int64)).to(torch.int32)

    slots = torch.zeros((3, n, SLOTS), dtype=torch.int16, device=dev)
    slots[0, :, 0] = dc_cat.to(torch.int16)
    slots[1, :, 0] = _amplitude(dc, dc_cat).to(torch.int16)
    slots[2, :, 0] = dc_cat.to(torch.int16)
    base = (torch.arange(n, device=dev) * SLOTS)[:, None]
    coef_sym = ((run & 15) << 4) | ac_cat
    coded = (base + start + zrl)[nz]
    for plane, val in ((0, coef_sym), (1, _amplitude(acl, ac_cat)),
                       (2, ac_cat)):
        slots[plane].view(-1)[coded] = val[nz].to(torch.int16)
    for t in range(MAX_ZRL):
        live = nz & (zrl > t)
        slots[0].view(-1)[(base + start + t)[live]] = ZRL

    stats[:256] = torch.bincount(dc_cat, minlength=256)
    ac_hist = torch.bincount(coef_sym[nz], minlength=256)
    ac_hist[ZRL] += torch.where(nz, zrl, 0).sum()
    ac_hist[EOB] += eob.sum()
    stats[256:512] = ac_hist
    return slots, total, stats.to(torch.int32)
