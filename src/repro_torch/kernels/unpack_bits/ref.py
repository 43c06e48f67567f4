"""Plain PyTorch version of the unpack_bits kernel
(``csrc/unpack_bits.cu``), and the host's chain resolution that runs
after either.

Huffman decode is serial in the bit-offset chain, not in the work
(Cloud et al., arXiv:1107.1525): the staging step decodes speculatively
from *every* bit offset of the payload,

* a **unit word** ``(ctrl + 2) << 6 | adv`` for the DC and the AC table,
  where ``ctrl`` is the symbol byte, -1 for an invalid prefix or -2 for
  a unit that needs bits past the payload, and ``adv`` the code plus
  amplitude bits (0 for those two);
* an **outcome word** ``value << 2 | kind`` per offset that collapses
  the AC chain starting there, by six pointer-doubling squarings over
  (position after the unit, coefficient positions it covers): kind 0,
  the block ends well and ``value`` is the first bit after it; 1, an
  invalid prefix at bit ``value``; 2, a truncation at bit ``value``;
  3, an AC run that overruns the block.

These are the reference's word layouts (``repro.kernels.unpack_bits``),
bit-identical at every offset.  :func:`resolve` (NumPy, a copy of the
reference's) then hops block starts through the words, O(1) per block,
and re-reads amplitudes from the payload's 16-bit windows.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.entropy import bitio

AC_LEN = 63                   # AC coefficients per 8x8 block
MAX_CATEGORY = 15             # largest magnitude category (amplitude width)
ZRL = 0xF0                    # sixteen-zeros AC run marker

_CTRL_SHIFT = 6
_ADV_MASK = 0x3F

# outcome kinds
_OK, _INVALID, _TRUNCATED, _OVERRUN = 0, 1, 2, 3


def _windows(payload: torch.Tensor, n_pos: int) -> torch.Tensor:
    """MSB-first 16-bit windows at bit offsets 0..n_pos-1, 1-padded past
    the payload (``bitio.bit_windows``' convention)."""
    dev = payload.device
    p = torch.arange(n_pos, device=dev)
    k = p >> 3
    pad = torch.full(((n_pos >> 3) + 3,), 0xFF, dtype=torch.int64,
                     device=dev)
    b = torch.cat([payload.to(torch.int64), pad])
    w24 = (b[k] << 16) | (b[k + 1] << 8) | b[k + 2]
    return (w24 >> (8 - (p & 7))) & 0xFFFF


def _unit_words(w16: torch.Tensor, nbits: int, params: torch.Tensor,
                syms: torch.Tensor) -> torch.Tensor:
    """Unit words of one table at every offset, by matching each
    window's top ``L`` bits against the canonical bounds of length L."""
    p = torch.arange(w16.shape[0], device=w16.device)
    length = torch.zeros_like(w16)
    sidx = torch.zeros_like(w16)
    for L in range(1, 17):
        c = w16 >> (16 - L)
        mn, mx, vp = params[L - 1], params[16 + L - 1], params[32 + L - 1]
        ok = (mx >= 0) & (c >= mn) & (c <= mx)
        length = torch.where(ok, L, length)
        sidx = torch.where(ok, vp + c - mn, sidx)
    sym = torch.where(length > 0, syms[sidx], 0)
    size = torch.where(sym > MAX_CATEGORY, sym & 0xF, sym)
    adv = length + size
    ctrl = torch.where(length == 0, -1, sym)
    ctrl = torch.where(p + adv > nbits, -2, ctrl)
    adv = torch.where(ctrl < 0, 0, adv)
    return ((ctrl + 2) << _CTRL_SHIFT) | adv


def _ac_outcomes(ac_words: torch.Tensor) -> torch.Tensor:
    """Outcome word of the AC chain starting at every offset."""
    w = ac_words.shape[0]
    ctrl = (ac_words >> _CTRL_SHIFT) - 2
    adv = ac_words & _ADV_MASK
    idx = torch.arange(w, device=ac_words.device)
    term = ctrl <= 0                       # EOB or error: absorbing
    J = torch.where(term, idx, torch.clamp(idx + adv, max=w - 1))
    S = torch.where(term, 0, (ctrl >> 4) + 1)
    levels = []
    for _ in range(6):
        levels.append((J, S))
        S = S + S[J]
        J = J[J]
    # parked on a terminal (fewer than 63 positions covered)
    t_ctrl = ctrl[J]
    t_out = torch.where(
        t_ctrl == 0, (J + adv[J]) << 2,
        torch.where(t_ctrl == -1, (J << 2) | _INVALID,
                    (J << 2) | _TRUNCATED))
    # crossing position 63: descend to the unit that crosses it
    cur, s = idx, torch.zeros_like(idx)
    for Jk, Sk in reversed(levels):
        ns = s + Sk[cur]
        take = ns < 63
        s = torch.where(take, ns, s)
        cur = torch.where(take, Jk[cur], cur)
    c_ctrl = ctrl[cur]
    c_run = torch.where(c_ctrl > 0, c_ctrl >> 4, 0)
    overrun = (c_ctrl != ZRL) & (s + c_run + 1 >= 64)
    c_out = torch.where(overrun, _OVERRUN, (cur + adv[cur]) << 2)
    return torch.where(S < 63, t_out, c_out)


def unpack_words_ref(payload: torch.Tensor, params: torch.Tensor,
                     syms: torch.Tensor) -> torch.Tensor:
    """Staged words at every bit offset of a payload.

    Args:
        payload: (nbytes,) uint8 entropy payload.
        params: (96,) int32 canonical bounds ``mincode[16] | maxcode[16]
            | valptr[16]`` of the DC table, then of the AC table
            (:func:`repro_torch.kernels.unpack_bits.ops.table_params`).
        syms: (512,) int32 symbol lists of the DC then the AC table, in
            canonical order.

    Returns:
        (3, 8 * nbytes + 1) int32 on the payload's device: DC unit
        words, AC unit words and AC outcome words at offsets
        0..8 * nbytes.
    """
    nbits = payload.shape[0] * 8
    w16 = _windows(payload, nbits + 1)
    prm = params.to(torch.int64)
    sy = syms.to(torch.int64)
    dcw = _unit_words(w16, nbits, prm[:48], sy[:256])
    acw = _unit_words(w16, nbits, prm[48:], sy[256:])
    return torch.stack([dcw, acw, _ac_outcomes(acw)]).to(torch.int32)


def _emit_tile(win: np.ndarray, t0: int, dc_words: np.ndarray,
               ac_words: np.ndarray, dc_starts: list, ac_starts: list,
               block_ids: list, dc_out: np.ndarray,
               ac_out: np.ndarray) -> None:
    """Emit coefficient values for all blocks starting in one tile.

    DC amplitudes are gathered in one shot; AC units are emitted with a
    wavefront — every live block consumes one unit per step, so the
    loop runs at most 64 times however many blocks the tile holds.
    Amplitude bits are re-read from ``win`` at the resolved offsets
    only (the unit words carry no values).
    """
    def amplitude(p, words):
        x = words[p - t0]
        adv = x & _ADV_MASK
        c = (x >> _CTRL_SHIFT) - 2
        size = c & 0xF                     # c >= 0 for resolved units
        safe = np.maximum(size, 1)
        bits = win[p + (adv - size)].astype(np.int64) >> (16 - safe)
        val = np.where(bits < (1 << (safe - 1)), bits - (1 << safe) + 1,
                       bits)
        return c, adv, np.where(size == 0, 0, val)

    bids = np.asarray(block_ids, np.int64)
    _, _, dc_val = amplitude(np.asarray(dc_starts, np.int64), dc_words)
    dc_out[bids] = dc_val.astype(np.int32)

    pos = np.zeros(len(bids), np.int64)
    p = np.asarray(ac_starts, np.int64)
    alive = np.ones(len(bids), bool)
    while alive.any():
        c, adv, val = amplitude(p[alive], ac_words)
        eob = c == 0
        run = c >> 4
        coef = ~eob & (c != ZRL)
        col = pos[alive] + run
        if coef.any():
            ac_out[bids[alive][coef], col[coef]] = val[coef].astype(np.int32)
        new_pos = pos[alive] + np.where(eob, 0, run + 1)
        pos[alive] = new_pos
        p[alive] += adv
        live_idx = np.flatnonzero(alive)
        alive[live_idx[eob | (new_pos >= AC_LEN)]] = False


def resolve(win: np.ndarray, nbits: int, n_blocks: int, tile_bits: int,
            get_tile) -> tuple:
    """Resolve the true chain and emit values from staged tiles.

    ``get_tile(t)`` must return ``(dc_words, ac_words, outcomes)`` for
    bit offsets ``[t * tile_bits, t * tile_bits + w)`` with
    ``w >= min(tile_bits + 2048, nbits + 1 - t * tile_bits)`` — the
    stage is the parallel part; this resolver is the serial O(1)
    -per-block remainder.

    Raises what the reference's ``rle.decode_payload`` raises, at the
    same bit offsets: :class:`repro_torch.core.entropy.bitio.
    TruncatedStream` when a block needs bits past the payload,
    ``ValueError`` on invalid prefixes and AC runs overrunning a block.
    """
    dc_out = np.zeros(n_blocks, np.int32)
    ac_out = np.zeros((n_blocks, AC_LEN), np.int32)
    t = -1
    dcw = acw = outc = None
    dc_starts: list = []
    ac_starts: list = []
    block_ids: list = []
    p = 0
    for b in range(n_blocks):
        nt = p // tile_bits
        if nt != t:
            if block_ids:
                _emit_tile(win, t * tile_bits, dcw, acw, dc_starts,
                           ac_starts, block_ids, dc_out, ac_out)
                dc_starts, ac_starts, block_ids = [], [], []
            dcw, acw, outc = get_tile(nt)
            t = nt
        t0 = t * tile_bits
        x = int(dcw[p - t0])
        c = (x >> _CTRL_SHIFT) - 2
        if c == -2:
            raise bitio.TruncatedStream(
                f"entropy payload truncated: needed bit {p} of {nbits}")
        if c == -1:
            raise ValueError(f"invalid DC Huffman prefix at bit {p}")
        q = p + (x & _ADV_MASK)
        o = int(outc[q - t0])
        kind = o & 3
        v = o >> 2
        if kind == _INVALID:
            raise ValueError(f"invalid AC Huffman prefix at bit {v}")
        if kind == _TRUNCATED:
            raise bitio.TruncatedStream(
                f"entropy payload truncated: needed bit {v} of {nbits}")
        if kind == _OVERRUN:
            raise ValueError(f"corrupted stream: AC run overruns block {b}")
        dc_starts.append(p)
        ac_starts.append(q)
        block_ids.append(b)
        p = v
    if block_ids:
        _emit_tile(win, t * tile_bits, dcw, acw, dc_starts, ac_starts,
                   block_ids, dc_out, ac_out)
    return dc_out, ac_out
