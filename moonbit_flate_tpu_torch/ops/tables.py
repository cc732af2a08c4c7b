"""Closed-form length/distance code maps (RFC 1951 §3.2.5) on tensors.

Port of ``moonbit_flate_tpu/ops/tables.py``: every function is pure
integer arithmetic, so it runs unchanged on the CPU or the card.
"""

from __future__ import annotations

import torch

from ..formats import constants as C


def extra_bits_tables(device):
    """(LENGTH_EXTRA_BITS[29], OFFSET_EXTRA_BITS[30]) as int32 on device."""
    return (torch.as_tensor(C.LENGTH_EXTRA_BITS, device=device),
            torch.as_tensor(C.OFFSET_EXTRA_BITS, device=device))


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for x in [1, 2^24) via the f32 exponent field."""
    return ((x.float().view(torch.int32) >> 23) & 0xFF) - 127


def offset_code(xoffset: torch.Tensor) -> torch.Tensor:
    """Distance code for xoffset = dist - 1: codes 0..3 are the offsets
    themselves; beyond that each code pair covers one power-of-two
    octave split by the next bit."""
    k = _floor_log2(torch.clamp(xoffset, min=1))
    code = 2 * k + ((xoffset >> torch.clamp(k - 1, min=0)) & 1)
    return torch.where(xoffset < 4, xoffset, code)


def length_code(xlen: torch.Tensor) -> torch.Tensor:
    """Length code for xlen = len - 3: codes 0..7 are xlen itself; each
    octave k >= 3 splits into 4 codes of 2^(k-2) lengths; xlen 255
    (len 258) is its own code 28."""
    k = _floor_log2(torch.clamp(xlen, min=1))
    code = 4 * k - 8 + (xlen >> torch.clamp(k - 2, min=0))
    return torch.where(xlen < 8, xlen, torch.where(xlen == 255, 28, code))


def length_base_extra(lc: torch.Tensor):
    """(base_len, extra_bits) for a length code."""
    eb = torch.where(lc < 8, 0, (lc - 4) >> 2)
    base = torch.where(lc < 8, 3 + lc, (1 << (eb + 2)) + 3 + ((lc & 3) << eb))
    base = torch.where(lc >= 28, 258, base)
    eb = torch.where(lc >= 28, 0, eb)
    return base, eb


def offset_base_extra(dc: torch.Tensor):
    """(base_dist, extra_bits) for a distance code."""
    eb = torch.where(dc < 4, 0, (dc - 2) >> 1)
    base = torch.where(dc < 4, dc + 1, (1 << (eb + 1)) + 1 + ((dc & 1) << eb))
    return base, eb
