"""Bit-reversal primitives (the port's own copy of
``moonbit_flate_tpu/utils/bits.py``).

DEFLATE Huffman codes are written to the wire LSB-first, i.e. bit-reversed
relative to their canonical MSB-first value (reference: bits.mbt:11-46).
The 256-entry reversal table is generated, not hardcoded, and is shared by
the host codec.
"""

from __future__ import annotations

import numpy as np


def _build_rev8_table() -> np.ndarray:
    v = np.arange(256, dtype=np.uint16)
    out = np.zeros(256, dtype=np.uint16)
    for bit in range(8):
        out |= ((v >> bit) & 1) << (7 - bit)
    return out


REV8_TABLE = _build_rev8_table()


def reverse8(x: int) -> int:
    """Reverse the bits of an 8-bit value."""
    return int(REV8_TABLE[x & 0xFF])


def reverse16(x: int) -> int:
    """Reverse the bits of a 16-bit value."""
    return int(REV8_TABLE[x >> 8] | (REV8_TABLE[x & 0xFF] << 8))


def reverse_bits(value: int, width: int) -> int:
    """Reverse the low `width` bits of `value` (width <= 16)."""
    return reverse16(value << (16 - width))


def reverse_bits_array(values: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Vectorised reverse of the low widths[i] bits of values[i]."""
    values = np.asarray(values, dtype=np.uint32)
    widths = np.asarray(widths)
    shifted = (values << (16 - widths)).astype(np.uint16)
    rev = REV8_TABLE[shifted >> 8] | (REV8_TABLE[shifted & 0xFF] << 8)
    return rev.astype(np.uint32)


def wrap32(x):
    """An integer (or an int64 tensor of them) -> the int32 value of its
    low 32 bits."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
