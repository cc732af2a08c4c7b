"""DEFLATE (RFC 1951) wire-format constants used by the segment encoder.

The port's own copy of the encoder's share of
``moonbit_flate_tpu/formats/constants.py``: the same names, derived by
the same RFC 1951 formulas, so the two packages agree table by table
(tests/test_torch_tables.py checks it) without one importing the other.
"""

from __future__ import annotations

import numpy as np

WINDOW_SIZE = 1 << 15          # 32768: LZ77 history window / max match offset
MAX_MATCH_OFFSET = 1 << 15
BASE_MATCH_LENGTH = 3          # smallest match length per RFC 1951
MAX_MATCH_LENGTH = 258         # largest match length per RFC 1951
MIN_MATCH_LENGTH = 4           # the encoder only emits matches >= 4 bytes

MAX_STORE_BLOCK_SIZE = 65535   # stored-block LEN field is 16 bits

MAX_NUM_LIT = 286              # literal/length alphabet size (0..285)
MAX_NUM_DIST = 30              # distance alphabet size (0..29)
NUM_CODES = 19                 # code-length ("codegen") alphabet size
END_BLOCK_MARKER = 256         # end-of-block symbol in the lit/len alphabet

LIT_LEN_MAX_BITS = 15          # lit/len + dist codes limited to 15 bits
CODEGEN_MAX_BITS = 7           # code-length codes limited to 7 bits

# Order in which code-length code lengths appear in a dynamic header.
CODEGEN_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)


def _build_length_tables():
    """Base length and extra bits of lit/len symbols 257..285."""
    base = []
    extra = []
    length = 3
    for i in range(28):
        eb = 0 if i < 8 else (i - 4) >> 2
        base.append(length)
        extra.append(eb)
        length += 1 << eb
    # code 285: length 258 exactly, 0 extra bits
    base.append(258)
    extra.append(0)
    return np.array(base, dtype=np.int32), np.array(extra, dtype=np.int32)


LENGTH_BASE, LENGTH_EXTRA_BITS = _build_length_tables()


def _build_length_code_map():
    """Map (length - 3) in 0..255 to the length-code index 0..28."""
    codes = np.zeros(256, dtype=np.int32)
    for code in range(28):
        lo = LENGTH_BASE[code] - 3
        hi = lo + (1 << LENGTH_EXTRA_BITS[code])
        codes[lo:hi] = code
    codes[255] = 28  # length 258 -> symbol 285
    return codes


LENGTH_CODES = _build_length_code_map()


def _build_offset_tables():
    """Base distance and extra bits of distance codes 0..29."""
    base = []
    extra = []
    dist = 1
    for code in range(30):
        eb = 0 if code < 4 else (code - 2) >> 1
        base.append(dist)
        extra.append(eb)
        dist += 1 << eb
    return np.array(base, dtype=np.int32), np.array(extra, dtype=np.int32)


OFFSET_BASE, OFFSET_EXTRA_BITS = _build_offset_tables()


def _build_offset_code_map():
    """Map (offset - 1) in 0..255 to distance-code indices."""
    codes = np.zeros(256, dtype=np.int32)
    for code in range(30):
        lo = OFFSET_BASE[code] - 1
        if lo >= 256:
            break
        hi = min(256, lo + (1 << OFFSET_EXTRA_BITS[code]))
        codes[lo:hi] = code
    return codes


OFFSET_CODES = _build_offset_code_map()
