"""DEFLATE (RFC 1951) wire-format constants and derived tables.

The port's own copy of ``moonbit_flate_tpu/formats/constants.py``: the
same names, derived by the same RFC 1951 formulas, so the two packages
agree table by table (tests/test_torch_tables.py and
tests/test_torch_hostcodec.py check it) without one importing the other.
Where each constant comes from in the reference (SURVEY.md §2 "Key
constants"):

- window / match geometry: deflate-fast.mbt:31-46, deflate.mbt:9-25
- hash parameters:         deflate-fast.mbt:12-21,78-81
- token layout:            token.mbt:8-24
- length/offset code maps: token.mbt:30-61,107-123
- extra-bits tables:       huffman-bit-writer.mbt:49-78
- codegen order:           huffman-bit-writer.mbt:83-85
- alphabet sizes:          inflate.mbt:28-34
"""

from __future__ import annotations

import numpy as np

# ----------------------------------------------------------------------------
# Window / block geometry (RFC 1951 + Go deflateFast policy).
# ----------------------------------------------------------------------------

WINDOW_SIZE = 1 << 15          # 32768: LZ77 history window / max match offset
MAX_MATCH_OFFSET = 1 << 15
BASE_MATCH_LENGTH = 3          # smallest match length per RFC 1951
MAX_MATCH_LENGTH = 258         # largest match length per RFC 1951
MIN_MATCH_LENGTH = 4           # the encoder only emits matches >= 4 bytes
BASE_MATCH_OFFSET = 1          # smallest match offset

MAX_STORE_BLOCK_SIZE = 65535   # stored-block LEN field is 16 bits
MAX_INPUT_BLOCK_SIZE = 65536   # encoder windowing granularity (2 * 32K)

# deflateFast hash table: 14-bit direct-mapped table over 4-byte hashes.
TABLE_BITS = 14
TABLE_SIZE = 1 << TABLE_BITS
TABLE_SHIFT = 32 - TABLE_BITS
HASH_MUL = 0x1E35A7BD          # Knuth-style multiplicative hash constant

# Offset-epoch renormalisation point: `cur` grows monotonically across
# blocks; when it approaches this bound, offsets are shifted down.
BUFFER_RESET = (1 << 31) - 1 - 2 * MAX_STORE_BLOCK_SIZE

# Input-drain policy thresholds (close/sync path).
TINY_BLOCK_MAX = 16            # <= 16 bytes: emit a stored block
LITERAL_ONLY_MAX = 128         # < 128 bytes: emit a literal-only huffman block

# ----------------------------------------------------------------------------
# Alphabets.
# ----------------------------------------------------------------------------

MAX_NUM_LIT = 286              # literal/length alphabet size (0..285)
MAX_NUM_DIST = 30              # distance alphabet size (0..29)
NUM_CODES = 19                 # code-length ("codegen") alphabet size
END_BLOCK_MARKER = 256         # end-of-block symbol in the lit/len alphabet

MAX_CODE_LEN = 16              # decoder sanity bound on code lengths
MAX_BITS_LIMIT = 16            # encoder sanity bound for length-limited codes
LIT_LEN_MAX_BITS = 15          # lit/len + dist codes limited to 15 bits
CODEGEN_MAX_BITS = 7           # code-length codes limited to 7 bits

# Order in which code-length code lengths appear in a dynamic header.
CODEGEN_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

# Huffman bit-writer internals.
BIT_ACCUMULATOR_BITS = 64      # u64 LSB-first accumulator
BIT_FLUSH_THRESHOLD = 48       # flush 6 bytes whenever >= 48 bits pending
BUFFER_FLUSH_SIZE = 240        # byte buffer flush threshold
BUFFER_SIZE = 248              # byte buffer capacity

# ----------------------------------------------------------------------------
# Length code tables (RFC 1951 §3.2.5).
#
# Codes 257..285 encode match lengths 3..258.  Derived from the RFC: the
# first 8 codes have 0 extra bits and cover lengths 3..10; thereafter each
# group of 4 codes doubles the extra bit count; code 285 is the special
# length-258 code with 0 extra bits.
# ----------------------------------------------------------------------------


def _build_length_tables():
    base = []          # base length for code 257 + i (as length, not length-3)
    extra = []         # extra bits for code 257 + i
    length = 3
    for i in range(28):
        if i < 8:
            eb = 0
        else:
            eb = (i - 4) >> 2
        base.append(length)
        extra.append(eb)
        length += 1 << eb
    # code 285: length 258 exactly, 0 extra bits
    base.append(258)
    extra.append(0)
    return (
        np.array(base, dtype=np.int32),
        np.array(extra, dtype=np.int32),
    )


LENGTH_BASE, LENGTH_EXTRA_BITS = _build_length_tables()


def _build_length_code_map():
    """Map (length - 3) in 0..255 to the length-code index 0..28.

    Index i means lit/len symbol 257 + i.  Length 258 maps to code 28
    (symbol 285), the dedicated max-length code.
    """
    codes = np.zeros(256, dtype=np.int32)
    for code in range(28):
        lo = LENGTH_BASE[code] - 3
        hi = lo + (1 << LENGTH_EXTRA_BITS[code])
        codes[lo:hi] = code
    codes[255] = 28  # length 258 → symbol 285
    return codes


LENGTH_CODES = _build_length_code_map()

# ----------------------------------------------------------------------------
# Distance code tables (RFC 1951 §3.2.5).
#
# Codes 0..29 encode distances 1..32768.  Codes 0..3 have 0 extra bits;
# thereafter each pair of codes doubles the extra bit count.
# ----------------------------------------------------------------------------


def _build_offset_tables():
    base = []
    extra = []
    dist = 1
    for code in range(30):
        eb = 0 if code < 4 else (code - 2) >> 1
        base.append(dist)
        extra.append(eb)
        dist += 1 << eb
    return (
        np.array(base, dtype=np.int32),
        np.array(extra, dtype=np.int32),
    )


OFFSET_BASE, OFFSET_EXTRA_BITS = _build_offset_tables()


def _build_offset_code_map():
    """Map (offset - 1) >> k ranges to distance-code indices.

    Mirrors the reference's three-range scheme (token.mbt:112-123): a
    256-entry table indexed by (offset-1) for offsets <= 256, reused with
    >>7 (+14) for offsets <= 32768 via mid range, and >>14 (+28) above.
    """
    codes = np.zeros(256, dtype=np.int32)
    for code in range(30):
        lo = OFFSET_BASE[code] - 1
        if lo >= 256:
            break
        hi = min(256, lo + (1 << OFFSET_EXTRA_BITS[code]))
        codes[lo:hi] = code
    return codes


OFFSET_CODES = _build_offset_code_map()


def offset_code(offset_minus_one: int) -> int:
    """Distance code for xoffset = offset - 1 (scalar helper)."""
    if offset_minus_one < 256:
        return int(OFFSET_CODES[offset_minus_one])
    if offset_minus_one < 256 << 7:
        return int(OFFSET_CODES[offset_minus_one >> 7]) + 14
    return int(OFFSET_CODES[offset_minus_one >> 14]) + 28


def offset_code_array(xoffset: np.ndarray) -> np.ndarray:
    """Vectorised distance-code lookup over xoffset = offset - 1."""
    xoffset = np.asarray(xoffset)
    small = xoffset < 256
    mid = xoffset < (256 << 7)
    return np.where(
        small,
        OFFSET_CODES[np.minimum(xoffset, 255)],
        np.where(
            mid,
            OFFSET_CODES[np.minimum(xoffset >> 7, 255)] + 14,
            OFFSET_CODES[np.minimum(xoffset >> 14, 255)] + 28,
        ),
    )


# ----------------------------------------------------------------------------
# Fixed (static) Huffman code lengths (RFC 1951 §3.2.6).
# ----------------------------------------------------------------------------


def fixed_literal_lengths() -> np.ndarray:
    lens = np.empty(288, dtype=np.int32)
    lens[0:144] = 8
    lens[144:256] = 9
    lens[256:280] = 7
    lens[280:288] = 8
    return lens


def fixed_distance_lengths() -> np.ndarray:
    return np.full(32, 5, dtype=np.int32)


# ----------------------------------------------------------------------------
# Token representation: 32-bit packed, mirroring the reference layout
# (token.mbt:8-24) — 2-bit type, 8-bit xlength (= length - 3) at bit 22,
# 22-bit xoffset (= offset - 1).
# ----------------------------------------------------------------------------

TOKEN_LITERAL_TYPE = 0 << 30
TOKEN_MATCH_TYPE = 1 << 30
TOKEN_LENGTH_SHIFT = 22
TOKEN_OFFSET_MASK = (1 << 22) - 1
TOKEN_TYPE_MASK = 3 << 30


def literal_token(lit: int) -> int:
    return TOKEN_LITERAL_TYPE + lit


def match_token(xlength: int, xoffset: int) -> int:
    return TOKEN_MATCH_TYPE + (xlength << TOKEN_LENGTH_SHIFT) + xoffset
