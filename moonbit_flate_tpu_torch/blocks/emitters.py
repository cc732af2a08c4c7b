"""DEFLATE block emitters: stored, literal-only dynamic, and full dynamic
(the port's own copy of ``moonbit_flate_tpu/blocks/emitters.py``).

Behavioral parity with the reference bit writer (huffman-bit-writer.mbt):

- stored header / empty final block    :474-487, deflate.mbt:171
- codegen RLE (RFC 1951 §3.2.7)        :241-330
- dynamic size accounting              :335-360
- stored fallback rule ``ssize < (size+size)>>4`` — reproduced as-is,
  including the reference's deviation from Go (SURVEY.md §2.9.2) :526-531
- dynamic header                       :421-471
- token emission                       :596-731 (vectorized here)
- literal-only blocks                  :738-824

Token layout is the reference's packed u32 (token.mbt:8-24).  All emission
goes through the vectorized ``BitWriter.write_packed`` path.
"""

from __future__ import annotations

import numpy as np

from ..bitio.writer import BitWriter
from ..formats import constants as C
from ..huffman import encode as henc

BAD_CODE = 0xFF


# ---------------------------------------------------------------------------
# Size accounting
# ---------------------------------------------------------------------------


def stored_size(n: int) -> tuple[int, bool]:
    """(bits including 5-byte header, fits-in-one-block)."""
    if n == 0:
        return 0, False
    if n <= C.MAX_STORE_BLOCK_SIZE:
        return (n + 5) * 8, True
    return 0, False


# ---------------------------------------------------------------------------
# Codegen (RFC 1951 §3.2.7 run-length encoding of the code-length arrays)
# ---------------------------------------------------------------------------


def generate_codegen(lit_lengths: np.ndarray, off_lengths: np.ndarray,
                     num_literals: int, num_offsets: int):
    """RLE the concatenated code-length arrays.

    Returns (symbols, extras, freq) where symbols[i] in 0..18 is the
    codegen alphabet symbol, extras[i] is the repeat-count payload (or -1
    when the symbol has no payload), and freq is the 19-entry histogram.
    """
    seq = np.concatenate(
        [lit_lengths[:num_literals], off_lengths[:num_offsets]]
    ).astype(np.int64)
    syms: list[int] = []
    extras: list[int] = []
    freq = np.zeros(C.NUM_CODES, dtype=np.int64)

    def put(sym: int, extra: int = -1):
        syms.append(sym)
        extras.append(extra)
        freq[sym] += 1

    i = 0
    n = len(seq)
    while i < n:
        size = int(seq[i])
        j = i + 1
        while j < n and int(seq[j]) == size:
            j += 1
        count = j - i
        if size != 0:
            # literal first, then runs of 16 (copy-previous ×3..6)
            put(size)
            count -= 1
            while count >= 3:
                rep = min(6, count)
                put(16, rep - 3)
                count -= rep
        else:
            while count >= 11:
                rep = min(138, count)
                put(18, rep - 11)
                count -= rep
            if count >= 3:
                put(17, count - 3)
                count = 0
        # trailing stragglers emitted verbatim
        for _ in range(count):
            put(size)
        i = j
    return np.array(syms, np.int64), np.array(extras, np.int64), freq


def dynamic_size(codegen_freq: np.ndarray, codegen_lengths: np.ndarray,
                 lit_lengths: np.ndarray, lit_freq: np.ndarray,
                 off_lengths: np.ndarray, off_freq: np.ndarray,
                 extra_bits: int) -> tuple[int, int]:
    """(total size in bits, num_codegens) — huffman-bit-writer.mbt:335-360."""
    num_codegens = C.NUM_CODES
    while num_codegens > 4 and codegen_freq[C.CODEGEN_ORDER[num_codegens - 1]] == 0:
        num_codegens -= 1
    header = (
        3 + 5 + 5 + 4 + 3 * num_codegens
        + henc.bit_length(codegen_lengths, codegen_freq)
        + int(codegen_freq[16]) * 2
        + int(codegen_freq[17]) * 3
        + int(codegen_freq[18]) * 7
    )
    size = (
        header
        + henc.bit_length(lit_lengths, lit_freq)
        + henc.bit_length(off_lengths, off_freq)
        + extra_bits
    )
    return size, num_codegens


# ---------------------------------------------------------------------------
# Token indexing (histograms) — huffman-bit-writer.mbt:550-593
# ---------------------------------------------------------------------------


def split_tokens(tokens: np.ndarray):
    """Decompose packed tokens into (is_match, literal/sym, xlength, xoffset)."""
    tokens = np.asarray(tokens, dtype=np.uint32)
    is_match = (tokens & np.uint32(C.TOKEN_TYPE_MASK)) == np.uint32(C.TOKEN_MATCH_TYPE)
    lit = (tokens & np.uint32((1 << 30) - 1)).astype(np.int64)
    xlength = ((tokens >> np.uint32(C.TOKEN_LENGTH_SHIFT)) & np.uint32(0xFF)).astype(np.int64)
    xoffset = (tokens & np.uint32(C.TOKEN_OFFSET_MASK)).astype(np.int64)
    return is_match, lit, xlength, xoffset


def index_tokens(tokens: np.ndarray):
    """Histogram tokens → (lit_freq[286], off_freq[30], num_literals, num_offsets)."""
    is_match, lit, xlength, xoffset = split_tokens(tokens)
    lit_syms = np.where(is_match, 257 + C.LENGTH_CODES[xlength], lit)
    lit_freq = np.bincount(lit_syms, minlength=C.MAX_NUM_LIT).astype(np.int64)

    off_codes = C.offset_code_array(xoffset[is_match])
    off_freq = np.bincount(off_codes, minlength=C.MAX_NUM_DIST).astype(np.int64)
    off_freq = off_freq[: C.MAX_NUM_DIST]

    num_literals = C.MAX_NUM_LIT
    while lit_freq[num_literals - 1] == 0:
        num_literals -= 1
    num_offsets = C.MAX_NUM_DIST
    while num_offsets > 0 and off_freq[num_offsets - 1] == 0:
        num_offsets -= 1
    if num_offsets == 0:
        # Keep the offset tree encodable even with zero matches
        # (huffman-bit-writer.mbt:584-589).
        off_freq[0] = 1
        num_offsets = 1
    return lit_freq, off_freq, num_literals, num_offsets


# ---------------------------------------------------------------------------
# Wire emission
# ---------------------------------------------------------------------------


def write_stored_header(bw: BitWriter, length: int, is_eof: bool):
    bw.write_bits(1 if is_eof else 0, 3)  # BFINAL + BTYPE=00
    bw.flush()
    bw.write_bits(length, 16)
    bw.write_bits(~length & 0xFFFF, 16)


def write_stored_block(bw: BitWriter, data: bytes, is_eof: bool = False):
    write_stored_header(bw, len(data), is_eof)
    bw.write_bytes(data)


def write_final_empty_block(bw: BitWriter):
    """Close-time empty stored block carrying BFINAL (deflate.mbt:171-176)."""
    write_stored_header(bw, 0, True)
    bw.flush()


def _write_dynamic_header(bw: BitWriter, num_literals, num_offsets, num_codegens,
                          cg_syms, cg_extras, cg_codes, cg_lengths, is_eof):
    bw.write_bits(5 if is_eof else 4, 3)  # BFINAL + BTYPE=10
    bw.write_bits(num_literals - 257, 5)
    bw.write_bits(num_offsets - 1, 5)
    bw.write_bits(num_codegens - 4, 4)
    for i in range(num_codegens):
        bw.write_bits(int(cg_lengths[C.CODEGEN_ORDER[i]]), 3)
    # codegen symbol stream: huffman code, then the repeat payload
    extra_widths = np.zeros(19, np.int64)
    extra_widths[16], extra_widths[17], extra_widths[18] = 2, 3, 7
    vals = np.empty(2 * len(cg_syms), np.uint64)
    wids = np.empty(2 * len(cg_syms), np.int64)
    vals[0::2] = cg_codes[cg_syms]
    wids[0::2] = cg_lengths[cg_syms]
    has_extra = cg_extras >= 0
    vals[1::2] = np.where(has_extra, cg_extras, 0).astype(np.uint64)
    wids[1::2] = np.where(has_extra, extra_widths[cg_syms], 0)
    bw.write_packed(vals, wids)


def tokens_to_units(tokens: np.ndarray, le_codes, le_lengths, oe_codes, oe_lengths):
    """Vectorize token emission into (values, widths) unit arrays.

    Each token expands to 4 units: lit/len code, length extra bits,
    distance code, distance extra bits (unused units have width 0).
    """
    is_match, lit, xlength, xoffset = split_tokens(tokens)
    lc = C.LENGTH_CODES[xlength]
    lit_syms = np.where(is_match, 257 + lc, lit)
    dc = C.offset_code_array(xoffset)

    n = len(tokens)
    vals = np.zeros((n, 4), np.uint64)
    wids = np.zeros((n, 4), np.int64)
    vals[:, 0] = le_codes[lit_syms]
    wids[:, 0] = le_lengths[lit_syms]

    len_eb = np.where(is_match, C.LENGTH_EXTRA_BITS[lc], 0)
    # extra value = xlength - (length_base - 3)
    len_ev = xlength - (C.LENGTH_BASE[lc] - 3)
    vals[:, 1] = np.where(len_eb > 0, len_ev, 0).astype(np.uint64)
    wids[:, 1] = len_eb

    vals[:, 2] = np.where(is_match, oe_codes[dc], 0).astype(np.uint64)
    wids[:, 2] = np.where(is_match, oe_lengths[dc], 0)

    off_eb = np.where(is_match, C.OFFSET_EXTRA_BITS[dc], 0)
    off_ev = xoffset - (C.OFFSET_BASE[dc] - 1)
    vals[:, 3] = np.where(off_eb > 0, off_ev, 0).astype(np.uint64)
    wids[:, 3] = off_eb
    return vals.reshape(-1), wids.reshape(-1)


def write_block_dynamic(bw: BitWriter, tokens: np.ndarray, is_eof: bool,
                        input_bytes: bytes):
    """Full dynamic-Huffman block (huffman-bit-writer.mbt:496-542).

    ``tokens`` must NOT include the end-of-block marker; it is appended
    here, mirroring the reference.
    """
    tokens = np.concatenate(
        [np.asarray(tokens, np.uint32), np.array([C.END_BLOCK_MARKER], np.uint32)]
    )
    lit_freq, off_freq, num_literals, num_offsets = index_tokens(tokens)
    le_codes, le_lengths = henc.generate(lit_freq, C.LIT_LEN_MAX_BITS)
    oe_codes, oe_lengths = henc.generate(off_freq, C.LIT_LEN_MAX_BITS)

    cg_syms, cg_extras, cg_freq = generate_codegen(
        le_lengths, oe_lengths, num_literals, num_offsets
    )
    cg_codes, cg_lengths = henc.generate(cg_freq, C.CODEGEN_MAX_BITS)
    size, num_codegens = dynamic_size(
        cg_freq, cg_lengths, le_lengths, lit_freq, oe_lengths, off_freq, 0
    )

    ssize, storable = stored_size(len(input_bytes))
    if storable and ssize < (size + size) >> 4:
        write_stored_block(bw, input_bytes, is_eof)
        return

    _write_dynamic_header(bw, num_literals, num_offsets, num_codegens,
                          cg_syms, cg_extras, cg_codes, cg_lengths, is_eof)
    vals, wids = tokens_to_units(tokens, le_codes, le_lengths, oe_codes, oe_lengths)
    bw.write_packed(vals, wids)


def write_block_huff(bw: BitWriter, is_eof: bool, input_bytes: bytes):
    """Literal-only dynamic block (huffman-bit-writer.mbt:738-824)."""
    data = np.frombuffer(input_bytes, dtype=np.uint8)
    lit_freq = np.bincount(data, minlength=C.MAX_NUM_LIT).astype(np.int64)
    lit_freq[C.END_BLOCK_MARKER] = 1
    num_literals = C.END_BLOCK_MARKER + 1
    num_offsets = 1
    le_codes, le_lengths = henc.generate(lit_freq, C.LIT_LEN_MAX_BITS)
    ho_codes, ho_lengths = henc.huff_offset_codes()
    off_freq = np.zeros(C.MAX_NUM_DIST, np.int64)
    off_freq[0] = 1

    cg_syms, cg_extras, cg_freq = generate_codegen(
        le_lengths, ho_lengths, num_literals, num_offsets
    )
    cg_codes, cg_lengths = henc.generate(cg_freq, C.CODEGEN_MAX_BITS)
    size, num_codegens = dynamic_size(
        cg_freq, cg_lengths, le_lengths, lit_freq, ho_lengths, off_freq, 0
    )

    ssize, storable = stored_size(len(input_bytes))
    if storable and ssize < (size + size) >> 4:
        write_stored_block(bw, input_bytes, is_eof)
        return

    _write_dynamic_header(bw, num_literals, num_offsets, num_codegens,
                          cg_syms, cg_extras, cg_codes, cg_lengths, is_eof)
    vals = le_codes[data].astype(np.uint64)
    wids = le_lengths[data].astype(np.int64)
    bw.write_packed(vals, wids)
    bw.write_bits(int(le_codes[C.END_BLOCK_MARKER]), int(le_lengths[C.END_BLOCK_MARKER]))
