"""Length-limited canonical Huffman code construction (the port's own
copy of ``moonbit_flate_tpu/huffman/encode.py``).

Behavioral parity target: the reference's encoder (huffman-code.mbt:112-343),
which is Katajainen-style *boundary package-merge* over the frequency list
sorted by (freq, symbol) ascending, with the package preferred over the leaf
on weight ties, followed by canonical code assignment in symbol order with
bit-reversed codes (huffman-code.mbt:250-286).

Two implementations are provided:

- ``package_merge_bit_counts``: eager package-merge over NumPy leaf-count
  matrices.  With the same sorted order and the same tie-breaking rule it
  produces the identical ``bit_count`` vector as the reference's lazy
  level-walking algorithm, and it vectorizes cleanly (it is also the shape
  the device encoder builds in ``ops/huffman_torch.py``).
- ``generate``: the full pipeline — histogram → bit counts → canonical,
  bit-reversed code assignment — returning (codes, lengths) arrays.

Special cases mirror the reference (huffman-code.mbt:326-336): with one or
two live symbols every live symbol gets a 1-bit code, assigned in symbol
order.
"""

from __future__ import annotations

import numpy as np

from ..utils.bits import reverse_bits_array

_MAX_FREQ = np.iinfo(np.int64).max // 4  # sentinel guard, never overflows


def package_merge_bit_counts(sorted_freqs: np.ndarray, max_bits: int) -> np.ndarray:
    """Number of symbols per code length for an optimal length-limited code.

    ``sorted_freqs`` must be the non-zero frequencies sorted ascending with
    ties broken by ascending symbol value (the caller's responsibility —
    matches the reference's ``by_frequency`` comparator).  Requires
    ``len(sorted_freqs) >= 3``; callers handle the <= 2 cases.

    Returns ``bit_count`` where ``bit_count[i]`` = number of symbols coded
    in ``i`` bits, for i in 0..max_bits.
    """
    n = len(sorted_freqs)
    max_bits = min(max_bits, n - 1)
    w = sorted_freqs.astype(np.int64)

    # Each list item carries (weight, per-symbol leaf multiplicity vector).
    # level 1 list = the leaves themselves.
    weights = w.copy()
    counts = np.eye(n, dtype=np.int32)

    leaf_counts = np.eye(n, dtype=np.int32)
    for _ in range(1, max_bits):
        # Package adjacent pairs of the previous level's list.
        m = (len(weights) // 2) * 2
        pkg_w = weights[0:m:2] + weights[1:m:2]
        pkg_c = counts[0:m:2] + counts[1:m:2]
        # Merge leaves with packages; packages win weight ties (the
        # reference takes a leaf only when strictly cheaper,
        # huffman-code.mbt:187).
        all_w = np.concatenate([pkg_w, w])
        all_c = np.concatenate([pkg_c, leaf_counts])
        is_leaf = np.concatenate(
            [np.zeros(len(pkg_w), np.int8), np.ones(n, np.int8)]
        )
        # Stable sort by (weight, package-before-leaf).  Leaves and
        # packages are each already internally ordered.
        order = np.lexsort((is_leaf, all_w))
        weights = all_w[order]
        counts = all_c[order]

    # Take the first 2n-2 items of the final list; a symbol's code length
    # is the number of selected items containing it.
    lengths = counts[: 2 * n - 2].sum(axis=0)
    bit_count = np.bincount(lengths, minlength=max_bits + 1)
    return bit_count[: max_bits + 1]


def lengths_from_freqs(freqs: np.ndarray, max_bits: int) -> np.ndarray:
    """Per-symbol code lengths (0 for unused symbols)."""
    freqs = np.asarray(freqs, dtype=np.int64)
    lengths = np.zeros(len(freqs), dtype=np.int32)
    nz = np.nonzero(freqs)[0]
    if len(nz) == 0:
        return lengths
    if len(nz) <= 2:
        lengths[nz] = 1
        return lengths
    # Sort by (freq, symbol) ascending.
    order = nz[np.lexsort((nz, freqs[nz]))]
    sorted_freqs = freqs[order]
    bit_count = package_merge_bit_counts(sorted_freqs, max_bits)
    # Most frequent symbols get the shortest codes: walk bit lengths
    # ascending, peeling chunks off the tail of the sorted list
    # (huffman-code.mbt:257-279).
    pos = len(order)
    for bits in range(len(bit_count)):
        cnt = int(bit_count[bits])
        if cnt == 0:
            continue
        chunk = order[pos - cnt : pos]
        lengths[chunk] = bits
        pos -= cnt
    assert pos == 0
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical DEFLATE codes (bit-reversed, wire-ready) for given lengths.

    Codes are assigned in symbol order within each length per RFC 1951
    §3.2.2, then bit-reversed for LSB-first emission.
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = np.zeros(len(lengths), dtype=np.uint32)
    live = np.nonzero(lengths)[0]
    if len(live) == 0:
        return codes
    max_len = int(lengths[live].max())
    bl_count = np.bincount(lengths[live], minlength=max_len + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_len + 2, dtype=np.int64)
    code = 0
    for ln in range(1, max_len + 1):
        code = (code + int(bl_count[ln - 1])) << 1
        next_code[ln] = code
    # rank of each live symbol within its length group (symbol order)
    order = np.lexsort((live, lengths[live]))
    sorted_syms = live[order]
    sorted_lens = lengths[sorted_syms]
    # position within the sorted-by-(len,sym) array:
    ranks = np.arange(len(sorted_syms)) - np.searchsorted(
        sorted_lens, sorted_lens, side="left"
    )
    raw = next_code[sorted_lens] + ranks
    codes[sorted_syms] = reverse_bits_array(raw, sorted_lens)
    return codes


def generate(freqs: np.ndarray, max_bits: int):
    """freq table → (wire-ready bit-reversed codes, lengths).

    Mirrors HuffmanEncoder::generate (huffman-code.mbt:295-343) including
    the <=2 live-symbol special case, where codes are assigned in symbol
    order with length 1 (code values 0 and 1 — NOT bit-reversed beyond the
    trivial 1-bit identity).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    lengths = np.zeros(len(freqs), dtype=np.int32)
    codes = np.zeros(len(freqs), dtype=np.uint32)
    nz = np.nonzero(freqs)[0]
    if len(nz) == 0:
        return codes, lengths
    if len(nz) <= 2:
        lengths[nz] = 1
        codes[nz] = np.arange(len(nz), dtype=np.uint32)
        return codes, lengths
    lengths = lengths_from_freqs(freqs, max_bits)
    codes = canonical_codes(lengths)
    return codes, lengths


def bit_length(lengths: np.ndarray, freqs: np.ndarray) -> int:
    """Total encoded size in bits of `freqs` under code `lengths`."""
    return int((np.asarray(lengths, np.int64) * np.asarray(freqs, np.int64)).sum())


# Preset 1-bit distance encoder used by literal-only blocks
# (huffman-code.mbt:691-726): distance symbol 0 has a 1-bit code.
def huff_offset_codes(num_offsets: int = 30):
    codes = np.zeros(num_offsets, dtype=np.uint32)
    lengths = np.zeros(num_offsets, dtype=np.int32)
    lengths[0] = 1
    return codes, lengths
