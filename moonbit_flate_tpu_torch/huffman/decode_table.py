"""zlib-style two-level Huffman decode tables (the port's own copy of
``moonbit_flate_tpu/huffman/decode_table.py``).

Parity with the reference decoder tables (inflate.mbt:69-223): a 512-entry
primary chunk table indexed by 9 reversed bits (chunk & 15 = code length,
chunk >> 4 = symbol or link index), overflow link tables for codes longer
than 9 bits, the canonical completeness check (rejecting over- and
under-subscribed codes but allowing the degenerate single-code tree), and
the ``min`` first-read optimization.
"""

from __future__ import annotations

import numpy as np

from ..formats import constants as C
from ..utils.bits import reverse_bits

CHUNK_BITS = 9
NUM_CHUNKS = 1 << CHUNK_BITS
COUNT_MASK = 15
VALUE_SHIFT = 4


class HuffmanDecoder:
    __slots__ = ("min", "chunks", "links", "link_mask")

    def __init__(self):
        self.min = 0
        self.chunks = np.zeros(NUM_CHUNKS, dtype=np.uint32)
        self.links: list[np.ndarray] = []
        self.link_mask = 0

    def initialize(self, lengths) -> bool:
        """Build tables from code lengths; False iff the code is invalid."""
        if self.min != 0:
            self.min = 0
            self.chunks = np.zeros(NUM_CHUNKS, dtype=np.uint32)
            self.links = []
            self.link_mask = 0

        lengths = np.asarray(lengths, dtype=np.int64)
        live = lengths > 0
        if not live.any():
            return True  # empty tree: only fails if actually used
        count = np.bincount(lengths[live], minlength=C.MAX_CODE_LEN)
        mn = int(lengths[live].min())
        mx = int(lengths[live].max())

        nextcode = np.zeros(C.MAX_CODE_LEN, dtype=np.int64)
        code = 0
        for i in range(mn, mx + 1):
            code <<= 1
            nextcode[i] = code
            code += int(count[i])
        if code != (1 << mx) and not (code == 1 and mx == 1):
            return False

        self.min = mn
        if mx > CHUNK_BITS:
            num_links = 1 << (mx - CHUNK_BITS)
            self.link_mask = num_links - 1
            link = int(nextcode[CHUNK_BITS + 1]) >> 1
            nlinks = NUM_CHUNKS - link
            self.links = [np.zeros(num_links, dtype=np.uint32) for _ in range(nlinks)]
            for j in range(link, NUM_CHUNKS):
                rev = reverse_bits(j, 16) >> (16 - CHUNK_BITS)
                off = j - link
                self.chunks[rev] = (off << VALUE_SHIFT) | (CHUNK_BITS + 1)

        chunks = self.chunks
        for sym in np.nonzero(live)[0]:
            n = int(lengths[sym])
            code = int(nextcode[n])
            nextcode[n] += 1
            chunk = (int(sym) << VALUE_SHIFT) | n
            rev = reverse_bits(code, 16) >> (16 - n)
            if n <= CHUNK_BITS:
                chunks[rev :: 1 << n] = chunk
            else:
                j = rev & (NUM_CHUNKS - 1)
                linktab = self.links[int(chunks[j]) >> VALUE_SHIFT]
                linktab[rev >> CHUNK_BITS :: 1 << (n - CHUNK_BITS)] = chunk
        return True


def _build_fixed_decoder() -> HuffmanDecoder:
    """Fixed lit/len decoder (RFC 1951 §3.2.6), built not hardcoded.

    Matches the reference's precomputed table (inflate.mbt:886-939)
    including min=7.
    """
    from ..formats.constants import fixed_literal_lengths

    h = HuffmanDecoder()
    ok = h.initialize(fixed_literal_lengths())
    assert ok
    return h


FIXED_LITERAL_DECODER = _build_fixed_decoder()
