"""LSB-first bitstream assembly (the port's own copy of
``moonbit_flate_tpu/bitio/writer.py``).

The reference accumulates bits in a u64 and flushes 6 bytes at a time
(huffman-bit-writer.mbt:170-199).  Byte-identical output only depends on
LSB-first order, so the host implementation here is free to use a
data-parallel formulation: per-symbol (value, nbits) arrays, an exclusive
prefix sum of nbits giving each symbol's bit offset, and a scatter-OR into
a u64 word buffer.  ``pack_bits`` below is exactly that — it is the NumPy
model of the device packer in ``ops/pack.py``.
"""

from __future__ import annotations

import numpy as np


def pack_bits(values: np.ndarray, nbits: np.ndarray, bit_offset: int = 0) -> tuple[np.ndarray, int]:
    """Pack symbols LSB-first into a byte array.

    values[i] contributes its low nbits[i] bits, in order.  ``bit_offset``
    shifts the whole stream (0..7) so a partially-filled byte can be merged
    by the caller.  Returns (bytes, total_bits) where total_bits includes
    the initial offset; the final byte may be partial (zero-padded high
    bits).
    """
    values = np.asarray(values, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    if len(values) == 0:
        return np.zeros(0, dtype=np.uint8), bit_offset
    offsets = bit_offset + np.concatenate(([0], np.cumsum(nbits)[:-1]))
    total_bits = int(bit_offset + nbits.sum())
    # A zero-width unit may sit exactly at offset == total_bits, so size
    # for word index (total_bits >> 6) + 1.
    nwords = (total_bits >> 6) + 2
    words = np.zeros(nwords, dtype=np.uint64)
    word_idx = (offsets >> 6).astype(np.int64)
    shift = (offsets & 63).astype(np.uint64)
    lo = values << shift
    # value >> (64 - shift) is UB when shift == 0; route through a
    # two-step shift that is well-defined for shift in [0, 63].
    hi = (values >> np.uint64(1)) >> (np.uint64(63) - shift)
    np.add.at(words, word_idx, lo)
    np.add.at(words, word_idx + 1, hi)
    out = words.view(np.uint8)[: (total_bits + 7) // 8]
    return out, total_bits


class BitWriter:
    """Streaming LSB-first bit writer over an in-memory byte buffer.

    API parity with HuffmanBitWriter's bit-level surface
    (huffman-bit-writer.mbt:139-225): write_bits, write_bytes (byte-aligned
    raw copy), flush (pad to byte boundary).  Bulk token emission goes
    through ``write_packed`` which uses the vectorized path.
    """

    def __init__(self, sink=None):
        self._chunks: list[bytes] = []
        self.hold = 0          # pending bits, LSB-first
        self.nhold = 0         # number of pending bits (0..7 after flushes)
        self.sink = sink       # optional callable(bytes) for streaming out

    # -- internals ---------------------------------------------------------

    def _emit(self, b: bytes):
        if self.sink is not None:
            self.sink(b)
        else:
            self._chunks.append(b)

    def _drain_whole_bytes(self):
        if self.nhold >= 8:
            n = self.nhold // 8
            out = (self.hold & ((1 << (n * 8)) - 1)).to_bytes(n, "little")
            self.hold >>= n * 8
            self.nhold -= n * 8
            self._emit(out)

    # -- public surface ----------------------------------------------------

    def write_bits(self, value: int, n: int):
        self.hold |= (value & ((1 << n) - 1)) << self.nhold
        self.nhold += n
        if self.nhold >= 48:
            self._drain_whole_bytes()

    def write_packed(self, values: np.ndarray, nbits: np.ndarray):
        """Bulk-append symbols via the vectorized packer."""
        if len(values) == 0:
            return
        self._drain_whole_bytes()
        packed, total_bits = pack_bits(values, nbits, bit_offset=self.nhold)
        if self.nhold:
            packed = packed.copy()
            packed[0] |= self.hold
        rem = total_bits & 7
        if rem:
            self.hold = int(packed[-1])
            self.nhold = rem
            self._emit(packed[:-1].tobytes())
        else:
            self.hold = 0
            self.nhold = 0
            self._emit(packed.tobytes())

    def flush(self):
        """Pad to a byte boundary and drain (huffman-bit-writer.mbt:139)."""
        if self.nhold:
            n = (self.nhold + 7) // 8
            self._emit((self.hold & ((1 << (n * 8)) - 1)).to_bytes(n, "little"))
        self.hold = 0
        self.nhold = 0

    def write_bytes(self, data: bytes):
        """Byte-aligned raw write; requires nhold % 8 == 0."""
        if self.nhold & 7:
            raise ValueError("write_bytes with unfinished bits")
        self.flush()
        self._emit(bytes(data))

    def getvalue(self) -> bytes:
        if self.sink is not None:
            raise ValueError("getvalue on a sink-backed writer")
        return b"".join(self._chunks)

    @property
    def bit_position(self) -> int:
        return sum(len(c) for c in self._chunks) * 8 + self.nhold
