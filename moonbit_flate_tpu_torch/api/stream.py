"""Streaming compression API: Writer / Compressor (the port's own copy of
``moonbit_flate_tpu/api/stream.py``).

Behavioral parity with the reference's L3/L4 encode stack:

- Windowing and block-emission policy: deflate.mbt:236-294 — accumulate up
  to 65535 bytes; on a full window or sync/close, apply the small-input
  heuristics (0 → nothing, <=16 → stored, <128 → literal-only huffman)
  then deflateFast + the 1/16 ratio check choosing literal-only vs
  dynamic blocks.
- Close semantics: deflate.mbt:157-183 — drain, then emit an empty final
  stored block (BFINAL=1) and flush to byte alignment.
- Sticky errors: writes after close raise WriterClosedError.
- Dictionary semantics: Writer.with_dict uses the reference's *prepend*
  semantics (writer.mbt:25-31 + deflate.mbt:108-151): the last 32 KB of
  the dictionary are loaded into the input window, so the compressed
  stream includes the compressed dictionary bytes.  The device encoders
  (``api/cuda.py``, ``parallel/sharded.py``) use the reader-style preset
  dictionary instead (SURVEY.md §2.9.3-4).
"""

from __future__ import annotations

import numpy as np

from ..bitio.writer import BitWriter
from ..blocks import emitters
from ..formats import constants as C
from ..lz77.reference_fast import DeflateFast
from ..utils.errors import WriterClosedError


class Compressor:
    """Exact-policy BestSpeed compressor over an in-memory/byte-sink stream."""

    def __init__(self, sink=None):
        self.bw = BitWriter(sink)
        self.best_speed = DeflateFast()
        self.window = np.zeros(C.MAX_STORE_BLOCK_SIZE, dtype=np.uint8)
        self.window_end = 0
        self.sync = False
        self.closed = False

    # -- policy ------------------------------------------------------------

    def _enc_speed(self):
        n = self.window_end
        if n < C.MAX_STORE_BLOCK_SIZE:
            if not self.sync:
                return
            if n < C.LITERAL_ONLY_MAX:
                if n == 0:
                    return
                data = self.window[:n].tobytes()
                if n <= C.TINY_BLOCK_MAX:
                    emitters.write_stored_block(self.bw, data)
                else:
                    emitters.write_block_huff(self.bw, False, data)
                self.window_end = 0
                self.best_speed.reset()
                return
        data = self.window[:n].tobytes()
        tokens = self.best_speed.encode(data)
        # If we removed less than 1/16th, emit a literal-only block.
        if len(tokens) > n - (n >> 4):
            emitters.write_block_huff(self.bw, False, data)
        else:
            emitters.write_block_dynamic(self.bw, tokens, False, data)
        self.window_end = 0

    # -- public ------------------------------------------------------------

    def write(self, data: bytes) -> int:
        if self.closed:
            raise WriterClosedError()
        data = memoryview(bytes(data))
        total = len(data)
        while len(data) > 0:
            self._enc_speed()
            room = C.MAX_STORE_BLOCK_SIZE - self.window_end
            n = min(room, len(data))
            self.window[self.window_end : self.window_end + n] = np.frombuffer(
                data[:n], dtype=np.uint8
            )
            self.window_end += n
            data = data[n:]
        return total

    def fill_window(self, dictionary: bytes):
        """Preload the input window (prepend-semantics dictionary)."""
        if self.window_end != 0:
            raise ValueError("fill_window called with stale data")
        d = bytes(dictionary)[-C.WINDOW_SIZE:]
        self.window[: len(d)] = np.frombuffer(d, dtype=np.uint8)
        self.window_end = len(d)

    def close(self):
        if self.closed:
            return
        self.sync = True
        self._enc_speed()
        emitters.write_final_empty_block(self.bw)
        self.closed = True

    def reset(self, sink=None):
        self.bw = BitWriter(sink)
        self.best_speed.reset()
        self.window_end = 0
        self.sync = False
        self.closed = False


class Writer:
    """Public compressor handle (writer.mbt:10-58 parity)."""

    def __init__(self, sink=None, dictionary: bytes | None = None):
        self._c = Compressor(sink)
        if dictionary:
            self._c.fill_window(dictionary)

    @classmethod
    def with_dict(cls, sink, dictionary: bytes) -> "Writer":
        return cls(sink, dictionary)

    def write(self, data: bytes) -> int:
        return self._c.write(data)

    def close(self):
        self._c.close()

    def getvalue(self) -> bytes:
        return self._c.bw.getvalue()

    def reset(self, sink=None):
        self._c.reset(sink)


def compress(data: bytes, dictionary: bytes | None = None) -> bytes:
    """One-shot raw-DEFLATE compression at BestSpeed (exact host policy)."""
    w = Writer(dictionary=dictionary)
    w.write(data)
    w.close()
    return w.getvalue()
