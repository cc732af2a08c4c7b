"""LZ77 sliding-window dictionary for decompression (the port's own copy
of ``moonbit_flate_tpu/inflate/dict_decoder.py``).

Parity with the reference's DictDecoder (dict-decoder.mbt:29-209): a
fixed-size history buffer with read/write cursors, preset-dictionary
preload (tail-truncated to the window), literal inserts, and backward
copies where length > dist is the legal RLE mechanism — the overlapping
section must be copied in a forward, dependency-respecting order.  The
overlap copy here doubles the copied chunk each pass (NumPy block copies)
instead of byte-at-a-time, which preserves the dependency semantics.
"""

from __future__ import annotations

import numpy as np


class DictDecoder:
    __slots__ = ("hist", "wr_pos", "rd_pos", "full")

    def __init__(self, size: int, dictionary: bytes = b""):
        self.hist = np.zeros(size, dtype=np.uint8)
        d = bytes(dictionary)[-size:]
        n = len(d)
        self.hist[:n] = np.frombuffer(d, dtype=np.uint8)
        self.wr_pos = n
        self.full = False
        if n == size:
            self.wr_pos = 0
            self.full = True
        self.rd_pos = self.wr_pos

    def hist_size(self) -> int:
        return len(self.hist) if self.full else self.wr_pos

    def avail_read(self) -> int:
        return self.wr_pos - self.rd_pos

    def avail_write(self) -> int:
        return len(self.hist) - self.wr_pos

    def write_byte(self, c: int):
        self.hist[self.wr_pos] = c
        self.wr_pos += 1

    def write_bytes(self, data: np.ndarray) -> int:
        """Bulk literal insert of up to avail_write() bytes."""
        n = min(len(data), self.avail_write())
        self.hist[self.wr_pos : self.wr_pos + n] = data[:n]
        self.wr_pos += n
        return n

    def _overlap_copy(self, src_pos: int, dst_pos: int, end_pos: int) -> int:
        """Forward copy where [src_pos, dst_pos) repeats into [dst_pos, end_pos)."""
        hist = self.hist
        while dst_pos < end_pos:
            n = min(dst_pos - src_pos, end_pos - dst_pos)
            hist[dst_pos : dst_pos + n] = hist[src_pos : src_pos + n]
            dst_pos += n
        return dst_pos

    def write_copy(self, dist: int, length: int) -> int:
        """General backward copy; returns bytes actually copied (may be
        short if the window fills)."""
        dst_base = self.wr_pos
        dst_pos = dst_base
        src_pos = dst_pos - dist
        end_pos = min(dst_pos + length, len(self.hist))
        if src_pos < 0:
            # Source wraps around the circular buffer: non-overlapping
            # tail copy first.
            src_pos += len(self.hist)
            n = min(end_pos - dst_pos, len(self.hist) - src_pos)
            self.hist[dst_pos : dst_pos + n] = self.hist[src_pos : src_pos + n]
            dst_pos += n
            src_pos = 0
        dst_pos = self._overlap_copy(src_pos, dst_pos, end_pos)
        self.wr_pos = dst_pos
        return dst_pos - dst_base

    def try_write_copy(self, dist: int, length: int) -> int:
        """Fast path: fails (returns 0) when the copy would wrap or fill."""
        dst_pos = self.wr_pos
        end_pos = dst_pos + length
        if dst_pos < dist or end_pos > len(self.hist):
            return 0
        self.wr_pos = self._overlap_copy(dst_pos - dist, dst_pos, end_pos)
        return self.wr_pos - dst_pos

    def read_flush(self) -> np.ndarray:
        """Emit-ready slice; resets cursors when the window fills."""
        out = self.hist[self.rd_pos : self.wr_pos].copy()
        self.rd_pos = self.wr_pos
        if self.wr_pos == len(self.hist):
            self.wr_pos = 0
            self.rd_pos = 0
            self.full = True
        return out
