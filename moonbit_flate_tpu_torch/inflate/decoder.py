"""Streaming DEFLATE decompressor (host oracle; the port's own copy of
``moonbit_flate_tpu/inflate/decoder.py``).

Behavioral parity with the reference's resumable state-machine reader
(inflate.mbt:257-883):

- step-function state machine parked at literal/copy/data-copy granularity
  whenever the 32 KB window fills, bounding memory to one window;
- block-type dispatch (stored / fixed / dynamic, :345-379);
- dynamic-table parsing with the exact error offsets (:429-548) and the
  EOB-min optimization (:542-544) so no byte past the stream end is read;
- closed-form length/distance decode (:592-674);
- corrupt-input error offsets carried in CorruptInputError;
- the reference's more_bits quirk: a clean EOF (not UnexpectedEOF) is
  surfaced when the stream ends at a bit-fill boundary (more_bits returns
  the raw error, :789-799 — unlike Go which wraps with no_eof);
- reset/make_reader reuse hooks (:857-883).

This is the correctness oracle and the corrupt-input reference; the
device decode paths live in ``cuda_inflate.py`` and ``ops/lanes_resolve.py``.
"""

from __future__ import annotations

import numpy as np

from ..formats import constants as C
from ..huffman.decode_table import (
    CHUNK_BITS,
    COUNT_MASK,
    FIXED_LITERAL_DECODER,
    NUM_CHUNKS,
    VALUE_SHIFT,
    HuffmanDecoder,
)
from ..utils.bits import reverse8
from ..utils.errors import (
    CorruptInputError,
    EOFError_,
    InternalError,
    UnexpectedEOFError,
)
from .dict_decoder import DictDecoder

_STATE_INIT = 0
_STATE_DICT = 1


class _ByteSource:
    """Byte-granular reader over bytes/bytearray/file-like objects."""

    def __init__(self, src):
        if isinstance(src, (bytes, bytearray, memoryview, np.ndarray)):
            self._buf = memoryview(bytes(src))
            self._pos = 0
            self._stream = None
        else:
            self._buf = None
            self._stream = src

    def read_byte(self):
        if self._buf is not None:
            if self._pos >= len(self._buf):
                return None
            b = self._buf[self._pos]
            self._pos += 1
            return b
        b = self._stream.read(1)
        return b[0] if b else None

    def read_at_most(self, n: int) -> bytes:
        if self._buf is not None:
            out = bytes(self._buf[self._pos : self._pos + n])
            self._pos += len(out)
            return out
        return self._stream.read(n) or b""


class Decompressor:
    """Resumable streaming reader; ``read`` pulls decompressed bytes."""

    def __init__(self, src, dictionary: bytes = b""):
        self._init_state(src, dictionary)

    def _init_state(self, src, dictionary):
        self.src = _ByteSource(src)
        self.roffset = 0
        self.b = 0
        self.nb = 0
        self.h1 = HuffmanDecoder()
        self.h2 = HuffmanDecoder()
        self.bits = np.zeros(C.MAX_NUM_LIT + C.MAX_NUM_DIST, dtype=np.int64)
        self.codebits = np.zeros(C.NUM_CODES, dtype=np.int64)
        self.dict = DictDecoder(C.MAX_MATCH_OFFSET, dictionary)
        self.step = self._next_block
        self.step_state = _STATE_INIT
        self.final = False
        self.err = None
        self.to_read = b""
        self.hl = None
        self.hd = None
        self.copy_len = 0
        self.copy_dist = 0
        # observability (SURVEY §5.5): blocks seen per type
        self.block_type_counts = {"stored": 0, "fixed": 0, "dynamic": 0}

    # -- reuse hooks (inflate.mbt:857-883) ---------------------------------

    def make_reader(self, src):
        self.src = _ByteSource(src)

    def reset(self, src, dictionary: bytes = b""):
        self._init_state(src, dictionary)

    # -- bit input ---------------------------------------------------------

    def _more_bits(self):
        c = self.src.read_byte()
        if c is None:
            return EOFError_()
        self.roffset += 1
        self.b |= c << self.nb
        self.nb += 8
        return None

    def _huff_sym(self, h: HuffmanDecoder):
        """Decode one symbol; returns int or None with self.err set."""
        n = h.min
        nb, b = self.nb, self.b
        chunks = h.chunks
        while True:
            while nb < n:
                c = self.src.read_byte()
                if c is None:
                    self.b, self.nb = b, nb
                    self.err = UnexpectedEOFError()
                    return None
                self.roffset += 1
                b |= c << nb
                nb += 8
            chunk = int(chunks[b & (NUM_CHUNKS - 1)])
            n = chunk & COUNT_MASK
            if n > CHUNK_BITS:
                chunk = int(
                    h.links[chunk >> VALUE_SHIFT][(b >> CHUNK_BITS) & h.link_mask]
                )
                n = chunk & COUNT_MASK
            if n <= nb:
                if n == 0:
                    self.b, self.nb = b, nb
                    self.err = CorruptInputError(self.roffset)
                    return None
                self.b = b >> n
                self.nb = nb - n
                return chunk >> VALUE_SHIFT

    # -- block dispatch ----------------------------------------------------

    def _next_block(self):
        while self.nb < 3:
            self.err = self._more_bits()
            if self.err is not None:
                return
        self.final = bool(self.b & 1)
        typ = (self.b >> 1) & 3
        self.b >>= 3
        self.nb -= 3
        if typ == 0:
            self.block_type_counts["stored"] += 1
            self._data_block()
        elif typ == 1:
            self.block_type_counts["fixed"] += 1
            self.hl = FIXED_LITERAL_DECODER
            self.hd = None
            self._huffman_block()
        elif typ == 2:
            self.block_type_counts["dynamic"] += 1
            self.err = self._read_huffman()
            if self.err is None:
                self.hl = self.h1
                self.hd = self.h2
                self._huffman_block()
        else:
            self.err = CorruptInputError(self.roffset)

    def _read_huffman(self):
        while self.nb < 14:
            err = self._more_bits()
            if err is not None:
                return err
        nlit = (self.b & 0x1F) + 257
        if nlit > C.MAX_NUM_LIT:
            return CorruptInputError(self.roffset)
        self.b >>= 5
        ndist = (self.b & 0x1F) + 1
        if ndist > C.MAX_NUM_DIST:
            return CorruptInputError(self.roffset)
        self.b >>= 5
        nclen = (self.b & 0xF) + 4
        self.b >>= 4
        self.nb -= 14

        for i in range(nclen):
            while self.nb < 3:
                err = self._more_bits()
                if err is not None:
                    return err
            self.codebits[C.CODEGEN_ORDER[i]] = self.b & 0x7
            self.b >>= 3
            self.nb -= 3
        self.codebits[C.CODEGEN_ORDER[nclen:]] = 0
        if not self.h1.initialize(self.codebits):
            return CorruptInputError(self.roffset)

        i, n = 0, nlit + ndist
        while i < n:
            x = self._huff_sym(self.h1)
            if x is None:
                return self.err
            if x < 16:
                self.bits[i] = x
                i += 1
                continue
            if x == 16:
                rep, nb2 = 3, 2
                if i == 0:
                    return CorruptInputError(self.roffset)
                b2 = int(self.bits[i - 1])
            elif x == 17:
                rep, nb2, b2 = 3, 3, 0
            elif x == 18:
                rep, nb2, b2 = 11, 7, 0
            else:
                return InternalError("unexpected length code")
            while self.nb < nb2:
                err = self._more_bits()
                if err is not None:
                    return err
            rep += self.b & ((1 << nb2) - 1)
            self.b >>= nb2
            self.nb -= nb2
            if i + rep > n:
                return CorruptInputError(self.roffset)
            self.bits[i : i + rep] = b2
            i += rep

        if not self.h1.initialize(self.bits[:nlit]) or not self.h2.initialize(
            self.bits[nlit : nlit + ndist]
        ):
            return CorruptInputError(self.roffset)

        # Never read past the stream end: the block must end with EOB, so
        # at least that many bits remain (inflate.mbt:542-544).
        if self.h1.min < self.bits[C.END_BLOCK_MARKER]:
            self.h1.min = int(self.bits[C.END_BLOCK_MARKER])
        return None

    def _huffman_block(self):
        if self.step_state == _STATE_INIT:
            self._read_literal()
        else:
            self._copy_history()

    # -- symbol loop -------------------------------------------------------

    def _read_literal(self):
        while True:
            v = self._huff_sym(self.hl)
            if v is None:
                return
            if v < 256:
                self.dict.write_byte(v)
                if self.dict.avail_write() == 0:
                    self.to_read = self.dict.read_flush().tobytes()
                    self.step = self._huffman_block
                    self.step_state = _STATE_INIT
                    return
                continue
            if v == 256:
                self._finish_block()
                return
            if v >= C.MAX_NUM_LIT:
                self.err = CorruptInputError(self.roffset)
                return
            lc = v - 257
            length = int(C.LENGTH_BASE[lc])
            n = int(C.LENGTH_EXTRA_BITS[lc])
            if n > 0:
                while self.nb < n:
                    self.err = self._more_bits()
                    if self.err is not None:
                        return
                length += self.b & ((1 << n) - 1)
                self.b >>= n
                self.nb -= n

            if self.hd is None:
                # Fixed blocks: distances are raw 5-bit reversed codes.
                while self.nb < 5:
                    self.err = self._more_bits()
                    if self.err is not None:
                        return
                dist = reverse8((self.b & 0x1F) << 3)
                self.b >>= 5
                self.nb -= 5
            else:
                dist = self._huff_sym(self.hd)
                if dist is None:
                    return

            if dist < 4:
                dist += 1
            elif dist < C.MAX_NUM_DIST:
                nb2 = (dist - 2) >> 1
                extra = (dist & 1) << nb2
                while self.nb < nb2:
                    self.err = self._more_bits()
                    if self.err is not None:
                        return
                extra |= self.b & ((1 << nb2) - 1)
                self.b >>= nb2
                self.nb -= nb2
                dist = (1 << (nb2 + 1)) + 1 + extra
            else:
                self.err = CorruptInputError(self.roffset)
                return

            # No check on length; the encoding can be prescient.
            if dist > self.dict.hist_size():
                self.err = CorruptInputError(self.roffset)
                return
            self.copy_len = length
            self.copy_dist = dist
            if not self._copy_history_inner():
                return

    def _copy_history_inner(self) -> bool:
        """Returns True to continue the literal loop, False when parked."""
        cnt = self.dict.try_write_copy(self.copy_dist, self.copy_len)
        if cnt == 0:
            cnt = self.dict.write_copy(self.copy_dist, self.copy_len)
        self.copy_len -= cnt
        if self.dict.avail_write() == 0 or self.copy_len > 0:
            self.to_read = self.dict.read_flush().tobytes()
            self.step = self._huffman_block
            self.step_state = _STATE_DICT
            return False
        return True

    def _copy_history(self):
        if self._copy_history_inner():
            self._read_literal()

    # -- stored blocks -----------------------------------------------------

    def _data_block(self):
        self.nb = 0
        self.b = 0
        hdr = self.src.read_at_most(4)
        self.roffset += len(hdr)
        if len(hdr) < 4:
            self.err = UnexpectedEOFError()
            return
        n = hdr[0] | (hdr[1] << 8)
        nn = hdr[2] | (hdr[3] << 8)
        if nn != (~n & 0xFFFF):
            self.err = CorruptInputError(self.roffset)
            return
        if n == 0:
            self.to_read = self.dict.read_flush().tobytes()
            self._finish_block()
            return
        self.copy_len = n
        self._copy_data()

    def _copy_data(self):
        want = min(self.dict.avail_write(), self.copy_len)
        data = self.src.read_at_most(want)
        self.roffset += len(data)
        self.copy_len -= len(data)
        self.dict.write_bytes(np.frombuffer(data, dtype=np.uint8))
        if len(data) < want:
            self.err = UnexpectedEOFError()
            return
        if self.dict.avail_write() == 0 or self.copy_len > 0:
            self.to_read = self.dict.read_flush().tobytes()
            self.step = self._copy_data
            return
        self._finish_block()

    def _finish_block(self):
        if self.final:
            if self.dict.avail_read() > 0:
                self.to_read = self.dict.read_flush().tobytes()
            self.err = EOFError_()
        self.step = self._next_block

    # -- public read surface ----------------------------------------------

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            chunks = []
            while True:
                c = self.read(1 << 20)
                if not c:
                    return b"".join(chunks)
                chunks.append(c)
        while True:
            if self.to_read:
                out, self.to_read = self.to_read[:n], self.to_read[n:]
                return out
            if self.err is not None:
                if isinstance(self.err, EOFError_):
                    return b""
                raise self.err
            self.step()
            if self.err is not None and not self.to_read:
                self.to_read = self.dict.read_flush().tobytes()

    def close(self):
        if self.err is not None and not isinstance(self.err, EOFError_):
            raise self.err


class Reader(Decompressor):
    """Public decompressor handle (&Reader::new / new_dict parity)."""

    @classmethod
    def with_dict(cls, src, dictionary: bytes) -> "Reader":
        return cls(src, dictionary)


def decompress(data: bytes, dictionary: bytes = b"") -> bytes:
    """One-shot raw-DEFLATE decompression (host oracle path)."""
    return Reader(data, dictionary).read()
