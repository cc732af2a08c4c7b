"""Host-side exact-policy LZ77 match finder ("deflateFast" semantics; the
port's own copy of ``moonbit_flate_tpu/lz77/reference_fast.py``).

This is the *oracle* implementation: it reproduces, decision-for-decision,
the reference's Snappy-style greedy matcher (deflate-fast.mbt:123-342) —
14-bit direct-mapped hash table, 4-byte load/compare match admission, the
skip heuristic (start 32, step skip>>5), chained emitCopy continuation with
the s-1/s/s+1 hash refresh, cross-block matching against the previous
block, and the offset-epoch bookkeeping (cur / shift_offsets,
deflate-fast.mbt:348-389).

It exists to (a) pin down the compressed-size parity bar the device encoder
is measured against, and (b) serve as a differential-test oracle for the
vectorized matcher in ``ops/matcher.py``.  The hot-loop C twin lives
in ``native/``; this Python version favors clarity and uses NumPy only for
bulk precomputation (32-bit loads, hashes) and match extension.
"""

from __future__ import annotations

import numpy as np

from ..formats import constants as C

_INPUT_MARGIN = 16 - 1
_MIN_NON_LITERAL_BLOCK_SIZE = 1 + 1 + _INPUT_MARGIN


def _first_mismatch(a: np.ndarray, b: np.ndarray) -> int:
    """Index of the first differing element, or len(a) if all equal."""
    if len(a) == 0:
        return 0
    neq = a != b
    idx = int(np.argmax(neq))
    return idx if neq[idx] else len(a)


class DeflateFast:
    """Stateful across blocks: hash table epochs + previous block."""

    def __init__(self):
        self.table_val = np.zeros(C.TABLE_SIZE, dtype=np.uint32)
        self.table_off = np.zeros(C.TABLE_SIZE, dtype=np.int64)
        self.prev = np.zeros(0, dtype=np.uint8)
        self.cur = C.MAX_STORE_BLOCK_SIZE

    def reset(self):
        """Invalidate history so no matches reach the previous block."""
        self.prev = np.zeros(0, dtype=np.uint8)
        self.cur += C.MAX_MATCH_OFFSET
        if self.cur >= C.BUFFER_RESET:
            self._shift_offsets()

    def _shift_offsets(self):
        if len(self.prev) == 0:
            self.table_val[:] = 0
            self.table_off[:] = 0
            self.cur = C.MAX_MATCH_OFFSET + 1
            return
        shifted = self.table_off - (self.cur - (C.MAX_MATCH_OFFSET + 1))
        self.table_off[:] = np.maximum(shifted, 0)
        self.cur = C.MAX_MATCH_OFFSET + 1

    # -- match extension ---------------------------------------------------

    def _match_len(self, s: int, t: int, src: np.ndarray) -> int:
        """Extension length beyond the already-matched 4 bytes.

        ``t`` < 0 means the match source starts in the previous block.
        """
        s1 = min(s + C.MAX_MATCH_LENGTH - 4, len(src))
        if t >= 0:
            return _first_mismatch(src[s:s1], src[t : t + (s1 - s)])
        tp = len(self.prev) + t
        if tp < 0:
            return 0
        b_len = min(len(self.prev) - tp, s1 - s)
        n0 = _first_mismatch(src[s : s + b_len], self.prev[tp : tp + b_len])
        if n0 < b_len or s + n0 == s1:
            return n0
        # The source ran off the end of prev; continue matching against
        # the *start of the current block* (deflate-fast.mbt:334-341).
        rem = s1 - (s + n0)
        return n0 + _first_mismatch(src[s + n0 : s1], src[:rem])

    # -- encoding ----------------------------------------------------------

    def encode(self, src_bytes) -> np.ndarray:
        """Encode one block (<= 65535 bytes) into packed tokens."""
        src = np.frombuffer(bytes(src_bytes), dtype=np.uint8)
        n = len(src)
        parts: list[np.ndarray] = []

        def emit_literals(a: int, b: int):
            if b > a:
                parts.append(src[a:b].astype(np.uint32))

        if self.cur >= C.BUFFER_RESET:
            self._shift_offsets()

        if n < _MIN_NON_LITERAL_BLOCK_SIZE:
            self.cur += C.MAX_STORE_BLOCK_SIZE
            self.prev = np.zeros(0, dtype=np.uint8)
            emit_literals(0, n)
            return (np.concatenate(parts) if parts
                    else np.zeros(0, dtype=np.uint32))

        # Bulk precompute: little-endian u32 at every position, and hashes.
        a32 = src.astype(np.uint32)
        u32 = (a32[: n - 3] | (a32[1 : n - 2] << 8)
               | (a32[2 : n - 1] << 16) | (a32[3:] << 24))
        hashes = ((u32 * np.uint32(C.HASH_MUL)) >> np.uint32(C.TABLE_SHIFT)
                  ).astype(np.int64)

        table_val = self.table_val
        table_off = self.table_off
        cur = self.cur
        s_limit = n - _INPUT_MARGIN
        next_emit = 0
        s = 0
        cv = int(u32[0])
        next_hash = int(hashes[0])
        finished = False

        while not finished:
            # Scan for a 4-byte match with skip heuristic.
            skip = 32
            next_s = s
            while True:
                s = next_s
                next_s = s + (skip >> 5)
                skip += skip >> 5
                if next_s > s_limit:
                    finished = True
                    break
                cand_off = int(table_off[next_hash])
                cand_val = int(table_val[next_hash])
                now = int(u32[next_s])
                table_off[next_hash] = s + cur
                table_val[next_hash] = cv
                next_hash = int(hashes[next_s])
                offset = s - (cand_off - cur)
                if offset > C.MAX_MATCH_OFFSET or cv != cand_val:
                    cv = now
                    continue
                break
            if finished:
                break

            emit_literals(next_emit, s)

            # Chain emitCopy calls while the byte right after each match
            # also matches.
            while True:
                s += 4
                t = cand_off - cur + 4
                ext = self._match_len(s, t, src)
                parts.append(np.array(
                    [C.TOKEN_MATCH_TYPE
                     + ((ext + 4 - C.BASE_MATCH_LENGTH) << C.TOKEN_LENGTH_SHIFT)
                     + (s - t - C.BASE_MATCH_OFFSET)], dtype=np.uint32))
                s += ext
                next_emit = s
                if s >= s_limit:
                    finished = True
                    break
                # Refresh hashes at s-1 and s; peek candidate at s.
                x_m1 = int(u32[s - 1])
                table_off[hashes[s - 1]] = cur + s - 1
                table_val[hashes[s - 1]] = x_m1
                x_0 = int(u32[s])
                h0 = int(hashes[s])
                cand_off = int(table_off[h0])
                cand_val = int(table_val[h0])
                table_off[h0] = cur + s
                table_val[h0] = x_0
                offset = s - (cand_off - cur)
                if offset > C.MAX_MATCH_OFFSET or x_0 != cand_val:
                    cv = int(u32[s + 1])
                    next_hash = int(hashes[s + 1])
                    s += 1
                    break

        # emit_remainder.  Reference quirk (deflate-fast.mbt:157): the
        # previous block is "saved" via slice_copy into a zero-length
        # slice, which copies nothing — so prev stays empty forever and
        # cross-block matches are admitted (4-byte table-value check) but
        # never extended.  Reproduced here for size parity; the device
        # matcher is allowed to do strictly better.
        emit_literals(next_emit, n)
        self.cur = cur + n
        return (np.concatenate(parts) if parts
                else np.zeros(0, dtype=np.uint32))
