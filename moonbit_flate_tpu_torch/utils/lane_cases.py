"""Raw-DEFLATE streams that reach every rule of the lane shard decode.

``lane_cases`` are the streams of tests/test_lanes_inflate.py (its
truncated, BTYPE=3 and 24 fuzz mutants included); ``rule_cases`` are
hand-made streams for each error and edge rule of kernel A.  The port's
tests hold the port against the JAX package on them, and chip_smoke.py
holds the CUDA kernels against their plain twins on them.
``token_cases`` are token rows made by hand for kernel BC alone, laid
out as kernel A lays out its output by ``token_wave``.
"""

from __future__ import annotations

import zlib

import numpy as np

SEGB = 4096   # output bytes of one shard, at most


class _Bits:
    """LSB-first bit writer for hand-made DEFLATE streams."""

    def __init__(self):
        self.v, self.n = 0, 0

    def put(self, value, width):
        self.v |= value << self.n
        self.n += width

    def code(self, code, width):            # Huffman codes go MSB first
        self.put(int(f"{code:0{width}b}"[::-1], 2), width)

    def fixed_lit(self, b):
        if b < 144:
            self.code(0x30 + b, 8)
        else:
            self.code(0x190 + b - 144, 9)

    def tobytes(self):
        return self.v.to_bytes((self.n + 7) // 8, "little")


def lane_cases():
    """The streams of tests/test_lanes_inflate.py."""
    rng = np.random.default_rng(0)
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    m1 = co.compress(b"A" * 600) + co.flush(zlib.Z_FULL_FLUSH)
    m2 = co.compress(b"B" * 500 + b"A" * 100) + co.flush()
    cases = [
        b"hello hello hello world",
        (b"the quick brown fox " * 60)[:1200],
        rng.integers(0, 256, 700, np.uint8).tobytes(),
        b"",
        b"A" * SEGB,
        (b"xyz" * 700)[:SEGB],
        rng.integers(0, 256, 900, np.uint8).tobytes() + b"abc" * 300,
    ]
    streams = [zlib.compress(c, 1)[2:-4] for c in cases] + [m1 + m2]
    good = zlib.compress(b"some reasonable text " * 40, 1)[2:-4]
    streams += [good[: len(good) // 2], bytes([0x07]), good]
    rng = np.random.default_rng(11)
    bases = [
        zlib.compress((b"fuzz seed payload " * 60)[:1024], 1)[2:-4],
        zlib.compress(rng.integers(0, 256, 800, np.uint8).tobytes(), 1)[2:-4],
        zlib.compress(b"r" * 1500, 1)[2:-4],
    ]
    for k in range(24):
        b = bytearray(bases[k % 3])
        pos = int(rng.integers(0, len(b)))
        b[pos] ^= int(rng.integers(1, 256))
        streams.append(bytes(b))
    return streams


def _one_distance_code(dist_bit):
    """A final dynamic block of 'a', a match of length 3 at distance 1,
    'b' and the end of block.  Literal/length code: 'a', 'b', 256, 257, two
    bits each; distance code: symbol 0 alone, one bit, so the pattern 1
    has no code.  ``dist_bit`` is the match's distance bit."""
    w = _Bits()
    w.put(1, 1)
    w.put(2, 2)
    w.put(258 - 257, 5)               # nlit = 258
    w.put(0, 5)                       # ndist = 1
    w.put(18 - 4, 4)                  # 18 code-length code lengths
    # code-length code: 18 one bit (code 0), 1 and 2 two bits (10, 11)
    order = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1)
    cl_len = {18: 1, 2: 2, 1: 2}
    for k in order:
        w.put(cl_len.get(k, 0), 3)

    def zeros(n):                     # runs of 11..138 zeros (symbol 18)
        while n:
            r = min(n, 138)
            w.code(0, 1)
            w.put(r - 11, 7)
            n -= r

    zeros(97)
    w.code(3, 2)                      # 'a': 2
    w.code(3, 2)                      # 'b': 2
    zeros(256 - 99)
    w.code(3, 2)                      # 256: 2
    w.code(3, 2)                      # 257: 2
    w.code(2, 2)                      # distance symbol 0: 1
    w.code(0, 2)                      # 'a'
    w.code(3, 2)                      # length 3
    w.code(dist_bit, 1)               # distance 1, or no code
    w.code(1, 2)                      # 'b'
    w.code(2, 2)                      # end of block
    return w.tobytes()


def rule_cases():
    """Streams that reach kernel A's error and edge rules."""
    out = []
    # 40 empty non-final stored blocks: each pauses its stream for a
    # whole 128-row chunk, so the token rows run out (ST_OVERFLOW)
    out.append(b"\x00\x00\x00\xff\xff" * 40 + b"\x03\x00")
    # a non-final fixed block that ends with 1 bit left: DONE by the EOF rule
    w = _Bits()
    w.put(0b010, 3)
    for b in b"\x90\xa0\xb0\xc0\xd0":
        w.fixed_lit(b)
    w.code(0, 7)
    out.append(w.tobytes())
    # the same block with 6 bits left: a zero header (stored), corrupt
    w = _Bits()
    w.put(0b010, 3)
    w.fixed_lit(65)
    w.code(0, 7)
    out.append(w.tobytes())
    # a non-final stored block cut by a sync flush, then nothing
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    out.append(co.compress(b"sync flushed " * 30) + co.flush(zlib.Z_SYNC_FLUSH))
    # a dynamic header cut inside the code lengths
    rng = np.random.default_rng(9)
    letters = np.frombuffer(b"etaoinshrdlucmfw .,", np.uint8)
    dyn = zlib.compress(bytes(rng.choice(letters, 3000)), 9)[2:-4]
    if (dyn[0] >> 1) & 3 != 2:
        raise RuntimeError("zlib level 9 did not open with a dynamic block")
    out += [dyn[:12], dyn[:30]]
    # a stored block whose len and nlen do not match
    out.append(b"\x01\x05\x00\x34\x12hello")
    # a match whose distance reaches before the output start
    w = _Bits()
    w.put(0b011, 3)
    w.fixed_lit(66)
    w.code(1, 7)          # length code 257: length 3
    w.code(4, 5)          # distance code 4: distance 5..6, 1 extra bit
    w.put(1, 1)
    w.code(0, 7)
    out.append(w.tobytes())
    # a dynamic block whose distance code is one code of length 1: a
    # match through it decodes, one whose distance bit is 1 has no code
    out += [_one_distance_code(bit) for bit in (0, 1)]
    # streams that inflate to more than SEGB bytes
    rng = np.random.default_rng(5)
    out.append(zlib.compress(b"A" * 5000, 1)[2:-4])
    out.append(zlib.compress(rng.integers(0, 256, 4500, np.uint8).tobytes(), 1)[2:-4])
    out.append(zlib.compress((b"abcdefgh" * 700), 9)[2:-4])
    return out


TOK_ROWS = 35 * 128   # token rows of a stream
NSTR = 1024           # streams of a wave


def lit(b):
    """A literal record."""
    return (1 << 30) | b


def match(length, dist):
    """A match record (int32 value): 1 << 31 | length << 13 | dist."""
    return -(1 << 31) + (length << 13) + dist


def _random_chain(rng):
    """Short matches close behind each other, so that most of them read
    bytes that a match of the same 32 rows writes, some overlapping."""
    rows, pos = [lit(int(b)) for b in rng.integers(0, 256, 8)], 8
    while pos < 3000:
        if rng.random() < 0.3:
            rows.append(lit(int(rng.integers(0, 256))))
            pos += 1
        else:
            n, d = int(rng.integers(3, 13)), int(rng.integers(1, min(pos, 40) + 1))
            rows += [0, match(n, d)]
            pos += n
    return rows, pos


def token_cases():
    """(group, outlen, rows) for kernel BC alone: rows are one stream's
    token records in order, 0 for a gap row, at most TOK_ROWS of them.
    The list opens with a block of 8 streams (stream 0 of 4,096 literal
    rows, seven empty ones), so that ``token_wave`` puts them in one
    block of the kernel.  Groups: long_block, rle (dist 1-33, len 258),
    chain (matches reading the bytes of matches just before them),
    edge (a length-0 record, dist 0, sources before the start, a record
    > 0 without the literal bit, lengths past 258, matches without gap
    rows: from the second tile of 128 rows on, a whole tile of them, in
    the block of a stream whose matches of the first tile wait to be
    copied meanwhile), outlen (0, exactly
    4,096, above it, below 0, a cut inside a match, the 4,096th byte on
    the last row), gaps (runs of gap rows across tile boundaries) and
    random (records of every kind, outlen of every kind)."""
    rng = np.random.default_rng(8)
    cases = [("long_block", SEGB, [lit(int(b)) for b in rng.integers(0, 256, SEGB)])]
    cases += [("long_block", 0, [])] * 7
    for d in range(1, 34):
        rows = [lit(int(b)) for b in rng.integers(0, 256, d)]
        rows += [0, match(258, d)] * (-(-(SEGB - d) // 258))
        cases.append(("rle", SEGB, rows))
    for _ in range(4):
        rows, pos = _random_chain(rng)
        cases.append(("chain", pos, rows))
    text = [lit(b) for b in b"abcdefgh"]
    cases += [
        ("edge", 8 + 1 + 1 + 7 + 1 + 25 + 50 + 511,
         text + [match(0, 3), lit(105), match(7, 0), lit(106),
                 match(25, 30), match(50, 40), match(511, 8191)]),
        ("edge", 8 + 400 + 3 + 300,
         text + [match(400, 5), 0x3FFFFF41, 0x141, 0x7FFFFF42, match(300, 1)]),
        ("edge", 4 + 258, [lit(1), lit(2), lit(3), lit(4), match(258, 4096)]),
        ("edge", SEGB, [lit(1), lit(2), lit(3)] + [match(3, 1 + k % 5) for k in range(1400)]),
        ("edge", SEGB, [lit(int(b)) for b in rng.integers(0, 256, 128)]
         + [match(3, 1 + k % 97) for k in range(1300)]),
        ("edge", 8 + 4 * 40, text + [r for k in range(40) for r in (0, match(4, 1 + k % 8))]),
    ]
    letters = [lit(int(b)) for b in rng.integers(97, 123, 300)]
    rle = [lit(7), 0, match(258, 1)] * 20
    cases += [
        ("outlen", 0, letters),
        ("outlen", SEGB, rle),                   # 5,180 bytes of tokens
        ("outlen", 5000, rle),
        ("outlen", -7, letters),
        ("outlen", 100, [lit(5), match(258, 1)]),
        ("outlen", SEGB, [r for b in rng.integers(0, 256, SEGB) for r in
                          ([0, lit(int(b))] if rng.random() < 384 / SEGB else
                           [lit(int(b))])][:TOK_ROWS]),
    ]
    gap = [0] * 128
    cases += [
        ("gaps", 300, [0] * 200 + letters[:100] + [0] * 129 + [match(50, 60)]
         + [0] * 300 + [lit(9)] * 149 + gap + [0, match(0, 1)]),
        ("gaps", 2 * 127 + 1, [0] * 127 + [lit(3)] + gap + [lit(4), match(253, 2)]),
        ("gaps", SEGB, ([0] * 3 + [lit(6)] * 5 + [0, match(100, 7)]) * 40),
    ]
    for _ in range(8):
        rows = []
        for _ in range(int(rng.integers(1, TOK_ROWS + 1))):
            kind = rng.random()
            rows.append(0 if kind < 0.2 else
                        lit(int(rng.integers(0, 256))) if kind < 0.7 else
                        match(int(rng.integers(0, 512)), int(rng.integers(0, 8192))))
        cases.append(("random", int(rng.integers(-10, 5000)), rows))
    return cases


def token_wave(cases):
    """Case i as stream i of one wave, the rest empty: outlen
    int32[1, 8, 128] and kernel A's step-major token rows int32[1, 35,
    128, 8, 128] (row k of stream r at [0, k // 128, k % 128, r // 128,
    r % 128]), as numpy arrays."""
    outlen = np.zeros(NSTR, np.int32)
    tok = np.zeros((TOK_ROWS, NSTR), np.int32)
    for i, (_, n, rows) in enumerate(cases):
        outlen[i] = n
        tok[:len(rows), i] = rows
    return outlen.reshape(1, 8, 128), tok.reshape(1, 35, 128, 8, 128)
