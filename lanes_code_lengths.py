#!/usr/bin/env python3
"""How long the Huffman codes of the shard decode's streams are.

Run from the repository root:  python3 lanes_code_lengths.py [n_shards]

Decodes, on the host, zlib level-1 streams of n_shards (default 400)
4096-byte shards drawn with a fixed seed from the 32,768 of the shard
decode main path (chip_smoke.py's corpus), and prints the block types,
the longest literal/length code of each dynamic table, and, for fixed and
dynamic blocks apart, the share of decoded literal/length and distance
codes longer than each number of bits.  These shares size the root
tables of csrc/lanes_parse.cu: a code longer than its root takes a
slower path there.  Needs no card.
"""

import collections
import sys
import zlib

import numpy as np

from chip_smoke import DEC_WAVES, make_corpus

SEGB = 4096
ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
FIXED_LIT = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8


class _Bits:
    def __init__(self, data):
        self.v = int.from_bytes(data, "little")
        self.p = 0

    def take(self, n):
        r = (self.v >> self.p) & ((1 << n) - 1)
        self.p += n
        return r


def _codes(lens):
    """(length, code) -> symbol of a canonical code."""
    count = collections.Counter(l for l in lens if l)
    code, nxt = 0, {}
    for l in range(1, 16):
        code = (code + count.get(l - 1, 0)) << 1 if l > 1 else 0
        nxt[l] = code
    out = {}
    for sym, l in enumerate(lens):
        if l:
            out[(l, nxt[l])] = sym
            nxt[l] += 1
    return out


def _decode(bits, codes):
    c = 0
    for l in range(1, 16):
        c = (c << 1) | bits.take(1)
        if (l, c) in codes:
            return codes[(l, c)], l
    raise ValueError("no code")


def count(streams):
    kinds, longest = collections.Counter(), collections.Counter()
    lit, dist = collections.Counter(), collections.Counter()   # (dynamic, length) -> symbols
    for s in streams:
        b = _Bits(s)
        while True:
            final, typ = b.take(1), b.take(2)
            kinds[typ] += 1
            if typ == 0:
                b.p = (b.p + 7) & ~7
                n = b.take(16)
                b.take(16)
                b.p += 8 * n
            else:
                if typ == 1:
                    ll, dl = FIXED_LIT, [5] * 32
                else:
                    nlit, ndist, nclen = b.take(5) + 257, b.take(5) + 1, b.take(4) + 4
                    cl = [0] * 19
                    for k in range(nclen):
                        cl[ORDER[k]] = b.take(3)
                    clc, lens = _codes(cl), []
                    while len(lens) < nlit + ndist:
                        sym, _ = _decode(b, clc)
                        if sym < 16:
                            lens.append(sym)
                        elif sym == 16:
                            lens += [lens[-1]] * (3 + b.take(2))
                        else:
                            lens += [0] * ((3 + b.take(3)) if sym == 17 else (11 + b.take(7)))
                    ll, dl = lens[:nlit], lens[nlit:]
                    longest[max(ll)] += 1
                lc, dc, dyn = _codes(ll), _codes(dl), typ == 2
                while True:
                    sym, l = _decode(b, lc)
                    lit[dyn, l] += 1
                    if sym == 256:
                        break
                    if sym > 256:
                        lcode = sym - 257
                        b.take(0 if lcode < 8 or lcode == 28 else (lcode - 4) >> 2)
                        dsym, l = _decode(b, dc)
                        dist[dyn, l] += 1
                        b.take(0 if dsym < 4 else (dsym - 2) >> 1)
            if final:
                break
    return kinds, longest, lit, dist


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    n_sh = DEC_WAVES * 1024
    corpus = make_corpus(total=n_sh * SEGB, seed=0)
    pick = np.random.default_rng(0).choice(n_sh, n, replace=False)
    streams = [zlib.compress(corpus[i * SEGB:(i + 1) * SEGB], 1)[2:-4] for i in pick]
    kinds, longest, lit, dist = count(streams)
    print(f"{n} shards: blocks stored {kinds[0]}, fixed {kinds[1]}, dynamic {kinds[2]}; "
          f"longest literal/length code of a dynamic table: {dict(sorted(longest.items()))}")
    for dyn in (False, True):
        name = "dynamic" if dyn else "fixed"
        for what, hist, bits in (("literal/length", lit, (7, 8, 9, 10)), ("distance", dist, (4, 5, 6, 7))):
            total = sum(v for (d, _), v in hist.items() if d == dyn)
            shares = ", ".join(
                f"> {b} bits {sum(v for (d, l), v in hist.items() if d == dyn and l > b) / max(total, 1):.4f}"
                for b in bits)
            print(f"{name} blocks, {total} {what} codes: {shares}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
