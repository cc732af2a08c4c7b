"""Raw-DEFLATE streams that reach every block type, status and error
rule of the scalar-path parser (``ops/parse.py``).

``stream_cases`` returns (name, stream, status) triples: the payloads of
tests/test_parse_pallas.py at zlib levels 0, 1 and 9, fixed, multi-block
and flushed streams, and hand-made streams for each rule of the parse
kernel.  ``status`` is what the parser reports at a token capacity of
CASE_CAPACITY (8 chunks of 512): 1 done, 0 capacity exhausted, -3
corrupt, -4 truncated.  ``fuzz_cases`` are mutants of good streams, and
``token_cases`` and ``window_tokens`` are token rows for the resolve
kernel.  The port's tests hold the port against the JAX package on
them, and chip_smoke.py holds the CUDA kernels against their plain
twins on them.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..formats.constants import CODEGEN_ORDER
from .lane_cases import _Bits

CASE_CHUNKS, CASE_CHUNK = 8, 512
CASE_CAPACITY = CASE_CHUNKS * CASE_CHUNK

# a complete code-length code over all 19 symbols: 13 of 4 bits, 6 of 5
_CL_LENS = (4,) * 13 + (5,) * 6


def payloads():
    """The payloads of tests/test_parse_pallas.py."""
    rng = np.random.default_rng(11)
    text = (b"the quick brown fox jumps over the lazy dog | " * 40)[:1800]
    rnd = rng.integers(0, 256, 1200, np.uint8).tobytes()
    rle = b"abc" * 500
    mixed = text + rnd[:400] + rle[:600] + text[:300]
    return {"text": text, "random": rnd, "rle": rle, "mixed": mixed,
            "tiny": b"x", "empty": b""}


def _raw(data, level=6, strategy=zlib.Z_DEFAULT_STRATEGY, flush=zlib.Z_FINISH):
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return co.compress(data) + co.flush(flush)


def _canonical(lens):
    """{symbol: (code, length)} of a canonical Huffman code."""
    codes, code = {}, 0
    for length in range(1, 16):
        for sym, l in enumerate(lens):
            if l == length:
                codes[sym] = (code, length)
                code += 1
        code <<= 1
    return codes


def _rle(lens):
    """Code-length symbols (symbol, extra bits value) for a lens list:
    runs of zeros as 17 / 18, everything else plainly."""
    seq, i = [], 0
    while i < len(lens):
        run = 0
        while i + run < len(lens) and lens[i + run] == 0 and run < 138:
            run += 1
        if run >= 11:
            seq.append((18, run - 11))
        elif run >= 3:
            seq.append((17, run - 3))
        else:
            run = 1
            seq.append((lens[i], None))
        i += run
    return seq


def _dynamic_header(w, lit_lens, dist_lens, final=1, cl_lens=_CL_LENS, seq=None,
                    nlit=None, ndist=None):
    """Write a dynamic block header.  ``seq`` overrides the code-length
    symbols; ``nlit`` / ``ndist`` override the counts in the header."""
    w.put(final, 1)
    w.put(2, 2)
    w.put((len(lit_lens) if nlit is None else nlit) - 257, 5)
    w.put((len(dist_lens) if ndist is None else ndist) - 1, 5)
    w.put(19 - 4, 4)
    for s in CODEGEN_ORDER.tolist():
        w.put(cl_lens[s], 3)
    codes = _canonical(cl_lens)
    for sym, extra in (_rle(list(lit_lens) + list(dist_lens)) if seq is None else seq):
        w.code(*codes[sym])
        if sym >= 16:
            w.put(extra, {16: 2, 17: 3, 18: 7}[sym])


def _lit_lens(pairs, n=258):
    lens = [0] * n
    for sym, l in pairs.items():
        lens[sym] = l
    return lens


# a complete literal/length code: 'a' 1 bit, 'b' 2, end-of-block and
# length symbol 257 (length 3) 3 bits each
_LITS = {97: 1, 98: 2, 256: 3, 257: 3}


def _dynamic_cases():
    def block(lit_pairs=_LITS, dist_lens=(1,), body=(97, 98, 97, 256), **kw):
        w = _Bits()
        lens = _lit_lens(lit_pairs)
        _dynamic_header(w, lens, dist_lens, **kw)
        lit_codes, dist_codes = _canonical(lens), _canonical(dist_lens)
        for s in body:
            if isinstance(s, tuple):        # ("d", distance symbol or raw bits)
                if s[1] in dist_codes:
                    w.code(*dist_codes[s[1]])
                else:
                    w.put(*s[2])
            else:
                w.code(*lit_codes[s])
        return w.tobytes()

    zeros = [(18, 127), (18, 109)]               # 138 + 120 = 258 zeros
    return [
        ("dyn_ok", block(body=(97, 98, 257, ("d", 0), 97, 256)), 1),
        ("dyn_lit_oversubscribed", block({97: 1, 98: 1, 256: 1}), -3),
        ("dyn_lit_incomplete", block({97: 2, 256: 2}, body=()), -3),
        ("dyn_lit_empty", block({}, body=()), -3),
        ("dyn_dist_oversubscribed", block(dist_lens=(1, 1, 1)), -3),
        ("dyn_dist_incomplete", block(dist_lens=(2, 0)), -3),
        # an empty distance code is accepted; a match then finds no code
        ("dyn_dist_empty_match", block(dist_lens=(0,),
                                       body=(97, 257, ("d", None, (0, 1)), 256)), -3),
        # one distance code of length 1 (bit 0); bit 1 has no code
        ("dyn_dist_single_code_bit1", block(body=(97, 257, ("d", None, (1, 1)), 256)), -3),
        ("dyn_clen_incomplete", block(cl_lens=(2, 2) + (0,) * 17, seq=[]), -3),
        ("dyn_clen_oversubscribed", block(cl_lens=(1, 1, 1) + (0,) * 16, seq=[]), -3),
        ("dyn_repeat16_first", block(seq=[(16, 0)] + zeros), -3),
        ("dyn_repeat_past_end", block(seq=zeros + [(18, 0)]), -3),
        ("dyn_nlit_287", block(nlit=287), -3),
        ("dyn_ndist_31", block(ndist=31), -3),
    ]


def _long_code_cases():
    """Literal/length and distance codes of every length 1..15, so that
    codes longer than any root table are decoded (hit), and a one-code
    literal table whose other bit has no code."""
    lit = {97 + k: k + 1 for k in range(12)}          # 'a'..'l': 1..12 bits
    lit.update({256: 13, 257: 14, 109: 15, 285: 15})  # end, length 3, 'm', length 258
    lens = _lit_lens(lit, 286)
    dist_lens = list(range(1, 15)) + [15, 15]         # distance symbols 0..15
    lit_codes, dist_codes = _canonical(lens), _canonical(dist_lens)

    def stream(cut_bits=0):
        w = _Bits()
        _dynamic_header(w, lens, dist_lens)
        for sym in list(range(97, 110)) + [97] * 300:
            w.code(*lit_codes[sym])
        for lsym, dsym, extra, ebits in ((257, 10, 5, 4),    # 14 + 11 bits, distance 38
                                         (285, 15, 63, 6),   # 15 + 15 bits, distance 256
                                         (257, 13, 0, 6),    # 14 + 14 bits, distance 129
                                         (285, 0, 0, 0)):    # 15 + 1 bits, distance 1
            w.code(*lit_codes[lsym])
            w.code(*dist_codes[dsym])
            w.put(extra, ebits)
        for sym in (107, 108, 109, 256):
            w.code(*lit_codes[sym])
        return w.tobytes()[:(w.n - cut_bits + 7) // 8] if cut_bits else w.tobytes()

    out = [("dyn_long_codes", stream(), 1),
           # cut inside the last symbols: the 13-bit end-of-block code, then
           # the 15-bit literal before it
           ("dyn_long_codes_cut_in_end_of_block", stream(cut_bits=10), -4),
           ("dyn_long_codes_cut_in_literal", stream(cut_bits=24), -4)]
    # one literal/length code of 1 bit (end of block): bit 1 has no code
    for name, bit, status in (("dyn_lit_single_code_bit0", 0, 1),
                              ("dyn_lit_single_code_bit1", 1, -3)):
        w = _Bits()
        _dynamic_header(w, _lit_lens({256: 1}), (1,))
        w.put(bit, 1)
        out.append((name, w.tobytes(), status))
    return out


def _stored_boundary_cases():
    """A stored block whose header and bytes straddle 4, 8 and 16 KB of
    input, reached through empty stored blocks (5 bytes and no token
    each), and a Huffman stream that ends within 48 bits of a long run
    of tokens, whole and cut."""
    rng = np.random.default_rng(23)
    out = []
    for kb in (4, 8, 16):
        lead = (kb * 1024 - 3) // 5                   # ends 3 to 7 bytes short
        body = rng.integers(0, 256, 100, np.uint8).tobytes()
        out.append((f"stored_across_{kb}k",
                    b"\x00\x00\x00\xff\xff" * lead + b"\x01\x64\x00\x9b\xff" + body, 1))
    letters = np.frombuffer(b"etaoinshrdlucmfw .,", np.uint8)
    run = _raw(bytes(rng.choice(letters, 3500)), 6, zlib.Z_HUFFMAN_ONLY)
    out.append(("long_run_whole", run, 1))
    out.append(("long_run_cut_1_byte", run[:-1], -4))
    out.append(("long_run_cut_5_bytes", run[:-5], -4))
    matches = _raw((b"a run of tokens and matches " * 150)[:3900], 9)
    out.append(("long_matches_cut_2_bytes", matches[:-2], -4))
    return out


def _fixed(final=1):
    w = _Bits()
    w.put(final, 1)
    w.put(1, 2)
    return w


def _fixed_cases():
    out = []
    # a match whose distance reaches before the output start
    w = _fixed()
    w.fixed_lit(66)
    w.code(1, 7)          # length code 257: length 3
    w.code(4, 5)          # distance code 4: distance 5..6, 1 extra bit
    w.put(1, 1)
    w.code(0, 7)
    out.append(("fixed_dist_before_start", w.tobytes(), -3))
    # literal/length symbol 286 (8-bit code 0xC6)
    w = _fixed()
    w.fixed_lit(65)
    w.code(0xC6, 8)
    w.code(0, 7)
    out.append(("fixed_symbol_286", w.tobytes(), -3))
    # distance symbol 30
    w = _fixed()
    w.fixed_lit(65)
    w.code(1, 7)
    w.code(30, 5)
    w.code(0, 7)
    out.append(("fixed_dist_symbol_30", w.tobytes(), -3))
    # a length code with the stream ending before its distance code: the
    # distance reads as 1, beyond an empty history, and corrupt wins ...
    w = _fixed()
    w.code(13, 7)         # length code 269, 2 extra bits: 4 bits are left
    w.put(0, 2)
    out.append(("fixed_cut_distance_first", w.tobytes(), -3))
    # ... but after a literal it is plainly truncated
    w = _fixed()
    w.fixed_lit(0x90)     # a 9-bit code: 3 bits are left after the length
    w.code(13, 7)
    w.put(0, 2)
    out.append(("fixed_cut_distance_later", w.tobytes(), -4))
    # ... whatever the three bits that are left say (here distance code 28)
    w = _fixed()
    w.fixed_lit(0x90)
    w.code(13, 7)
    w.put(0, 2)
    w.put(7, 3)
    out.append(("fixed_cut_distance_ones", w.tobytes(), -4))
    # ... or four bits that would read as distance symbol 30
    w = _fixed()
    w.fixed_lit(0x90)
    w.code(9, 7)          # length code 265, 1 extra bit: 4 bits are left
    w.put(0, 1)
    w.put(15, 4)
    out.append(("fixed_cut_distance_symbol_30", w.tobytes(), -4))
    # ten literals, a length code, a distance code, cut before its extra
    # bits: near (5 <= 10) is truncated, far (24577 > 10) is corrupt
    for name, dcode, ebits, status in (("near", 4, 1, -4), ("far", 29, 13, -3)):
        w = _fixed()
        w.fixed_lit(0x90)
        for _ in range(9):
            w.fixed_lit(65)
        w.code(1, 7)
        w.code(dcode, 5)
        if w.n % 8:
            raise RuntimeError("the extra bits do not start on a byte boundary")
        cut = w.n // 8
        w.put(0, ebits)
        w.code(0, 7)
        out.append((f"fixed_cut_extra_{name}", w.tobytes()[:cut], status))
    # a non-final block that ends with fewer than 3 bits left: a clean end
    w = _fixed(final=0)
    for b in b"\x90\xa0\xb0\xc0\xd0":
        w.fixed_lit(b)
    w.code(0, 7)
    out.append(("fixed_nonfinal_clean_end", w.tobytes(), 1))
    # ... and with exactly 3 bits left, which read as a stored header
    # whose LEN and NLEN lie past the end
    w = _fixed(final=0)
    for b in b"\x90\xa0\xb0":
        w.fixed_lit(b)
    w.code(0, 7)
    if w.n % 8 != 5:
        raise RuntimeError("the block does not end 3 bits before a byte boundary")
    out.append(("fixed_nonfinal_three_bits_left", w.tobytes(), -3))
    return out


def stream_cases():
    """(name, stream, status at CASE_CAPACITY tokens) of every case."""
    rng = np.random.default_rng(7)
    cases = []
    for name, p in payloads().items():
        for level in (0, 1, 9):
            cases.append((f"{name}_l{level}", _raw(p, level), 1))
    text = payloads()["text"]
    cases.append(("z_fixed", _raw(b"fixed huffman block round trip " * 20, 1, zlib.Z_FIXED), 1))
    cases.append(("sync_flushed_nonfinal", _raw(b"truncate me " * 100, 6,
                                                flush=zlib.Z_SYNC_FLUSH), 1))
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    multi = co.compress(b"A" * 600) + co.flush(zlib.Z_FULL_FLUSH)
    multi += co.compress(text[:500] + b"A" * 100) + co.flush()
    cases.append(("multi_block", multi, 1))
    cases.append(("huffman_only", _raw(text, 6, zlib.Z_HUFFMAN_ONLY), 1))
    cases.append(("empty_stream", b"", 1))
    cases.append(("stored_empty_final", b"\x01\x00\x00\xff\xff", 1))
    cases.append(("stored_empty_nonfinal", b"\x00\x00\x00\xff\xff", 1))
    # what follows a final block is not read
    cases.append(("stored_empty_final_then_data",
                  b"\x01\x00\x00\xff\xff" + _raw(b"not read"), 1))
    cases.append(("stored_final_then_data",
                  b"\x01\x03\x00\xfc\xffabc" + _raw(b"not read"), 1))

    half = _raw(b"truncate me " * 100)
    cases.append(("cut_in_symbols", half[: len(half) // 2], -4))
    cases.append(("block_type_3", bytes([0x06]) + half[1:], -3))
    cases.append(("block_type_3_alone", bytes([0x07]), -3))
    cases.append(("stored_bad_nlen", b"\x01\x05\x00\x34\x12hello", -3))
    cases.append(("stored_body_past_end", b"\x01\x0a\x00\xf5\xffhello", -4))
    cases.append(("stored_header_cut", b"\x01\x05", -3))
    letters = np.frombuffer(b"etaoinshrdlucmfw .,", np.uint8)
    dyn = _raw(bytes(rng.choice(letters, 3000)), 9)
    if (dyn[0] >> 1) & 3 != 2:
        raise RuntimeError("zlib level 9 did not open with a dynamic block")
    # a dynamic header cut short is corrupt here (the host scanner ends cleanly)
    cases.append(("dyn_header_cut_in_counts", dyn[:1], -3))
    cases.append(("dyn_header_cut_in_clens", dyn[:6], -3))
    cases.append(("dyn_header_cut_in_lens", dyn[:30], -3))
    cases += _dynamic_cases()
    cases += _fixed_cases()
    cases += _long_code_cases()
    cases += _stored_boundary_cases()
    # more tokens than CASE_CAPACITY: stored bytes, and Huffman literals
    big = rng.integers(0, 256, CASE_CAPACITY + 900, np.uint8).tobytes()
    cases.append(("exhaust_stored", _raw(big, 0), 0))
    cases.append(("exhaust_literals",
                  _raw(bytes(rng.choice(letters, CASE_CAPACITY + 700)), 6,
                       zlib.Z_HUFFMAN_ONLY), 0))
    # exactly CASE_CAPACITY tokens with only the end-of-block symbol left
    cases.append(("exhaust_at_end_of_block",
                  _raw(bytes(rng.choice(letters, CASE_CAPACITY)), 6,
                       zlib.Z_HUFFMAN_ONLY), 0))
    return cases


def fuzz_cases(n=96):
    """n mutants (one to three bytes changed) of dynamic, fixed and stored
    streams; what each decodes to is whatever the parser's rules give."""
    rng = np.random.default_rng(17)
    letters = np.frombuffer(b"etaoinshrdlucmfw .,", np.uint8)
    p = payloads()
    bases = [_raw(p["mixed"], 9), _raw(bytes(rng.choice(letters, 2500)), 6),
             _raw(p["text"] + p["rle"], 1, zlib.Z_FIXED), _raw(p["random"][:300], 0),
             _raw(p["text"][:900], 6, zlib.Z_HUFFMAN_ONLY),
             _raw(p["rle"] + p["random"][:200], 6)]
    out = []
    for k in range(n):
        b = bytearray(bases[k % len(bases)])
        for _ in range(1 + k % 3):
            # half of the changes fall in the first 64 bytes, where headers are
            hi = min(len(b), 64) if rng.random() < 0.5 else len(b)
            b[int(rng.integers(0, hi))] ^= int(rng.integers(1, 256))
        out.append(bytes(b))
    return out


def _match(length, dist):
    return int(np.int32(-(1 << 31)) | np.int32(((length - 3) << 15) | (dist - 1)))


def token_cases():
    """(name, tokens int32[N]) rows for the resolve kernel: overlapping
    copies at small distances, long copies, and the inputs the parser
    never emits (a source before the stream's start)."""
    rng = np.random.default_rng(13)
    lits = rng.integers(0, 256, 300).tolist()
    out = []
    for d in (1, 2, 3, 5, 31, 32, 33):
        out.append((f"rle_d{d}", lits[:d] + [_match(258, d)] * 40))
    out.append(("far_copies", lits + [_match(100, 300), _match(258, 1),
                                      _match(3, 400)] * 30))
    out.append(("before_start", [65, 66, _match(20, 5), 67, _match(9, 30)]))
    out.append(("match_first", [_match(10, 1), 65]))
    out.append(("empty", []))
    return [(name, np.asarray(t, np.int32)) for name, t in out]


def window_tokens(n_out, seed=17):
    """A valid token row of at least n_out bytes, almost all of it long
    matches (258 bytes seven times in ten) with one to three literals
    between two, at distances from 1 to 32768 (never past the output so
    far): the last token a round of the resolve kernel takes nearly
    always runs past the round's window, and sources lie inside the
    window, in the finished output before it, and across its start."""
    rng = np.random.default_rng(seed)
    dists = (1, 2, 3, 5, 16, 31, 258, 1000, 4096, 16383, 16384, 16385, 32768)
    toks = rng.integers(0, 256, 64).tolist()
    out = len(toks)
    while out < n_out:
        length = 258 if rng.random() < 0.7 else int(rng.integers(3, 259))
        toks.append(_match(length, min(dists[rng.integers(len(dists))], out)))
        lits = rng.integers(0, 256, int(rng.integers(1, 4))).tolist()
        toks += lits
        out += length + len(lits)
    return np.asarray(toks, np.int32)
