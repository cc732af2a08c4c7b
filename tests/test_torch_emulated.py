"""The CUDA sources of the walk (``csrc/walk.cu``), the symbol parser
(``csrc/parse.cu``), the resolver (``csrc/resolve.cu``), the bit packs
(``csrc/pack.cu``) and the two lane kernels (``csrc/lanes_parse.cu``,
``csrc/lanes_resolve.cu``), compiled for the CPU by
``kernels/emulate.py`` (one OS thread a CUDA thread) and held exactly
against their plain twins.

This tests the kernels' own logic (tiles, entries, the fast loop, the
turns of the parsing lane, table builds, stored-block copies, the
resolver's windows, rounds and pointer doubling, the batched pack's tile
sums, scans and edge words, the lane parser's roots, slow path, rings and
chunk schedule) without a card, at small shapes.  The lane parser's
plain model of its table decode is held against the twin's length
counting on every 15-bit pattern.  It cannot stand in for the card: chip_smoke.py
builds the same sources with nvcc and holds them against the same twins
there.  Without g++ the tests skip.
"""

import zlib

import numpy as np
import pytest
import torch

from moonbit_flate_tpu_torch import native
from moonbit_flate_tpu_torch.inflate.cuda_inflate import scan_tokens
from moonbit_flate_tpu_torch.kernels import emulate
from moonbit_flate_tpu_torch.ops import lanes_inflate as LI
from moonbit_flate_tpu_torch.ops import lanes_resolve as LR
from moonbit_flate_tpu_torch.ops import pack as TK
from moonbit_flate_tpu_torch.ops import parse as TP
from moonbit_flate_tpu_torch.ops import pipeline as TPL
from moonbit_flate_tpu_torch.ops import resolve as TR
from moonbit_flate_tpu_torch.ops import walk as TW
from moonbit_flate_tpu_torch.utils import stream_cases as SC
from moonbit_flate_tpu_torch.utils.lane_cases import (lane_cases, rule_cases, token_cases,
                                                       token_wave)

torch.set_num_threads(1)

BLOCK = 65535
PAD = 320


def _entry(name, symbol, argtypes):
    try:
        return emulate.entry(name, symbol, argtypes)
    except RuntimeError as e:
        pytest.skip(str(e))


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parse_emulated():
    fn = _entry("parse", "parse_launch", TP._ARGTYPES)

    def run(nbits, words, n_chunks, out_chunk):
        B, SW = words.shape
        cap = n_chunks * out_chunk
        # what the kernel does not write shows as a difference
        toks = torch.full((B, cap), 0x5A5A5A5A, dtype=torch.int32)
        cnt = torch.full((B, 3), -99, dtype=torch.int32)
        assert fn(nbits.data_ptr(), words.data_ptr(), toks.data_ptr(),
                  cnt.data_ptr(), B, SW, cap, None) == 0
        return toks, cnt

    return run


@pytest.fixture(scope="module")
def case_batch():
    streams = [c[1] for c in SC.stream_cases()] + lane_cases() + rule_cases() \
        + SC.fuzz_cases()
    return TP.stage_streams(streams, device="cpu")


def _corpus(total, seed):
    """Text, records with noise, a repeated unit and random bytes."""
    rng = np.random.default_rng(seed)
    words = [b"deflate", b"window", b"the", b"of", b"huffman", b"block", b"a"]
    parts = []
    while sum(map(len, parts)) < total:
        parts.append(b" ".join(words[i] for i in rng.integers(0, len(words), 3000)))
        rec = rng.integers(0, 256, 64, np.uint8).tobytes()
        parts.append(b"".join(rec[:48] + rng.integers(0, 256, 16, np.uint8).tobytes()
                              for _ in range(300)))
        parts.append(rng.integers(0, 256, 7, np.uint8).tobytes() * 2500)
        parts.append(rng.integers(0, 256, 40000, np.uint8).tobytes())
    return b"".join(parts)[:total]


@pytest.mark.parametrize("n_chunks,out_chunk",
                         [(SC.CASE_CHUNKS, SC.CASE_CHUNK), (3, 8192), (1, 7)])
def test_emulated_parser_equals_twin_on_every_case(parse_emulated, case_batch,
                                                   n_chunks, out_chunk):
    nbits, words = case_batch
    toks, cnt = parse_emulated(nbits, words, n_chunks, out_chunk)
    want_toks, want_cnt = TP.parse_batch_ref(nbits, words, n_chunks, out_chunk)
    bad = (cnt != want_cnt).any(1).nonzero()[:, 0].tolist()
    assert not bad, f"streams whose counts differ: {bad[:20]}"
    bad = (toks != want_toks).any(1).nonzero()[:, 0].tolist()
    assert not bad, f"streams whose tokens differ: {bad[:20]}"


@pytest.mark.parametrize("cap", [2047, 2048, 2049, 4097])
def test_emulated_parser_stops_at_the_capacity(parse_emulated, cap):
    """Capacities around the staging size, on whole and cut streams."""
    data = _corpus(120_000, 5)
    streams = [zlib.compress(data[:60_000], 1)[2:-4], zlib.compress(data[60_000:90_000], 9)[2:-4],
               SC._raw(data[:20_000], 6, zlib.Z_HUFFMAN_ONLY),
               SC._raw(data[90_000:], 6, zlib.Z_FIXED), zlib.compress(data[:9000], 0)[2:-4]]
    streams += [s[:-k] for s in streams[:4] for k in (1, 3, 6)]
    nbits, words = TP.stage_streams(streams, device="cpu")
    toks, cnt = parse_emulated(nbits, words, 1, cap)
    want_toks, want_cnt = TP.parse_batch_ref(nbits, words, 1, cap)
    assert torch.equal(cnt, want_cnt)
    assert torch.equal(toks, want_toks)
    assert 0 in want_cnt[:, 1].tolist()


def test_emulated_parser_equals_the_host_scanner_on_long_streams(parse_emulated):
    try:
        native.scanner()
    except RuntimeError as e:
        pytest.skip(f"host scanner unavailable: {e}")
    data = _corpus(400_000, 3)
    streams = [zlib.compress(data[:300_000], 1)[2:-4], zlib.compress(data[100_000:], 6)[2:-4],
               zlib.compress(data[:150_000], 0)[2:-4],
               SC._raw(data[200_000:], 6, zlib.Z_HUFFMAN_ONLY)]
    nbits, words = TP.stage_streams(streams, device="cpu")
    toks, cnt = parse_emulated(nbits, words, 40, 8192)
    for i, s in enumerate(streams):
        want = scan_tokens(s)
        n = int(cnt[i, 0])
        assert cnt[i, 1] == 1 and n == len(want)
        assert np.array_equal(toks[i, :n].numpy(), want)
        assert not toks[i, n:].any()


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

def _walk_emulated(payloads, ctxs, nb):
    fn = _entry("walk", "walk_launch", TW._ARGTYPES)
    S = nb * BLOCK
    B = len(payloads)
    buf = np.zeros((B, S + PAD), np.uint8)
    ns = [len(p) for p in payloads]
    for b, p in enumerate(payloads):
        buf[b, :len(p)] = np.frombuffer(p, np.uint8)
    data = torch.from_numpy(buf)
    clipped = [TPL._find_clip(data[b], ns[b], ctxs[b], nb) for b in range(B)]
    mlen = torch.stack([m for m, _ in clipped])
    dist = torch.stack([d for _, d in clipped])
    scratch, outs = TW._scratch(B, S, "cpu"), TW._outputs(B, S, "cpu")
    for t in scratch + outs:
        t.view(torch.uint8).fill_(0xA5)
    assert fn(data.data_ptr(), data.shape[1], mlen.data_ptr(), dist.data_ptr(),
              torch.tensor(ctxs, dtype=torch.int32).data_ptr(),
              torch.tensor(ns, dtype=torch.int32).data_ptr(),
              *(t.data_ptr() for t in scratch), *(t.data_ptr() for t in outs),
              B, S, TW.ALL_PHASES, None) == 0
    return outs, TW.commit_walk_ref(data, mlen, dist, ns, ctxs, nb)


@pytest.mark.parametrize("nb,ctxs,lens", [
    (2, [0, 32768, 5], [131070, 70001, 131000]),      # a full row, a short one, a run
    (2, [70000, 131070, 0], [131070, 131070, 0]),     # start in a later tile, at the end, empty
    (1, [0, 1000], [65535, 40000]),                   # rows at odd addresses, one ragged tile
])
def test_emulated_walk_equals_twin(nb, ctxs, lens):
    data = _corpus(3 * 131070, 9)
    payloads = [data[i * 131070: i * 131070 + n] for i, n in enumerate(lens)]
    if nb == 2:
        payloads[2] = (b"z" * 131000)[:lens[2]]
    got, want = _walk_emulated(payloads, ctxs, nb)
    for g, w, what in zip(got, want, ("committed", "match starts", "lengths", "distances")):
        assert torch.equal(g.view(torch.uint8) if g.dtype == torch.bool else g,
                           w.view(torch.uint8) if w.dtype == torch.bool else w), what
    if any(lens):
        assert bool(want[1].any())


# ---------------------------------------------------------------------------
# the resolver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resolve_emulated():
    fn = _entry("resolve", "resolve_launch", TR._ARGTYPES)

    def run(rows, no_pad, ntok=None, fills=None):
        """Rows of tokens into words; ``fills[i]`` goes past row i's tokens."""
        nt_pad = -(-max(max(map(len, rows)), 1) // 1024) * 1024
        toks = torch.zeros((len(rows), nt_pad), dtype=torch.int32)
        for i, t in enumerate(rows):
            toks[i, len(t):] = fills[i] if fills else 0
            toks[i, :len(t)] = torch.from_numpy(np.asarray(t, np.int32))
        n = torch.tensor([len(t) for t in rows] if ntok is None else ntok,
                         dtype=torch.int32)
        # what the kernel does not write shows as a difference
        out = torch.full((len(rows), no_pad // 4), 0x5A5A5A5A, dtype=torch.int32)
        assert fn(n.data_ptr(), toks.data_ptr(), out.data_ptr(), len(rows), nt_pad,
                  no_pad, None) == 0
        return out, TR.resolve_batch_ref(toks, n, nt_pad, no_pad)

    return run


def _zlib_tokens(data, level):
    return scan_tokens(zlib.compress(data, level)[2:-4])


def test_emulated_resolver_on_rows_across_several_windows(resolve_emulated):
    try:
        native.scanner()
    except RuntimeError as e:
        pytest.skip(f"host scanner unavailable: {e}")
    datas = [_corpus(45_000, 4), b"\x00" * 40_000]
    rows = [_zlib_tokens(d, lv) for d, lv in zip(datas, (6, 9))]
    rows.append(SC.window_tokens(40_000, seed=1))
    no_pad = 6 * TR.OUT_BYTES
    got, want = resolve_emulated(rows, no_pad)
    assert torch.equal(got, want)
    flat = got.numpy().view(np.uint8)
    for i, d in enumerate(datas):
        assert flat[i, :len(d)].tobytes() == d and not flat[i, len(d):].any()
    assert all(len(TR.round_bounds(torch.from_numpy(np.asarray(t)), no_pad)) >= 3
               for t in rows)


@pytest.mark.parametrize("d", [1, 2, 3, 5])
def test_emulated_resolver_on_rle(resolve_emulated, d):
    rows = [list(range(1, d + 1)) + [SC._match(258, d)] * 70,
            list(range(7, 7 + d)) + [SC._match(3 + i * 7 % 256, d) for i in range(140)]]
    got, want = resolve_emulated(rows, 3 * TR.OUT_BYTES)
    assert torch.equal(got, want)


def test_emulated_resolver_on_token_cases_past_ntok_and_cut(resolve_emulated):
    """The token cases with stray literals or matches past ntok; ntok past
    the row's capacity and below 0; a long row cut at no_pad mid-match."""
    rows = [t for _, t in SC.token_cases()] * 2 + [SC.window_tokens(12_000, seed=7)]
    ntok = [len(t) for t in rows]
    ntok[-1] = 1 << 30
    ntok[0] = -5
    fills = [0x41 if i % 2 else SC._match(100, 3) for i in range(len(rows))]
    got, want = resolve_emulated(rows, TR.OUT_BYTES, ntok, fills)
    assert torch.equal(got, want)
    assert int(want[-1, -1]) != 0                 # the cut row fills its capacity



# ---------------------------------------------------------------------------
# the bit packs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,NU", [(5, 9000), (3, 4096), (3, 4097), (2, 1)])
def test_emulated_packs_equal_twins(B, NU):
    """Random units, 60% of the widths zero, an all-zero row, a row of
    width 28, a row whose bits run past n_words; NU a multiple of the
    tile, not one, and tiny."""
    batch = _entry("pack", "pack_batch_launch", TK._ARGTYPES_BATCH)
    rng = np.random.default_rng(NU)
    w = rng.integers(0, TK.MAX_WIDTH + 1, (B, NU)).astype(np.int32)
    w[rng.random((B, NU)) < 0.6] = 0
    if B > 2:
        w[1] = 0
        w[2] = TK.MAX_WIDTH
    v = rng.integers(-2**31, 2**31, (B, NU), dtype=np.int64).astype(np.int32)
    n_words = int(w[0].sum()) // 32 + 2        # row 0 fits, longer rows are cut
    vals, wids = torch.from_numpy(v), torch.from_numpy(w)

    def run(vals, wids):
        rows = vals.shape[0]
        words, bits, sums = TK._batch_buffers(rows, NU, n_words, "cpu")
        words.fill_(0x5A5A5A5A)
        bits.fill_(-7)
        assert batch(vals.data_ptr(), wids.data_ptr(), words.data_ptr(), bits.data_ptr(),
                     sums.data_ptr(), rows, NU, n_words, TK.ALL_PASSES, None) == 0
        return words, bits

    words, bits = run(vals, wids)
    want_words, want_bits = TK.pack_units_batch_ref(vals, wids, n_words)
    assert torch.equal(words, want_words) and torch.equal(bits, want_bits)
    if B > 2:
        assert int(want_bits[2]) > 32 * n_words
    # the one-row call that pack_units_dense makes, against its own twin
    for b in range(B):
        row, total = run(vals[b:b + 1].contiguous(), wids[b:b + 1].contiguous())
        want_row, want_total = TK.pack_units_ref(vals[b], wids[b], n_words)
        assert torch.equal(row[0], want_row) and torch.equal(total[0], want_total)


# ---------------------------------------------------------------------------
# the lane kernels
# ---------------------------------------------------------------------------

def _lane_streams():
    """The lane and rule cases, zlib level-1 and level-9 shards of text and
    records, and empty streams for the rest of one wave."""
    data = _corpus(24 * LI.SEGB, 11)
    shards = [data[i * LI.SEGB:(i + 1) * LI.SEGB] for i in range(24)]
    return lane_cases() + rule_cases() + [zlib.compress(sh, 1 + 8 * (i % 2))[2:-4]
                                          for i, sh in enumerate(shards)]


def _resolve_emulated(outlen, tok, step_major):
    """The emulated kernel BC on one wave, as each entry gives it its
    input: kernel A's step-major tok as it is (``resolve_steps``), or
    lane-major tok_lm relaid step-major (``resolve_waves``); what it does
    not write shows as a difference."""
    resolve = _entry("lanes_resolve", "lanes_resolve_launch", LR._ARGTYPES)
    tok = tok if step_major else LR.step_major(tok)
    out = torch.full((1, LR.GROUPS, LI.NSTR, LI.LANE), 0x5A5A5A5A, dtype=torch.int32)
    assert resolve(outlen.data_ptr(), tok.data_ptr(), out.data_ptr(), 1, None) == 0
    return out


@pytest.fixture(scope="module")
def lanes_emulated():
    parse = _entry("lanes_parse", "lanes_parse_launch", LI._ARGTYPES)
    nbits, inw = LI.stage_streams_lanes(_lane_streams(), 1, device="cpu")
    # what the kernels do not write shows as a difference
    tok = torch.full((1, LI.TOK_CHUNKS, 128, LI.SUB, LI.LANE), 0x5A5A5A5A, dtype=torch.int32)
    misc = torch.full((1, 4, LI.SUB, LI.LANE), -99, dtype=torch.int32)
    scratch = torch.full((LI.NSTR * LI.SCRATCH,), 0x5A5A5A5A, dtype=torch.int32)
    assert parse(nbits.data_ptr(), inw.data_ptr(), tok.data_ptr(), misc.data_ptr(),
                 scratch.data_ptr(), LI.NSTR, None) == 0
    want_tok, want_misc = LI.parse_waves_ref(nbits, inw, 1)
    # the resolver on the twin's tokens, so that each kernel is held alone
    tok_lm = LR.lane_major(want_tok)
    outlen = want_misc[:, 1].contiguous()
    return {"tok": (tok, want_tok), "misc": (misc, want_misc),
            "out": (_resolve_emulated(outlen, tok_lm, False),
                    LR.resolve_waves_ref(outlen, tok_lm, 1)),
            "out_steps": _resolve_emulated(outlen, want_tok, True)}


def test_emulated_lanes_parse_tokens_equal_twin(lanes_emulated):
    got, want = lanes_emulated["tok"]
    bad = (got != want).reshape(LI.TOK_ROWS, LI.NSTR).any(0).nonzero()[:, 0].tolist()
    assert not bad, f"streams whose tokens differ: {bad[:20]}"


@pytest.mark.parametrize("row", [0, 1, 2])
def test_emulated_lanes_parse_misc_equals_twin(lanes_emulated, row):
    got, want = lanes_emulated["misc"]
    assert torch.equal(got[:, row], want[:, row])
    if row == 0:
        assert set(want[0, 0].reshape(-1).tolist()) == {
            LI.ST_DONE, LI.ST_CORRUPT, LI.ST_TRUNC, LI.ST_OVERFLOW}
    assert not got[:, 3].any()


def test_emulated_lanes_resolve_equals_twin(lanes_emulated):
    got, want = lanes_emulated["out"]
    assert torch.equal(got, want)


def test_emulated_lanes_resolve_on_step_major_tokens_equals_twin(lanes_emulated):
    """The same kernel reading kernel A's layout as kernel A wrote it."""
    assert torch.equal(lanes_emulated["out_steps"], lanes_emulated["out"][1])


@pytest.fixture(scope="module")
def token_cases_emulated():
    """The hand-made token rows of ``utils/lane_cases.py`` through both
    entries of the emulated kernel BC and through the twin."""
    cases = token_cases()
    outlen, tok = (torch.from_numpy(a) for a in token_wave(cases))
    tok_lm = LR.lane_major(tok)
    return {"groups": [g for g, _, _ in cases],
            "want": LR.resolve_waves_ref(outlen, tok_lm, 1),
            True: _resolve_emulated(outlen, tok, True),
            False: _resolve_emulated(outlen, tok_lm, False)}


def _stream_bytes(out, i):
    return out[0, :, i, :].reshape(-1).numpy().astype("<u4").tobytes()


@pytest.mark.parametrize("step_major", [True, False], ids=["step_major", "lane_major"])
@pytest.mark.parametrize("group", ["long_block", "rle", "chain", "edge", "outlen",
                                   "gaps", "random"])
def test_emulated_lanes_resolve_token_cases(token_cases_emulated, group, step_major):
    got, want = token_cases_emulated[step_major], token_cases_emulated["want"]
    idx = [i for i, g in enumerate(token_cases_emulated["groups"]) if g == group]
    assert idx
    for i in idx:
        assert _stream_bytes(got, i) == _stream_bytes(want, i), (group, i)
    if group == "long_block":
        assert not torch.equal(want[0, :, idx[0]], torch.zeros_like(want[0, :, idx[0]]))
        assert not want[0, :, idx[1]:idx[-1] + 1].any()


def test_emulated_lanes_resolve_token_cases_leave_the_rest_zero(token_cases_emulated):
    n = len(token_cases_emulated["groups"])
    for step_major in (True, False):
        got = token_cases_emulated[step_major]
        assert torch.equal(got, token_cases_emulated["want"])
        assert not got[0, :, n:].any()


def test_token_cases_reach_the_rules():
    """The hand-made rows hold what their groups promise."""
    cases = token_cases()
    assert len(cases) <= LI.NSTR
    assert [g for g, _, _ in cases[:8]] == ["long_block"] * 8
    assert len(cases[0][2]) == LI.SEGB and not any(len(r) for _, _, r in cases[1:8])
    dists = {r & 8191 for g, _, rows in cases if g == "rle" for r in rows if r < 0}
    assert dists == set(range(1, 34))
    outlens = {n for g, n, _ in cases if g == "outlen"}
    assert {0, LI.SEGB}.issubset(outlens) and min(outlens) < 0 and max(outlens) > LI.SEGB
    assert all(len(rows) <= LI.TOK_ROWS for _, _, rows in cases)
    assert max(len(rows) for g, _, rows in cases if g == "outlen") > LI.TOK_ROWS - 128
    # a tile of 128 match records after the first, while the next stream
    # of the same block of 8 holds matches of its first tile in its queue
    full = [i for i, (_, _, rows) in enumerate(cases)
            if any(len(rows[k:k + 128]) == 128
                   and all(r < 0 and (r >> 13) & 511 for r in rows[k:k + 128])
                   for k in range(128, len(rows), 128))]
    assert any(i % 8 < 7 and any(r < 0 for r in cases[i + 1][2][:128])
               and len(cases[i + 1][2]) <= 128 for i in full)


def _first_tables():
    """The tables of the first block of every stream that opens with a
    Huffman block and builds it: (name, fc, base, rank entries, root bits)
    for each alphabet."""
    streams = _lane_streams()
    st = LI._Lanes(*LI.stage_streams_lanes(streams, 1, device="cpu"), 1)
    n = len(streams)
    typ = (st.words[:n, 0] >> 1) & 3
    out = []
    for dyn in (False, True):
        idx = (typ == (2 if dyn else 1)).nonzero()[:, 0]
        _, ok, (fcl, bal, fcd, bad), (maplit, mapdist) = LI._huffman_build(
            st.words[idx], st.nbits[idx], torch.full((len(idx),), dyn), torch.full_like(idx, 3))
        bits = LI.DYN_ROOT_BITS if dyn else LI.FIX_ROOT_BITS
        for k in ok.nonzero()[:, 0].tolist()[: None if dyn else 1]:
            i = int(idx[k])
            out.append((f"stream {i} literal/length", fcl[k], bal[k], maplit[k], bits[0]))
            out.append((f"stream {i} distance", fcd[k], bad[k], mapdist[k], bits[1]))
    return out


def test_lanes_root_decode_model_equals_length_counting():
    """Every 15-bit pattern through the kernel's table decode (the root,
    else length counting) and through the twin's length counting, on the
    fixed code and on each dynamic code the cases open with: among them
    codes longer than the root and one distance code of length 1."""
    lo = torch.arange(1 << 15, dtype=torch.int64)
    tables = _first_tables()
    slow_patterns = 0
    for name, fc, base, entries, bits in tables:
        root = LI.root_table_ref(fc, base, entries, bits)
        ln, entry, matched = LI.root_decode_ref(lo, root, bits, fc, base, entries)
        w_ln, w_rank, w_matched = LI._length_decode(lo, fc.expand(len(lo), -1),
                                                    base.expand(len(lo), -1))
        w_entry = entries[w_rank.clamp(max=len(entries) - 1)]
        assert torch.equal(matched, w_matched), name
        assert torch.equal(ln[matched], w_ln[matched]), name
        assert torch.equal(entry[matched], w_entry[matched]), name
        slow = root[0][lo & ((1 << bits) - 1)] == 0
        slow_patterns += int((slow & matched).sum())
        if bits in LI.FIX_ROOT_BITS:
            assert not slow.any(), f"{name}: the fixed root misses a code"
    halves = [name for name, fc, *_ in tables
              if int(fc[0]) & 511 == 1 and not (fc[1:] & 511).any()]
    assert halves, "no distance code of one code of length 1"
    assert slow_patterns > 0, "no code longer than its root"
    assert len(tables) > 10
