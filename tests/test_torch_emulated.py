"""The CUDA sources of the walk (``csrc/walk.cu``) and of the symbol
parser (``csrc/parse.cu``), compiled for the CPU by ``kernels/emulate.py``
(one OS thread a CUDA thread) and held exactly against their plain twins.

This tests the kernels' own logic (tiles, entries, the fast loop, the
turns of the parsing lane, table builds, stored-block copies) without a
card, at small shapes.  It cannot stand in for the card: chip_smoke.py
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
from moonbit_flate_tpu_torch.ops import parse as TP
from moonbit_flate_tpu_torch.ops import pipeline as TPL
from moonbit_flate_tpu_torch.ops import walk as TW
from moonbit_flate_tpu_torch.utils import stream_cases as SC
from moonbit_flate_tpu_torch.utils.lane_cases import lane_cases, rule_cases

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
