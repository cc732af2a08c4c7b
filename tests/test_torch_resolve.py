"""Port parity of the scalar-path resolver: moonbit_flate_tpu_torch's
``ops/resolve.py`` against the JAX package's ``ops/resolve_pallas.py``
(interpret mode) and its plain resolver ``resolve_tokens_batch``, exact,
on the CPU.

The cases are those of tests/test_resolve_pallas.py: zlib token streams
in a batch, overlapping copies at distances 1, 2, 3 and 5, a copy across
the 8192-byte boundary, zeroed padding; then tokens past ``ntok``, an
output that stops at ``no_pad``, and the token rows of
``utils/stream_cases.py``.  The port's wrapper gets CPU tensors and so
takes its plain twin; the CUDA kernel is held against the same twin on
the card by chip_smoke.py, and on the CPU by test_torch_emulated.py.

The plain model of the kernel's rounds, ``resolve_rounds_ref``, is held
against the twin and the JAX kernel on the same cases and on rows made
for the rounds (a match across every window's end, a window inside one
long match, a chain of matches in one window) at windows of 64 and 256
bytes, where a few kilobytes of output meet every boundary.
"""

import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonbit_flate_tpu.inflate import tpu_inflate as JI
from moonbit_flate_tpu.ops import resolve_pallas as JR
from moonbit_flate_tpu_torch import native
from moonbit_flate_tpu_torch.inflate.cuda_inflate import scan_tokens
from moonbit_flate_tpu_torch.ops import resolve as TR
from moonbit_flate_tpu_torch.utils import stream_cases as SC
from moonbit_flate_tpu_torch.utils.stream_cases import token_cases

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scanner():
    try:
        native.scanner()
    except RuntimeError as e:
        pytest.skip(f"host scanner unavailable: {e}")


def _toks(data, level=6):
    return scan_tokens(zlib.compress(data, level)[2:-4])


def _out_len(t):
    return int(np.where(t < 0, ((t >> 15) & 0xFF) + 3, 1).sum())


def _pack(tokens_list, nt_pad=None):
    B = len(tokens_list)
    nt = max(max((len(t) for t in tokens_list), default=1), 1)
    nt_pad = nt_pad or -(-nt // 1024) * 1024
    toks = np.zeros((B, nt_pad), np.int32)
    ntok = np.zeros(B, np.int32)
    for i, t in enumerate(tokens_list):
        toks[i, : len(t)] = t
        ntok[i] = len(t)
    return toks, ntok, nt_pad


def _both(toks, ntok, nt_pad, no_pad):
    """(port words, JAX words) of one batch, as numpy int32[B, no_pad/4]."""
    want = JR.resolve_batch_pallas(jnp.asarray(toks), jnp.asarray(ntok), nt_pad,
                                   no_pad, interpret=True)
    before = TR.launches
    got = TR.resolve_batch(torch.from_numpy(toks), torch.from_numpy(ntok), nt_pad,
                           no_pad)
    assert TR.launches == before            # CPU tensors launch no kernel
    assert got.dtype == torch.int32
    return got.numpy(), np.asarray(want)


def _check(datas, level=6):
    tl = [_toks(d, level) for d in datas]
    toks, ntok, nt_pad = _pack(tl)
    no_pad = -(-(max(map(len, datas)) + 1) // TR.OUT_BYTES) * TR.OUT_BYTES
    got, want = _both(toks, ntok, nt_pad, no_pad)
    assert np.array_equal(got, want)
    flat = got.view(np.uint8).reshape(len(datas), no_pad)
    for i, d in enumerate(datas):
        assert flat[i, : len(d)].tobytes() == d
        assert not flat[i, len(d):].any()       # padding is zeroed


def test_constants_equal_jax_package():
    assert TR.OUT_BYTES == JR.OUT_BYTES


def test_zlib_token_roundtrip_batch(scanner):
    rng = np.random.default_rng(1)
    _check([
        b"hello world, " * 40,
        bytes(rng.integers(0, 256, 1000, np.uint8)),           # literals
        b"\x00" * 3000,                                         # RLE d=1
        (b"abcdefg" * 300)[:1900],                              # period 7
        b"x" + b"yz" * 5 + bytes(rng.integers(0, 256, 50, np.uint8)) * 30,
    ])


def test_copy_straddles_chunk_boundary(scanner):
    head = bytes(np.random.default_rng(2).integers(0, 256, 300, np.uint8))
    data = (head * ((TR.OUT_BYTES + 2000) // 300 + 2))[: TR.OUT_BYTES + 1500]
    _check([data])


@pytest.mark.parametrize("d", [1, 2, 3, 5])
def test_overlapping_rle_copies(scanner, d):
    _check([bytes(range(d)) * 400])


def test_padding_is_zeroed(scanner):
    _check([b"q" * 100])


# rows whose source lies before the stream's start: the JAX kernel reads
# its uncleared window there, the port defines the byte as 0
_UNDEFINED_IN_JAX = {"before_start", "match_first"}


def test_token_cases_equal_jax():
    rows = [t for name, t in token_cases() if name not in _UNDEFINED_IN_JAX]
    toks, ntok, nt_pad = _pack(rows)
    no_pad = -(-(max(map(_out_len, rows)) + 1) // TR.OUT_BYTES) * TR.OUT_BYTES
    got, want = _both(toks, ntok, nt_pad, no_pad)
    assert np.array_equal(got, want)


def test_source_before_the_start_reads_zero():
    cases = dict(token_cases())
    toks, ntok, nt_pad = _pack([cases["before_start"], cases["match_first"]])
    out = TR.resolve_batch(torch.from_numpy(toks), torch.from_numpy(ntok), nt_pad,
                           TR.OUT_BYTES).numpy().view(np.uint8)
    # A B, then 20 bytes from 5 back: three before the start, then A B,
    # repeating with period 5; C; then 9 bytes from 30 back
    first = bytearray(b"AB")
    for q in range(20):
        s = 2 - 5 + q % 5
        first.append(first[s] if s >= 0 else 0)
    first += b"C"
    for q in range(9):
        s = 23 - 30 + q % 30
        first.append(first[s] if s >= 0 else 0)
    assert out[0, : len(first)].tobytes() == bytes(first)
    assert not out[0, len(first):].any()
    assert out[1, :11].tobytes() == bytes(10) + b"A" and not out[1, 11:].any()


def test_tokens_past_ntok_are_ignored(scanner):
    t = _toks(b"only the first tokens count " * 30)
    toks, ntok, nt_pad = _pack([t, t])
    toks[0, len(t):] = 0x41                       # stray literals past ntok
    toks[1, len(t) // 2:] = -(1 << 31) | 7        # stray matches past ntok
    ntok[1] = len(t) // 2
    got, want = _both(toks, ntok, nt_pad, TR.OUT_BYTES)
    assert np.array_equal(got, want)


def test_full_token_row_ending_in_a_match():
    """No padded token follows the last match: what lies past it is 0."""
    rng = np.random.default_rng(5)
    row = rng.integers(0, 256, 1024).astype(np.int32)
    row[-1] = -(1 << 31) | ((20 - 3) << 15) | (7 - 1)
    toks, ntok, nt_pad = _pack([row])
    assert ntok[0] == nt_pad == 1024
    got, want = _both(toks, ntok, nt_pad, TR.OUT_BYTES)
    assert np.array_equal(got, want)
    assert not got.view(np.uint8)[0, 1043:].any()


def test_output_stops_at_no_pad(scanner):
    data = (b"0123456789abcdef" * 40 + bytes(range(256))) * 12   # > 8192 bytes
    assert len(data) > TR.OUT_BYTES + 300
    toks, ntok, nt_pad = _pack([_toks(data), _toks(b"short")])
    got, want = _both(toks, ntok, nt_pad, TR.OUT_BYTES)
    assert np.array_equal(got, want)
    assert got.view(np.uint8).reshape(2, -1)[0].tobytes() == data[: TR.OUT_BYTES]


def test_wrapper_checks_geometry():
    toks = torch.zeros(1, 1024, dtype=torch.int32)
    n = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        TR.resolve_batch(toks, n, 1024, 1000)
    with pytest.raises(ValueError, match="int32"):
        TR.resolve_batch(toks.long(), n, 1024, TR.OUT_BYTES)


@pytest.mark.parametrize("B", [1, 3])
def test_resolve_tokens_batch_equals_jax(scanner, B):
    rng = np.random.default_rng(3)
    datas = [b"the quick brown fox " * 60
             + bytes(rng.integers(0, 256, 400, np.uint8)) + b"Z" * 500,
             b"ab" * 900, bytes(rng.integers(0, 256, 700, np.uint8))][:B]
    toks, _, nt_pad = _pack([_toks(d) for d in datas])
    no_pad = -(-(max(map(len, datas)) + 1) // TR.OUT_BYTES) * TR.OUT_BYTES
    want, want_len = JI.resolve_tokens_batch(jnp.asarray(toks), nt_pad, no_pad)
    got, got_len = TR.resolve_tokens_batch(torch.from_numpy(toks), nt_pad, no_pad)
    assert got.dtype == torch.uint8 and got_len.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_len.numpy(), np.asarray(want_len))
    for i, d in enumerate(datas):
        assert got[i, : len(d)].numpy().tobytes() == d


def test_twin_equals_plain_resolver_on_valid_tokens(scanner):
    """The kernel's twin and the plain resolver agree wherever both are
    defined: the bytes of the real output."""
    data = b"twin and resolver " * 100 + b"\x07" * 900
    t = _toks(data, 9)
    toks, ntok, nt_pad = _pack([t])
    words = TR.resolve_batch_ref(torch.from_numpy(toks), torch.from_numpy(ntok),
                                 nt_pad, TR.OUT_BYTES)
    plain, _ = TR.resolve_tokens_batch(torch.from_numpy(toks), nt_pad, TR.OUT_BYTES)
    assert words.numpy().view(np.uint8)[0, : len(data)].tobytes() == data
    assert plain[0, : len(data)].numpy().tobytes() == data


# ---------------------------------------------------------------------------
# the plain model of the kernel's rounds, at windows of 64 and 256 bytes
# ---------------------------------------------------------------------------

def _no_pad_for(n_out):
    return -(-(n_out + 1) // TR.OUT_BYTES) * TR.OUT_BYTES


def _data_rows(datas, level=6):
    toks, ntok, nt_pad = _pack([_toks(d, level) for d in datas])
    return toks, ntok, nt_pad, _no_pad_for(max(map(len, datas)))


def _token_rows(rows, no_pad=None):
    toks, ntok, nt_pad = _pack(rows)
    return toks, ntok, nt_pad, no_pad or _no_pad_for(max(map(_out_len, rows)))


def _straddling_row(window, n_out=3000, seed=0):
    """A row whose every round but the last ends in a match that runs past
    the round's window: literals and short matches until the window's end
    is less than a match away, then a match across it."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, 256, 8).tolist()
    p, wend = len(row), window
    while p < n_out:
        if p >= wend:                       # the next round's window
            wend = (p & ~15) + window
        gap = wend - p
        if gap < 258:
            length = max(3, min(258, gap + 1 + int(rng.integers(0, 40))))
        elif rng.random() < 0.5:
            row.append(int(rng.integers(0, 256)))
            p += 1
            continue
        else:
            length = int(rng.integers(3, 20))
        row.append(SC._match(length, int(rng.integers(1, p + 1))))
        p += length
    return np.asarray(row, np.int32)



def _chain_row():
    """Eight literals, then matches at distances under 9 that copy the
    bytes of the matches before them: one chain, all in the first window."""
    rng = np.random.default_rng(4)
    row = rng.integers(0, 256, 8).tolist()
    for length, dist in ((5, 3), (7, 4), (9, 8), (4, 6), (6, 1), (3, 7), (8, 5)):
        row.append(SC._match(length, dist))
    return np.asarray(row, np.int32)


def _past_ntok():
    t = _toks(b"only the first tokens count " * 30)
    toks, ntok, nt_pad = _pack([t, t])
    toks[0, len(t):] = 0x41
    toks[1, len(t) // 2:] = -(1 << 31) | 7
    ntok[1] = len(t) // 2
    return toks, ntok, nt_pad, TR.OUT_BYTES


def _row_ending_in_a_match():
    row = np.random.default_rng(5).integers(0, 256, 1024).astype(np.int32)
    row[-1] = SC._match(20, 7)
    return _token_rows([row], TR.OUT_BYTES)


def _cut_at_no_pad():
    data = (b"0123456789abcdef" * 40 + bytes(range(256))) * 12
    toks, ntok, nt_pad = _pack([_toks(data), _toks(b"short")])
    return toks, ntok, nt_pad, TR.OUT_BYTES


def _zlib_batch():
    rng = np.random.default_rng(1)
    return _data_rows([b"hello world, " * 40, bytes(rng.integers(0, 256, 1000, np.uint8)),
                       b"\x00" * 3000, (b"abcdefg" * 300)[:1900],
                       b"x" + b"yz" * 5 + bytes(rng.integers(0, 256, 50, np.uint8)) * 30])


# name -> (rows(window), needs the host scanner, defined in the JAX kernel)
_ROUND_CASES = {
    "zlib_batch": (lambda w: _zlib_batch(), True, True),
    "copy_across_8k": (lambda w: _data_rows([(bytes(np.random.default_rng(2).integers(
        0, 256, 300, np.uint8)) * 40)[: TR.OUT_BYTES + 1500]]), True, True),
    **{f"rle_d{d}": ((lambda w, d=d: _data_rows([bytes(range(d)) * 400])), True, True)
       for d in (1, 2, 3, 5)},
    "padding": (lambda w: _data_rows([b"q" * 100]), True, True),
    "token_cases": (lambda w: _token_rows([t for name, t in token_cases()
                                           if name not in _UNDEFINED_IN_JAX]), False, True),
    "before_start": (lambda w: _token_rows([t for name, t in token_cases()
                                            if name in _UNDEFINED_IN_JAX]), False, False),
    "past_ntok": (lambda w: _past_ntok(), True, True),
    "row_ending_in_a_match": (lambda w: _row_ending_in_a_match(), False, True),
    "cut_at_no_pad": (lambda w: _cut_at_no_pad(), True, True),
    "straddle_every_window": (lambda w: _token_rows([_straddling_row(w, seed=s)
                                                     for s in range(3)]), False, True),
    "window_inside_a_long_match": (lambda w: _token_rows(
        [np.asarray(list(range(10)) + [SC._match(258, 1)] * 20, np.int32),
         np.asarray(list(range(40)) + [SC._match(258, 37)] * 3 + [7] + [SC._match(258, 3)] * 5,
                    np.int32)]), False, True),
    "chain_in_one_window": (lambda w: _token_rows([_chain_row()]), False, True),
    "window_rows": (lambda w: _token_rows([SC.window_tokens(5000, seed=s)
                                           for s in range(2)]), False, True),
}
_jax_words = {}


@pytest.mark.parametrize("window", [64, 256])
@pytest.mark.parametrize("case", sorted(_ROUND_CASES))
def test_rounds_model_equals_twin_and_jax(request, case, window):
    rows, needs_scanner, in_jax = _ROUND_CASES[case]
    if needs_scanner:
        request.getfixturevalue("scanner")
    toks, ntok, nt_pad, no_pad = rows(window)
    if case == "straddle_every_window":
        for t in toks:
            rounds = TR.round_bounds(torch.from_numpy(t[t != 0]), no_pad, window)
            assert len(rounds) > 10
            for w0, k0, k1, e in rounds[:-1]:
                assert e > window, "a round ends inside its window"
    got = TR.resolve_rounds_ref(torch.from_numpy(toks), torch.from_numpy(ntok), nt_pad,
                                no_pad, window)
    want = TR.resolve_batch_ref(torch.from_numpy(toks), torch.from_numpy(ntok), nt_pad,
                                no_pad)
    assert torch.equal(got, want)
    if in_jax:
        key = (case, window) if case == "straddle_every_window" else case
        if key not in _jax_words:
            _jax_words[key] = np.asarray(JR.resolve_batch_pallas(
                jnp.asarray(toks), jnp.asarray(ntok), nt_pad, no_pad, interpret=True))
        assert np.array_equal(got.numpy(), _jax_words[key])


def test_window_equals_the_kernel_constant():
    src = (Path(TR.__file__).parents[1] / "csrc" / "resolve.cu").read_text()
    assert f"constexpr int kWindow = {TR.WINDOW};" in src
    assert f"constexpr int kMaxMatch = {TR.MAX_MATCH};" in src


def test_round_bounds_cover_the_output():
    """Rounds take the tokens in order, each at least one, and every
    window starts on 16 bytes at most 15 before its first token."""
    row = torch.from_numpy(SC.window_tokens(40_000, seed=3))
    length, _, start = TR._fields(row.long())
    for window in (16, 64, 4096, TR.WINDOW):
        rounds = TR.round_bounds(row, 1 << 20, window)
        assert rounds[0][1] == 0 and rounds[-1][2] == len(row)
        for (w0, k0, k1, e), nxt in zip(rounds, rounds[1:] + [None]):
            assert w0 % 16 == 0 and 0 <= start[k0] - w0 < 16 and k1 > k0
            assert e == int(start[k1 - 1] + length[k1 - 1]) - w0 <= window - 1 + TR.MAX_MATCH
            assert nxt is None or nxt[1] == k1
    with pytest.raises(ValueError, match="multiple of 16"):
        TR.round_bounds(row, 1 << 20, 100)
