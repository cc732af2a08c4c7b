"""Port parity of the scalar-path decode as a whole:
moonbit_flate_tpu_torch's ``inflate/cuda_inflate.py`` against the JAX
package's ``inflate/tpu_inflate.py``, exact, on the CPU: the same bytes
from ``decompress_segments`` (the JAX side with its Pallas parser in
interpret mode) and ``decompress``, the same tokens from the host
scanner, and the same exception types for truncated, corrupt and
oversized streams.  ``device="cpu"`` takes the kernels' plain twins.
"""

import os
import zlib

import numpy as np
import pytest
import torch

import moonbit_flate_tpu_torch as mft
from moonbit_flate_tpu import compress as mf_compress
from moonbit_flate_tpu.inflate import tpu_inflate as JI
from moonbit_flate_tpu.utils import errors as JE
from moonbit_flate_tpu_torch import native
from moonbit_flate_tpu_torch.api.cuda import CUDACompressor
from moonbit_flate_tpu_torch.inflate import cuda_inflate as TI
from moonbit_flate_tpu_torch.ops import parse as TP
from moonbit_flate_tpu_torch.ops import resolve as TR
from moonbit_flate_tpu_torch.utils import errors as TE

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def scanner():
    try:
        native.scanner()
    except RuntimeError as e:
        pytest.skip(f"host scanner unavailable: {e}")


def _raw(data, level=6, **kw):
    co = zlib.compressobj(level, zlib.DEFLATED, -15, **kw)
    return co.compress(data) + co.flush()


def _segment_payloads():
    """The payloads of test_tpu_decode.py's segment test."""
    rng = np.random.default_rng(9)
    return [b"segment zero " * 50, rng.integers(0, 256, 900, np.uint8).tobytes(),
            b"ab" * 700, b""]


def _decode_cases():
    """The payloads of test_tpu_decode.py's round-trip test."""
    rng = np.random.default_rng(0)
    return [
        b"", b"x", b"hello world " * 5,
        b"a" * 100000,                       # deep dist-1 RLE chains
        b"abcdef" * 50000,                   # periodic
        rng.integers(0, 256, 150000, np.uint8).tobytes(),
        b"The quick brown fox jumps over the lazy dog. " * 5000,
    ]


# ---- the host scanner --------------------------------------------------------

def test_native_library_is_the_ports_own():
    path = native._lib_path()
    assert "moonbit_flate_tpu_torch/_build" in path.replace("\\", "/")
    native.scanner()
    assert os.path.exists(path)


@pytest.mark.parametrize("i", range(7))
def test_scan_tokens_equals_jax(i):
    data = _decode_cases()[i]
    for lvl in (0, 1, 6, 9):
        s = _raw(data, lvl)
        got, want = TI.scan_tokens(s), JI.scan_tokens(s)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_scan_tokens_with_dictionary_equals_jax():
    d = b"shared dictionary content! " * 100
    s = _raw(b"shared dictionary content! and more", zdict=d)
    assert np.array_equal(TI.scan_tokens(s, d), JI.scan_tokens(s, d))
    with pytest.raises(TE.CorruptInputError):
        TI.scan_tokens(s)                   # the distances reach into the dictionary
    with pytest.raises(JE.CorruptInputError):
        JI.scan_tokens(s)


@pytest.mark.parametrize("kind", ["truncated", "corrupt"])
def test_scan_tokens_raises_like_jax(kind):
    good = _raw(b"truncate me " * 100)
    s = good[: len(good) // 2] if kind == "truncated" else b"\x01\x05\x00\x00\x00hello"
    want = {"truncated": "UnexpectedEOFError", "corrupt": "CorruptInputError"}[kind]
    with pytest.raises(getattr(JE, want)):
        JI.scan_tokens(s)
    with pytest.raises(getattr(TE, want)):
        TI.scan_tokens(s)


# ---- decompress_segments -----------------------------------------------------

def _own_streams():
    """The port's own encoder output: two one-block segments and the
    final empty stored block, one stream."""
    data = (b"the port's own encoder " * 60 + bytes(range(256)) * 3)[:2000]
    return data, CUDACompressor(blocks_per_segment=1, device="cpu").compress(data)


def test_decompress_segments_equals_jax():
    payloads = _segment_payloads()
    streams = [_raw(p) for p in payloads]
    own_data, own = _own_streams()
    payloads.append(own_data)
    streams.append(own)
    payloads.append(b"level one " * 300)
    streams.append(_raw(payloads[-1], 1))
    sizes = [len(p) for p in payloads]
    want = JI.decompress_segments(streams, sizes, interpret=True)
    before = (TP.launches, TR.launches)
    got = mft.decompress_segments(streams, sizes, device="cpu")
    assert (TP.launches, TR.launches) == before     # CPU tensors launch no kernel
    assert got == want == payloads


def test_decompress_segments_sub_batches(monkeypatch):
    """More streams than one sub-batch holds: same bytes, in order."""
    payloads = [bytes([65 + i]) * (50 + 7 * i) + b"tail" for i in range(7)]
    streams = [_raw(p, 1) for p in payloads]
    monkeypatch.setitem(TI._SUB_TOKEN_BYTES, "cpu", 3 * 4 * 8192)   # 3 streams each
    calls = []
    real = TI._parse_resolve
    monkeypatch.setattr(TI, "_parse_resolve",
                        lambda nb, *a: calls.append(len(nb)) or real(nb, *a))
    assert mft.decompress_segments(streams, [len(p) for p in payloads],
                                   device="cpu") == payloads
    assert calls == [3, 3, 1]


def _bad_segment_calls():
    good = _raw(b"segment zero " * 50)
    big = _raw(b"truncate me " * 100)
    return {
        "truncated": ([good, big[: len(big) // 2]], [650, 1200], "UnexpectedEOFError"),
        "corrupt": ([good, bytes([0x06]) + big[1:]], [650, 1200], "CorruptInputError"),
        "bound_below_size": ([good, big], [650, 1199], "ValueError"),
        # the capacity (one chunk of 8192 tokens) runs out before the bound is seen
        "capacity_exhausted": (
            [good, _raw(np.random.default_rng(4).integers(0, 256, 9000, np.uint8)
                        .tobytes(), 0)], [650, 100], "ValueError"),
        # the first failing stream decides: truncated comes before corrupt
        "first_failure_wins": ([big[: len(big) // 2], bytes([0x07])], [1200, 10],
                               "UnexpectedEOFError"),
    }


@pytest.mark.parametrize("kind", sorted(_bad_segment_calls()))
def test_decompress_segments_raises_like_jax(kind):
    streams, sizes, name = _bad_segment_calls()[kind]
    want = ValueError if name == "ValueError" else getattr(JE, name)
    got = ValueError if name == "ValueError" else getattr(TE, name)
    with pytest.raises(want) as jerr:
        JI.decompress_segments(streams, sizes, interpret=True)
    with pytest.raises(got) as terr:
        mft.decompress_segments(streams, sizes, device="cpu")
    if name == "ValueError":
        assert str(terr.value) == str(jerr.value)


def test_decompress_segments_of_nothing():
    assert mft.decompress_segments([], [], device="cpu") == []


# ---- decompress ----------------------------------------------------------------

@pytest.mark.parametrize("i", range(7))
def test_decompress_equals_jax(i):
    t = _decode_cases()[i]
    for lvl in (0, 1, 6, 9):
        s = _raw(t, lvl)
        assert mft.decompress(s, backend="cuda", device="cpu") == JI.decompress(s) == t
    s = mf_compress(t)
    assert mft.decompress(s, backend="cuda", device="cpu") == JI.decompress(s) == t


def test_decompress_own_encoder_output():
    data, s = _own_streams()
    assert mft.decompress(s, backend="cuda", device="cpu") == JI.decompress(s) == data


def test_decompress_preset_dictionary_equals_jax():
    d = b"shared dictionary content! " * 100
    s = _raw(b"shared dictionary content! and more", zdict=d)
    want = JI.decompress(s, dictionary=d)
    assert mft.decompress(s, dictionary=d, backend="cuda", device="cpu") == want
    assert want == b"shared dictionary content! and more"
    # a dictionary routes around the device parser, as in the JAX package
    assert TI.decompress(s, dictionary=d, parse_on_device=True, device="cpu") == want


@pytest.mark.parametrize("parse_on_device", [False, True])
def test_decompress_corrupt_raises_like_jax(parse_on_device):
    with pytest.raises(JE.FlateError):
        JI.decompress(b"\x01\x05\x00\x00\x00hello")
    with pytest.raises(TE.CorruptInputError):
        TI.decompress(b"\x01\x05\x00\x00\x00hello", parse_on_device=parse_on_device,
                      device="cpu")
    good = _raw(b"truncate me " * 100)
    with pytest.raises(TE.UnexpectedEOFError):
        TI.decompress(good[: len(good) // 2], parse_on_device=parse_on_device,
                      device="cpu")


def test_decompress_parse_on_device():
    payload = b"on-device stage A parse " * 40
    s = _raw(payload)
    assert TI.decompress(s, parse_on_device=True, device="cpu") == payload
    assert np.array_equal(TI.scan_tokens_device(s, device="cpu"), JI.scan_tokens(s))


def test_scan_tokens_device_grows_its_capacity_by_four(monkeypatch):
    s = _raw(np.random.default_rng(2).integers(0, 256, 200, np.uint8).tobytes(), 1)
    chunks = []

    def small_chunks(data, max_out_chunks, device=None):
        chunks.append(max_out_chunks)
        return TP.parse_stream(data, max_out_chunks, out_chunk=16, device=device)

    monkeypatch.setattr(TI, "parse_stream", small_chunks)
    toks = TI.scan_tokens_device(s, max_out_bytes=100, device="cpu")
    assert chunks == [1, 4, 16]             # 16, 64, then 256 tokens of capacity
    assert np.array_equal(toks, JI.scan_tokens(s))


def test_resolve_tokens_equals_jax():
    import jax.numpy as jnp

    t = TI.scan_tokens(_raw(b"resolve one stream " * 70 + b"\x00" * 600, 9))
    toks = np.zeros(1024, np.int32)
    toks[: len(t)] = t
    want, want_len = JI.resolve_tokens(jnp.asarray(toks), 1024, 8192)
    got, got_len = TI.resolve_tokens(torch.from_numpy(toks), 1024, 8192)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int(got_len) == int(want_len)


def test_round_up_equals_jax():
    for x in (0, 1, (1 << 18) - 1, 1 << 18, (1 << 18) + 1, 5_000_000):
        assert TI._round_up(x) == JI._round_up(x)
