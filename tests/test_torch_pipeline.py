"""Port parity of the whole slice: the port's segment encoder and
compressor emit the same bytes as the JAX package's (exact)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonbit_flate_tpu.api.tpu import TPUCompressor
from moonbit_flate_tpu.ops import pipeline as JP
from moonbit_flate_tpu_torch import compress as port_compress
from moonbit_flate_tpu_torch.api.cuda import CUDACompressor, stage_segment
from moonbit_flate_tpu_torch.ops import pipeline as TP

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)

NB = 4   # S > 131072: the windowed matcher


def _payloads():
    rng = np.random.default_rng(0)
    text = (b"compression window huffman block stream symbol match " * 6000)
    return {
        "text": text,
        "random": rng.integers(0, 256, 90000, np.uint8).tobytes(),
        "zeros": bytes(150000),
        "empty": b"",
        "one": b"x",
        "b65536": (bytes(range(256)) * 256 + text)[:65536],
        "full": (text + rng.integers(0, 256, 160000, np.uint8).tobytes())
        [: NB * 65535 - 5000],
    }


def _jax_segment(buf, n, ctx):
    words, bits = JP.encode_segment_ctx(jnp.asarray(buf), jnp.int32(n),
                                        jnp.int32(ctx), NB, None, ctx == 0)
    return np.asarray(words).view("<u4").tobytes()[: int(bits) // 8]


def _port_segment(buf, n, ctx):
    words, bits = TP.encode_segment_ctx(torch.from_numpy(buf), n, ctx, NB)
    assert int(bits) % 8 == 0
    return words.numpy().view("<u4").tobytes()[: int(bits) // 8]


@pytest.mark.parametrize("ctx", [0, 5000])
@pytest.mark.parametrize("name", ["text", "random", "zeros", "empty", "one",
                                  "b65536", "full"])
def test_encode_segment_ctx_bytes_equal_jax(name, ctx):
    rng = np.random.default_rng(1)
    context = rng.integers(0, 256, ctx, np.uint8).tobytes()
    payload = _payloads()[name][: NB * 65535 - ctx]
    buf, n, c = stage_segment(context, payload, NB)
    got = _port_segment(buf, n, c)
    assert got == _jax_segment(buf, n, c)
    dec = zlib.decompressobj(-15, zdict=context)
    assert dec.decompress(got + bytes([1, 0, 0, 0xFF, 0xFF])) == payload


def test_encode_segments_batch_equals_single_segments():
    p = _payloads()
    staged = [stage_segment(b"", p["text"][:200000], NB),
              stage_segment(p["random"][:7000], p["zeros"], NB),
              stage_segment(b"", p["one"], NB)]
    data = torch.from_numpy(np.stack([s[0] for s in staged]))
    words, bits = TP.encode_segments(data, [s[1] for s in staged],
                                     [s[2] for s in staged], NB)
    for b, (buf, n, ctx) in enumerate(staged):
        w1, b1 = TP.encode_segment_ctx(torch.from_numpy(buf), n, ctx, NB)
        assert int(bits[b]) == int(b1)
        assert torch.equal(words[b], w1)


def test_stage_segment_layout():
    buf, n, ctx = stage_segment(b"ab", b"cde", 1)
    assert buf.shape == (65535 + 320,) and buf.dtype == np.uint8
    assert (n, ctx) == (5, 2)
    assert buf[:5].tobytes() == b"abcde" and not buf[5:].any()
    with pytest.raises(ValueError):
        stage_segment(b"", bytes(65536), 1)


# the cases of tests/test_tpu_dict.py, port (on the CPU) against JAX
def _dict_cases():
    rng = np.random.default_rng(0)
    d1 = (b"dictionary of shared material 0123456789 " * 900)[:32768]
    p1 = (d1[:5000] + b" fresh " + d1[10000:15000]
          + rng.integers(0, 256, 2000, np.uint8).tobytes())
    d2 = bytes(range(256)) * 64
    p2 = d2[1000:9000] + b"tail"
    return {"preset": (p1, d1), "zlib_interop": (p2, d2), "none": (p1, None),
            "empty": (b"", None), "dictless": (b"no context " * 10000, None)}


@pytest.mark.parametrize("case", ["preset", "zlib_interop", "none", "empty",
                                  "dictless"])
def test_compressor_equals_tpu_compressor_with_dictionary(case):
    payload, dct = _dict_cases()[case]
    got = CUDACompressor(blocks_per_segment=2, device="cpu").compress(
        payload, dictionary=dct)
    assert got == TPUCompressor(blocks_per_segment=2).compress(
        payload, dictionary=dct)
    dec = zlib.decompressobj(-15, zdict=dct or b"")
    assert dec.decompress(got) + dec.flush() == payload


def test_compressor_equals_tpu_compressor_with_halo():
    rng = np.random.default_rng(1)
    rep = rng.integers(0, 256, 30000, np.uint8).tobytes()
    data = rep + bytes(40000) + rep + rep
    halo = CUDACompressor(blocks_per_segment=1, halo=True, device="cpu").compress(data)
    assert halo == TPUCompressor(blocks_per_segment=1, halo=True).compress(data)
    indep = CUDACompressor(blocks_per_segment=1, device="cpu").compress(data)
    assert indep == TPUCompressor(blocks_per_segment=1).compress(data)
    assert zlib.decompress(halo, wbits=-15) == data
    assert len(halo) < len(indep)


def test_package_compress_on_the_cpu_route():
    data = b"the quick compression of the deflate window " * 3000
    out = port_compress(data, backend="cuda", device="cpu")
    assert zlib.decompress(out, wbits=-15) == data
    assert out == CUDACompressor(16, device="cpu").compress(data)
