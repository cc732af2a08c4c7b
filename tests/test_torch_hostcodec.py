"""Port parity of the host codec: each pure-Python module of
moonbit_flate_tpu_torch against its original in the JAX package, byte for
byte (tolerance 0), on the inputs of tests/test_{bitio,huffman,dict,
dict_decoder,formats,inflate_errors,native,roundtrip,fuzz,utf8}.py, and the
package's one-shot ``compress`` / ``decompress`` for every backend against
the JAX package's function for the matching backend ('cuda' against
'tpu', on the CPU route), and with the default backend against the JAX
package's default.  An error is compared by its type's name, its
offset and its message.
"""

import random
import zlib

import numpy as np
import pytest
import torch

import moonbit_flate_tpu as J
import moonbit_flate_tpu_torch as T
from moonbit_flate_tpu import native as JN
from moonbit_flate_tpu.api import stream as JS
from moonbit_flate_tpu.bitio import writer as JW
from moonbit_flate_tpu.blocks import emitters as JEM
from moonbit_flate_tpu.formats import constants as JC
from moonbit_flate_tpu.huffman import decode_table as JDT
from moonbit_flate_tpu.huffman import encode as JH
from moonbit_flate_tpu.inflate import decoder as JD
from moonbit_flate_tpu.inflate import dict_decoder as JDD
from moonbit_flate_tpu.lz77 import reference_fast as JL
from moonbit_flate_tpu.utils import bits as JB
from moonbit_flate_tpu.utils import errors as JE
from moonbit_flate_tpu.utils import utf8 as JU
from moonbit_flate_tpu_torch import native as TN
from moonbit_flate_tpu_torch.api import stream as TS
from moonbit_flate_tpu_torch.bitio import writer as TW
from moonbit_flate_tpu_torch.blocks import emitters as TEM
from moonbit_flate_tpu_torch.formats import constants as TC
from moonbit_flate_tpu_torch.huffman import decode_table as TDT
from moonbit_flate_tpu_torch.huffman import encode as TH
from moonbit_flate_tpu_torch.inflate import decoder as TD
from moonbit_flate_tpu_torch.inflate import dict_decoder as TDD
from moonbit_flate_tpu_torch.lz77 import reference_fast as TL
from moonbit_flate_tpu_torch.utils import bits as TB
from moonbit_flate_tpu_torch.utils import errors as TE
from moonbit_flate_tpu_torch.utils import utf8 as TU
from moonbit_flate_tpu_torch.utils.corpus import make_corpus

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)


def _outcome(fn, *args, **kw):
    """("ok", result) or ("raise", type name, offset, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:            # either package's FlateError, or any other
        return ("raise", type(e).__name__, getattr(e, "offset", None), str(e))


def _same(a, b):
    """Equality of results that may hold numpy arrays, in tuples or lists."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


# ---- formats/constants, utils/bits, utils/errors -------------------------------

@pytest.mark.parametrize("name", sorted(n for n in dir(JC) if n.isupper()))
def test_every_constant_equals_the_original(name):
    assert _same(getattr(TC, name), getattr(JC, name))


@pytest.mark.parametrize("fn", ["fixed_literal_lengths", "fixed_distance_lengths"])
def test_fixed_lengths_equal_the_original(fn):
    assert _same(getattr(TC, fn)(), getattr(JC, fn)())


def test_offset_codes_and_tokens_equal_the_original():
    x = np.arange(1 << 22)
    assert _same(TC.offset_code_array(x), JC.offset_code_array(x))
    for v in list(range(0, 1 << 15, 37)) + [(1 << 15) - 1, 1 << 15, (1 << 22) - 1]:
        assert TC.offset_code(v) == JC.offset_code(v)
    for xl, xo in [(0, 0), (255, 32767), (17, 4095), (3, (1 << 22) - 1)]:
        assert TC.match_token(xl, xo) == JC.match_token(xl, xo)
    assert [TC.literal_token(i) for i in range(256)] == \
        [JC.literal_token(i) for i in range(256)]


def test_bit_reversal_equals_the_original():
    assert _same(TB.REV8_TABLE, JB.REV8_TABLE)
    assert [TB.reverse16(v) for v in range(1 << 16)] == \
        [JB.reverse16(v) for v in range(1 << 16)]
    for w in range(1, 17):
        v = np.arange(1 << w, dtype=np.uint32)
        assert _same(TB.reverse_bits_array(v, np.full(len(v), w)),
                     JB.reverse_bits_array(v, np.full(len(v), w)))
        assert [TB.reverse_bits(int(x), w) for x in v[:300]] == \
            [JB.reverse_bits(int(x), w) for x in v[:300]]


@pytest.mark.parametrize("name,args", [
    ("CorruptInputError", (17,)), ("InternalError", ("bad state",)),
    ("WriterClosedError", ()), ("UnexpectedEOFError", ()), ("EOFError_", ())])
def test_error_types_equal_the_original(name, args):
    t, j = getattr(TE, name)(*args), getattr(JE, name)(*args)
    assert str(t) == str(j) and isinstance(t, TE.FlateError)
    assert getattr(t, "offset", None) == getattr(j, "offset", None)
    assert [c.__name__ for c in type(t).__mro__] == [c.__name__ for c in type(j).__mro__]


# ---- utils/utf8 -----------------------------------------------------------------

@pytest.mark.parametrize("text", ["Aé世\U0001F600", "Hello, 世界! \U0001F680 café", ""])
def test_utf8_encode_equals_the_original(text):
    assert list(TU.utf8_encode(text)) == list(JU.utf8_encode(text)) == \
        list(text.encode("utf-8"))


@pytest.mark.parametrize("data", ["Hello, 世界! \U0001F680 café".encode(),
                                  b"ab\x80cd", b"ok\xe4\xb8", b"x\xf9y", b""])
def test_utf8_decode_equals_the_original(data):
    assert list(TU.utf8_decode(data)) == list(JU.utf8_decode(data))


# ---- bitio/writer ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_pack_bits_equals_the_original(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        k = rng.integers(1, 200)
        nbits = rng.integers(0, 29, k)
        values = rng.integers(0, 1 << 28, k, dtype=np.uint64) & \
            ((1 << nbits.astype(np.uint64)) - 1)
        off = int(rng.integers(0, 8))
        assert _same(TW.pack_bits(values, nbits, off), JW.pack_bits(values, nbits, off))
    assert _same(TW.pack_bits([], [], 3), JW.pack_bits([], [], 3))


def _drive_writer(mod, seed):
    rng = np.random.default_rng(seed)
    bw = mod.BitWriter()
    for _ in range(50):
        if rng.random() < 0.5:
            w = int(rng.integers(1, 17))
            bw.write_bits(int(rng.integers(0, 1 << 16)) & ((1 << w) - 1), w)
        else:
            k = int(rng.integers(1, 30))
            wid = rng.integers(0, 20, k)
            bw.write_packed(rng.integers(0, 1 << 19, k, dtype=np.uint64)
                            & ((1 << wid.astype(np.uint64)) - 1), wid)
    pos = bw.bit_position
    bw.flush()
    bw.write_bytes(b"abc")
    bw.write_bits(0b101, 3)
    err = _outcome(bw.write_bytes, b"x")
    bw.flush()
    sunk = []
    sink = mod.BitWriter(sink=sunk.append)
    sink.write_bits(0x1234, 13)
    sink.flush()
    return bw.getvalue(), pos, err, sunk, _outcome(sink.getvalue)


@pytest.mark.parametrize("seed", range(4))
def test_bitwriter_equals_the_original(seed):
    assert _same(_drive_writer(TW, seed), _drive_writer(JW, seed))


# ---- huffman/encode, huffman/decode_table ------------------------------------------

def _freq_cases():
    cases = []
    for seed in range(10):
        for alphabet, max_bits in [(286, 15), (30, 15), (19, 7)]:
            rng = np.random.default_rng(seed)
            freqs = rng.integers(0, 1000, alphabet)
            freqs[rng.random(alphabet) < 0.5] = 0
            if np.count_nonzero(freqs) < 3:
                freqs[:3] = [5, 3, 1]
            cases.append((freqs, max_bits))
    skew = np.zeros(286, np.int64)
    skew[:40] = 2 ** np.arange(40) % 100003 + 1       # forces the 15-bit limit
    cases += [(np.array([0, 7, 0, 0]), 15), (np.array([3, 0, 9]), 15),
              (np.zeros(5, np.int64), 15), (skew, 15),
              (np.random.default_rng(42).integers(1, 500, 286), 15)]
    return cases


@pytest.mark.parametrize("i", range(len(_freq_cases())))
def test_huffman_codes_equal_the_original(i):
    freqs, max_bits = _freq_cases()[i]
    for fn in ("lengths_from_freqs", "generate"):
        assert _same(getattr(TH, fn)(freqs, max_bits), getattr(JH, fn)(freqs, max_bits))
    lengths = JH.lengths_from_freqs(freqs, max_bits)
    assert _same(TH.canonical_codes(lengths), JH.canonical_codes(lengths))
    assert TH.bit_length(lengths, freqs) == JH.bit_length(lengths, freqs)
    order = np.lexsort((np.arange(len(freqs)), freqs))
    live = freqs[order][freqs[order] > 0]
    if len(live) > 2:
        assert _same(TH.package_merge_bit_counts(live, max_bits),
                     JH.package_merge_bit_counts(live, max_bits))


def test_offset_codes_of_the_huffman_module_equal_the_original():
    for n in (1, 30):
        assert _same(TH.huff_offset_codes(n), JH.huff_offset_codes(n))


def _decoder_state(mod, lengths):
    h = mod.HuffmanDecoder()
    ok = h.initialize(lengths)
    return ok, h.min, h.chunks, list(h.links), h.link_mask


@pytest.mark.parametrize("i", range(len(_freq_cases()) + 5))
def test_huffman_decoder_tables_equal_the_original(i):
    extra = [np.array([2] * 5 + [0] * 5), np.array([2, 0]), np.array([1, 0]),
             np.zeros(4, np.int64), JC.fixed_literal_lengths()]
    cases = [JH.lengths_from_freqs(f, b) for f, b in _freq_cases()] + extra
    assert _same(_decoder_state(TDT, cases[i]), _decoder_state(JDT, cases[i]))


def test_decode_table_constants_and_fixed_decoder_equal_the_original():
    for name in ("CHUNK_BITS", "NUM_CHUNKS", "COUNT_MASK", "VALUE_SHIFT"):
        assert getattr(TDT, name) == getattr(JDT, name)
    t, j = TDT.FIXED_LITERAL_DECODER, JDT.FIXED_LITERAL_DECODER
    assert _same((t.min, t.chunks, list(t.links), t.link_mask),
                 (j.min, j.chunks, list(j.links), j.link_mask))


# ---- lz77/reference_fast -----------------------------------------------------------

def _native_cases():
    rng = np.random.default_rng(0)
    return [
        b"", b"x", b"hello world", b"abcabcabc",
        b"a" * 100000,
        b"the quick brown fox jumps over the lazy dog. " * 9000,
        bytes(range(256)) * 700,
        rng.integers(0, 256, 300000, np.uint8).tobytes(),
        (b"mixed " + rng.integers(0, 256, 500, np.uint8).tobytes()) * 300,
    ]


def _encode_blocks(mod, data):
    """DeflateFast over consecutive 65535-byte blocks (its cross-block
    state carries over), then once more after a reset."""
    df = mod.DeflateFast()
    out = [df.encode(data[s: s + 65535]) for s in range(0, len(data), 65535)]
    df.reset()
    out.append(df.encode(data[:65535]))
    return out, df.cur


@pytest.mark.parametrize("i", range(len(_native_cases())))
def test_deflate_fast_tokens_equal_the_original(i):
    data = _native_cases()[i]
    assert _same(_encode_blocks(TL, data), _encode_blocks(JL, data))


# ---- blocks/emitters -----------------------------------------------------------------

def _emit(mod, name, data):
    tokens = (TL if mod is TEM else JL).DeflateFast().encode(data[:65535])
    bw = (TW if mod is TEM else JW).BitWriter()
    if name == "write_stored_block":
        mod.write_stored_block(bw, data[:65535], True)
    elif name == "write_final_empty_block":
        mod.write_stored_block(bw, data[:100])
        mod.write_final_empty_block(bw)
    elif name == "write_block_huff":
        mod.write_block_huff(bw, False, data[:65535])
        mod.write_block_huff(bw, True, data[:3])
    elif name == "write_block_dynamic":
        mod.write_block_dynamic(bw, tokens, True, data[:65535])
    else:                                  # the size accounting and token helpers
        lit, off, nl, no = mod.index_tokens(tokens)
        lit_len = (TH if mod is TEM else JH).lengths_from_freqs(lit, 15)
        off_len = (TH if mod is TEM else JH).lengths_from_freqs(off, 15)
        codegen = mod.generate_codegen(lit_len, off_len, nl, no)
        cg_len = (TH if mod is TEM else JH).lengths_from_freqs(codegen[2], 7)
        return (mod.stored_size(len(data)), mod.stored_size(0),
                mod.split_tokens(tokens), (lit, off, nl, no), codegen,
                mod.dynamic_size(codegen[2], cg_len, lit_len, off_len, lit, off,
                                 nl, no))
    return bw.getvalue(), bw.nhold


_EMITTERS = ["write_stored_block", "write_final_empty_block", "write_block_huff",
             "write_block_dynamic", "accounting"]


@pytest.mark.parametrize("name", _EMITTERS)
@pytest.mark.parametrize("i", [0, 3, 5, 7, 8])
def test_emitter_equals_the_original(name, i):
    data = _native_cases()[i]
    assert _same(_outcome(_emit, TEM, name, data), _outcome(_emit, JEM, name, data))


# ---- api/stream: Compressor, Writer, compress ------------------------------------

ABC = bytes(range(128)) * (131072 // 128)
_GRID = [[0], [1], [1, 256], [1, 65536], [14], [15], [16], [16, 256], [16, 65536],
         [127], [128], [128, 256], [128, 65536], [129], [65536, 256], [65536, 65536]]


def _write_grid(mod, first_n):
    outs = []
    for tail in _GRID:
        w = mod.Writer()
        for n in [first_n] + tail[1:]:
            assert w.write(ABC[:n]) == n
        w.close()
        outs.append(w.getvalue())
    return outs


@pytest.mark.parametrize("first_n", [1, 65534, 65535, 65536, 65537, 131072])
def test_writer_grid_equals_the_original(first_n):
    assert _write_grid(TS, first_n) == _write_grid(JS, first_n)


def _writer_life(mod):
    """with_dict, a dictionary past the window, a sink, reset, and the
    closed writer's error."""
    out = []
    w = mod.Writer.with_dict(None, b"hello world")
    w.write(b"hello again world")
    w.close()
    out.append(w.getvalue())
    big = bytes(range(256)) * 200
    w = mod.Writer(dictionary=big)
    w.write(b"tail data that matches " + big[-100:])
    w.close()
    w.close()                                 # closing twice is a no-op
    out.append(w.getvalue())
    out.append(_outcome(w.write, b"more"))
    sunk = []
    w.reset(sunk.append)
    w.write(ABC[:70000])
    w.close()
    out.append(b"".join(sunk))
    out.append(_outcome(w.getvalue))
    c = mod.Compressor()
    c.write(ABC[:5000])
    out.append(_outcome(c.fill_window, b"late"))
    return out


def test_writer_dictionary_reset_and_errors_equal_the_original():
    got, want = _writer_life(TS), _writer_life(JS)
    assert _same(got, want)
    assert len(got[0]) == 38                     # the reference's size fixture
    assert got[2][1] == "WriterClosedError"


@pytest.mark.parametrize("seed", range(3))
def test_compress_of_random_sizes_equals_the_original(seed):
    rng = np.random.default_rng(seed)
    for size in [0, 1, 15, 17, 127, 129, 65535, 65536, 70000, 200001]:
        raw = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        data = raw[: size // 2] + raw[: size // 4] + raw[: size - size // 2 - size // 4]
        c = TS.compress(data)
        assert c == JS.compress(data)
        assert zlib.decompress(c, wbits=-15) == data


# ---- inflate/dict_decoder -----------------------------------------------------------

POEM = (b"The woods are lovely, dark and deep,\nBut I have promises to keep,\n"
        b"And miles to go before I sleep,\nAnd miles to go before I sleep.\n") * 8
_SCRIPTS = [
    (2048, [("lit", POEM)], b""),
    (2048, [("lit", POEM[:300]), ("copy", 100, 200), ("copy", 300, 500),
            ("lit", b"interlude"), ("copy", 509, 1000)], b""),
    (2048, [("lit", b"z"), ("copy", 1, 60), ("lit", b"ab"), ("copy", 2, 57),
            ("copy", 3, 258)], b""),
    (2048, [("lit", bytes(range(256)) * 8), ("copy", 2048, 100), ("copy", 1, 258)], b""),
    (2048, [("copy", 300, 300), ("lit", b"x"), ("copy", 1, 10)], b"0123456789" * 30),
    (64, [("copy", 32, 10)], b"A" * 100 + b"B" * 32),
]


def _run_script(mod, window, script, dictionary):
    """Every cursor after every call, and the bytes flushed."""
    dd = mod.DictDecoder(window, dictionary)
    trace = [dd.hist_size()]
    for op, *args in script:
        if op == "lit":
            arr = np.frombuffer(args[0], dtype=np.uint8)
            while len(arr):
                if dd.avail_write() == 0:
                    trace.append(dd.read_flush())
                n = dd.write_bytes(arr)
                arr = arr[n:]
                trace.append((n, dd.wr_pos, dd.rd_pos, dd.full))
        else:
            dist, rem = args
            while rem > 0:
                if dd.avail_write() == 0:
                    trace.append(dd.read_flush())
                cnt = dd.try_write_copy(dist, rem)
                trace.append(cnt)
                if cnt == 0:
                    cnt = dd.write_copy(dist, rem)
                rem -= cnt
                trace.append((cnt, dd.wr_pos, dd.avail_read(), dd.hist_size()))
    trace.append(dd.read_flush())
    return trace


@pytest.mark.parametrize("i", range(len(_SCRIPTS)))
def test_dict_decoder_equals_the_original(i):
    assert _same(_run_script(TDD, *_SCRIPTS[i]), _run_script(JDD, *_SCRIPTS[i]))


# ---- inflate/decoder: Decompressor, Reader, decompress ------------------------------

def _bw_stream(mod, bits):
    bw = mod.BitWriter()
    for v, n in bits:
        bw.write_bits(v, n)
    bw.flush()
    return bw.getvalue()


def _corrupt_streams():
    codes = JH.canonical_codes(JC.fixed_literal_lengths())
    good = JS.compress(b"A" * 1000)
    bits = {
        "reserved_block_type": [(1, 1), (3, 2)],
        "repeat_code_at_start": ([(1, 1), (2, 2), (0, 5), (0, 5), (15, 4)]
                                 + [(v, 3) for v in [1, 0, 0, 1] + [0] * 15]
                                 + [(1, 1), (0, 2)]),
        "oversubscribed_code_lengths": ([(1, 1), (2, 2), (0, 5), (0, 5), (15, 4)]
                                        + [(1, 3)] * 19),
        "distance_too_far_back": [(1, 1), (1, 2), (int(codes[257]), 7), (0, 5)],
    }
    out = {k: _bw_stream(JW, v) for k, v in bits.items()}
    out.update({
        "stored_len_mismatch": b"\x01\x05\x00\x00\x00hello",
        "stored_truncated_payload": b"\x01\x05\x00\xfa\xffhe",
        "stored_truncated_header": b"\x01\x05\x00",
        "garbage_after_data": good[:-5] + b"\x01\x09\x00\x00\x00",
        "truncated_dynamic": JS.compress(ABC[:5000])[:40],
        "empty": b"",
        "one_byte": b"\x07",
    })
    return out


def _read_all(mod, stream, n, dictionary=b""):
    """Chunks of n bytes until the end or an error; the error twice."""
    r = mod.Reader(stream, dictionary) if dictionary else mod.Reader(stream)
    chunks = []
    while True:
        got = _outcome(r.read, n)
        chunks.append(got)
        if got[0] != "ok" or not got[1]:
            break
    if got[0] != "ok":
        chunks.append(_outcome(r.read, n))        # sticky error
        chunks.append(_outcome(r.close))
    return chunks, r.block_type_counts


@pytest.mark.parametrize("name", sorted(_corrupt_streams()))
def test_reader_errors_equal_the_original(name):
    s = _corrupt_streams()[name]
    for n in (100, -1):
        assert _same(_read_all(TD, s, n), _read_all(JD, s, n))
    assert _same(_outcome(TD.decompress, s), _outcome(JD.decompress, s))


def _decode_cases():
    rng = np.random.default_rng(7)
    payload = (b"The quick brown fox jumps over the lazy dog. " * 3000
               + rng.integers(0, 256, 50000, dtype=np.uint8).tobytes())
    cases = {f"zlib{lvl}": (zlib.compressobj(lvl, zlib.DEFLATED, -15), payload, b"")
             for lvl in (0, 1, 6, 9)}
    dictionary = b"A common preamble with shared phrases and tokens. " * 40
    cases["zdict"] = (zlib.compressobj(6, zlib.DEFLATED, -15, zdict=dictionary),
                      b"shared phrases and tokens appear again: common preamble!" * 20,
                      dictionary)
    for dsize in (1, 100, 32768, 40000):
        d = ((b"x" * 7 + b"abcdefgh") * (dsize // 15 + 1))[:dsize]
        cases[f"zdict{dsize}"] = (zlib.compressobj(9, zlib.DEFLATED, -15, zdict=d),
                                  d[-min(dsize, 500):] + b" fresh bytes", d)
    out = {k: (co.compress(p) + co.flush(), p, d) for k, (co, p, d) in cases.items()}
    out["own"] = (JS.compress(ABC[:100000]), ABC[:100000], b"")
    return out


@pytest.mark.parametrize("name", sorted(_decode_cases()))
def test_reader_streaming_equals_the_original(name):
    stream, payload, dictionary = _decode_cases()[name]
    got = _read_all(TD, stream, 777, dictionary)
    assert _same(got, _read_all(JD, stream, 777, dictionary))
    assert b"".join(c[1] for c in got[0]) == payload
    assert TD.decompress(stream, dictionary) == payload


def test_reader_reset_and_make_reader_equal_the_original():
    a, b = ABC[:5000], ABC[1:4001]
    out = []
    for mod in (TD, JD):
        r = mod.Reader(JS.compress(a))
        first = r.read()
        r.reset(JS.compress(b))
        second = r.read()
        r.make_reader(b"\x01\x05\x00\xfa\xffhello")
        third = r.read()
        out.append((first, second, third, r.block_type_counts))
    assert out[0] == out[1]
    assert out[0][:2] == (a, b)


def _fuzz_bases():
    rng = random.Random(0xF00D)
    inputs = [bytes(rng.randrange(256) for _ in range(3000)),
              b"the quick brown fox jumps over the lazy dog. " * 90,
              bytes(1500), bytes(rng.choices(range(8), k=4000)), b"ab" * 2000]
    streams = []
    for d in inputs:
        streams.append(JN.compress(d))
        for lvl in (6, 1):
            co = zlib.compressobj(lvl, zlib.DEFLATED, -15)
            streams.append(co.compress(d) + co.flush())
    return streams


def _mutants(seed, count):
    rng = random.Random(seed)
    bases = _fuzz_bases()
    out = []
    for i in range(count):
        b = bytearray(bases[i % len(bases)])
        kind = rng.randrange(4)
        if kind == 0:
            i = rng.randrange(len(b))
            b[i] ^= 1 << rng.randrange(8)
        elif kind == 1:
            for _ in range(rng.randrange(1, 5)):
                b[rng.randrange(len(b))] = rng.randrange(256)
        elif kind == 2:
            b = b[: rng.randrange(len(b))]
        else:
            i = rng.randrange(len(b) + 1)
            b[i:i] = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 4)))
        out.append(bytes(b))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_decoder_on_mutated_streams_equals_the_original(seed):
    for m in _mutants(seed, 75):
        assert _same(_outcome(TD.decompress, m), _outcome(JD.decompress, m))


# ---- native ------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(_native_cases())))
def test_native_compress_equals_the_original(i):
    data = _native_cases()[i]
    c = TN.compress(data)
    assert c == JN.compress(data) == TS.compress(data)
    assert TN.decompress(c) == data


def test_native_dictionaries_and_buffer_growth_equal_the_original():
    d = b"hello world"
    assert TN.compress(b"hello again world", dictionary=d) == \
        JN.compress(b"hello again world", dictionary=d)
    big = bytes(range(256)) * 200
    assert TN.compress(b"tail", dictionary=big) == JN.compress(b"tail", dictionary=big)
    co = zlib.compressobj(9, zlib.DEFLATED, -15, zdict=d)
    s = co.compress(b"hello world once more") + co.flush()
    assert TN.decompress(s, dictionary=d) == JN.decompress(s, dictionary=d)
    zeros = zlib.compress(bytes(1 << 20), 9)[2:-4]        # 1 MiB from ~1 KB: -5 twice
    assert TN.decompress(zeros) == JN.decompress(zeros) == bytes(1 << 20)
    assert _same(_outcome(TN.decompress, zeros, max_output=4096),
                 _outcome(JN.decompress, zeros, max_output=4096))


@pytest.mark.parametrize("seed", range(2))
def test_native_decompress_on_mutated_streams_equals_the_original(seed):
    for m in _mutants(seed + 10, 300):
        assert _same(_outcome(TN.decompress, m), _outcome(JN.decompress, m))


@pytest.mark.parametrize("name", sorted(_corrupt_streams()))
def test_native_errors_equal_the_original(name):
    s = _corrupt_streams()[name]
    assert _same(_outcome(TN.decompress, s), _outcome(JN.decompress, s))


# ---- the package's one-shot compress / decompress ------------------------------------

_ONE_SHOT = {
    "text": (b"one-shot backend parity | " * 2000, None),
    "dictionary": (b"hello again world, and again" * 50, b"hello world " * 300),
    "empty": (b"", None),
}


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("case", sorted(_ONE_SHOT))
def test_one_shot_host_backends_equal_the_original(backend, case):
    data, dictionary = _ONE_SHOT[case]
    c = T.compress(data, dictionary, backend=backend)
    assert c == J.compress(data, dictionary, backend=backend)
    d = dictionary or b""
    reader_stream = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=d) if d else \
        zlib.compressobj(6, zlib.DEFLATED, -15)
    s = reader_stream.compress(data) + reader_stream.flush()
    assert T.decompress(s, d, backend=backend) == J.decompress(s, d, backend=backend) \
        == data
    assert T.decompress(c, backend=backend) == (d[-32768:] + data)


@pytest.mark.parametrize("case,backend", [("text", "cuda"), ("dictionary", "cuda"),
                                          ("empty", "cuda")])
def test_one_shot_cuda_backend_equals_tpu(case, backend):
    """'cuda' in the port gives the 'tpu' backend's bytes."""
    data, dictionary = _ONE_SHOT[case]
    c = T.compress(data, dictionary, backend=backend, device="cpu")
    assert c == J.compress(data, dictionary, backend="tpu")
    assert T.decompress(c, dictionary or b"", backend=backend, device="cpu") == \
        J.decompress(c, dictionary or b"", backend="tpu") == data


def _default_cases():
    corpus = make_corpus(100_000, 2)
    return dict(_ONE_SHOT, abc=(b"abcabcabcabc" * 50, None),
                corpus_dictionary=(corpus, make_corpus(51_200, 3)[50_000:]))


@pytest.mark.parametrize("case", sorted(_default_cases()))
def test_one_shot_default_backend_equals_the_original(case):
    """No backend named: the JAX package's bytes ('auto' is 'native' in
    both, the writer's prepend of a dictionary), no card needed."""
    data, dictionary = _default_cases()[case]
    c = T.compress(data, dictionary)
    assert c == J.compress(data, dictionary)
    assert zlib.decompress(c, wbits=-15) == (dictionary or b"")[-32768:] + data
    assert T.decompress(c) == J.decompress(c)
    d = dictionary or b""
    z = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=d) if d else \
        zlib.compressobj(6, zlib.DEFLATED, -15)
    s = z.compress(data) + z.flush()
    assert T.decompress(s, d) == J.decompress(s, d) == data
    for s in (b"\x01\x05\x00\x00\x00hello", c[:40]):
        got, want = _outcome(T.decompress, s), _outcome(J.decompress, s)
        assert got[:2] == want[:2]


def test_native_available_and_auto_without_it(monkeypatch):
    assert TN.available() is JN.available() is True
    data = _ONE_SHOT["dictionary"][0]
    dictionary = _ONE_SHOT["dictionary"][1]

    def no_compiler():
        raise RuntimeError("no C compiler: the host token scanner cannot be built")

    monkeypatch.setattr(TN, "_load", no_compiler)
    assert TN.available() is False
    # 'auto' takes the pure-Python codec, same bytes; 'native' still raises
    c = T.compress(data, dictionary)
    assert c == T.compress(data, dictionary, backend="python") == \
        J.compress(data, dictionary, backend="python")
    assert T.decompress(c) == dictionary + data
    with pytest.raises(RuntimeError, match="no C compiler"):
        T.compress(data, backend="native")


@pytest.mark.parametrize("backend", ["auto", "native", "python"])
@pytest.mark.parametrize("fn", ["compress", "decompress"])
def test_one_shot_host_backends_refuse_a_device(fn, backend):
    """A call that names a device never runs on the host codec."""
    data = b"x" if fn == "compress" else b"\x03\x00"
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="applies to backend=\"cuda\" only"):
            getattr(T, fn)(data, backend=backend, device=device)
    assert getattr(T, fn)(data, backend=backend) == getattr(J, fn)(data, backend=backend)


@pytest.mark.parametrize("backend", ["native", "python", "cuda"])
def test_one_shot_errors_equal_the_original(backend):
    jb = "tpu" if backend == "cuda" else backend
    kw = {"device": "cpu"} if backend == "cuda" else {}
    for s in (b"\x01\x05\x00\x00\x00hello", JS.compress(ABC[:5000])[:40]):
        got = _outcome(T.decompress, s, backend=backend, **kw)
        want = _outcome(J.decompress, s, backend=jb)
        assert got[:2] == want[:2] and got[0] == "raise"


def test_unknown_backends_raise():
    for fn in (T.compress, T.decompress):
        with pytest.raises(ValueError, match="unknown backend 'tpu'"):
            fn(b"abc", backend="tpu")
    with pytest.raises(ValueError, match="unknown backend 'cuda'"):
        J.compress(b"abc", backend="cuda")
