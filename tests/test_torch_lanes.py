"""Port parity of the lane shard decode: moonbit_flate_tpu_torch's
``ops/lanes_inflate.py`` and ``ops/lanes_resolve.py`` against the JAX
package's, exact, on the CPU.

One wave of 1024 streams holds the cases of tests/test_lanes_inflate.py
(its 24 fuzz mutants included), zlib level-1 and level-9 shards of a
small mixed corpus, and streams built to reach each error rule of
kernel A.  The JAX kernels run once each in interpret mode (a module
fixture); every test compares the port's arrays with theirs.  The port's
wrappers get CPU tensors and so take their plain twins, which is what
these tests check; the CUDA kernels are held against the same twins on
the card by chip_smoke.py.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_corpus
from moonbit_flate_tpu.ops import lanes_inflate as JL
from moonbit_flate_tpu.ops import lanes_resolve as JR
from moonbit_flate_tpu_torch.ops import lanes_inflate as TL
from moonbit_flate_tpu_torch.ops import lanes_resolve as TR
from moonbit_flate_tpu_torch.ops import tables as TT
from moonbit_flate_tpu_torch.utils.errors import CorruptInputError, UnexpectedEOFError
from moonbit_flate_tpu_torch.utils.lane_cases import SEGB, lane_cases, rule_cases

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)


def _corpus_cases():
    """zlib level-1 and level-9 shards of a small mixed corpus."""
    corpus = make_corpus(total=48 * TL.SEGB, seed=3)
    shards = [corpus[i:i + TL.SEGB] for i in range(0, len(corpus), TL.SEGB)]
    shards.append(corpus[:1000])
    return [zlib.compress(s, lvl)[2:-4] for lvl in (1, 9) for s in shards]


def _streams():
    return lane_cases() + rule_cases() + _corpus_cases()


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def lanes():
    """One wave through both JAX kernels (interpret mode) and the port."""
    streams = _streams()
    assert len(streams) <= TL.NSTR
    jnb, jinw = JL.stage_streams_lanes(streams, 1)
    jtok, jmisc = JL.parse_waves(jnb, jinw, 1, interpret=True)
    jtok_lm = jnp.transpose(jtok, (0, 1, 3, 4, 2)).reshape(
        1, JL.TOK_CHUNKS, JL.NSTR, JL.LANE)
    jout = JR.resolve_waves(jmisc[:, 1], jtok_lm, 1, interpret=True)
    tnb, tinw = TL.stage_streams_lanes(streams, 1, device="cpu")
    before = (TL.launches, TR.launches)
    ttok, tmisc = TL.parse_waves(tnb, tinw, 1)
    ttok_lm = ttok.permute(0, 1, 3, 4, 2).reshape(1, TL.TOK_CHUNKS, TL.NSTR, TL.LANE)
    tout = TR.resolve_waves(tmisc[:, 1].contiguous(), ttok_lm.contiguous(), 1)
    return {
        "streams": streams,
        "jax": {k: np.asarray(v) for k, v in dict(
            nbits=jnb, inw=jinw, tok=jtok, misc=jmisc, tok_lm=jtok_lm,
            out=jout).items()},
        "port": dict(nbits=tnb, inw=tinw, tok=ttok, misc=tmisc, tok_lm=ttok_lm,
                     out=tout),
        "launches": (before, (TL.launches, TR.launches)),
    }


def test_closed_forms_equal_the_lane_kernels():
    lc = np.arange(29, dtype=np.int32)
    for got, want in zip(TT.length_base_extra(torch.from_numpy(lc)),
                         JL.len_base_extra(jnp.asarray(lc))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    dc = np.arange(30, dtype=np.int32)
    for got, want in zip(TT.offset_base_extra(torch.from_numpy(dc)),
                         JL.dist_base_extra(jnp.asarray(dc))):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["SUB", "LANE", "NSTR", "SEGB", "TOK_ROWS",
                                  "IN_W", "IN_CHUNKS", "TOK_CHUNKS", "TOK_LIT",
                                  "TOK_MATCH", "CLS_LIT", "CLS_LEN", "CLS_EOB",
                                  "CLS_BAD", "ST_ACTIVE", "ST_DONE", "ST_PAUSED",
                                  "ST_CORRUPT", "ST_TRUNC", "ST_OVERFLOW"])
def test_constants_equal_jax_package(name):
    assert getattr(TL, name) == getattr(JL, name)
    if hasattr(JR, name):
        assert getattr(TR, name) == getattr(JR, name)


def test_groups_equal_jax_package():
    assert TR.GROUPS == JR.GROUPS


def test_lane_cases_shard_size_equals_jax_package():
    assert SEGB == JL.SEGB


@pytest.mark.parametrize("waves", [1, 2])
def test_stage_streams_lanes_equals_jax(waves):
    streams = _streams()[:60] * waves
    jnb, jinw = JL.stage_streams_lanes(streams, waves)
    tnb, tinw = TL.stage_streams_lanes(streams, waves, device="cpu")
    assert tnb.dtype == tinw.dtype == torch.int32
    assert np.array_equal(tnb.numpy(), np.asarray(jnb))
    assert np.array_equal(tinw.numpy(), np.asarray(jinw))


def _staging_case(name):
    rng = np.random.default_rng(4)

    def data(n):
        return rng.integers(0, 256, n, np.uint8).tobytes()

    return {
        "empty_stream": [data(9), b"", data(3)],
        "exactly_in_w_words": [data(TL.IN_W * 4), data(5)],
        "len_1_mod_4": [data(4 * k + 1) for k in range(6)],
        "len_2_mod_4": [data(4 * k + 2) for k in range(6)],
        "len_3_mod_4": [data(4 * k + 3) for k in range(6)],
        "only_empty": [b""] * 3,
        "no_streams": [],
        "full_wave": [data(int(k)) for k in rng.integers(0, 200, TL.NSTR)],
    }[name]


@pytest.mark.parametrize("name", ["empty_stream", "exactly_in_w_words", "len_1_mod_4",
                                  "len_2_mod_4", "len_3_mod_4", "only_empty",
                                  "no_streams", "full_wave"])
def test_stage_streams_lanes_case_equals_jax(name):
    """Fewer streams than a wave in all but the last case; streams of
    bytearray and memoryview stage as bytes do."""
    streams = _staging_case(name)
    jnb, jinw = JL.stage_streams_lanes(streams, 1)
    for kind in (bytes, bytearray, memoryview):
        tnb, tinw = TL.stage_streams_lanes([kind(s) for s in streams], 1, device="cpu")
        assert np.array_equal(tnb.numpy(), np.asarray(jnb))
        assert np.array_equal(tinw.numpy(), np.asarray(jinw))


def test_stage_streams_lanes_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="stream 1"):
        TL.stage_streams_lanes([b"", bytes(TL.IN_W * 4 + 1)], 1, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        TL.stage_streams_lanes([b""] * (TL.NSTR + 1), 1, device="cpu")


def test_fixture_stages_like_jax(lanes):
    for k in ("nbits", "inw"):
        assert np.array_equal(_np(lanes["port"][k]), lanes["jax"][k])


def test_fixture_reaches_every_status(lanes):
    st = set(lanes["jax"]["misc"][0, 0].reshape(-1).tolist())
    assert st == {JL.ST_DONE, JL.ST_CORRUPT, JL.ST_TRUNC, JL.ST_OVERFLOW}


def test_parse_waves_tokens_equal_jax(lanes):
    got, want = _np(lanes["port"]["tok"]), lanes["jax"]["tok"]
    assert got.shape == want.shape and got.dtype == want.dtype
    bad = np.nonzero((got != want).reshape(JL.TOK_ROWS, JL.NSTR).any(0))[0]
    assert bad.size == 0, f"streams whose tokens differ: {bad[:20]}"


@pytest.mark.parametrize("row", [0, 1, 2])
def test_parse_waves_misc_equals_jax(lanes, row):
    got = _np(lanes["port"]["misc"])[:, row]
    want = lanes["jax"]["misc"][:, row]
    bad = np.nonzero((got != want).reshape(-1))[0]
    assert bad.size == 0, f"streams whose misc row {row} differs: {bad[:20]}"


def test_parse_waves_misc_row3_is_zero(lanes):
    assert not _np(lanes["port"]["misc"])[:, 3].any()


def test_resolve_waves_equals_jax(lanes):
    got, want = _np(lanes["port"]["out"]), lanes["jax"]["out"]
    assert got.shape == want.shape and got.dtype == want.dtype
    bad = np.nonzero((got != want).transpose(0, 2, 1, 3).reshape(JL.NSTR, -1).any(1))[0]
    assert bad.size == 0, f"streams whose bytes differ: {bad[:20]}"


def test_resolve_waves_on_jax_tokens(lanes):
    """The port's BC on JAX's own kernel-A output (not the port's)."""
    j = lanes["jax"]
    out = TR.resolve_waves(torch.from_numpy(j["misc"][:, 1].copy()),
                           torch.from_numpy(j["tok_lm"].copy()), 1)
    assert np.array_equal(out.numpy(), j["out"])


def test_resolve_steps_on_jax_tokens(lanes):
    """The port's BC on JAX's own kernel-A output as kernel A wrote it,
    step-major, against JAX's BC on the same tokens relaid."""
    j = lanes["jax"]
    out = TR.resolve_steps(torch.from_numpy(j["misc"][:, 1].copy()),
                           torch.from_numpy(j["tok"].copy()), 1)
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), j["out"])


def test_lane_major_equals_jax_relayout(lanes):
    j = lanes["jax"]
    assert np.array_equal(TR.lane_major(torch.from_numpy(j["tok"].copy())).numpy(),
                          j["tok_lm"])


def test_step_major_inverts_lane_major(lanes):
    """What ``resolve_waves`` gives the kernel on the card: JAX's
    lane-major rows relaid as kernel A wrote them."""
    j = lanes["jax"]
    assert np.array_equal(TR.step_major(torch.from_numpy(j["tok_lm"].copy())).numpy(),
                          j["tok"])


def test_inflate_waves_passes_kernel_a_buffer_as_it_is(lanes, monkeypatch):
    """No relayout between the kernels: BC gets kernel A's tensor."""
    p = lanes["port"]
    seen = {}
    parse, steps = TR.parse_waves, TR.resolve_steps

    def parse_spy(*a):
        seen["tok"], misc = parse(*a)
        return seen["tok"], misc

    def steps_spy(outlen, tok, waves):
        seen["given"] = tok
        return steps(outlen, tok, waves)

    monkeypatch.setattr(TR, "parse_waves", parse_spy)
    monkeypatch.setattr(TR, "resolve_steps", steps_spy)
    out, _ = TR.inflate_waves(p["nbits"], p["inw"], 1)
    assert seen["given"] is seen["tok"]
    assert np.array_equal(out.numpy(), lanes["jax"]["out"])


def test_done_streams_match_zlib(lanes):
    misc, out = lanes["jax"]["misc"], lanes["jax"]["out"]
    n_done = 0
    for i, s in enumerate(lanes["streams"]):
        if misc[0, 0].reshape(-1)[i] != JL.ST_DONE:
            continue
        d = zlib.decompressobj(-15)
        want = d.decompress(s)
        n = int(misc[0, 1].reshape(-1)[i])
        got = out[0, :, i, :].reshape(-1).astype("<u4").tobytes()[:n]
        assert got == want, i
        n_done += 1
    assert n_done > 100


def test_inflate_waves_equals_jax(lanes):
    p = lanes["port"]
    out, misc = TR.inflate_waves(p["nbits"], p["inw"], 1)
    assert np.array_equal(out.numpy(), lanes["jax"]["out"])
    assert np.array_equal(misc.numpy()[:, :3], lanes["jax"]["misc"][:, :3])


def test_cpu_tensors_launch_no_kernel(lanes):
    before, after = lanes["launches"]
    assert before == after


def _status(lanes, i):
    return int(lanes["jax"]["misc"][0, 0].reshape(-1)[i])


def test_decompress_shards_done_bytes(lanes):
    streams = lanes["streams"]
    idx = [i for i in range(len(streams)) if _status(lanes, i) == JL.ST_DONE]
    misc, out = lanes["jax"]["misc"], lanes["jax"]["out"]
    want = []
    for i in idx:
        n = int(misc[0, 1].reshape(-1)[i])
        want.append(out[0, :, i, :].reshape(-1).astype("<u4").tobytes()[:n])
    got = TR.decompress_shards([streams[i] for i in idx], [TL.SEGB] * len(idx),
                               device="cpu")
    assert got == want


# the exception decompress_shards raises for each status (lanes_resolve.py:349-364)
_RAISES = {JL.ST_TRUNC: UnexpectedEOFError, JL.ST_OVERFLOW: ValueError,
           JL.ST_CORRUPT: CorruptInputError}


@pytest.mark.parametrize("status", sorted(_RAISES))
def test_decompress_shards_raises_for_status(lanes, status):
    streams = lanes["streams"]
    first = min(i for i in range(len(streams)) if _status(lanes, i) == status)
    done = [i for i in range(len(streams)) if _status(lanes, i) == JL.ST_DONE][:3]
    sel = done + [first]
    with pytest.raises(_RAISES[status]):
        TR.decompress_shards([streams[i] for i in sel], [TL.SEGB] * len(sel),
                             device="cpu")


def test_decompress_shards_checks_sizes():
    s = zlib.compress(b"abc" * 100, 1)[2:-4]
    with pytest.raises(ValueError, match="shard cap"):
        TR.decompress_shards([s], [TL.SEGB + 1], device="cpu")
    with pytest.raises(CorruptInputError):
        TR.decompress_shards([bytes(TL.IN_W * 4 + 1)], [TL.SEGB], device="cpu")
    with pytest.raises(ValueError, match="exceeds caller bound"):
        TR.decompress_shards([s], [299], device="cpu")
    assert TR.decompress_shards([s], [300], device="cpu") == [b"abc" * 100]
    assert TR.decompress_shards([], [], device="cpu") == []
