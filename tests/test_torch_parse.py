"""Port parity of the scalar-path parser: moonbit_flate_tpu_torch's
``ops/parse.py`` against the JAX package's ``ops/parse_pallas.py``,
exact, on the CPU.

One batch holds every stream of ``utils/stream_cases.py`` (the
test_parse_pallas.py payloads at zlib levels 0/1/9, fixed, flushed and
multi-block streams, a hand-made stream for each rule of the kernel, and
streams that exhaust the token capacity), the JAX host encoder's streams,
the lane-decode cases and 96 mutants of good streams.  The JAX kernel
runs once in interpret mode (a module fixture, 8 chunks of 512 tokens);
every test compares the port's arrays with its.  The port's wrapper gets CPU tensors and so
takes its plain twin, which is what these tests check; the CUDA kernel
is held against the same twin on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from moonbit_flate_tpu.api.stream import compress as host_compress
from moonbit_flate_tpu.ops import parse_pallas as JP
from moonbit_flate_tpu_torch import native
from moonbit_flate_tpu_torch.inflate.cuda_inflate import scan_tokens
from moonbit_flate_tpu_torch.ops import parse as TP
from moonbit_flate_tpu_torch.utils.lane_cases import lane_cases, rule_cases
from moonbit_flate_tpu_torch.utils.stream_cases import (CASE_CHUNK, CASE_CHUNKS,
                                                        fuzz_cases, payloads,
                                                        stream_cases)

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)

_CASES = stream_cases()
_NAMES = [c[0] for c in _CASES]


def _streams():
    own = [host_compress(p) for p in payloads().values()]
    return [c[1] for c in _CASES] + own + lane_cases() + rule_cases() + fuzz_cases()


@pytest.fixture(scope="module")
def batch():
    """Every stream through the JAX kernel (interpret mode) and the port."""
    streams = _streams()
    jnb, jw = JP._stage_streams(streams)
    jtoks, jcnt = JP.parse_batch(jnb, jw, CASE_CHUNKS, interpret=True,
                                 out_chunk=CASE_CHUNK)
    tnb, tw = TP.stage_streams(streams, device="cpu")
    before = TP.launches
    ttoks, tcnt = TP.parse_batch(tnb, tw, CASE_CHUNKS, CASE_CHUNK)
    return {"streams": streams,
            "jax": {"nbits": np.asarray(jnb), "words": np.asarray(jw),
                    "toks": np.asarray(jtoks), "cnt": np.asarray(jcnt)},
            "port": {"nbits": tnb.numpy(), "words": tw.numpy(),
                     "toks": ttoks.numpy(), "cnt": tcnt.numpy()},
            "launches": (before, TP.launches)}


def test_constants_equal_jax_package():
    assert TP.OUT_CHUNK == JP.OUT_CHUNK
    assert TP.SLACK_W == JP.WWIN


@pytest.mark.parametrize("sel", [slice(0, 1), slice(3, 40), slice(0, 0)])
def test_stage_streams_equals_jax(sel):
    streams = [c[1] for c in _CASES][sel]
    jnb, jw = JP._stage_streams(streams)
    tnb, tw = TP.stage_streams(streams, device="cpu")
    assert tnb.dtype == tw.dtype == torch.int32
    assert np.array_equal(tnb.numpy(), np.asarray(jnb))
    assert tw.shape == jw.shape and np.array_equal(tw.numpy(), np.asarray(jw))


def test_stage_streams_refuses_a_stream_too_long_for_int32_bits(monkeypatch):
    monkeypatch.setattr(TP, "MAX_STREAM_BYTES", 16)
    with pytest.raises(ValueError, match="int32"):
        TP.stage_streams([bytes(16)], device="cpu")


def test_fixture_stages_like_jax(batch):
    for k in ("nbits", "words"):
        assert np.array_equal(batch["port"][k], batch["jax"][k])


def test_fixture_reaches_every_status(batch):
    assert set(batch["jax"]["cnt"][:, 1].tolist()) == {1, 0, -3, -4}


def test_tokens_equal_jax(batch):
    got, want = batch["port"]["toks"], batch["jax"]["toks"]
    assert got.shape == want.shape and got.dtype == want.dtype
    bad = np.nonzero((got != want).any(1))[0]
    assert bad.size == 0, f"streams whose tokens differ: {bad[:20]}"


@pytest.mark.parametrize("col,what", [(0, "token count"), (1, "status"),
                                      (2, "output bytes")])
def test_cnt_equals_jax(batch, col, what):
    got, want = batch["port"]["cnt"][:, col], batch["jax"]["cnt"][:, col]
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, f"streams whose {what} differs: {bad[:20]}"


@pytest.mark.parametrize("name", _NAMES)
def test_case_reaches_its_rule(batch, name):
    """Each hand-made stream ends in the status its rule gives, in the
    JAX kernel and in the port."""
    i = _NAMES.index(name)
    assert batch["jax"]["cnt"][i, 1] == _CASES[i][2]
    assert batch["port"]["cnt"][i, 1] == _CASES[i][2]


def test_tokens_past_the_count_are_zero(batch):
    toks, cnt = batch["port"]["toks"], batch["port"]["cnt"]
    past = np.arange(toks.shape[1])[None, :] >= cnt[:, :1]
    assert not toks[past].any()


def test_done_streams_equal_the_host_scanner(batch):
    try:
        native.scanner()
    except RuntimeError as e:
        pytest.skip(f"host scanner unavailable: {e}")
    toks, cnt = batch["port"]["toks"], batch["port"]["cnt"]
    n_done = 0
    for i, s in enumerate(batch["streams"]):
        if cnt[i, 1] == 1:
            assert np.array_equal(toks[i, :cnt[i, 0]], scan_tokens(s)), i
            n_done += 1
    assert n_done > 40


def test_parse_stream_equals_batch_row(batch):
    i = _NAMES.index("mixed_l9")
    toks, status, outpos = TP.parse_stream(_CASES[i][1], max_out_chunks=CASE_CHUNKS,
                                           out_chunk=CASE_CHUNK, device="cpu")
    ntok, want_status, want_out = batch["jax"]["cnt"][i, :3]
    assert (status, outpos) == (want_status, want_out)
    assert np.array_equal(toks, batch["jax"]["toks"][i, :ntok])


def test_cpu_tensors_launch_no_kernel(batch):
    before, after = batch["launches"]
    assert before == after
