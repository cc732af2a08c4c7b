"""Port parity of the encoder's profiling hooks: ``_cksum`` and
``encode_segment_ctx(..., stage_cut=k)`` against the JAX package's, on
the CPU at nb = 1 (exact: each cut returns an int32 checksum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonbit_flate_tpu.ops import pipeline as JP
from moonbit_flate_tpu_torch.api.cuda import stage_segment
from moonbit_flate_tpu_torch.ops import pipeline as TP

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)

NB = 1


def _payload(name):
    if name == "text":
        return (b"compression window huffman block stream symbol match " * 1300)[:60000]
    return np.random.default_rng(4).integers(0, 256, 50000, np.uint8).tobytes()


def _cuts(buf, n, ctx, k):
    want = JP.encode_segment_ctx(jnp.asarray(buf), jnp.int32(n), jnp.int32(ctx), NB,
                                 k, ctx == 0)
    got = TP.encode_segment_ctx(torch.from_numpy(buf), n, ctx, NB, stage_cut=k)
    return got, want


@pytest.mark.parametrize("dtype", ["int32_overflow", "bool", "uint8", "u32_in_int32"])
def test_cksum_equals_jax(dtype):
    rng = np.random.default_rng(3)
    if dtype == "int32_overflow":     # the sum leaves the int32 range both ways
        arrays = [rng.integers(1 << 29, 1 << 31, 40, dtype=np.int64).astype(np.int32),
                  -rng.integers(1 << 30, 1 << 31, 70, dtype=np.int64).astype(np.int32)]
    elif dtype == "bool":
        arrays = [rng.random(1000) < 0.3, rng.random((7, 9)) < 0.5]
    elif dtype == "uint8":
        arrays = [rng.integers(0, 256, 5000, dtype=np.int64).astype(np.uint8)]
    else:                             # u32 patterns with the top bit set
        arrays = [rng.integers(1 << 31, 1 << 32, 300, dtype=np.int64)
                  .astype(np.uint32).view(np.int32)]
    want = int(JP._cksum(*(jnp.asarray(a) for a in arrays)))
    got = TP._cksum(*(torch.from_numpy(a) for a in arrays))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want
    if dtype == "u32_in_int32":       # the port holds u32 values in int64 too
        wide = torch.from_numpy(arrays[0].view(np.uint32).astype(np.int64))
        assert int(TP._cksum(wide)) == want


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("name", ["text", "random"])
def test_stage_cut_equals_jax(name, k):
    buf, n, ctx = stage_segment(b"", _payload(name), NB)
    got, want = _cuts(buf, n, ctx, k)
    assert int(got[0]) == int(want[0])
    assert int(got[1]) == int(want[1]) == 0


def test_stage_cut_3_with_context_equals_jax():
    context = np.random.default_rng(5).integers(0, 256, 5000, np.uint8).tobytes()
    buf, n, ctx = stage_segment(context, _payload("text")[:55000], NB)
    assert ctx == 5000
    got, want = _cuts(buf, n, ctx, 3)
    assert int(got[0]) == int(want[0])


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7])
def test_stage_cut_returns_before_the_later_launches(monkeypatch, k):
    """Cut 1 calls no walk and no cut a pack (here the wrappers' CPU
    route; on the card each would be a launch)."""
    def refuse(*args):
        raise AssertionError("called past the cut")

    if k == 1:
        monkeypatch.setattr(TP, "_commit_walk_batch", refuse)
        monkeypatch.setattr(TP, "_commit_xla", refuse)
    monkeypatch.setattr(TP, "pack_units_dense", refuse)
    buf, n, ctx = stage_segment(b"", _payload("text")[:20000], NB)
    ck, zero = TP.encode_segment_ctx(torch.from_numpy(buf), n, ctx, NB, stage_cut=k)
    assert ck.dtype == zero.dtype == torch.int32 and int(zero) == 0


@pytest.mark.parametrize("k", [0, 8])
def test_stage_cut_outside_1_to_7_raises(k):
    buf, n, ctx = stage_segment(b"", _payload("text")[:2000], NB)
    with pytest.raises(ValueError, match="stage_cut"):
        TP.encode_segment_ctx(torch.from_numpy(buf), n, ctx, NB, stage_cut=k)
