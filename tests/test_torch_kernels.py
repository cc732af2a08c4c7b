"""Port parity of the two kernel modules' plain twins against the Pallas
kernels they replace, run in interpret mode on the CPU (exact).

The CUDA kernels themselves run only on the card: chip_smoke.py builds
them and holds each against these twins there.  Here the wrappers get
CPU tensors and so take the twins, which this file checks against
``walk_batch`` and ``pack_units_dense`` of the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonbit_flate_tpu.formats import constants as JC
from moonbit_flate_tpu.ops.matcher import find_matches, pack_match_info
from moonbit_flate_tpu_torch.ops import pack as TPK
from moonbit_flate_tpu_torch.ops import pipeline as TP
from moonbit_flate_tpu_torch.ops import walk as TW

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)

BLOCK = 65535
PAD = 320


def _unit_cases():
    """The unit sets of tests/test_kernels_interpret.py."""
    rng = np.random.default_rng(7)
    cases = []
    for n in (1, 7, 256, 4097, 70000):
        w = rng.integers(0, 29, n).astype(np.int32)
        v = rng.integers(0, 1 << 28, n).astype(np.int64).astype(np.int32)
        cases.append((v, w))
    w = rng.integers(0, 29, 30000).astype(np.int32)
    w[rng.random(30000) < 0.7] = 0
    v = rng.integers(0, 1 << 28, 30000).astype(np.int64).astype(np.int32)
    cases.append((v, w))
    w = np.zeros(1000, np.int32)
    w[500] = 13
    v = np.full(1000, 0x1ABC, np.int32)
    cases.append((v, w))
    return cases


@pytest.mark.parametrize("idx", range(7))
def test_pack_twin_matches_pallas_pack(idx):
    from moonbit_flate_tpu.ops.pack import pack_units_dense

    v, w = _unit_cases()[idx]
    n_words = int(w.sum()) // 32 + 4
    jw, jt = pack_units_dense(jnp.asarray(v), jnp.asarray(w), n_words,
                              interpret=True)
    before = TPK.launches
    tw, tt = TPK.pack_units_dense(torch.from_numpy(v), torch.from_numpy(w), n_words)
    assert TPK.launches == before          # CPU tensors take the twin
    assert int(tt) == int(jt)
    assert np.array_equal(tw.numpy().view(np.uint32), np.asarray(jw))


def test_pack_twin_drops_words_past_n_words():
    v, w = _unit_cases()[4]
    n_words = int(w.sum()) // 64          # half the stream
    full, total = TPK.pack_units_ref(torch.from_numpy(v), torch.from_numpy(w),
                                     int(w.sum()) // 32 + 2)
    cut, total_cut = TPK.pack_units_ref(torch.from_numpy(v), torch.from_numpy(w),
                                        n_words)
    assert int(total) == int(total_cut) == int(w.sum())
    assert torch.equal(cut, full[:n_words])


def _payloads():
    """The payloads of tests/test_kernels_interpret.py."""
    rng = np.random.default_rng(3)
    ramp = (bytes(range(128)) * 2000)[:130000]
    text = (b"compression window huffman block stream symbol match " * 4000)[:130000]
    mixed = bytearray(rng.integers(0, 256, 130000, np.uint8).tobytes())
    mixed[60000:120000] = mixed[:60000]
    mixed[70000:90000] = mixed[50000:70000]   # in-window repeats too
    rle = (b"aaaaabbbbb" * 20000)[:130000]
    return {"ramp": ramp, "text": text, "mixed": bytes(mixed), "rle": rle}


def _pallas_walk(buf, n, ctx, nb):
    """The TPU branch of pipeline._commit_walk_batch, Pallas interpreted."""
    from moonbit_flate_tpu.ops.walk_pallas import CHUNK, HALO, SLACK, walk_batch

    S = nb * BLOCK
    data = jnp.asarray(buf)
    pos = jnp.arange(S, dtype=jnp.int32)
    mlen, dist = find_matches(data, jnp.int32(n))
    block_end = ctx + (jnp.clip(pos - ctx, 0, S - 1) // BLOCK + 1) * BLOCK
    mlen = jnp.minimum(mlen, block_end - pos)
    mlen = jnp.where(mlen >= JC.MIN_MATCH_LENGTH, mlen, 0)
    S_pad = -(-S // CHUNK) * CHUNK
    minfo, grp = pack_match_info(mlen, dist, jnp.int32(ctx), S_pad)
    pb = jnp.concatenate([
        jnp.zeros(HALO, jnp.uint8), data,
        jnp.zeros(HALO + S_pad + SLACK - HALO - data.shape[0], jnp.uint8),
    ]).reshape(-1, 4).astype(jnp.uint32)
    words = pb[:, 0] | (pb[:, 1] << 8) | (pb[:, 2] << 16) | (pb[:, 3] << 24)
    words = jax.lax.bitcast_convert_type(words, jnp.int32)
    bits_o, minfo_o = walk_batch(grp[None], minfo[None], words[None],
                                 jnp.asarray([ctx], jnp.int32),
                                 jnp.asarray([n], jnp.int32), interpret=True)
    bits_o, minfo_o = np.asarray(bits_o[0]), np.asarray(minfo_o[0])
    start = ((bits_o[:, None] >> np.arange(32)) & 1).reshape(-1)[:S] > 0
    return (start, np.where(start, minfo_o[:S] & 511, 0),
            np.where(start, minfo_o[:S] >> 9, 0))


@pytest.mark.parametrize("name", ["ramp", "text", "mixed", "rle"])
@pytest.mark.parametrize("ctx", [0, 1000])
def test_walk_twin_matches_pallas_walk(name, ctx):
    nb = 2
    S = nb * BLOCK
    payload = _payloads()[name]
    buf = np.zeros(S + PAD, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    n = len(payload)
    want_start, want_len, want_dist = _pallas_walk(buf, n, ctx, nb)

    data = torch.from_numpy(buf)
    mlen, dist = TP._find_clip(data, n, ctx, nb)
    before = TW.launches
    committed, start, tlen, tdist = TW.commit_walk(
        data[None], mlen[None], dist[None], [n], [ctx], nb)
    assert TW.launches == before           # CPU tensors take the twin
    assert np.array_equal(start[0].numpy(), want_start)
    assert np.array_equal(tlen[0].numpy(), want_len)
    assert np.array_equal(tdist[0].numpy(), want_dist)
    # committed = match starts plus every uncovered position in [ctx, n)
    pos = np.arange(S)
    reach = np.maximum.accumulate(np.where(want_start, pos + want_len, 0))
    covered = np.concatenate([[False], reach[:-1] > pos[1:]])
    want_committed = (want_start | ~covered) & (pos >= ctx) & (pos < n)
    assert np.array_equal(committed[0].numpy(), want_committed)
