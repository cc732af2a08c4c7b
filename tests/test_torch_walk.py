"""The tiled decomposition of the greedy walk (``csrc/walk.cu``), as its
plain model ``commit_walk_tiled_ref`` computes it on the CPU, against the
whole-segment twin ``commit_walk_ref`` and against the Pallas kernel
``walk_batch`` in interpret mode.  Integer data, exact equality.

Segments of nb = 2 blocks with tiles of 512 and 4096 positions, so that
tile edges, the 65535-byte block edges and the end of the data fall in
many relative places: a context of 0 and of 32768 bytes, a run of one
byte (258-long matches across tile and block edges), data that ends
inside a tile, repetitive text and mixed random data.  The CUDA kernels
themselves run only on the card: chip_smoke.py holds them against
``commit_walk_ref`` there.
"""

import functools

import numpy as np
import pytest
import torch

from moonbit_flate_tpu_torch.ops import pipeline as TP
from moonbit_flate_tpu_torch.ops import walk as TW
from test_torch_kernels import _pallas_walk

torch.set_num_threads(1)

BLOCK = 65535
PAD = 320
NB = 2
S = NB * BLOCK


def _payload(name):
    rng = np.random.default_rng(5)
    if name == "run":           # one byte: every match is 258 long
        return b"z" * 131000
    if name == "short":         # ends inside a tile, far before S
        return (b"window huffman block stream " * 3000)[:70001]
    if name == "text":
        words = [b"the", b"quick", b"deflate", b"match", b"of", b"entropy", b"a"]
        idx = rng.integers(0, len(words), 40000)
        return b" ".join(words[i] for i in idx)[:S]
    if name == "mixed":         # random bytes with far and near repeats, and runs
        b = bytearray(rng.integers(0, 256, S, np.uint8).tobytes())
        b[50000:90000] = b[20000:60000]
        b[65400:65700] = b"\x07" * 300          # a run across the block edge
        b[100000:100900] = b"abc" * 300
        return bytes(b)
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _case(name, ctx):
    """Inputs, the twin's outputs and the Pallas kernel's for one case."""
    payload = _payload(name)
    n = len(payload)
    buf = np.zeros(S + PAD, np.uint8)
    buf[:n] = np.frombuffer(payload, np.uint8)
    data = torch.from_numpy(buf)
    mlen, dist = TP._find_clip(data, n, ctx, NB)
    args = (data[None], mlen[None], dist[None], [n], [ctx], NB)
    return args, TW.commit_walk_ref(*args), _pallas_walk(buf, n, ctx, NB)


@pytest.mark.parametrize("tile", [512, 4096])
@pytest.mark.parametrize("ctx", [0, 32768])
@pytest.mark.parametrize("name", ["run", "short", "text", "mixed"])
def test_tiled_walk_equals_twin_and_pallas(name, ctx, tile):
    args, want, (p_start, p_len, p_dist) = _case(name, ctx)
    got = TW.commit_walk_tiled_ref(*args, tile=tile)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    committed, start, tlen, tdist = (t[0].numpy() for t in got)
    assert np.array_equal(start, p_start)
    assert np.array_equal(tlen, p_len)
    assert np.array_equal(tdist, p_dist)
    assert start.any() and committed.sum() >= start.sum()


def test_tiled_walk_batch_rows_are_independent():
    """Two segments with different n and ctx in one call."""
    (a, _, _), (b, _, _) = _case("mixed", 0), _case("short", 32768)
    args = (torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]]),
            torch.cat([a[2], b[2]]), a[3] + b[3], a[4] + b[4], NB)
    got = TW.commit_walk_tiled_ref(*args, tile=TW.TILE)
    want = TW.commit_walk_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_tiled_walk_start_past_the_first_tile_and_at_the_end():
    """ctx deep in a later tile, and ctx == n == S (nothing to commit)."""
    args, _, _ = _case("text", 0)
    data, mlen, dist = args[:3]
    for n, ctx in ((S, 70000), (S, S)):
        m, d = TP._find_clip(data[0], n, ctx, NB)
        a = (data, m[None], d[None], [n], [ctx], NB)
        for g, w in zip(TW.commit_walk_tiled_ref(*a, tile=512), TW.commit_walk_ref(*a)):
            assert torch.equal(g, w)


def test_tile_must_hold_a_longest_match():
    args, _, _ = _case("short", 0)
    with pytest.raises(ValueError, match="258"):
        TW.commit_walk_tiled_ref(*args, tile=256)
