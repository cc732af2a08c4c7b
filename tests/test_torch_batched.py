"""Port parity of the batched encode and the shard-manifest pair:
moonbit_flate_tpu_torch's ``pack_units_dense_batch``, batched
``find_matches``, ``encode_segments_batched``, ``compact_streams``,
``ShardManifest``, ``compress_with_manifest`` and
``decompress_with_manifest`` against the JAX package, on the CPU.
Every comparison is exact (tolerance 0: integers and bytes).  The
inputs come from numpy seeds; the Pallas kernels of the JAX side run in
interpret mode; ``device="cpu"`` and CPU tensors take the port's plain
twins.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moonbit_flate_tpu_torch as mft
from moonbit_flate_tpu.ops import pipeline as JP
from moonbit_flate_tpu.parallel import sharded as JS
from moonbit_flate_tpu.utils import errors as JE
from moonbit_flate_tpu_torch.api.cuda import stage_segment
from moonbit_flate_tpu_torch.ops import matcher as TM
from moonbit_flate_tpu_torch.ops import pack as TPK
from moonbit_flate_tpu_torch.ops import pipeline as TP
from moonbit_flate_tpu_torch.parallel import sharded as TS
from moonbit_flate_tpu_torch.utils import errors as TE

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)

BLOCK = 65535
PAD = 320


# ---- (1) the batched pack -------------------------------------------------------

def _batch_units():
    """Three rows of 4000 units: random widths, all widths zero, and a
    row of wide units whose bits run past n_words."""
    rng = np.random.default_rng(11)
    nu = 4000
    w = rng.integers(0, 29, (3, nu)).astype(np.int32)
    w[0, rng.random(nu) < 0.7] = 0
    w[1] = 0
    w[2] = rng.integers(20, 29, nu)
    v = rng.integers(0, 1 << 28, (3, nu)).astype(np.int32)
    n_words = int(w[0].sum()) // 32 + 40
    assert int(w[2].sum()) // 32 > n_words + 100
    return v, w, n_words


def test_pack_batch_twin_matches_pallas_batch_pack():
    from moonbit_flate_tpu.ops.pack import pack_units_dense_batch

    v, w, n_words = _batch_units()
    jw, jt = pack_units_dense_batch(jnp.asarray(v), jnp.asarray(w), n_words,
                                    interpret=True)
    before = TPK.launches_batch
    tw, tt = TPK.pack_units_dense_batch(torch.from_numpy(v), torch.from_numpy(w),
                                        n_words)
    assert TPK.launches_batch == before    # CPU tensors take the twin
    assert tw.shape == (3, n_words) and tw.dtype == torch.int32
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    assert not tw[1].any() and int(tt[1]) == 0


@pytest.mark.parametrize("row", range(3))
def test_pack_batch_twin_rows_equal_the_one_segment_twin(row):
    v, w, n_words = _batch_units()
    bw, bt = TPK.pack_units_batch_ref(torch.from_numpy(v), torch.from_numpy(w),
                                      n_words)
    ow, ot = TPK.pack_units_ref(torch.from_numpy(v[row]), torch.from_numpy(w[row]),
                                n_words)
    assert torch.equal(bw[row], ow) and int(bt[row]) == int(ot)


def test_pack_batch_of_one_row_equals_the_one_segment_wrapper():
    v, w, n_words = _batch_units()
    bw, bt = TPK.pack_units_dense_batch(torch.from_numpy(v[:1]),
                                        torch.from_numpy(w[:1]), n_words)
    ow, ot = TPK.pack_units_dense(torch.from_numpy(v[0]), torch.from_numpy(w[0]),
                                  n_words)
    assert torch.equal(bw[0], ow) and int(bt[0]) == int(ot)


# ---- (2) the batched matcher ----------------------------------------------------

def _segment_rows(nb):
    """Three staged rows of an nb-block segment: text with far repeats
    and no context, mixed data behind a 32 KB context, a short RLE row."""
    rng = np.random.default_rng(5)
    S = nb * BLOCK
    words = [b"window", b"huffman", b"block", b"stream", b"symbol", b"match",
             b"entropy", b"parallel", b"kernel", b"of", b"and", b"the"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), S // 5))[:S]
    mixed = bytearray(rng.integers(0, 256, S - 32768, np.uint8).tobytes())
    mixed[40000:70000] = mixed[:30000]
    mixed[90000:95000] = b"\x07" * 5000
    context = bytes(mixed[-32768:])
    short = (b"aaaaabbbbb" * 3000 + b"xyz")[:29999]
    return [stage_segment(b"", text, nb),
            stage_segment(context, bytes(mixed), nb),
            stage_segment(b"", short, nb)]


@pytest.mark.parametrize("nb", [2, 4])     # flat sort, windowed sort
def test_find_matches_batch_equals_per_segment(nb):
    staged = _segment_rows(nb)
    data = torch.from_numpy(np.stack([s[0] for s in staged]))
    ns = [s[1] for s in staged]
    assert (nb * BLOCK > 2 * TM._WIN) == (nb == 4)
    bm, bd = TM.find_matches_batch(data, torch.tensor(ns))
    for b, (buf, n, _) in enumerate(staged):
        m, d = TM.find_matches(torch.from_numpy(buf), n)
        assert torch.equal(bm[b], m) and torch.equal(bd[b], d)
        assert int((m > 0).sum()) > 100


def test_find_matches_batch_equals_jax_windowed():
    from moonbit_flate_tpu.ops.matcher import find_matches

    buf, n, _ = _segment_rows(4)[1]
    jm, jd = find_matches(jnp.asarray(buf), jnp.int32(n))
    tm, td = TM.find_matches_batch(torch.from_numpy(buf)[None], torch.tensor([n]))
    assert np.array_equal(tm[0].numpy(), np.asarray(jm))
    assert np.array_equal(td[0].numpy(), np.asarray(jd))


# ---- (3) the batched segment encode ---------------------------------------------

NB = 2


@pytest.fixture(scope="module")
def encoded():
    """Rows with ctx = 0, ctx = 32768 and a short last row through the
    port's batched encode and through JAX encode_segments_batched (its
    CPU route: vmapped plain stages)."""
    staged = _segment_rows(NB)
    bufs = np.stack([s[0] for s in staged])
    ns = [s[1] for s in staged]
    ctxs = [s[2] for s in staged]
    assert ctxs == [0, 32768, 0]
    tw, tb = TP.encode_segments_batched(torch.from_numpy(bufs), ns, ctxs, NB)
    jw, jb = JP.encode_segments_batched(
        jnp.asarray(bufs), jnp.asarray(ns, jnp.int32), jnp.asarray(ctxs, jnp.int32), NB)
    return bufs, ns, ctxs, tw, tb, np.asarray(jw), np.asarray(jb)


def test_encode_segments_batched_equals_jax(encoded):
    _, _, _, tw, tb, jw, jb = encoded
    assert tw.dtype == torch.int32 and tw.shape == jw.shape
    assert np.array_equal(tb.numpy(), jb)
    assert np.array_equal(tw.numpy().view(np.uint32), jw)


def test_encode_segments_batched_equals_the_loop(encoded):
    bufs, ns, ctxs, tw, tb, _, _ = encoded
    lw, lb = TP.encode_segments(torch.from_numpy(bufs), ns, ctxs, NB)
    assert torch.equal(tw, lw) and torch.equal(tb, lb)


@pytest.mark.parametrize("row", range(3))
def test_encode_segments_batched_rows_inflate(encoded, row):
    bufs, ns, ctxs, tw, tb, _, _ = encoded
    assert int(tb[row]) % 8 == 0
    raw = tw[row].numpy().view("<u4").tobytes()[: int(tb[row]) // 8]
    dec = zlib.decompressobj(-15, zdict=bufs[row, :ctxs[row]].tobytes())
    got = dec.decompress(raw + mft.api.cuda.FINAL_EMPTY_BLOCK) + dec.flush()
    assert got == bufs[row, ctxs[row]:ns[row]].tobytes()


def test_encode_segments_batched_checks_the_buffer_width():
    with pytest.raises(ValueError, match="segment buffer"):
        TP.encode_segments_batched(torch.zeros(1, 100, dtype=torch.uint8), [1], [0], NB)


# ---- (4) the stream compaction --------------------------------------------------

def _compact_both(words_u32, bits):
    js, jt = JP.compact_streams(jnp.asarray(words_u32), jnp.asarray(bits))
    ts, tt = TP.compact_streams(torch.from_numpy(words_u32.view(np.int32).copy()),
                                torch.from_numpy(np.array(bits)))
    assert ts.dtype == torch.int32 and ts.shape == js.shape
    assert int(tt) == int(jt)
    assert np.array_equal(ts.numpy().view(np.uint32), np.asarray(js))
    return ts, int(tt)


def test_compact_streams_equals_jax_on_encoded_rows(encoded):
    _, _, _, tw, tb, jw, jb = encoded
    ts, total = _compact_both(jw, jb)
    want = b"".join(tw[b].numpy().view("<u4").tobytes()[: int(tb[b]) // 8]
                    for b in range(3))
    assert ts.numpy().view("<u4").tobytes()[:total] == want


def test_compact_streams_equals_jax_at_every_byte_shift():
    rng = np.random.default_rng(13)
    sizes = np.array([5, 0, 6, 12, 3, 6, 1, 9, 40, 2], np.int32)
    assert set(np.cumsum(sizes)[:-1] % 4) == {0, 1, 2, 3}
    W = 10
    raw = rng.integers(1, 256, (len(sizes), 4 * W), np.uint8)
    raw[np.arange(4 * W)[None, :] >= sizes[:, None]] = 0   # zero past each end
    words = np.ascontiguousarray(raw).view("<u4")
    ts, total = _compact_both(words, sizes * 8)
    assert total == int(sizes.sum())
    want = b"".join(raw[b, :sizes[b]].tobytes() for b in range(len(sizes)))
    assert ts.numpy().view("<u4").tobytes()[:total] == want
    assert not ts.numpy().view(np.uint8)[total:].any()


# ---- (5) compress_with_manifest -------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs two (virtual) devices")
    return JS.make_mesh(jax.devices()[:2])


def _manifest_payload(n_bytes):
    rng = np.random.default_rng(17)
    text = b"shard manifest over one card | " * 4000
    noise = rng.integers(0, 256, 70000, np.uint8).tobytes()
    return ((text + noise) * (n_bytes // 190000 + 1))[:n_bytes]


@pytest.mark.parametrize("n_bytes,wave", [
    (3 * BLOCK + BLOCK // 2, 2),           # about 3.5 shards, two waves of two
    (3 * BLOCK + BLOCK // 2, 16),          # the same in one wave of the port
    (2 * BLOCK, 2),                        # exactly one wave
    (0, 16),                               # empty input
])
def test_compress_with_manifest_equals_jax(mesh, monkeypatch, n_bytes, wave):
    monkeypatch.setattr(TS, "WAVE", wave)
    payload = _manifest_payload(n_bytes)
    j_stream, j_man = JS.compress_with_manifest(payload, mesh, 1)
    t_stream, t_man = mft.compress_with_manifest(payload, blocks_per_segment=1,
                                                 device="cpu")
    assert t_stream == j_stream
    assert t_man.to_dict() == j_man.to_dict()
    assert sum(t_man.comp_sizes) + 5 == len(t_stream)
    assert zlib.decompress(t_stream, wbits=-15) == payload


def test_manifest_dict_round_trips_across_the_packages(mesh):
    payload = _manifest_payload(BLOCK + 700)
    _, j_man = JS.compress_with_manifest(payload, mesh, 1)
    stream, t_man = mft.compress_with_manifest(payload, blocks_per_segment=1,
                                               device="cpu")
    d = t_man.to_dict()
    assert d == {"version": 1, "blocks_per_segment": 1,
                 "comp_sizes": t_man.comp_sizes, "payload_sizes": [BLOCK, 700]}
    assert JS.ShardManifest.from_dict(d).to_dict() == d
    assert mft.ShardManifest.from_dict(j_man.to_dict()).to_dict() == d
    assert b"".join(mft.ShardManifest.from_dict(d).segments(stream)) == stream[:-5]
    with pytest.raises(AssertionError):
        mft.ShardManifest.from_dict(dict(d, version=2))


# ---- (6) decompress_with_manifest -----------------------------------------------

def test_manifest_decode_takes_the_lane_route_for_small_shards(mesh, monkeypatch):
    payload = (b"lane manifest shard | " * 80)[:1500]
    stream, j_man = JS.compress_with_manifest(payload, mesh, 1)
    t_stream, t_man = mft.compress_with_manifest(payload, blocks_per_segment=1,
                                                 device="cpu")
    assert (t_stream, t_man.to_dict()) == (stream, j_man.to_dict())
    called = []
    orig = TS.decompress_shards
    monkeypatch.setattr(TS, "decompress_shards",
                        lambda *a, **kw: called.append("lane") or orig(*a, **kw))
    monkeypatch.setattr(TS, "decompress_segments",
                        lambda *a, **kw: called.append("scalar"))
    got = mft.decompress_with_manifest(stream, t_man, device="cpu")
    assert got == payload == JS.decompress_with_manifest(stream, j_man,
                                                         interpret=True)
    assert called == ["lane"]


def test_manifest_decode_takes_the_scalar_route_for_large_shards(mesh, monkeypatch):
    payload = _manifest_payload(BLOCK + 5000)
    stream, j_man = JS.compress_with_manifest(payload, mesh, 1)
    man = mft.ShardManifest.from_dict(j_man.to_dict())
    called = []
    orig = TS.decompress_segments
    monkeypatch.setattr(TS, "decompress_segments",
                        lambda *a, **kw: called.append("scalar") or orig(*a, **kw))
    monkeypatch.setattr(TS, "decompress_shards",
                        lambda *a, **kw: called.append("lane"))
    got = mft.decompress_with_manifest(stream, man, device="cpu")
    assert got == payload == JS.decompress_with_manifest(stream, j_man,
                                                         interpret=True)
    assert called == ["scalar"]


def test_manifest_decode_of_an_empty_manifest():
    stream, man = mft.compress_with_manifest(b"", device="cpu")
    assert stream == bytes([1, 0, 0, 0xFF, 0xFF]) and man.comp_sizes == []
    assert mft.decompress_with_manifest(stream, man, device="cpu") == b""


@pytest.mark.parametrize("n_bytes", [1500, BLOCK + 5000])   # lane, scalar route
def test_manifest_decode_raises_like_jax_on_a_corrupt_body(mesh, n_bytes):
    payload = _manifest_payload(n_bytes)
    stream, j_man = JS.compress_with_manifest(payload, mesh, 1)
    bad = bytes([0x06]) + stream[1:]       # block type 3
    with pytest.raises(JE.FlateError) as j_exc:
        JS.decompress_with_manifest(bad, j_man, interpret=True)
    with pytest.raises(TE.FlateError) as t_exc:
        mft.decompress_with_manifest(bad, mft.ShardManifest.from_dict(
            j_man.to_dict()), device="cpu")
    assert type(t_exc.value).__name__ == type(j_exc.value).__name__
