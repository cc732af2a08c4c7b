"""Port parity of the sharded layer (``parallel/sharded.py``):
``make_mesh``, ``make_sharded_encoder``, ``ShardedCompressor``,
``compress`` and ``compress_with_manifest`` on both forms of mesh: a
local mesh, one process over a list of devices, and a process mesh over
``torch.distributed``.

Worlds of 2 and 4 CPU processes on the ``gloo`` backend are spawned once,
in a module fixture; every rank runs every case and hands its results
back through a file.  The same fixture runs every case in this process
on local meshes of 2 and 4 CPU devices (``make_mesh(["cpu"] * D)``).
The tests hold the results against each other, against the one-device
``CUDACompressor(device="cpu")``, against zlib and the port's own
decoder, and byte for byte against the JAX package's
``ShardedCompressor`` / sharded step over 2 and 4 of the virtual CPU
devices of ``tests/conftest.py`` (tolerance 0: bytes).  The inputs come
from numpy seeds.  JAX is imported inside the tests only: the spawned
ranks import this module and must not load it.
"""

import datetime
import multiprocessing
import os
import pickle
import time
import traceback
import zlib

import numpy as np
import pytest
import torch

import moonbit_flate_tpu_torch as mft
from moonbit_flate_tpu_torch.api.cuda import CUDACompressor, stage_segment
from moonbit_flate_tpu_torch.formats import constants as C
from moonbit_flate_tpu_torch.ops.pipeline import BLOCK, encode_segment_ctx
from moonbit_flate_tpu_torch.parallel import sharded as TS

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)

NB = 1
WORD_CAP = 1024                  # 4 KB a shard: text fits, random bytes do not
GRAFT_SIZES = [1531, 0, 2048, 733]
WORLDS = (2, 4)
DICTIONARY = b"the quick brown fox jumps over the lazy dog | " * 50
WORLD_TIMEOUT_S = 600
# (mesh kind, D); a gloo world keeps the plain D as its test id
MESHES = ([pytest.param(("gloo", w), id=str(w)) for w in WORLDS]
          + [pytest.param(("local", w), id=f"local{w}") for w in WORLDS])


def _payloads():
    rng = np.random.default_rng(0)
    unit = np.random.default_rng(2).integers(0, 256, 32768, np.uint8).tobytes()
    return {
        "mixed": (b"distributed deflate over a device mesh | " * 3000
                  + rng.integers(0, 256, 40000, np.uint8).tobytes()),
        "text": (b"determinism across meshes " * 10000)[: 3 * BLOCK + 1234],
        "short": b"short payload, most shards empty" * 100,
        "empty": b"",
        "periodic": unit * 5,          # period 32 KB: a halo one byte short misses
        "dictionary": DICTIONARY[200:1800] * 3 + b" tail data",
        "random": np.random.default_rng(5).integers(0, 256, 100000,
                                                    np.uint8).tobytes(),
        "manifest": (b"manifest shard payload | " * 6000
                     + np.random.default_rng(4).integers(0, 256, 3000,
                                                         np.uint8).tobytes()),
    }


# name -> (payload, ShardedCompressor keywords, compress keywords)
CASES = {
    "roundtrip": ("mixed", {}, {}),
    "single_device": ("text", {}, {}),
    "uneven_and_empty_shards": ("short", {}, {}),
    "empty_input": ("empty", {}, {}),
    "no_halo": ("periodic", {}, {}),
    "halo": ("periodic", {"halo": True}, {}),
    "no_dictionary": ("dictionary", {}, {}),
    "dictionary": ("dictionary", {}, {"dictionary": DICTIONARY}),
    "halo_and_dictionary": ("periodic", {"halo": True}, {"dictionary": DICTIONARY}),
    "word_cap_retry": ("random", {"word_cap": WORD_CAP}, {}),
    "word_cap_full": ("random", {}, {}),
    "word_cap_fits": ("text", {"word_cap": WORD_CAP}, {}),
}


def _graft_rows(n_ranks):
    """``__graft_entry__.dryrun_multichip``'s shards: uneven payloads, one
    empty, each with the previous 32 KB of the joined data as context."""
    rng = np.random.default_rng(0)
    base = (b"tiny multichip dry-run payload | " * 64
            + rng.integers(0, 256, 512, np.uint8).tobytes())
    sizes = GRAFT_SIZES[:n_ranks]
    payloads = [bytes((base * 4)[:s]) for s in sizes]
    full = b"".join(payloads)
    rows, off = [], 0
    for p in payloads:
        rows.append((full[max(0, off - C.WINDOW_SIZE): off], p))
        off += len(p)
    return rows, full


def _run_cases(mesh):
    """Every case on this mesh (on a process mesh, this rank's part); the
    results every rank must agree on."""
    data = _payloads()
    out = {}
    for name, (key, sc_kw, kw) in CASES.items():
        out[name] = TS.ShardedCompressor(mesh, NB, **sc_kw).compress(data[key], **kw)
    out["module_compress"] = TS.compress(data["periodic"], mesh, NB, halo=True,
                                         dictionary=DICTIONARY)
    stream, man = TS.compress_with_manifest(data["manifest"], mesh, NB)
    out["manifest"] = (stream, man.to_dict())
    # the capped step alone: sizes stay exact, the gathered words are cut
    sc = TS.ShardedCompressor(mesh, NB, word_cap=WORD_CAP)
    shards = [sc._upload(b"", data["random"][d * sc.seg: (d + 1) * sc.seg], d)
              for d in mesh.shards]
    cut = sc._step(shards)
    full = sc._step_full(shards)
    out["step_cut"] = [(t[1].tolist(), int(t[2]), t[0].numel()) for t in (cut, full)]
    if mesh.size == len(GRAFT_SIZES):
        rows, _ = _graft_rows(mesh.size)
        step = TS.make_sharded_encoder(mesh, 16)
        staged = [stage_segment(*rows[d], 16) for d in mesh.shards]
        shards = [(torch.from_numpy(buf).to(mesh.shard_device(d)), n, ctx)
                  for d, (buf, n, ctx) in zip(mesh.shards, staged)]
        stream, sizes, total = step(shards)
        out["graft"] = (TS._stream_bytes(stream, total), sizes.tolist())
        out["graft_own_shard"] = [
            TS._stream_bytes(words, int(bits) // 8)
            for words, bits in (encode_segment_ctx(*shard, 16) for shard in shards)]
    return out


def _world_main(rank, world, store, out_dir):
    """One rank of a gloo world: run every case, write the results."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        try:
            res = _run_cases(mft.make_mesh(device="cpu"))
        finally:
            dist.destroy_process_group()
    except Exception:
        res = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _jax_results(world):
    """The JAX package's results for every case over ``world`` virtual CPU
    devices.  Its step depends on the mesh, nb and word_cap alone, so
    one step is compiled for each of those and shared by every
    ShardedCompressor (halo, dictionary, the manifest)."""
    import jax
    import jax.numpy as jnp

    from moonbit_flate_tpu.parallel import sharded as JS

    mesh = JS.make_mesh(jax.devices()[:world])
    steps = {}
    make = JS.make_sharded_encoder

    def shared_step(mesh, nb, word_cap=None):
        if (nb, word_cap) not in steps:
            steps[nb, word_cap] = make(mesh, nb, word_cap)
        return steps[nb, word_cap]

    data = _payloads()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "make_sharded_encoder", shared_step)
        for name, (key, sc_kw, kw) in CASES.items():
            out[name] = JS.ShardedCompressor(mesh, NB, **sc_kw).compress(data[key], **kw)
        stream, man = JS.compress_with_manifest(data["manifest"], mesh, NB)
        out["manifest"] = (stream, man.to_dict())
    if world == len(GRAFT_SIZES):
        staged = [stage_segment(c, p, 16) for c, p in _graft_rows(world)[0]]
        j_stream, j_sizes, j_total = make(mesh, 16)(
            jnp.asarray(np.stack([s[0] for s in staged])),
            jnp.asarray([s[1] for s in staged], jnp.int32),
            jnp.asarray([s[2] for s in staged], jnp.int32))
        out["graft"] = (np.asarray(j_stream).view("<u4").tobytes()[: int(j_total)],
                        np.asarray(j_sizes).tolist())
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{(kind, D): ([rank 0's results, ...], the JAX package's results)}
    for gloo worlds of 2 and 4 processes, both spawned at once and given
    WORLD_TIMEOUT_S, and for local meshes of 2 and 4 CPU devices (one
    process: a list of one result); the JAX side and the local meshes are
    computed here while the worlds run."""
    ctx = multiprocessing.get_context("spawn")
    procs, dirs, jax_out = [], {}, {}
    try:
        for world in WORLDS:
            d = dirs[world] = tmp_path_factory.mktemp(f"world{world}")
            for rank in range(world):
                p = ctx.Process(target=_world_main,
                                args=(rank, world, str(d / "store"), str(d)))
                p.start()
                procs.append(p)
        deadline = time.time() + WORLD_TIMEOUT_S
        for world in WORLDS:
            jax_out[world] = _jax_results(world)
        results = {("local", world): ([_run_cases(mft.make_mesh(["cpu"] * world))],
                                      jax_out[world]) for world in WORLDS}
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
        assert not any(p.is_alive() for p in procs), "a gloo world timed out"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    for world, d in dirs.items():
        ranks = []
        for rank in range(world):
            with open(d / f"rank{rank}.pkl", "rb") as f:
                res = pickle.load(f)
            assert "error" not in res, f"rank {rank} of {world}:\n{res['error']}"
            ranks.append(res)
        results["gloo", world] = (ranks, jax_out[world])
    return results


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_results(worlds, world):
    ranks = worlds["gloo", world][0]
    shared = [{k: v for k, v in r.items() if k != "graft_own_shard"} for r in ranks]
    assert all(s == shared[0] for s in shared[1:])
    assert len(ranks) == world


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_equals_jax_sharded_compressor(worlds, mesh, case):
    ranks, jax_res = worlds[mesh]
    got = ranks[0][case]
    assert got == jax_res[case]
    key, _, kw = CASES[case]
    d = zlib.decompressobj(wbits=-15, zdict=kw.get("dictionary", b""))
    assert d.decompress(got) + d.flush() == _payloads()[key]


@pytest.mark.parametrize("mesh", MESHES)
def test_module_compress_equals_the_compressor(worlds, mesh):
    res = worlds[mesh][0][0]
    assert res["module_compress"] == res["halo_and_dictionary"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["roundtrip", "single_device",
                                  "uneven_and_empty_shards", "empty_input"])
def test_sharding_does_not_change_bytes(worlds, mesh, case):
    key = CASES[case][0]
    one = CUDACompressor(blocks_per_segment=NB, device="cpu")
    assert worlds[mesh][0][0][case] == one.compress(_payloads()[key])


@pytest.mark.parametrize("mesh", MESHES)
def test_halo_improves_ratio(worlds, mesh):
    res = worlds[mesh][0][0]
    assert len(res["halo"]) < len(res["no_halo"])
    one = CUDACompressor(blocks_per_segment=NB, halo=True, device="cpu")
    assert res["halo"] == one.compress(_payloads()["periodic"])


@pytest.mark.parametrize("mesh", MESHES)
def test_dictionary_decodes_and_helps(worlds, mesh):
    from moonbit_flate_tpu_torch.inflate.decoder import decompress as py_inflate

    res, payload = worlds[mesh][0][0], _payloads()["dictionary"]
    assert py_inflate(res["dictionary"], dictionary=DICTIONARY) == payload
    assert len(res["dictionary"]) < len(res["no_dictionary"])


@pytest.mark.parametrize("mesh", MESHES)
def test_word_cap_retry_gives_the_full_cap_bytes(worlds, mesh):
    world = mesh[1]
    res = worlds[mesh][0][0]
    assert res["word_cap_retry"] == res["word_cap_full"]
    (cut_sizes, cut_total, cut_words), (sizes, total, words) = res["step_cut"]
    # sizes and total exact under the cap; the stream buffer is cut to it
    assert cut_sizes == sizes and cut_total == total == sum(sizes)
    assert max(sizes) > 4 * WORD_CAP - 4
    assert cut_words == world * WORD_CAP + 1 < words


@pytest.mark.parametrize("mesh", MESHES)
def test_manifest_with_a_mesh(worlds, mesh):
    ranks, jax_res = worlds[mesh]
    stream, man = ranks[0]["manifest"]
    assert (stream, man) == jax_res["manifest"]
    payload = _payloads()["manifest"]
    one_stream, one_man = mft.compress_with_manifest(payload, blocks_per_segment=NB,
                                                     device="cpu")
    assert (stream, man) == (one_stream, one_man.to_dict())
    assert len(man["comp_sizes"]) == -(-len(payload) // BLOCK)
    got = mft.decompress_with_manifest(stream, mft.ShardManifest.from_dict(man),
                                       device="cpu")
    assert got == payload


def _check_graft(ranks, jax_res):
    """The graft step's stream and sizes against the JAX step's and the
    shards encoded one by one (each rank's, or the local mesh's all)."""
    stream, sizes = ranks[0]["graft"]
    assert (stream, sizes) == jax_res["graft"]
    own = [s for r in ranks for s in r["graft_own_shard"]]
    assert stream == b"".join(own)
    assert sizes == [len(s) for s in own]
    full = _graft_rows(len(GRAFT_SIZES))[1]
    assert zlib.decompress(stream + TS.FINAL_EMPTY_BLOCK, wbits=-15) == full


def test_graft_step_equals_jax_and_the_shard_by_shard_encode(worlds):
    _check_graft(*worlds["gloo", len(GRAFT_SIZES)])


def test_graft_step_on_a_local_mesh(worlds):
    _check_graft(*worlds["local", len(GRAFT_SIZES)])


def test_make_mesh_raises_without_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialised"):
        mft.make_mesh(device="cpu")
    # without a group the default mesh is every card, and there is none
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mft.ShardedCompressor(blocks_per_segment=NB)


@pytest.mark.parametrize("backend,device,local_rank,want", [
    ("nccl", None, None, 1),          # rank 5 of 8 on 4 cards: 5 % 4
    ("nccl", None, "3", 3),           # the launcher's LOCAL_RANK wins
    ("nccl", "cuda:2", None, 2),      # a card the caller names
    ("gloo", "cuda", None, 0),        # the current card, given an index
])
def test_make_mesh_makes_the_ranks_card_current(monkeypatch, backend, device,
                                                local_rank, want):
    import torch.distributed as dist

    current = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 5)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    mesh = mft.make_mesh(device)
    assert mesh.device == torch.device("cuda", want)
    assert current == [mesh.device]
    assert (mesh.size, mesh.rank, mesh.backend) == (8, 5, backend)


def test_compress_with_manifest_takes_a_mesh_or_a_device(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        mesh = mft.make_mesh(device="cpu")
        assert (mesh.size, mesh.rank, mesh.device.type, mesh.backend) == \
            (1, 0, "cpu", "gloo")
        with pytest.raises(ValueError, match="not both"):
            mft.compress_with_manifest(b"abc", mesh, NB, device="cpu")
        payload = _payloads()["short"]
        stream, man = mft.compress_with_manifest(payload, mesh, NB)
        one = mft.compress_with_manifest(payload, blocks_per_segment=NB, device="cpu")
        assert (stream, man.to_dict()) == (one[0], one[1].to_dict())
        assert mft.ShardedCompressor(mesh, NB).compress(payload) == stream
    finally:
        dist.destroy_process_group()


def test_make_mesh_without_a_group_takes_every_card(monkeypatch):
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mft.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mft.make_mesh(["cuda:0", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = mft.make_mesh()
    assert isinstance(mesh, TS.LocalMesh)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(3))
    assert (mesh.size, mesh.device, list(mesh.shards)) == \
        (3, torch.device("cuda", 0), [0, 1, 2])


def test_make_mesh_forms_of_a_local_mesh():
    for devices in (["cpu", "cpu"], ("cpu", torch.device("cpu"))):
        mesh = mft.make_mesh(devices)
        assert mesh == TS.LocalMesh((torch.device("cpu"),) * 2)
        assert [mesh.shard_device(d) for d in mesh.shards] == list(mesh.devices)
    with pytest.raises(ValueError, match="at least one device"):
        mft.make_mesh([])
    with pytest.raises(ValueError, match="not both"):
        mft.make_mesh(["cpu"], device="cpu")


@pytest.mark.parametrize("key", ["mixed", "text", "empty", "random"])
def test_local_mesh_of_one_device_equals_cuda_compressor(key):
    data = _payloads()[key]
    one = CUDACompressor(blocks_per_segment=NB, device="cpu").compress(data)
    assert mft.ShardedCompressor(mft.make_mesh(["cpu"]), NB).compress(data) == one
    assert TS.compress(data, mft.make_mesh(["cpu"]), NB) == one


def test_local_mesh_runs_each_shard_with_its_card_current(monkeypatch):
    current = []

    class Device:  # stands for torch.cuda.device: records the current card
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            current.append(self.dev)

        def __exit__(self, *exc):
            current.pop()

    monkeypatch.setattr(torch.cuda, "device", Device)
    devs = tuple(torch.device("cuda", i) for i in (2, 0, 1))
    got = TS.LocalMesh(devs).run(lambda d: (d, list(current)), [0, 1, 2])
    assert got == [(d, [dev]) for d, dev in enumerate(devs)]
    assert current == []
    assert TS.LocalMesh((torch.device("cpu"),) * 2).run(
        lambda d: (d, list(current)), [0, 1]) == [(0, []), (1, [])]


def test_local_mesh_of_eight_devices_equals_cuda_compressor():
    """Eight shards a wave, the last wave short: CUDACompressor's stream."""
    data = _payloads()["mixed"][: 8 * BLOCK + 777]
    one = CUDACompressor(blocks_per_segment=NB, device="cpu").compress(data)
    assert mft.ShardedCompressor(mft.make_mesh(["cpu"] * 8), NB).compress(data) == one
