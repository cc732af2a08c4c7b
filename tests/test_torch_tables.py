"""Port parity: constants, code tables and dense helpers of
moonbit_flate_tpu_torch against the JAX package (exact, integer-only)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonbit_flate_tpu.formats import constants as JC
from moonbit_flate_tpu.ops import dense as JD
from moonbit_flate_tpu.ops import tables as JT
from moonbit_flate_tpu_torch.formats import constants as TC
from moonbit_flate_tpu_torch.ops import dense as TD
from moonbit_flate_tpu_torch.ops import tables as TT

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CONSTANTS = [
    "WINDOW_SIZE", "MAX_MATCH_OFFSET", "BASE_MATCH_LENGTH",
    "MAX_MATCH_LENGTH", "MIN_MATCH_LENGTH", "MAX_STORE_BLOCK_SIZE",
    "MAX_NUM_LIT", "MAX_NUM_DIST", "NUM_CODES", "END_BLOCK_MARKER",
    "LIT_LEN_MAX_BITS", "CODEGEN_MAX_BITS", "CODEGEN_ORDER", "LENGTH_BASE",
    "LENGTH_EXTRA_BITS", "LENGTH_CODES", "OFFSET_BASE", "OFFSET_EXTRA_BITS",
    "OFFSET_CODES",
]


@pytest.mark.parametrize("name", _CONSTANTS)
def test_constant_tables_equal_jax_package(name):
    want = np.asarray(getattr(JC, name))
    got = np.asarray(getattr(TC, name))
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_length_code_all_xlen():
    x = np.arange(256, dtype=np.int32)
    assert np.array_equal(TT.length_code(_t(x)).numpy(),
                          np.asarray(JT.length_code(jnp.asarray(x))))


def test_offset_code_all_xoff():
    x = np.arange(32768, dtype=np.int32)
    assert np.array_equal(TT.offset_code(_t(x)).numpy(),
                          np.asarray(JT.offset_code(jnp.asarray(x))))


@pytest.mark.parametrize("fn,n_codes", [("length_base_extra", 29),
                                        ("offset_base_extra", 30)])
def test_base_extra_all_codes(fn, n_codes):
    c = np.arange(n_codes, dtype=np.int32)
    for got, want in zip(getattr(TT, fn)(_t(c)), getattr(JT, fn)(jnp.asarray(c))):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_take1d_and_take_rows_match_jax():
    rng = np.random.default_rng(0)
    table = rng.integers(-1000, 1000, 40).astype(np.int32)
    idx = rng.integers(-3, 44, (5, 17)).astype(np.int32)   # some out of range
    assert np.array_equal(TD.take1d(_t(table), _t(idx)).numpy(),
                          np.asarray(JD.take1d(jnp.asarray(table), jnp.asarray(idx))))
    rows = rng.integers(-1000, 1000, (5, 40)).astype(np.int32)
    assert np.array_equal(
        TD.take_rows(_t(rows), _t(idx)).numpy(),
        np.asarray(JD.take_rows(jnp.asarray(rows), jnp.asarray(idx))))


def test_hist_rows_matches_jax():
    rng = np.random.default_rng(1)
    idx = rng.integers(-2, 33, (4, 3000)).astype(np.int32)   # some dropped
    assert np.array_equal(TD.hist_rows(_t(idx), 30).numpy(),
                          np.asarray(JD.hist_rows(jnp.asarray(idx), 30)))


def test_sort_carry_is_stable_like_jax():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 6, (3, 500)).astype(np.int32)     # many ties
    pay = rng.integers(0, 1 << 30, (3, 500)).astype(np.int32)
    got = TD.sort_carry(_t(keys), _t(pay))
    want = JD.sort_carry(jnp.asarray(keys), jnp.asarray(pay))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, moonbit_flate_tpu_torch\n"
        "import moonbit_flate_tpu_torch.ops.pipeline, "
        "moonbit_flate_tpu_torch.api.cuda, moonbit_flate_tpu_torch.kernels.build\n"
        "import moonbit_flate_tpu_torch.ops.lanes_inflate, "
        "moonbit_flate_tpu_torch.ops.lanes_resolve, moonbit_flate_tpu_torch.utils.errors\n"
        "import moonbit_flate_tpu_torch.native, moonbit_flate_tpu_torch.ops.parse, "
        "moonbit_flate_tpu_torch.ops.resolve, "
        "moonbit_flate_tpu_torch.inflate.cuda_inflate, "
        "moonbit_flate_tpu_torch.utils.stream_cases\n"
        "import moonbit_flate_tpu_torch.parallel.sharded, "
        "moonbit_flate_tpu_torch.ops.walk, moonbit_flate_tpu_torch.kernels.emulate\n"
        "import moonbit_flate_tpu_torch.config, moonbit_flate_tpu_torch.utils.bits, "
        "moonbit_flate_tpu_torch.utils.utf8, moonbit_flate_tpu_torch.bitio.writer, "
        "moonbit_flate_tpu_torch.huffman.encode, "
        "moonbit_flate_tpu_torch.huffman.decode_table, "
        "moonbit_flate_tpu_torch.lz77.reference_fast, "
        "moonbit_flate_tpu_torch.blocks.emitters, moonbit_flate_tpu_torch.api.stream, "
        "moonbit_flate_tpu_torch.inflate.dict_decoder, "
        "moonbit_flate_tpu_torch.inflate.decoder\n"
        "import moonbit_flate_tpu_torch.bench, moonbit_flate_tpu_torch.utils.corpus\n"
        "assert 'torch.distributed' in sys.modules\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'moonbit_flate_tpu' or m.startswith('moonbit_flate_tpu.')"
        " or m == 'bench']\n"
        "assert not bad, bad\n"
        "assert not any(m == 'triton' or m.startswith('triton.') for m in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=_ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch, tmp_path):
    import torch.distributed as dist

    from moonbit_flate_tpu_torch import (ShardManifest, ShardedCompressor, compress,
                                         compress_with_manifest, decompress,
                                         decompress_segments, decompress_shards,
                                         decompress_with_manifest, make_mesh)
    from moonbit_flate_tpu_torch.api.cuda import CUDACompressor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDACompressor()
    # the one-shot default is the host codec, as in the JAX package
    assert decompress(compress(b"abc")) == b"abc"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decompress_shards([b"\x03\x00"], [0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decompress_segments([b"\x03\x00"], [0])
    assert decompress(b"\x03\x00") == b""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compress_with_manifest(b"abc")
    for payload_size in (1, 5000):         # the lane route, the scalar route
        with pytest.raises(RuntimeError, match="no CUDA device"):
            decompress_with_manifest(b"\x03\x00",
                                     ShardManifest([2], [payload_size], 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compress(b"abc", backend="cuda")
    for backend in ("native", "python"):            # the host backends need no card
        assert decompress(compress(b"abc", backend=backend), backend=backend) == b"abc"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decompress(b"\x03\x00", backend="cuda")
    # no process group: the default mesh is every card, and there is none
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedCompressor()
    # a process group without a device: make_mesh asks for the card
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedCompressor()
        assert make_mesh(device="cpu").device.type == "cpu"
    finally:
        dist.destroy_process_group()
    assert CUDACompressor(device="cpu").device.type == "cpu"


_KERNEL_WRAPPERS = ["walk", "pack", "parse", "resolve", "lanes_inflate",
                    "lanes_resolve"]


@pytest.mark.parametrize("module", _KERNEL_WRAPPERS)
def test_every_kernel_wrapper_launches_through_build_launch(module):
    # build.launch makes the tensors' device current around the C call;
    # a wrapper that took the stream itself would launch on whichever
    # card the process has current and fail on any other
    with open(os.path.join(_ROOT, "moonbit_flate_tpu_torch", "ops", f"{module}.py")) as f:
        src = f.read()
    assert "build.launch(" in src
    assert "current_stream(" not in src and "build.entry(" not in src


@pytest.mark.parametrize("err", [0, 7])
def test_build_launch_makes_the_device_current_around_the_call(monkeypatch, err):
    from moonbit_flate_tpu_torch.kernels import build

    events = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            events.append(("enter", self.device))

        def __exit__(self, *exc):
            events.append(("exit", self.device))

    class Stream:
        cuda_stream = 0xBEEF

    def fake_entry(name, symbol, argtypes):
        def fn(*args):
            events.append(("call", name, symbol, args))
            return err
        return fn

    dev = torch.device("cuda", 1)
    monkeypatch.setattr(build, "entry", fake_entry)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: events.append(("stream", d)) or Stream())
    if err:
        with pytest.raises(RuntimeError, match="pack_batch kernel launch failed"):
            build.launch("pack", "pack_batch_launch", [], dev, 11, 22,
                         label="pack_batch")
    else:
        build.launch("pack", "pack_batch_launch", [], dev, 11, 22, label="pack_batch")
    assert events == [("enter", dev), ("stream", dev),
                      ("call", "pack", "pack_batch_launch", (11, 22, 0xBEEF)),
                      ("exit", dev)]
