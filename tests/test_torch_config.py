"""Port parity of ``CodecConfig`` (``moonbit_flate_tpu_torch/config.py``)
against ``moonbit_flate_tpu/config.py``: the same frozen fields, defaults
and checks, the backend names with 'cuda' in place of 'tpu', and the
factories of the port's compressors (the sharded one on a process mesh
and on a local mesh)."""

import dataclasses

import pytest

from moonbit_flate_tpu import config as JCFG
from moonbit_flate_tpu_torch import config as TCFG
from moonbit_flate_tpu_torch.api.cuda import CUDACompressor
from moonbit_flate_tpu_torch.parallel.sharded import ShardedCompressor, make_mesh


def test_fields_and_defaults_equal_the_original():
    t = [(f.name, f.default) for f in dataclasses.fields(TCFG.CodecConfig)]
    j = [(f.name, f.default) for f in dataclasses.fields(JCFG.CodecConfig)]
    assert t == j
    assert TCFG.CodecConfig.__dataclass_params__.frozen


@pytest.mark.parametrize("nb", [1, 2, 16])
def test_segment_bytes_equal_the_original(nb):
    assert TCFG.CodecConfig(blocks_per_segment=nb).segment_bytes == \
        JCFG.CodecConfig(blocks_per_segment=nb).segment_bytes == nb * 65535


@pytest.mark.parametrize("backend", ["auto", "native", "python"])
def test_shared_backend_names_are_accepted_by_both(backend):
    assert TCFG.CodecConfig(backend=backend).backend == \
        JCFG.CodecConfig(backend=backend).backend == backend


def test_cuda_takes_the_place_of_tpu():
    assert TCFG.CodecConfig(backend="cuda").backend == "cuda"
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        TCFG.CodecConfig(backend="tpu")
    with pytest.raises(ValueError, match="unknown backend 'cuda'"):
        JCFG.CodecConfig(backend="cuda")


@pytest.mark.parametrize("kw", [{"blocks_per_segment": 0},
                                {"blocks_per_segment": -3},
                                {"backend": "gpu"}])
def test_invalid_values_raise_like_the_original(kw):
    with pytest.raises(ValueError) as t_exc:
        TCFG.CodecConfig(**kw)
    with pytest.raises(ValueError) as j_exc:
        JCFG.CodecConfig(**kw)
    assert str(t_exc.value) == str(j_exc.value)


def test_config_is_frozen():
    cfg = TCFG.CodecConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.halo = True


def test_cuda_compressor_factory():
    cfg = TCFG.CodecConfig(blocks_per_segment=2, halo=True)
    comp = cfg.cuda_compressor(device="cpu")
    assert isinstance(comp, CUDACompressor)
    assert (comp.nb, comp.halo, comp.device.type) == (2, True, "cpu")


def test_sharded_compressor_factory(tmp_path):
    import torch.distributed as dist

    cfg = TCFG.CodecConfig(blocks_per_segment=1, halo=True)
    # no group and no card: the default mesh, every card, has none
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.sharded_compressor()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        sc = cfg.sharded_compressor(make_mesh(device="cpu"))
        assert isinstance(sc, ShardedCompressor)
        assert (sc.nb, sc.halo, sc.n_dev, sc.mesh.device.type) == (1, True, 1, "cpu")
        data = b"config factory payload " * 5000
        assert sc.compress(data) == cfg.cuda_compressor(device="cpu").compress(data)
    finally:
        dist.destroy_process_group()


def test_sharded_compressor_factory_on_a_local_mesh():
    cfg = TCFG.CodecConfig(blocks_per_segment=1, halo=True)
    sc = cfg.sharded_compressor(make_mesh(["cpu", "cpu"]))
    assert (sc.nb, sc.halo, sc.n_dev, sc.mesh.device.type) == (1, True, 2, "cpu")
    data = b"config factory payload " * 5000
    assert sc.compress(data) == cfg.cuda_compressor(device="cpu").compress(data)
