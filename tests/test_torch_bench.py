"""The port's bench against the JAX side's ``bench.py``: the corpus
generator byte for byte, and both smoke runs (``MF_BENCH_SMOKE=1``, on
the CPU) line against line: the same metric, the same keys under the
port's names, and the same chip-independent fields."""

import json
import os
import subprocess
import sys

import pytest
import torch

import bench as jax_bench
from moonbit_flate_tpu_torch import bench as port_bench
from moonbit_flate_tpu_torch.utils.corpus import make_corpus

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMEOUT_S = 300

# the port's names for bench.py's keys ('cuda' stands for the JAX 'tpu')
_RENAMED = {"decode_tpu_compute_gbps": "decode_cuda_compute_gbps",
            "decode_tpu_gbps": "decode_cuda_gbps"}

# the JAX side's smoke run, with its compilation cache moved from the
# fixed path that bench.py names into the directory given as argv[1]
_JAX_SMOKE = (
    "import runpy, sys\n"
    "import jax\n"
    "cache_dir = sys.argv[1]\n"
    "update = jax.config.update\n"
    "def update_in_tmp(name, value):\n"
    "    update(name, cache_dir if name == 'jax_compilation_cache_dir' else value)\n"
    "jax.config.update = update_in_tmp\n"
    "sys.argv = ['bench.py']\n"
    "runpy.run_path('bench.py', run_name='__main__')\n"
)

# the port's smoke run, which then checks what it imported
_PORT_SMOKE = (
    "import sys\n"
    "from moonbit_flate_tpu_torch import bench\n"
    "rc = bench.main()\n"
    "bad = [m for m in sys.modules if m in ('jax', 'moonbit_flate_tpu', 'bench')"
    " or m.startswith(('jax.', 'moonbit_flate_tpu.'))]\n"
    "assert not bad, bad\n"
    "sys.exit(rc)\n"
)


@pytest.mark.parametrize("total,seed", [(2 * 4 * 65535, 0), (1000, 0), (300_000, 1),
                                        (0, 2)])
def test_make_corpus_equals_bench(total, seed):
    got = make_corpus(total=total, seed=seed)
    assert len(got) == total
    assert got == jax_bench.make_corpus(total=total, seed=seed)


def _last_json(proc, out, err):
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def smoke_lines(tmp_path_factory):
    """Both smoke benches, run at once in subprocesses."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", MF_BENCH_SMOKE="1", PYTHONPATH=_ROOT,
               OMP_NUM_THREADS="2")
    cache_dir = str(tmp_path_factory.mktemp("jax_cache"))
    cmds = {"jax": [sys.executable, "-c", _JAX_SMOKE, cache_dir],
            "port": [sys.executable, "-c", _PORT_SMOKE]}
    procs = {k: subprocess.Popen(c, cwd=_ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    try:
        outs = {k: p.communicate(timeout=_TIMEOUT_S) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {k: _last_json(procs[k], *outs[k]) for k in procs}


def test_smoke_line_has_bench_keys_under_port_names(smoke_lines):
    jax_line, port_line = smoke_lines["jax"], smoke_lines["port"]
    assert port_line["metric"] == jax_line["metric"] == "encode_throughput_silesia_like"
    assert port_line["unit"] == jax_line["unit"] == "GB/s"
    assert set(port_line) == set(jax_line)
    keys = set(port_line["extra"])
    medians = {k for k in keys if k.endswith("_median")}
    assert {"value_median", "ms_per_mb_median"} <= medians
    for k in medians:
        assert k == "value_median" or k[:-len("_median")] in keys
    assert keys - medians == {_RENAMED.get(k, k) for k in jax_line["extra"]} \
        | {"device", "reps"}
    assert port_line["extra"]["reps"] == {"encode": 1}
    assert port_line["extra"]["device"] == {"platform": "cpu"}


def test_smoke_line_fields_equal_bench(smoke_lines):
    jax_extra, port_extra = smoke_lines["jax"]["extra"], smoke_lines["port"]["extra"]
    for k in ("methodology", "compression_ratio", "corpus_mb", "tokens", "blocks"):
        assert port_extra[k] == jax_extra[k], k
    assert port_extra["compression_ratio"] == 0.2617
    assert port_extra["corpus_mb"] == 0.52428
    assert port_extra["tokens"] == {"literals": 106622, "matches": 605}
    assert port_extra["blocks"] == {"stored": 2, "fixed": 0, "dynamic": 3}
    line = smoke_lines["port"]
    assert line["value"] > 0 and line["vs_baseline"] == line["value"]
    assert port_extra["value_median"] > 0 and port_extra["decode_native_gbps"] > 0


def test_bench_raises_without_a_card(monkeypatch):
    def no_corpus(*args, **kwargs):
        raise AssertionError("made a corpus before asking for the card")

    monkeypatch.delenv("MF_BENCH_SMOKE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_bench, "make_corpus", no_corpus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_bench.main()


def test_bench_reports_a_failed_round_trip(monkeypatch, capsys):
    """A wrong stream prints value 0 with "error" and returns 1."""
    real = port_bench.encode_segments

    def corrupt(*args):
        words, bits = real(*args)
        return words ^ 0x10, bits

    monkeypatch.setenv("MF_BENCH_SMOKE", "1")
    monkeypatch.setattr(port_bench, "encode_segments", corrupt)
    assert port_bench.main() == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0 and line["error"] == "round-trip mismatch"
