#!/usr/bin/env python3
"""Whether a local mesh should drive its shards from one thread, one
after another (``LocalMesh.run``, the port's design), or with a host
thread a shard.

Run from the repository root on a machine with one or more cards:

    python3 -m torch_tools.local_mesh_threads

On the 16 MiB corpus (``make_corpus``, seed 0) at nb = 16 it times
``CUDACompressor`` on card 0 and ``ShardedCompressor`` on two meshes:
four shards a wave on card 0, and, with several cards, one shard a wave
on each card (then also on a corpus of 16 MiB a card).  Each mesh runs
as ``LocalMesh`` and as ``ThreadedMesh`` below, the latter also under a
switch interval of 0.1 ms.  Every stream must equal ``CUDACompressor``'s.
It prints the card's name and power limit, then one line a run: the
median of three warm calls in MB/s and every call's seconds.
"""

import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

from moonbit_flate_tpu_torch import CUDACompressor, ShardedCompressor, make_mesh
from moonbit_flate_tpu_torch.kernels import build
from moonbit_flate_tpu_torch.parallel.sharded import LocalMesh, _on_device
from moonbit_flate_tpu_torch.utils.corpus import make_corpus


@dataclass(frozen=True)
class ThreadedMesh(LocalMesh):
    """A local mesh that runs each shard in a host thread of its own,
    with its card current; ``switch_interval`` sets the interpreter's
    for the run (``None``: unchanged)."""

    switch_interval: float | None = None

    def run(self, fn, args):
        old = sys.getswitchinterval()
        if self.switch_interval is not None:
            sys.setswitchinterval(self.switch_interval)
        try:
            with ThreadPoolExecutor(len(args)) as pool:
                futures = [pool.submit(_on_device, dev, fn, a)
                           for dev, a in zip(self.devices, args)]
                return [f.result() for f in futures]
        finally:
            sys.setswitchinterval(old)


def timed(label, comp, data, ref, reps=3):
    if comp.compress(data) != ref:
        raise AssertionError(f"{label}: the stream differs from CUDACompressor's")
    secs = []
    for _ in range(reps):
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        t0 = time.time()
        comp.compress(data)
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        secs.append(time.time() - t0)
    med = statistics.median(secs)
    print(f"{label}: {len(data)} bytes, median {med:.3f} s = "
          f"{len(data) / med / 1e6:.2f} MB/s (calls {', '.join(f'{t:.3f}' for t in secs)})",
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("local_mesh_threads: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    build.build_all()
    cards = torch.cuda.device_count()
    every_card = [f"cuda:{i}" for i in range(cards)]
    sizes = [16 << 20] + ([cards * (16 << 20)] if cards > 1 else [])
    for total in sizes:
        data = make_corpus(total, 0)
        ref = CUDACompressor(16).compress(data)
        timed("CUDACompressor cuda:0", CUDACompressor(16), data, ref)
        meshes = ([["cuda:0"] * 4] if total == 16 << 20 else []) + \
            ([every_card] if cards > 1 else [])
        for devs in meshes:
            mesh = make_mesh(devs)
            for name, m in (("one after another", mesh),
                            ("a thread a shard", ThreadedMesh(mesh.devices)),
                            ("a thread a shard, switch interval 0.1 ms",
                             ThreadedMesh(mesh.devices, 1e-4))):
                timed(f"local mesh {devs}, {name}", ShardedCompressor(m, 16),
                      data, ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
