"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on
its own into ``_build/lib<name>-<hash>.so`` (``_build/`` sits beside
this package's ``csrc/`` and is listed in ``.gitignore``).  The hash
covers the source and the flags, so an edited source builds anew and
an unchanged one is reused.  Pointers and the stream pass as
``c_void_p``, so ctypes never cuts them to 32 bits.  ``launch`` makes the
tensors' device current around the call, so a wrapper works on any card
whichever one the process has current.  Nothing is built
or loaded at import: the first CUDA call of a wrapper builds what it
needs, and ``build_all`` builds every kernel at once with one nvcc
process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("walk", "pack", "lanes_parse", "lanes_resolve", "parse", "resolve")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one kernel unless its library exists; returns
    (process or None, temporary output, final path)."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None, None, path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, tmp, path


def _finish(name: str, proc, tmp: str, path: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out.decode()}")
    os.replace(tmp, path)


def build_all(names=KERNELS) -> None:
    """Build every kernel library that is missing, all nvcc runs at once."""
    started = [(name, *_start(name)) for name in names]
    for name, proc, tmp, path in started:
        if proc is not None:
            _finish(name, proc, tmp, path)


def entry(name: str, symbol: str, argtypes):
    """C entry point ``symbol`` of kernel ``name`` (built and loaded at
    first use), declared to return the CUDA error code as an int."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_lib_path(name))
        _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, symbol: str, argtypes, device, *args,
           label: str | None = None) -> None:
    """Call ``symbol`` of kernel ``name`` with ``args`` and ``device``'s
    current stream, ``device`` current for the call (CUDA refuses a
    launch into a stream of another device than the current one), and
    raise if it reports an error."""
    fn = entry(name, symbol, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, label or name)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
