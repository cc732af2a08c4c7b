"""Run a CUDA kernel of ``csrc/`` on the CPU, to test its logic where
there is no card and no nvcc.

``csrc/emu/cuda_runtime.h`` stands in for the CUDA headers: one OS
thread a CUDA thread, barriers and warp collectives on spinning
counters, the blocks of a launch one after another.  ``entry`` rewrites
a source's launch statements (``kernel<<<grid, block, shared, stream>>>(...)``)
into calls of that header's ``emu_launch`` and its dynamic shared array
(``extern __shared__ T name[];``) into a pointer to the buffer
``emu_launch`` makes, compiles the result with
g++ into ``_build/`` and returns the same C entry point that
``build.entry`` gives on the card, to be called with the ``data_ptr()``
of CPU tensors and no stream.  A source that uses inline PTX keeps a
plain C++ form of it behind ``#ifdef __CUDACC__``.

This is a test tool: no wrapper calls it, it is slow (use small
shapes), and it cannot show what only real warps do (a missing
``__syncwarp``, a launch the card refuses).  ``chip_smoke.py`` stays
the proof that a kernel builds and is right on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

from . import build

EMU_INCLUDE = os.path.join(build.CSRC, "emu")
CXX_FLAGS = ["-std=c++17", "-O1", "-fPIC", "-shared", "-pthread",
             "-Wno-unknown-pragmas"]

_LAUNCH = re.compile(r"(\w+)<<<(.*?)>>>\s*\((.*?)\);", re.S)
_DYNAMIC_SHARED = re.compile(r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+(\w+)\[\];")
_libs: dict[str, ctypes.CDLL] = {}


def _split_args(text: str) -> list[str]:
    """Split at the commas outside any bracket."""
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(["
        depth -= ch in ")]"
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()]


def _host_source(name: str) -> str:
    with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
        src = f.read()

    def launch(m):
        config = _split_args(m.group(2))
        grid, block = config[:2]
        shared = config[2] if len(config) > 2 else "0"
        return (f"emu_launch(dim3({grid}), dim3({block}), {shared}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")

    src = _DYNAMIC_SHARED.sub(
        r"\1* \2 = reinterpret_cast<\1*>(emu_dynamic_shared);", src)
    return _LAUNCH.sub(launch, src)


def entry(name: str, symbol: str, argtypes):
    """C entry point ``symbol`` of kernel ``name``, compiled for the CPU."""
    lib = _libs.get(name)
    if lib is None:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the kernels cannot be emulated")
        src = _host_source(name)
        with open(os.path.join(EMU_INCLUDE, "cuda_runtime.h"), "rb") as f:
            h = hashlib.sha1(src.encode() + f.read() + " ".join(CXX_FLAGS).encode())
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        stem = os.path.join(build.BUILD_DIR, f"lib{name}-emu-{h.hexdigest()[:12]}")
        if not os.path.exists(stem + ".so"):
            tmp = f"{stem}.{os.getpid()}"
            with open(tmp + ".cpp", "w") as f:
                f.write(src)
            proc = subprocess.run([cxx, *CXX_FLAGS, "-I", EMU_INCLUDE, "-o",
                                   tmp + ".so", tmp + ".cpp"],
                                  capture_output=True, text=True)
            os.unlink(tmp + ".cpp")
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {name}.cu:\n{proc.stderr}")
            os.replace(tmp + ".so", stem + ".so")
        lib = _libs[name] = ctypes.CDLL(stem + ".so")
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
