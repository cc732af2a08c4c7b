"""ctypes binding to the host token scanner ``mf_scan_tokens`` of
``native/flate_native.c`` (a C source beside the packages; read here,
never edited).

The port's counterpart of ``moonbit_flate_tpu/native.py``, for the one
function the scalar decode needs.  The library is built with the host C
compiler at first use into ``moonbit_flate_tpu_torch/_build/``, named by
a hash of the source and the flags like the CUDA kernels' libraries, so
it never touches ``native/libflate_native.so`` (the JAX package's loader
rebuilds that file, and two writers would race when tests run in
several processes).  A build that fails raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "flate_native.c")
BUILD_DIR = os.path.join(_PKG, "_build")
CFLAGS = ["-O3", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib = None


def _lib_path() -> str:
    with open(SOURCE, "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(CFLAGS).encode())
    return os.path.join(BUILD_DIR, f"libflate_native-{h.hexdigest()[:12]}.so")


def _build(path: str) -> None:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler: the host token scanner cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run([cc, *CFLAGS, "-o", tmp, SOURCE],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"cc failed for {SOURCE}:\n{res.stdout.decode()}")
    os.replace(tmp, path)       # atomic: another process sees all or nothing


def scanner():
    """``mf_scan_tokens(in, n, toks, cap, dict_len) -> long`` (built and
    loaded at first use).  Raises RuntimeError if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                path = _lib_path()
                if not os.path.exists(path):
                    _build(path)
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"native scanner unavailable: {e}") from e
            lib.mf_scan_tokens.restype = ctypes.c_long
            lib.mf_scan_tokens.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_long, ctypes.c_long]
            _lib = lib
        return _lib.mf_scan_tokens
