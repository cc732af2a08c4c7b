"""ctypes bindings to the host codec of ``native/flate_native.c`` (a C
source beside the packages; read here, never edited): the token scanner
``mf_scan_tokens`` that the scalar decode needs, and the one-shot
``compress`` / ``decompress`` of the ``'native'`` backend over
``mf_deflate_fast`` and ``mf_inflate_dict``; ``available()`` tells the
one-shot ``'auto'`` backend whether that library builds here.

The port's counterpart of ``moonbit_flate_tpu/native.py``.  The library is
built with the host C compiler at first use into
``moonbit_flate_tpu_torch/_build/``, named by a hash of the source and the
flags like the CUDA kernels' libraries, so it never touches
``native/libflate_native.so`` (the JAX package's loader rebuilds that
file, and two writers would race when tests run in several processes).
A build that fails raises; there is no fallback in this module: the
caller that has one (``'auto'``) asks ``available()`` first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from .utils.errors import CorruptInputError, UnexpectedEOFError

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


def _load():
    """The library, built and loaded at first use.  Raises RuntimeError if
    it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                path = _lib_path()
                if not os.path.exists(path):
                    _build(path)
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"native codec unavailable: {e}") from e
            lib.mf_scan_tokens.restype = ctypes.c_long
            lib.mf_scan_tokens.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_long, ctypes.c_long]
            lib.mf_deflate_fast.restype = ctypes.c_long
            lib.mf_deflate_fast.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
            lib.mf_inflate_dict.restype = ctypes.c_long
            lib.mf_inflate_dict.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
                ctypes.c_char_p, ctypes.c_long]
            _lib = lib
        return _lib


def available() -> bool:
    """True if the library builds and loads here, as
    ``moonbit_flate_tpu.native.available``.  The one-shot ``'auto'``
    backend takes the pure-Python codec where this is False."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def scanner():
    """``mf_scan_tokens(in, n, toks, cap, dict_len) -> long``."""
    return _load().mf_scan_tokens


def compress(data: bytes, dictionary: bytes | None = None) -> bytes:
    """Exact reference-policy BestSpeed compression (native fast path).

    Writer-dict prepend semantics (SURVEY §2.9.3): with a dictionary, the
    stream is compress(dict[-32K:] + data) — byte-identical to the
    reference's Writer::new_dict behavior for one-shot use.
    """
    lib = _load()
    if dictionary:
        data = bytes(dictionary)[-32768:] + bytes(data)
    data = bytes(data)
    cap = len(data) + (len(data) >> 3) + 1024
    out = ctypes.create_string_buffer(cap)
    res = lib.mf_deflate_fast(data, len(data), out, cap)
    if res < 0:
        raise RuntimeError(f"native deflate failed: {res}")
    return out.raw[:res]


def decompress(data: bytes, dictionary: bytes = b"",
               max_output: int | None = None) -> bytes:
    """Native raw-DEFLATE decode with a reader-style preset dictionary.
    The output buffer grows by 4 while the decoder reports it too small
    (-5), unless ``max_output`` fixes it."""
    lib = _load()
    data = bytes(data)
    dictionary = bytes(dictionary)
    cap = max_output if max_output is not None else max(1024, len(data) * 4)
    while True:
        out = ctypes.create_string_buffer(cap)
        res = lib.mf_inflate_dict(data, len(data), out, cap,
                                  dictionary, len(dictionary))
        if res == -5 and max_output is None:  # output buffer too small
            cap *= 4
            continue
        if res == -4:
            raise UnexpectedEOFError()
        if res < 0:
            raise CorruptInputError(-1)
        return out.raw[:res]
