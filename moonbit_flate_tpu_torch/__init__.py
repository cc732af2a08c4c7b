"""moonbit_flate_tpu_torch: the DEFLATE codec in PyTorch and CUDA.

The port of ``moonbit_flate_tpu`` to an NVIDIA H100: the same raw
DEFLATE bytes, with the TPU's Pallas kernels rewritten by hand in CUDA
(``csrc/``, built with nvcc at first use).  This package imports
neither JAX nor the JAX package.  The device entry points run on the
card unless the caller passes ``device="cpu"``, which takes the plain
PyTorch route.

- ``compress`` / ``decompress``: one-shot raw DEFLATE with pluggable
  backends — 'native' (C fast path, exact reference policy), 'python'
  (pure-Python host codec), 'cuda' (the device pipeline, on the card
  unless ``device=`` says otherwise).  'auto', the default, means
  'native' where the C codec builds, else 'python', as in the JAX
  package, so the default call gives the JAX package's bytes.
- ``Writer`` / ``Reader``: streaming surfaces mirroring the reference's
  io.WriteCloser / io.ReadCloser semantics, including writer-side
  prepend-dictionary and reader-side preset-dictionary behavior.
- ``CUDACompressor``: the segment encode on one card;
  ``ShardedCompressor`` / ``make_mesh``: the same over several devices,
  driven from one process (every visible card by default) or over the
  ranks of a ``torch.distributed`` process group.
- ``decompress_shards`` (lane-parallel decode of shard streams of at
  most 4 KiB), ``decompress_segments`` (scalar-path decode of a batch of
  independent streams), and the shard-manifest pair
  ``compress_with_manifest`` / ``decompress_with_manifest``.
- ``CodecConfig``: the frozen configuration with its factories.
"""

from __future__ import annotations

from . import native as _native
from .api.cuda import CUDACompressor, compress as _cuda_compress
from .api.stream import Writer, compress as _py_compress
from .config import CodecConfig
from .inflate.cuda_inflate import decompress as _cuda_decompress
from .inflate.cuda_inflate import decompress_segments
from .inflate.decoder import Reader, decompress as _py_decompress
from .ops.lanes_resolve import decompress_shards
from .parallel.sharded import (ShardManifest, ShardedCompressor,
                               compress_with_manifest,
                               decompress_with_manifest, make_mesh)

__all__ = ["CUDACompressor", "CodecConfig", "Reader", "ShardManifest",
           "ShardedCompressor", "Writer", "compress", "compress_with_manifest",
           "decompress", "decompress_segments", "decompress_shards",
           "decompress_with_manifest", "make_mesh"]


def _one_shot_backend(backend: str, device) -> str:
    """``backend`` with 'auto' resolved; a device asked of a host backend
    raises, so a call never runs on the host when it names the card."""
    if backend == "auto":
        backend = "native" if _native.available() else "python"
    if device is not None and backend in ("native", "python"):
        raise ValueError('device= applies to backend="cuda" only')
    return backend


def compress(data: bytes, dictionary: bytes | None = None,
             backend: str = "auto", device=None) -> bytes:
    """One-shot BestSpeed raw-DEFLATE compression.

    backend 'auto' prefers the native fast path, falling back to pure
    Python; both run the exact host policy (a dictionary there is the
    writer's prepend).  'cuda' runs the segment encoder on ``device``
    (``None`` means the card, and raises without one; dictionaries there
    follow reader-style preset semantics, SURVEY §2.9.4).  ``device=``
    applies to 'cuda' only: with a host backend it raises ``ValueError``.
    """
    backend = _one_shot_backend(backend, device)
    if backend == "cuda":
        return _cuda_compress(data, dictionary=dictionary, device=device)
    if backend == "native":
        return _native.compress(data, dictionary)
    if backend == "python":
        return _py_compress(data, dictionary)
    raise ValueError(f"unknown backend {backend!r}")


def decompress(data: bytes, dictionary: bytes = b"",
               backend: str = "auto", device=None) -> bytes:
    """One-shot raw-DEFLATE decompression (reader-style preset dict).
    backend 'auto' means 'native' where the C codec builds, else
    'python'; 'cuda' runs the host scanner and the resolver on
    ``device`` (``inflate.cuda_inflate.decompress``); ``device=`` with a
    host backend raises ``ValueError``."""
    backend = _one_shot_backend(backend, device)
    if backend == "cuda":
        return _cuda_decompress(data, dictionary, device=device)
    if backend == "native":
        return _native.decompress(data, dictionary)
    if backend == "python":
        return _py_decompress(data, dictionary)
    raise ValueError(f"unknown backend {backend!r}")
