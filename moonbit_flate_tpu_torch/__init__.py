"""moonbit_flate_tpu_torch: the DEFLATE codec in PyTorch and CUDA.

The port of ``moonbit_flate_tpu`` to an NVIDIA H100: the same raw
DEFLATE bytes, with the TPU's Pallas kernels rewritten by hand in CUDA
(``csrc/``, built with nvcc at first use).  This package imports
neither JAX nor the JAX package.  Entry points run on the card unless
the caller passes ``device="cpu"``, which takes the plain PyTorch route.

- ``compress`` / ``decompress``: one-shot raw DEFLATE with pluggable
  backends — 'native' (C fast path, exact reference policy), 'python'
  (pure-Python host codec), 'cuda' (the device pipeline).  'auto' means
  'cuda', so that the default runs on the card (in the JAX package it
  means 'native').
- ``Writer`` / ``Reader``: streaming surfaces mirroring the reference's
  io.WriteCloser / io.ReadCloser semantics, including writer-side
  prepend-dictionary and reader-side preset-dictionary behavior.
- ``CUDACompressor``: the segment encode on one card;
  ``ShardedCompressor`` / ``make_mesh``: the same over the ranks of a
  ``torch.distributed`` process group.
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


def compress(data: bytes, dictionary: bytes | None = None,
             backend: str = "auto", device=None) -> bytes:
    """One-shot BestSpeed raw-DEFLATE compression.

    backend 'auto' means 'cuda': the segment encoder on ``device``
    (``None`` means the card; dictionaries there follow reader-style
    preset semantics, SURVEY §2.9.4).  'native' and 'python' run the
    exact host policy (a dictionary there is the writer's prepend).
    """
    if backend in ("auto", "cuda"):
        return _cuda_compress(data, dictionary=dictionary, device=device)
    if backend == "native":
        return _native.compress(data, dictionary)
    if backend == "python":
        return _py_compress(data, dictionary)
    raise ValueError(f"unknown backend {backend!r}")


def decompress(data: bytes, dictionary: bytes = b"",
               backend: str = "auto", device=None) -> bytes:
    """One-shot raw-DEFLATE decompression (reader-style preset dict).
    backend 'auto' means 'cuda': the host scanner and the resolver on
    ``device`` (``inflate.cuda_inflate.decompress``)."""
    if backend in ("auto", "cuda"):
        return _cuda_decompress(data, dictionary, device=device)
    if backend == "native":
        return _native.decompress(data, dictionary)
    if backend == "python":
        return _py_decompress(data, dictionary)
    raise ValueError(f"unknown backend {backend!r}")
