"""moonbit_flate_tpu_torch: the DEFLATE codec in PyTorch and CUDA.

The port of ``moonbit_flate_tpu`` to an NVIDIA H100: the same raw
DEFLATE bytes, with the TPU's Pallas kernels rewritten by hand in CUDA
(``csrc/``, built with nvcc at first use).  This package imports
neither JAX nor the JAX package.  Entry points run on the card unless
the caller passes ``device="cpu"``, which takes the plain PyTorch route.
Ported so far: the one-segment encode (``compress``, ``CUDACompressor``),
the lane-parallel decode of shard streams of at most 4 KiB each
(``decompress_shards``) and the scalar-path decode of streams of any
size (``decompress_segments`` for a batch of independent streams, parse
and resolve kernels; ``decompress`` for one stream, with a preset
dictionary if it has one), and the shard-manifest pair on one device
(``compress_with_manifest`` over the batched segment encode with the
batched pack kernel and the on-device stream compaction,
``decompress_with_manifest`` over the two decode paths).
"""

from __future__ import annotations

from .api.cuda import CUDACompressor
from .inflate.cuda_inflate import decompress, decompress_segments
from .ops.lanes_resolve import decompress_shards
from .parallel.sharded import (ShardManifest, compress_with_manifest,
                               decompress_with_manifest)

__all__ = ["CUDACompressor", "ShardManifest", "compress",
           "compress_with_manifest", "decompress", "decompress_segments",
           "decompress_shards", "decompress_with_manifest"]


def compress(data: bytes, dictionary: bytes | None = None,
             device=None) -> bytes:
    """One-shot raw-DEFLATE compression with the segment encoder
    (16-block segments; a dictionary is a reader-style preset)."""
    return CUDACompressor(device=device).compress(data, dictionary)
