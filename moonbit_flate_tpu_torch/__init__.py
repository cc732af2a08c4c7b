"""moonbit_flate_tpu_torch: the DEFLATE encoder in PyTorch and CUDA.

The port of ``moonbit_flate_tpu`` to an NVIDIA H100: the same raw
DEFLATE bytes, with the TPU's Pallas kernels rewritten by hand in CUDA
(``csrc/``, built with nvcc at first use).  This package imports
neither JAX nor the JAX package.  Entry points run on the card unless
the caller passes ``device="cpu"``, which takes the plain PyTorch route.
Decompression is not ported yet.
"""

from __future__ import annotations

from .api.cuda import CUDACompressor

__all__ = ["CUDACompressor", "compress"]


def compress(data: bytes, dictionary: bytes | None = None,
             device=None) -> bytes:
    """One-shot raw-DEFLATE compression with the segment encoder
    (16-block segments; a dictionary is a reader-style preset)."""
    return CUDACompressor(device=device).compress(data, dictionary)
