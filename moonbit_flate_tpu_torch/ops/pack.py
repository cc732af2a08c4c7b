"""Bit packing of (value, width) units into 32-bit words.

Kernel 1 of the port.  ``pack_units_dense`` replaces the Pallas kernel
of ``moonbit_flate_tpu/ops/pack.py:pack_units_dense`` (``_place_kernel``)
with ``csrc/pack.cu``: one thread per unit OR-s the unit's two shifted
words into place.  What bounds it on the H100 is memory (8 bytes read
per unit, 4 written per word, next to no arithmetic); the design reads
each unit once and takes the bit offsets from one int64 prefix sum
before the launch, as the JAX package took its sums outside the kernel.

``pack_units_ref`` is the plain PyTorch twin (the port of
``moonbit_flate_tpu/ops/pipeline.py:pack_units``).  The wrapper takes
the twin for CPU tensors only; for CUDA tensors it launches the kernel.

``pack_units_dense_batch`` replaces the Pallas kernel of
``moonbit_flate_tpu/ops/pack.py:pack_units_dense_batch``
(``_make_place_kernel_batch``) with the second kernel of
``csrc/pack.cu``: B independent packs in one launch on a 2-D grid, one
grid row per segment, the offsets from one row-wise prefix sum.  Its
twin ``pack_units_batch_ref`` is the port of the ``vmap`` of
``pack_units``, and ``launches_batch`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

launches = 0        # kernel launches made by pack_units_dense
launches_batch = 0  # kernel launches made by pack_units_dense_batch

# values, widths, offsets, words, nu, n_words, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
# values, widths, offsets, words, rows, nu, n_words, stream
_ARGTYPES_BATCH = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p])


def _offsets(widths: torch.Tensor):
    """Exclusive prefix sum of the widths along the last axis (int64)
    and the totals."""
    csum = torch.cumsum(widths.long(), -1)
    return csum - widths.long(), csum[..., -1].int()


def pack_units_ref(values: torch.Tensor, widths: torch.Tensor, n_words: int):
    """LSB-first bit packing: units (<= 28 bits each) into n_words
    32-bit words (int32 tensor holding the u32 bit patterns), plus the
    total bit count.  Each unit lands in at most two words; bits of
    distinct units are disjoint, so an add is an OR.  Words at or past
    n_words are dropped."""
    w = widths.long()
    v = values.long() & ((1 << w) - 1)
    offsets, total = _offsets(widths)
    w_idx = offsets >> 5
    sh = offsets & 31
    lo = (v << sh) & 0xFFFFFFFF
    hi = (v >> 1) >> (31 - sh)
    words = torch.zeros(n_words + 2, dtype=torch.int64, device=values.device)
    words.index_add_(0, torch.clamp(w_idx, max=n_words + 1), lo)
    words.index_add_(0, torch.clamp(w_idx + 1, max=n_words + 1), hi)
    words = words[:n_words]
    return torch.where(words >= (1 << 31), words - (1 << 32), words).int(), total


def pack_units_dense(values: torch.Tensor, widths: torch.Tensor, n_words: int):
    """Same contract as ``pack_units_ref``; launches ``csrc/pack.cu`` for
    CUDA tensors.  values, widths: int32[NU] (widths 0..28)."""
    if not values.is_cuda:
        return pack_units_ref(values, widths, n_words)
    global launches
    if values.dtype != torch.int32 or widths.dtype != torch.int32 \
            or values.shape != widths.shape or values.dim() != 1:
        raise ValueError("pack_units_dense takes int32[NU] values and widths")
    values = values.contiguous()
    widths = widths.contiguous()
    offsets, total = _offsets(widths)
    words = torch.zeros(n_words, dtype=torch.int32, device=values.device)
    fn = build.entry("pack", "pack_launch", _ARGTYPES)
    build.check(fn(values.data_ptr(), widths.data_ptr(), offsets.data_ptr(),
                   words.data_ptr(), values.numel(), n_words,
                   torch.cuda.current_stream(values.device).cuda_stream),
                "pack")
    launches += 1
    return words, total


def pack_units_batch_ref(values: torch.Tensor, widths: torch.Tensor,
                         n_words: int):
    """``pack_units_ref`` on every row of [B, NU] units: words
    int32[B, n_words] and total bits int32[B]."""
    w = widths.long()
    v = values.long() & ((1 << w) - 1)
    offsets, total = _offsets(widths)
    w_idx = offsets >> 5
    sh = offsets & 31
    lo = (v << sh) & 0xFFFFFFFF
    hi = (v >> 1) >> (31 - sh)
    words = torch.zeros(values.shape[0], n_words + 2, dtype=torch.int64,
                        device=values.device)
    words.scatter_add_(1, torch.clamp(w_idx, max=n_words + 1), lo)
    words.scatter_add_(1, torch.clamp(w_idx + 1, max=n_words + 1), hi)
    words = words[:, :n_words]
    return torch.where(words >= (1 << 31), words - (1 << 32), words).int(), total


def pack_units_dense_batch(values: torch.Tensor, widths: torch.Tensor,
                           n_words: int):
    """Same contract as ``pack_units_batch_ref``; one launch of the
    batched kernel of ``csrc/pack.cu`` for CUDA tensors.  values,
    widths: int32[B, NU] (widths 0..28)."""
    if not values.is_cuda:
        return pack_units_batch_ref(values, widths, n_words)
    global launches_batch
    if values.dtype != torch.int32 or widths.dtype != torch.int32 \
            or values.shape != widths.shape or values.dim() != 2:
        raise ValueError("pack_units_dense_batch takes int32[B, NU] values "
                         "and widths")
    values = values.contiguous()
    widths = widths.contiguous()
    offsets, total = _offsets(widths)
    B, NU = values.shape
    words = torch.zeros(B, n_words, dtype=torch.int32, device=values.device)
    fn = build.entry("pack", "pack_batch_launch", _ARGTYPES_BATCH)
    build.check(fn(values.data_ptr(), widths.data_ptr(), offsets.data_ptr(),
                   words.data_ptr(), B, NU, n_words,
                   torch.cuda.current_stream(values.device).cuda_stream),
                "pack_batch")
    launches_batch += 1
    return words, total
