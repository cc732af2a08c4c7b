"""Bit packing of (value, width) units into 32-bit words.

One CUDA entry, ``pack_batch_launch`` of ``csrc/pack.cu``, serves both
wrappers.  ``pack_units_dense_batch`` replaces the Pallas kernel of
``moonbit_flate_tpu/ops/pack.py:pack_units_dense_batch``
(``_make_place_kernel_batch``): B independent packs, two CUDA kernels on
a grid of (tiles of ``TILE_UNITS`` units, rows) that compute the bit
offsets themselves in int32 (tile sums, then a scan inside each tile)
and build each tile's words in shared memory.  ``pack_units_dense``
replaces ``pack_units_dense`` of that module (``_place_kernel``) as the
entry's one-row case.  What bounds both on the H100 is memory (8 bytes
read a unit, 4 written a word, next to no arithmetic).

``pack_units_ref`` is the plain PyTorch twin of the one-row form (the
port of ``moonbit_flate_tpu/ops/pipeline.py:pack_units``) and
``pack_units_batch_ref`` the port of its ``vmap``.  The wrappers take the
twins for CPU tensors only; for CUDA tensors they launch the kernels.
``launches`` counts calls of ``pack_units_dense`` that launched,
``launches_batch`` those of ``pack_units_dense_batch``: one a call
whatever number of CUDA kernels the entry runs.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

TILE_UNITS = 2048   # units a tile of the batched kernels (kTileUnits)
MAX_WIDTH = 28      # the widest unit
ALL_PASSES = 3      # pack_batch_launch: 1 tile sums and zeroing, 2 scan and place

launches = 0        # kernel launches made by pack_units_dense
launches_batch = 0  # calls of pack_units_dense_batch that launched its kernels

# values, widths, words, bits, tile_sums, rows, nu, n_words, phases, stream
_ARGTYPES_BATCH = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_void_p])


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
    """Same contract as ``pack_units_ref``; for CUDA tensors one call of
    ``pack_batch_launch`` with one row.  values, widths: int32[NU]
    (widths 0..28)."""
    if not values.is_cuda:
        return pack_units_ref(values, widths, n_words)
    global launches
    if values.dtype != torch.int32 or widths.dtype != torch.int32 \
            or values.shape != widths.shape or values.dim() != 1:
        raise ValueError("pack_units_dense takes int32[NU] values and widths")
    words, bits = _pack_rows(values[None], widths[None], n_words)
    launches += 1
    return words[0], bits[0]


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


def _batch_buffers(B: int, NU: int, n_words: int, device):
    """Words int32[B, n_words], total bits int32[B] and the tile sums
    int32[B, ntiles] that ``pack_batch_launch`` fills."""
    ntiles = max(1, -(-NU // TILE_UNITS))
    return tuple(torch.empty(shape, dtype=torch.int32, device=device)
                 for shape in ((B, n_words), (B,), (B, ntiles)))


def _launch_batch(values, widths, n_words, bufs, phases=ALL_PASSES):
    """One checked call of ``pack_batch_launch`` on the wrapper's buffers."""
    words, bits, sums = bufs
    B, NU = values.shape
    build.launch("pack", "pack_batch_launch", _ARGTYPES_BATCH, values.device,
                 values.data_ptr(), widths.data_ptr(), words.data_ptr(),
                 bits.data_ptr(), sums.data_ptr(), B, NU, n_words, phases,
                 label="pack_batch")


def pack_units_dense_batch(values: torch.Tensor, widths: torch.Tensor,
                           n_words: int):
    """Same contract as ``pack_units_batch_ref``; one call of the batched
    kernels of ``csrc/pack.cu`` for CUDA tensors.  values, widths:
    int32[B, NU] (widths 0..28)."""
    if not values.is_cuda:
        return pack_units_batch_ref(values, widths, n_words)
    global launches_batch
    if values.dtype != torch.int32 or widths.dtype != torch.int32 \
            or values.shape != widths.shape or values.dim() != 2:
        raise ValueError("pack_units_dense_batch takes int32[B, NU] values "
                         "and widths")
    words, bits = _pack_rows(values, widths, n_words)
    launches_batch += 1
    return words, bits


def _pack_rows(values, widths, n_words):
    """One call of ``pack_batch_launch`` on int32[B, NU] CUDA units:
    words int32[B, n_words] and total bits int32[B]."""
    B, NU = values.shape
    if NU * MAX_WIDTH >= 1 << 31:
        raise ValueError(f"pack_units_dense: {NU} units a row may hold "
                         f"2**31 bits or more; offsets are int32")
    values = values.contiguous()
    widths = widths.contiguous()
    bufs = _batch_buffers(B, NU, n_words, values.device)
    _launch_batch(values, widths, n_words, bufs)
    return bufs[0], bufs[1]
