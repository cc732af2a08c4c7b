"""Table lookups, per-row histograms and payload-carrying sorts.

Port of ``moonbit_flate_tpu/ops/dense.py``.  The JAX versions are dense
one-hot contractions because XLA's gathers are slow on a TPU; in eager
PyTorch the one-hot form would materialise [rows, N, table] tensors
(over 1 GB for a 16-block segment), so these are written as gathers,
scatter-adds and stable sorts with the same results, including the
JAX versions' rule that an out-of-range index reads 0 or is dropped.
"""

from __future__ import annotations

import torch


def take1d(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 1-D table; out-of-range indices read 0."""
    A = table.shape[0]
    ok = (idx >= 0) & (idx < A)
    got = table[torch.clamp(idx, 0, A - 1).long()]
    return torch.where(ok, got, torch.zeros_like(got))


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row lookup out[b, n] = table[b, idx[b, n]]; out-of-range
    indices read 0.  table: [B, A]; idx: [B, N]."""
    A = table.shape[-1]
    ok = (idx >= 0) & (idx < A)
    got = torch.gather(table, 1, torch.clamp(idx, 0, A - 1).long())
    return torch.where(ok, got, torch.zeros_like(got))


def hist_rows(idx: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Per-row histogram out[b, k] = #{n : idx[b, n] == k} as int32.
    Out-of-range indices are dropped (mask entries with idx >= num_bins).
    """
    B = idx.shape[0]
    ok = (idx >= 0) & (idx < num_bins)
    slot = torch.where(ok, idx, num_bins).long()
    out = torch.zeros(B, num_bins + 1, dtype=torch.int32, device=idx.device)
    out.scatter_add_(1, slot, torch.ones_like(slot, dtype=torch.int32))
    return out[:, :num_bins]


def sort_carry(keys: torch.Tensor, *payloads: torch.Tensor, dim: int = -1):
    """Stable ascending sort of keys, carrying payloads along.

    Returns (sorted_keys, *sorted_payloads).
    """
    skeys, order = torch.sort(keys, dim=dim, stable=True)
    return (skeys,) + tuple(torch.gather(p, dim, order) for p in payloads)
