"""Length-limited Huffman construction batched over blocks.

Port of ``moonbit_flate_tpu/ops/huffman_jax.py``: the boundary
package-merge recurrence over fixed-shape sorted lists, for a [B, A]
batch of frequency tables at once.  Ties break as in the JAX version
and the host oracle: symbols sort stably by (freq, symbol), and
packages win weight ties against leaves.  The JAX version ranks and
merges with dense one-hot counts; both lists are sorted, so here the
ranks come from ``searchsorted`` (left for packages, right for leaves)
and the merge is a scatter to those ranks.

Weights are clamped at _INF = 2^22: a block's frequencies sum to at
most 65537, so every selected item weighs less than 65537 * 15 < 2^21
and the clamp never changes the selected set.
"""

from __future__ import annotations

import torch

from .dense import sort_carry, take_rows

_INF = 1 << 22


def _rev16(x: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low ``width`` bits of x (int64 arithmetic)."""
    x = x.long()
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return (x >> (16 - width.long())).int()


def huffman_lengths(freqs: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Code lengths for a batch of frequency tables.

    freqs: int32[B, A] (>= 0, each row sums below 2^17).
    Returns int32[B, A] lengths in 0..max_bits.
    """
    B, A = freqs.shape
    dev = freqs.device
    freqs = freqs.int()
    live = freqs > 0
    n_live = live.sum(1, dtype=torch.int32)                       # [B]
    sym = torch.arange(A, dtype=torch.int32, device=dev).expand(B, A)

    weight = torch.where(live, freqs, _INF)
    w_sorted, sym_sorted = sort_carry(weight, sym)

    # The reference caps max_bits at n_live - 1: extra rounds are inactive.
    n_rounds_eff = torch.clamp(n_live - 1, max=max_bits) - 1
    arange_a = torch.arange(A, dtype=torch.int64, device=dev)
    zero_col = torch.zeros(B, 1, dtype=torch.int32, device=dev)

    weights = torch.cat([w_sorted, torch.full_like(w_sorted, _INF)], dim=1)
    leaf_prefs, actives = [], []
    for t in range(max_bits - 1):
        # packages of a sorted list are sorted, so the level list is a
        # sorted merge; packages win weight ties
        pkg_w = torch.clamp(weights[:, 0::2] + weights[:, 1::2], max=_INF)
        r_pkg = arange_a + torch.searchsorted(w_sorted, pkg_w, side="left")
        r_leaf = arange_a + torch.searchsorted(pkg_w, w_sorted, side="right")
        merged = torch.empty_like(weights)
        merged.scatter_(1, r_pkg, pkg_w)
        merged.scatter_(1, r_leaf, w_sorted)
        # leaf count among the first k merged items, k = 0..2A
        is_leaf = torch.zeros_like(weights).scatter_(
            1, r_leaf, torch.ones_like(w_sorted))
        leaf_prefs.append(torch.cat([zero_col, is_leaf.cumsum(1, dtype=torch.int32)], 1))
        active = t < n_rounds_eff
        actives.append(active)
        weights = torch.where(active[:, None], merged, weights)

    # Backward pass: s_L = 2n-2; x_l = leaves among the first s_l items;
    # s_{l-1} = 2 * (s_l - x_l).  Inactive levels pass s through.
    s = 2 * n_live - 2
    xs = [None] * (max_bits - 1)
    for lvl in reversed(range(max_bits - 1)):
        active = actives[lvl]
        got = take_rows(leaf_prefs[lvl], torch.clamp(s, min=0)[:, None])[:, 0]
        x = torch.where(active, got, 0)
        s = torch.where(active, 2 * (s - x), s)
        xs[lvl] = x
    # level 1 is the plain leaf list: all remaining selected items are leaves
    ranks = torch.arange(A, dtype=torch.int32, device=dev)
    rank_lengths = (ranks[None, :] < s[:, None]).int()
    for x in xs:
        rank_lengths += (ranks[None, :] < x[:, None]).int()

    # back to symbol order (sym_sorted is a permutation per row)
    lengths = torch.empty_like(rank_lengths).scatter_(1, sym_sorted.long(),
                                                      rank_lengths)
    # n_live <= 2: every live symbol gets length 1; n_live == 0: all zero
    lengths = torch.where((n_live <= 2)[:, None], live.int(), lengths)
    return torch.where(live, lengths, 0)


def canonical_codes(lengths: torch.Tensor) -> torch.Tensor:
    """Wire-ready (bit-reversed) canonical codes from lengths [B, A]."""
    B, A = lengths.shape
    dev = lengths.device
    max_len = 15
    live = lengths > 0
    bl_count = torch.zeros(B, max_len + 2, dtype=torch.int32, device=dev)
    bl_count.scatter_add_(1, torch.where(live, lengths, max_len + 1).long(),
                          torch.ones_like(lengths))
    bl_count[:, 0] = 0
    # next_code[l] = (next_code[l-1] + bl_count[l-1]) << 1, next_code[0] = 0
    code = torch.zeros(B, dtype=torch.int32, device=dev)
    next_code = [code]
    for ln in range(1, max_len + 1):
        code = (code + bl_count[:, ln - 1]) << 1
        next_code.append(code)
    next_code = torch.stack(next_code, dim=1)                    # [B, 16]

    # rank of each symbol within its length group, in symbol order
    sym = torch.arange(A, dtype=torch.int32, device=dev).expand(B, A)
    key = torch.where(live, lengths * A + sym, 16 * A + sym)
    _, sorted_lens, sorted_sym = sort_carry(key, lengths, sym)
    is_start = torch.ones_like(sorted_lens, dtype=torch.bool)
    is_start[:, 1:] = sorted_lens[:, 1:] != sorted_lens[:, :-1]
    idx = torch.arange(A, dtype=torch.int32, device=dev).expand(B, A)
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    raw = take_rows(next_code, torch.clamp(sorted_lens, 0, max_len)) \
        + (idx - group_start)
    codes_sorted = _rev16(raw, torch.clamp(sorted_lens, min=1))
    codes = torch.empty_like(codes_sorted).scatter_(1, sorted_sym.long(),
                                                    codes_sorted)
    return torch.where(live, codes, 0)


def build_codes(freqs: torch.Tensor, max_bits: int):
    """freqs[B, A] -> (codes[B, A], lengths[B, A])."""
    lengths = huffman_lengths(freqs, max_bits)
    return canonical_codes(lengths), lengths
