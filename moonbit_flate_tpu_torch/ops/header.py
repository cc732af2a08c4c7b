"""Dynamic-header codegen RLE (RFC 1951 §3.2.7), batched over blocks.

Port of ``moonbit_flate_tpu/ops/header.py``.  The sequential greedy RLE
has closed-form chunk boundaries (16-chunks at multiples of 6 within a
nonzero run, 18-chunks at multiples of 138 within a zero run), so every
position of the 316-entry length array computes its own emission.
"""

from __future__ import annotations

import torch

from .dense import hist_rows

SEQ_LEN = 286 + 30  # concatenated lit + dist code length arrays


def codegen_emissions(seq: torch.Tensor, valid_len: torch.Tensor):
    """Per-position codegen emission schedule for a batch of blocks.

    seq: int32[B, 316] concatenated code lengths (garbage past
    valid_len); valid_len: int32[B].
    Returns (sym, payload_val, payload_width) int32[B, 316] and
    freq int32[B, 19]; sym = -1 where the position emits nothing.
    """
    B, J = seq.shape
    dev = seq.device
    j = torch.arange(J, dtype=torch.int32, device=dev)[None, :]
    vl = valid_len.int()[:, None]
    valid = j < vl
    prev = torch.full_like(seq, -1)
    prev[:, 1:] = seq[:, :-1]
    is_start = valid & ((j == 0) | (seq != prev))
    run_start = torch.cummax(torch.where(is_start, j, 0), dim=1).values
    nxt = torch.full_like(seq, -1)
    nxt[:, :-1] = seq[:, 1:]
    is_end = valid & ((j == vl - 1) | (seq != nxt))
    end_idx = torch.where(is_end, j, J)
    run_end = torch.flip(
        torch.cummin(torch.flip(end_idx, [1]), dim=1).values, [1])
    run_len = run_end - run_start + 1
    v = torch.gather(seq, 1, run_start.long())
    m = j - run_start

    # nonzero runs: literal at m == 0, 16-chunks at (m-1) % 6 == 0
    c0_nz = run_len - 1
    t_end = c0_nz // 6 + ((c0_nz % 6) >= 3).int()
    mp = m - 1
    nz_lit_head = m == 0
    nz_chunk = (m >= 1) & (mp % 6 == 0) & (mp // 6 < t_end)
    nz_rep = torch.clamp(c0_nz - mp, max=6)
    nz_tail = (m >= 1) & (mp >= 6 * t_end)

    # zero runs: 18-chunks at m % 138 == 0, then one 17 or literals
    c0_z = run_len
    rem0 = c0_z % 138
    consumed18 = c0_z - rem0 + torch.where(rem0 >= 11, rem0, 0)
    z_chunk18 = (m % 138 == 0) & (m < consumed18)
    z_rep18 = torch.clamp(c0_z - m, max=138)
    rem = c0_z - consumed18            # 0..10
    z_chunk17 = (rem >= 3) & (m == consumed18)
    z_tail = (rem < 3) & (m >= consumed18)

    nz = valid & (v != 0)
    zr = valid & (v == 0)
    sym = torch.full_like(seq, -1)
    sym = torch.where(nz & nz_lit_head, v, sym)
    sym = torch.where(nz & nz_chunk, 16, sym)
    sym = torch.where(nz & nz_tail, v, sym)
    sym = torch.where(zr & z_chunk18, 18, sym)
    sym = torch.where(zr & z_chunk17, 17, sym)
    sym = torch.where(zr & z_tail, 0, sym)

    pay_w = torch.zeros_like(seq)
    pay_v = torch.zeros_like(seq)
    pay_w = torch.where(nz & nz_chunk, 2, pay_w)
    pay_v = torch.where(nz & nz_chunk, nz_rep - 3, pay_v)
    pay_w = torch.where(zr & z_chunk18, 7, pay_w)
    pay_v = torch.where(zr & z_chunk18, z_rep18 - 11, pay_v)
    pay_w = torch.where(zr & z_chunk17, 3, pay_w)
    pay_v = torch.where(zr & z_chunk17, rem - 3, pay_v)

    freq = hist_rows(torch.where(sym >= 0, sym, 19), 19)
    return sym, pay_v, pay_w, freq
