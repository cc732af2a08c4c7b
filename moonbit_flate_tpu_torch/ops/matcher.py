"""Vectorized LZ77 match finding, port of ``moonbit_flate_tpu/ops/matcher.py``.

1. *Candidates*: the nearest previous position holding the same 4
   bytes, from one stable sort of the 32-bit little-endian loads (the
   key is the bytes themselves, so candidates are exact).
2. *Small distances (dist <= Z_LAGS)* get exact run lengths from
   lag-compare tables (a reverse cummin per lag).
3. Other candidates report SORT_CAP (">= 4, extend at commit"); the
   greedy walk (ops/walk.py) or extend_matches_xla resolves them.

The JAX version routes sorted candidates back to position order with a
second sort keyed on position; positions form a permutation, so here
that sort is a scatter, which gives the same array.  32-bit loads are
held in int64 so that they compare as unsigned.
"""

from __future__ import annotations

import torch

from ..formats import constants as C

SORT_CAP = 4  # sort candidates report ">= 4, extend at commit"
Z_LAGS = 4    # lags with exact vector-side run lengths (the RLE regime)

_WIN_STRIDE = 1 << 15   # window stride H (= max match distance)
_WIN = 2 * _WIN_STRIDE  # window width: upper-half positions see >= 32 KB


def _load32(data: torch.Tensor, SE: int) -> torch.Tensor:
    """Little-endian 32-bit loads at positions 0..SE-1 of the last
    axis, as int64."""
    d = data.long()
    return (d[..., :SE] | (d[..., 1:SE + 1] << 8) | (d[..., 2:SE + 2] << 16)
            | (d[..., 3:SE + 3] << 24))


def greedy_commit_xla(mlen: torch.Tensor, n: int, start: int = 0):
    """Greedy tokenization via pointer doubling: the positions the
    greedy parse visits from ``start`` (O(log S) gather/scatter rounds)."""
    S = mlen.shape[0]
    dev = mlen.device
    pos = torch.arange(S, dtype=torch.int64, device=dev)
    step = torch.where(mlen >= C.MIN_MATCH_LENGTH, mlen.long(), 1)
    nxt = torch.where(pos < n, torch.clamp(pos + step, max=S), S)
    jump = torch.cat([nxt, torch.full((1,), S, dtype=torch.int64, device=dev)])
    visited = torch.zeros(S + 1, dtype=torch.int32, device=dev)
    visited[min(max(start, 0), S)] = 1
    for _ in range(max(1, (S - 1).bit_length())):
        visited = visited.scatter_reduce(0, jump, visited, "amax",
                                         include_self=True)
        jump = jump[jump]
    return (visited[:S] > 0) & (pos < n) & (pos >= start)


def _tz_bytes(x: torch.Tensor) -> torch.Tensor:
    """Number of trailing zero BYTES of a 32-bit value (0..4)."""
    b0 = (x & 0xFF) == 0
    b1 = (x & 0xFF00) == 0
    b2 = (x & 0xFF0000) == 0
    b3 = (x & 0xFF000000) == 0
    return (b0.int() + (b0 & b1).int() + (b0 & b1 & b2).int()
            + (b0 & b1 & b2 & b3).int())


def _resolve_sorted(skey: torch.Tensor, sj: torch.Tensor) -> torch.Tensor:
    """Nearest-previous candidate from sort-adjacent elements (last
    axis): the previous sorted element's index where its key is equal,
    else -1."""
    same = torch.zeros_like(skey, dtype=torch.bool)
    same[..., 1:] = skey[..., 1:] == skey[..., :-1]
    prevj = torch.zeros_like(sj)
    prevj[..., 1:] = sj[..., :-1]
    return torch.where(same, prevj, -1)


def _nearest_prev_flat(u32e: torch.Tensor, S: int) -> torch.Tensor:
    """Flat-sort candidate search (small segments), one sort a row.
    u32e: int64[B, >= S]; returns int64[B, S]."""
    skey, spos = torch.sort(u32e[:, :S], dim=1, stable=True)
    cand = torch.empty_like(spos)
    cand.scatter_(1, spos, _resolve_sorted(skey, spos))
    return cand


def _nearest_prev_windowed(u32e: torch.Tensor, S: int) -> torch.Tensor:
    """Windowed batched candidate search.

    Distances are <= 32768, so only a 32 KB history matters: each
    segment is cut into 64 KB windows at 32 KB stride, each window is
    sorted on its own ([B, NW, 65536], one batched sort), and each
    position takes its candidate from the window where it sits in the
    upper half (window 0 serves its whole width).
    """
    H = _WIN_STRIDE
    B = u32e.shape[0]
    NH = -(-S // H)
    NW = max(NH - 1, 1)
    need = (NW + 1) * H + 8
    u32p = torch.cat(
        [u32e, u32e.new_zeros(B, max(0, need - u32e.shape[1]))], dim=1)
    halves = u32p[:, : (NW + 1) * H].reshape(B, NW + 1, H)
    key = torch.cat([halves[:, :-1], halves[:, 1:]], dim=2)      # [B, NW, W]
    skey, sj = torch.sort(key, dim=2, stable=True)
    cand_s = _resolve_sorted(skey, sj)                           # -1 = none
    cand_w = torch.empty_like(cand_s)
    cand_w.scatter_(2, sj, cand_s)
    base = (torch.arange(NW, device=u32e.device) * H)[:, None]
    cand_g = torch.where(cand_w >= 0, cand_w + base, -1)
    return torch.cat([cand_g[:, 0], cand_g[:, 1:, H:].reshape(B, -1)],
                     dim=1)[:, :S]


def _small_period_lengths(data: torch.Tensor) -> torch.Tensor:
    """z[b, d-1, i] = length of the agreement run between data[b, i:]
    and data[b, i-d:] for d = 1..Z_LAGS (0 where they differ or i < d),
    clipped at MAX_MATCH_LENGTH.  data: uint8[B, S]; returns
    int32[B, Z_LAGS, S].  All lags of all rows go through one reverse
    cummin: the scan runs serially along a row, and its time hardly
    depends on the number of rows."""
    B, S = data.shape
    pos = torch.arange(S, dtype=torch.int32, device=data.device)
    eq = torch.zeros(B, Z_LAGS, S, dtype=torch.bool, device=data.device)
    for d in range(1, Z_LAGS + 1):
        eq[:, d - 1, d:] = data[:, d:] == data[:, :S - d]
    m = torch.where(eq, S, pos)
    z = torch.flip(torch.cummin(torch.flip(m, [2]), dim=2).values, [2])
    return torch.clamp(z - pos, max=C.MAX_MATCH_LENGTH)


def find_matches_batch(data: torch.Tensor, n: torch.Tensor):
    """Per-position best matches for B segments.

    data: uint8[B, S + 320], each row zero-padded past its n; n:
    int64[B] valid byte counts.  Returns (mlen, dist) int32[B, S]:
    exact lengths for dist <= Z_LAGS, SORT_CAP for other candidates, 0
    where none.  Rows are independent: row b equals ``find_matches`` of
    that segment.
    """
    S = data.shape[1] - 320
    n = n.long()[:, None]
    u32e = _load32(data, S + 300)
    pos = torch.arange(S, dtype=torch.int64, device=data.device)
    if S > 2 * _WIN:
        cand = _nearest_prev_windowed(u32e, S)
    else:
        cand = _nearest_prev_flat(u32e, S)
    del u32e
    dist = pos - cand
    ok = (pos <= n - 4) & (cand >= 0) & (dist <= C.MAX_MATCH_OFFSET)
    mlen = torch.where(ok, SORT_CAP, 0)

    z = _small_period_lengths(data[:, :S])
    for d in range(1, Z_LAGS + 1):
        mlen = torch.where(ok & (dist == d), z[:, d - 1], mlen)
    del z

    # tail safety: bytes past n are padding
    mlen = torch.minimum(mlen, n - pos)
    mlen = torch.where(ok & (mlen >= C.MIN_MATCH_LENGTH), mlen, 0)
    return mlen.int(), torch.where(mlen > 0, dist, 0).int()


def find_matches(data: torch.Tensor, n: int):
    """Per-position best matches for one segment (``find_matches_batch``
    with one row).  data: uint8[S + 320]; n: valid byte count."""
    mlen, dist = find_matches_batch(
        data[None], torch.tensor([n], dtype=torch.int64, device=data.device))
    return mlen[0], dist[0]


def extend_matches_xla(data: torch.Tensor, mlen: torch.Tensor,
                       dist: torch.Tensor, n: int,
                       cap: torch.Tensor) -> torch.Tensor:
    """Resolve SORT_CAP lengths by a vectorized gather loop extending
    every dist > Z_LAGS candidate 4 bytes per round, up to
    min(258, n - pos, cap)."""
    S = mlen.shape[0]
    SE = S + 300
    u32e = _load32(data, SE)
    pos = torch.arange(S, dtype=torch.int64, device=data.device)
    mlen = mlen.long()
    dist = dist.long()
    max_l = torch.minimum(torch.clamp(n - pos, max=C.MAX_MATCH_LENGTH),
                          cap.long())
    active0 = (dist > Z_LAGS) & (mlen == SORT_CAP) & (max_l > SORT_CAP)
    L = torch.where(active0, SORT_CAP, mlen)
    act = active0
    while bool(act.any()):
        a = torch.clamp(pos + L, 0, SE - 1)
        b = torch.clamp(pos - dist + L, 0, SE - 1)
        x = torch.where(act, u32e[a] ^ u32e[b], 1)
        tzb = torch.minimum(_tz_bytes(x).long(), max_l - L)
        L = L + torch.where(act, tzb, 0)
        act = act & (tzb == 4) & (L + 4 <= max_l)
    # a full-word tail may stop 1-3 bytes short of max_l
    a = torch.clamp(pos + L, 0, SE - 1)
    b = torch.clamp(pos - dist + L, 0, SE - 1)
    tail = torch.minimum(_tz_bytes(u32e[a] ^ u32e[b]).long(), max_l - L)
    L = L + torch.where(active0, torch.clamp(tail, min=0), 0)
    return torch.where(mlen > 0, torch.minimum(L, max_l), 0).int()


def pack_match_info(mlen: torch.Tensor, dist: torch.Tensor,
                    ctx: torch.Tensor, S_pad: int):
    """Pack matcher output the way the TPU walk takes it, batched over
    segments (the port of the JAX ``pack_match_info``, held against it in
    the tests; ``csrc/walk.cu`` reads mlen and dist as they are, so
    nothing on the port's paths calls this).

    mlen, dist: int32[B, S]; ctx: int32[B].  Returns
    (minfo int32[B, S_pad] = dist << 9 | mlen at match starts,
     grp int32[B, S_pad / 32] bitmask of match-start positions).
    Positions before ``ctx`` never start a token but stay referencable.
    """
    B, S = mlen.shape
    pos = torch.arange(S, dtype=torch.int32, device=mlen.device)
    has = (mlen >= C.MIN_MATCH_LENGTH) & (pos[None, :] >= ctx[:, None])
    minfo = torch.zeros(B, S_pad, dtype=torch.int32, device=mlen.device)
    minfo[:, :S] = torch.where(has, (dist << 9) | mlen, 0)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=mlen.device)
    grp = ((minfo != 0).reshape(B, -1, 32).long() * weights).sum(-1)
    return minfo, _u32_to_i32(grp)


def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret the low 32 bits of an int64 tensor as int32."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).int()
