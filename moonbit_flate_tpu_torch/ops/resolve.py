"""Scalar-path DEFLATE inflate, stage B: packed token records to bytes.

Port of ``moonbit_flate_tpu/ops/resolve_pallas.py`` and of the plain
data-parallel resolver beside it in ``inflate/tpu_inflate.py``.  Token
records are the parser's and the host scanner's: a literal is its byte
value, a match is ``1<<31 | (len-3)<<15 | (dist-1)``; a match with
len > dist repeats byte by byte.

``resolve_tokens_batch`` is the plain formulation (not a kernel in the
reference either): output offsets from a prefix sum, each byte's
covering token from a scatter and a running maximum, and each byte's
source literal by pointer doubling over the "i -> i - dist" jumps, with
overlapping copies folded modulo the distance beforehand.

``resolve_batch`` launches ``csrc/resolve.cu`` (one block a stream, in
rounds over an output window of ``WINDOW`` bytes in shared memory, the
stream's finished output in global memory as the history before it)
for CUDA tensors and returns little-endian int32 output words, zero
past each stream's real output; ``resolve_batch_ref`` is its plain
twin, built on the pointer-doubling resolver, and the wrapper takes it
for CPU tensors only.  ``resolve_rounds_ref`` follows the kernel's
rounds with the window size as an argument, so that tests meet every
window boundary at small sizes; nothing on the decode path calls it.  A
distance that reaches before the stream's start reads as 0 in all three
(the TPU kernel reads whatever its history window held; the parser
rejects such a token, so it never arises on the decode path).
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build

OUT_BYTES = 8192            # output capacity quantum, bytes
WINDOW = 16384              # csrc/resolve.cu's kWindow: bytes in which a round's tokens start
MAX_MATCH = 258

launches = 0  # kernel launches made by resolve_batch

# ntok, tokens, out, n_streams, nt_pad, no_pad, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _resolve_flat(tokens: torch.Tensor, NO: int, before_start_zero: bool):
    """int32[B, NT] tokens -> (uint8[B, NO] bytes, int64[B] output
    lengths).  Streams lie in one flat index space, stream i's bytes at
    [i*NO, (i+1)*NO).  A token that starts at or past NO lands on the
    stream's last slot, which therefore holds no live byte.  A source
    before the stream's start reads the stream's first byte, or 0 with
    ``before_start_zero``."""
    B, NT = tokens.shape
    dev = tokens.device
    toks = tokens.reshape(-1).long()
    is_match = toks < 0
    length = torch.where(is_match, ((toks >> 15) & 0xFF) + 3, 1)
    dist = torch.where(is_match, (toks & 0x7FFF) + 1, 0)
    lit = torch.where(is_match, 0, toks & 0xFF).to(torch.uint8)

    csum = torch.cumsum(length.reshape(B, NT), 1)
    out_len = csum[:, -1]
    tok_base = (torch.arange(B, device=dev) * NO).repeat_interleave(NT)
    out_off = (csum - length.reshape(B, NT)).reshape(-1) + tok_base
    out_off = torch.minimum(out_off, tok_base + NO - 1)

    # covering token of each output byte: token ids scattered at their
    # start offsets, then a running maximum fills the interiors (stream
    # i's first token id i*NT lands on i*NO, so it never leaks across)
    tid = torch.zeros(B * NO, dtype=torch.int64, device=dev).scatter_reduce_(
        0, out_off, torch.arange(B * NT, device=dev), "amax")
    tid = torch.cummax(tid, 0).values

    pos = torch.arange(B * NO, device=dev)
    stream_base = pos // NO * NO
    d = dist[tid]
    start = out_off[tid]
    src = start - d + (pos - start) % torch.clamp(d, min=1)
    if before_start_zero:
        # a byte under a match is 0 in lit_at, so pointing it at itself reads 0
        jump = torch.where((d > 0) & (src >= stream_base), src, pos)
    else:
        jump = torch.where(d > 0, torch.maximum(src, stream_base), pos)
    lit_at = torch.zeros(B * NO, dtype=torch.uint8, device=dev)
    lit_at[out_off] = lit

    # root chase, leaving as soon as a round changes nothing
    for _ in range(21):
        nxt = jump[jump]
        changed = bool((nxt != jump).any())
        jump = nxt
        if not changed:
            break
    return lit_at[jump].reshape(B, NO), out_len


def resolve_tokens_batch(tokens: torch.Tensor, n_tokens_max: int, n_out_max: int):
    """Batched stage B, the plain way: int32[B, NT] -> (uint8[B, NO],
    int32[B] output lengths).  Tokens are padded with zeros past the real
    count (a zero is a literal 0 of one byte; callers slice the result),
    and NO must exceed every stream's real output length."""
    if tokens.shape[1] != n_tokens_max:
        raise ValueError(f"tokens are {tuple(tokens.shape)}, not [B, {n_tokens_max}]")
    out, out_len = _resolve_flat(tokens, n_out_max, before_start_zero=False)
    return out, out_len.int()


def resolve_batch_ref(tokens: torch.Tensor, ntok: torch.Tensor, nt_pad: int,
                      no_pad: int):
    """Kernel f, the plain way: the same output words as ``resolve_batch``."""
    B = tokens.shape[0]
    dev = tokens.device
    n = ntok.long().clamp(0, nt_pad)
    live = torch.arange(nt_pad, device=dev)[None, :] < n[:, None]
    # one slot more than no_pad: the slot that overflowing and padded
    # tokens land on then lies outside the bytes that are kept
    out, out_len = _resolve_flat(torch.where(live, tokens, 0), no_pad + 1,
                                 before_start_zero=True)
    # past the last token a trailing match would run on; the zeroed tokens
    # before that are literal zeros already
    keep = torch.arange(no_pad, device=dev)[None, :] < out_len[:, None]
    out = torch.where(keep, out[:, :no_pad], 0).contiguous()
    return out.view(torch.int32).reshape(B, no_pad // 4)


def _fields(t: torch.Tensor):
    """Output length, distance (0 for a literal) and output offset of each
    token of one stream's int64 records."""
    is_match = t < 0
    length = torch.where(is_match, ((t >> 15) & 0xFF) + 3, 1)
    dist = torch.where(is_match, (t & 0x7FFF) + 1, 0)
    return length, dist, torch.cumsum(length, 0) - length


def round_bounds(tokens: torch.Tensor, no_pad: int, window: int = WINDOW):
    """Kernel f's rounds over one stream's live tokens (int32[n]): a list
    of (w0, k0, k1, e), the window's first byte, the tokens [k0, k1) the
    round takes and the end e of the cells it fills, relative to w0.

    A round starts at the next token's output offset p, in a window of
    cells that begins at p rounded down to 16 (the bytes from there to p
    carried over from the last round), and takes every token whose output
    starts before min(w0 + window, no_pad); the cells past the window are
    its slack, so a match that starts in it ends in it.  The last round
    is the one that takes the last token or reaches no_pad."""
    if window % 16 or window < 16:
        raise ValueError(f"window {window} must be a positive multiple of 16")
    length, _, start = _fields(tokens.long().cpu())
    n, out = len(start), []
    p = k = carry = 0
    while True:
        w0 = p - carry
        k1 = max(k, int(torch.searchsorted(start, min(w0 + window, no_pad))))
        if k1 > k:
            p = int(start[k1 - 1] + length[k1 - 1])
        e = min(p, no_pad) - w0
        out.append((w0, k, k1, e))
        if k1 >= n or p >= no_pad:
            return out
        k, carry = k1, e % 16


def resolve_rounds_ref(tokens: torch.Tensor, ntok: torch.Tensor, nt_pad: int,
                       no_pad: int, window: int = WINDOW):
    """Kernel f's rounds, the plain way, one stream at a time: the same
    words as ``resolve_batch_ref``.

    Each round of ``round_bounds``: token ids scattered at their start
    cells and a running maximum give each byte its token; a byte of a
    match copies the cell s - d + q % d inside the window, or reads the
    finished output before it, or 0 before the stream's start; pointer
    doubling resolves the cells; the finished groups of 16 bytes go out,
    and the last round writes its part group with zeros past the output."""
    B = tokens.shape[0]
    n_all = ntok.long().clamp(0, nt_pad).tolist()
    out = torch.zeros(B, no_pad, dtype=torch.uint8)
    cells = -(-(window - 1 + MAX_MATCH) // 16) * 16
    for b in range(B):
        t = tokens[b, :n_all[b]].long().cpu()
        _, dist, start = _fields(t)
        row = out[b]
        # a cell is a resolved byte (ptr -1) or a pointer to an earlier cell
        byte = torch.zeros(cells, dtype=torch.uint8)
        ptr = torch.full((cells,), -1, dtype=torch.int64)
        rounds = round_bounds(t, no_pad, window)
        carry = 0
        for r, (w0, k0, k1, e) in enumerate(rounds):
            last = r == len(rounds) - 1
            if e > carry:
                cover = torch.full((cells,), -1, dtype=torch.int64)
                cover[start[k0:k1] - w0] = torch.arange(k0, k1)
                tid = torch.cummax(cover[carry:e], 0).values
                at = torch.arange(carry, e)
                s0, d = start[tid] - w0, dist[tid]
                src = s0 - d + (at - s0) % d.clamp(min=1)
                lit = d == 0
                inside = ~lit & (src >= 0)
                before = ~lit & ~inside & (w0 + src >= 0)
                byte[carry:e] = torch.where(lit, t[tid] & 0xFF, 0).to(torch.uint8)
                byte[carry:e][before] = row[(w0 + src)[before]]
                ptr[carry:e] = torch.where(inside, src, -1)
                while bool((ptr >= 0).any()):
                    live = ptr >= 0
                    j = ptr[live]
                    byte[live] = torch.where(ptr[j] < 0, byte[j], byte[live])
                    ptr[live] = ptr[j]
            keep = (e + 15) // 16 * 16 if last else e // 16 * 16
            byte[e:] = 0
            row[w0:w0 + keep] = byte[:keep]
            if last:
                break
            carry = e - keep
            byte[:carry] = byte[keep:e].clone()
            byte[carry:] = 0
    return out.to(tokens.device).view(torch.int32).reshape(B, no_pad // 4)


def resolve_batch(tokens: torch.Tensor, ntok: torch.Tensor, nt_pad: int,
                  no_pad: int):
    """Materialize B token streams into bytes.

    tokens: int32[B, nt_pad] (what lies past ntok[b] is ignored); ntok:
    int32[B] token counts; no_pad: output capacity per stream in bytes,
    where output stops.  Returns int32[B, no_pad / 4] little-endian
    output words, zero past each stream's real output.  One launch of
    ``csrc/resolve.cu`` for CUDA tensors; the plain twin for CPU tensors."""
    if tokens.dtype != torch.int32 or ntok.dtype != torch.int32 \
            or tokens.dim() != 2 or tokens.shape[1] != nt_pad \
            or ntok.shape != tokens.shape[:1] or ntok.device != tokens.device:
        raise ValueError("resolve_batch takes int32[B, nt_pad] tokens and "
                         "int32[B] ntok on one device")
    if nt_pad % 1024 or no_pad % OUT_BYTES or not 0 < no_pad <= 1 << 30:
        raise ValueError(f"resolve_batch: nt_pad {nt_pad} must be a multiple of 1024 "
                         f"and no_pad {no_pad} one of {OUT_BYTES}, at most 2**30")
    if not tokens.is_cuda:
        return resolve_batch_ref(tokens, ntok, nt_pad, no_pad)
    global launches
    tokens = tokens.contiguous()
    if tokens.data_ptr() % 16:                  # the kernel reads 16-byte groups
        tokens = tokens.clone()
    ntok = ntok.contiguous()
    B = tokens.shape[0]
    out = torch.empty(B, no_pad // 4, dtype=torch.int32, device=tokens.device)
    build.launch("resolve", "resolve_launch", _ARGTYPES, tokens.device,
                 ntok.data_ptr(), tokens.data_ptr(), out.data_ptr(), B, nt_pad,
                 no_pad)
    launches += 1
    return out
