"""Lane-parallel DEFLATE inflate, kernel BC: token records to bytes,
and the shard decode built on kernels A and BC.

Port of ``moonbit_flate_tpu/ops/lanes_resolve.py``.  Kernel BC expands
each stream's token records (kernel A's output) into its output bytes:
byte p < outlen is its literal or the byte ``dist`` before it,
overlapping copies (len > dist) byte by byte; bytes past outlen are 0.
A match record with length 0 stands for one 0 byte, and a source before
the stream's start (or a distance of 0) reads as 0; kernel A never
emits either.

``resolve_steps`` launches ``csrc/lanes_resolve.cu`` (a block of 8
streams, a warp a stream, its 4 KiB history in shared memory, token
tiles loaded ahead) for CUDA tensors, on kernel A's step-major token
buffer as ``parse_waves`` returns it (the main path).
``resolve_waves`` takes the lane-major rows that the JAX package's
``resolve_waves`` takes, relays them step-major and calls
``resolve_steps`` (for checks only).  ``resolve_waves_ref`` is the
plain PyTorch twin, one output byte of every stream per loop iteration,
and the wrappers take it for CPU tensors only.  ``decompress_shards``
is the entry point.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import build
from ..utils.device import to_host
from ..utils.errors import CorruptInputError, UnexpectedEOFError
from .lanes_inflate import (IN_W, LANE, NSTR, SEGB, ST_DONE, ST_OVERFLOW,
                            ST_TRUNC, SUB, TOK_CHUNKS, TOK_ROWS, parse_waves,
                            stage_streams_lanes)

GROUPS = SEGB // 512       # output word planes: 128 words of each stream each

launches = 0  # kernel launches made by resolve_steps

# outlen, tok, out, waves, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]


def lane_major(tok: torch.Tensor) -> torch.Tensor:
    """Kernel A's step-major token rows int32[waves, TOK_CHUNKS, 128, 8,
    128] relaid lane-major, int32[waves, TOK_CHUNKS, 1024, 128]: the
    input of the JAX package's ``resolve_waves``."""
    return tok.permute(0, 1, 3, 4, 2).reshape(
        tok.shape[0], TOK_CHUNKS, NSTR, LANE).contiguous()


def step_major(tok_lm: torch.Tensor) -> torch.Tensor:
    """The inverse of ``lane_major``: lane-major rows relaid as kernel A
    writes them."""
    return tok_lm.reshape(tok_lm.shape[0], TOK_CHUNKS, SUB, LANE, 128).permute(
        0, 1, 4, 2, 3).contiguous()


def resolve_waves_ref(outlen: torch.Tensor, tok_lm: torch.Tensor, waves: int):
    """Kernel BC, the plain way: the same output as ``resolve_waves``."""
    B = waves * NSTR
    dev = tok_lm.device
    toks = tok_lm.long().permute(0, 2, 1, 3).reshape(B, TOK_ROWS)
    # the nonzero records of each stream first, in order
    order = torch.sort((toks == 0).to(torch.uint8), dim=1, stable=True).indices
    toks = torch.cat([toks.gather(1, order),
                      torch.zeros(B, 1, dtype=torch.int64, device=dev)], 1)
    n = torch.clamp(outlen.reshape(B).long(), 0, SEGB)
    out = torch.zeros(B, SEGB, dtype=torch.int64, device=dev)
    ti = torch.zeros(B, dtype=torch.int64, device=dev)
    rem = torch.zeros_like(ti)
    dist = torch.zeros_like(ti)
    for p in range(int(n.max())):
        live = p < n
        need = live & (rem == 0)
        head = toks.gather(1, ti[:, None])[:, 0]
        is_m = need & (head < 0)
        is_l = need & (head > 0)
        ti = ti + (need & (ti < TOK_ROWS)).long()
        rem = torch.where(is_m, (head >> 13) & 511, rem)
        dist = torch.where(is_m, head & 8191, dist)
        copying = live & (rem > 0)
        src = p - dist
        copied = out.gather(1, torch.clamp(src, min=0)[:, None])[:, 0]
        copied = torch.where((src >= 0) & (dist > 0), copied, 0)
        out[:, p] = torch.where(copying, copied, torch.where(is_l, head & 255, 0))
        rem = rem - copying.long()
    words = (out.reshape(B, SEGB // 4, 4) << torch.tensor([0, 8, 16, 24], device=dev)).sum(2)
    words = torch.where(words >= (1 << 31), words - (1 << 32), words).int()
    return words.reshape(waves, NSTR, GROUPS, LANE).permute(0, 2, 1, 3).contiguous()


def resolve_waves(outlen: torch.Tensor, tok_lm: torch.Tensor, waves: int):
    """Kernel BC over ``waves`` waves, lane-major input.

    outlen: int32[waves, 8, 128] per-stream output byte counts (``misc``
    row 1); tok_lm: int32[waves, TOK_CHUNKS, 1024, 128] lane-major token
    rows (row k of stream r at [w, k // 128, r, k % 128]).  Returns
    int32[waves, GROUPS, 1024, 128] output words (word w of stream r at
    [wave, w // 128, r, w % 128]).  For CUDA tensors, the rows relaid
    step-major and ``resolve_steps``; the plain twin for CPU tensors."""
    if not tok_lm.is_cuda:
        return resolve_waves_ref(outlen, tok_lm, waves)
    if tok_lm.shape != (waves, TOK_CHUNKS, NSTR, LANE):
        raise ValueError(f"resolve_waves takes int32[{waves}, {TOK_CHUNKS}, {NSTR}, {LANE}] "
                         f"tokens, not {list(tok_lm.shape)}")
    return resolve_steps(outlen, step_major(tok_lm), waves)


def resolve_steps(outlen: torch.Tensor, tok: torch.Tensor, waves: int):
    """Kernel BC over ``waves`` waves on kernel A's token buffer as
    ``parse_waves`` returns it: tok int32[waves, TOK_CHUNKS, 128, 8, 128]
    (row k of stream r at [w, k // 128, k % 128, r // 128, r % 128]).
    Same output as ``resolve_waves`` on ``lane_major(tok)``, without that
    copy on the card.  One launch of ``csrc/lanes_resolve.cu`` for CUDA
    tensors; the plain twin for CPU tensors."""
    global launches
    if not tok.is_cuda:
        return resolve_waves_ref(outlen, lane_major(tok), waves)
    tok_shape = (waves, TOK_CHUNKS, 128, SUB, LANE)
    if outlen.dtype != torch.int32 or tok.dtype != torch.int32 \
            or outlen.shape != (waves, SUB, LANE) or tok.shape != tok_shape:
        raise ValueError(f"lanes_resolve takes int32[waves, 8, 128] outlen and "
                         f"int32{list(tok_shape)} tokens")
    outlen = outlen.contiguous()
    tok = tok.contiguous()
    if tok.data_ptr() % 16:            # the kernel loads 16 bytes at a time
        tok = tok.clone()
    out = torch.empty(waves, GROUPS, NSTR, LANE, dtype=torch.int32, device=tok.device)
    build.launch("lanes_resolve", "lanes_resolve_launch", _ARGTYPES, tok.device,
                 outlen.data_ptr(), tok.data_ptr(), out.data_ptr(), waves)
    launches += 1
    return out


def inflate_waves(nbits: torch.Tensor, inw: torch.Tensor, waves: int):
    """Kernel A, then kernel BC on its token buffer as it is.  Returns
    (out int32[waves, GROUPS, 1024, 128], misc int32[waves, 4, 8, 128])."""
    tok, misc = parse_waves(nbits, inw, waves)
    return resolve_steps(misc[:, 1].contiguous(), tok, waves), misc


def decompress_shards(streams, out_sizes, device=None):
    """Decode raw-DEFLATE shard streams, each decompressing to at most
    SEGB bytes, on the lane path.  Returns list[bytes].

    Raises ValueError for an out_size above SEGB, for a stream that
    exhausts the lane kernels' capacities (ST_OVERFLOW) and for one that
    decodes to more than its out_size; CorruptInputError(-1) for an input
    longer than IN_W words or a corrupt stream; UnexpectedEOFError for a
    truncated one.  ``device=None`` means the card."""
    if not streams:
        return []
    sizes = np.asarray(out_sizes, np.int64)[:len(streams)]
    lens = np.fromiter(map(len, streams), np.int64, len(streams))
    bad_in = (sizes > SEGB) | (lens > IN_W * 4)
    if bad_in.any():
        i = int(np.argmax(bad_in))
        if sizes[i] > SEGB:
            raise ValueError(f"stream {i}: out_size {sizes[i]} > shard cap {SEGB}")
        raise CorruptInputError(-1)
    waves = -(-len(streams) // NSTR)
    nbits, inw = stage_streams_lanes(streams, waves, device)
    out, misc = inflate_waves(nbits, inw, waves)
    st, n = misc[:, :2].permute(1, 0, 2, 3).reshape(2, -1)[:, :len(streams)].cpu().numpy()
    bad_out = (st != ST_DONE) | (n > sizes)
    if bad_out.any():
        i = int(np.argmax(bad_out))
        if st[i] == ST_TRUNC:
            raise UnexpectedEOFError()
        if st[i] == ST_OVERFLOW:
            raise ValueError(
                f"stream {i}: exceeds lane-shard capacity (out_size cap {SEGB})")
        if st[i] != ST_DONE:
            raise CorruptInputError(-1)
        raise ValueError(
            f"stream {i}: decompressed size {n[i]} exceeds caller bound {sizes[i]}")
    return shard_bytes(out, n)


def shard_bytes(out: torch.Tensor, lengths) -> list:
    """The first n[i] bytes of stream i of ``out`` (int32[waves, GROUPS,
    1024, 128]) for the first len(lengths) streams: one gather on the
    device, one copy to the host through a pinned buffer, then a split."""
    n = np.asarray(lengths, np.int64)
    return _split(_kept_bytes(out, n), n)


def _kept_bytes(out: torch.Tensor, n: np.ndarray) -> memoryview:
    """The bytes ``shard_bytes`` keeps, one after another, on the host."""
    waves = out.shape[0]
    rows = out.permute(0, 2, 1, 3).reshape(waves * NSTR, -1)[:len(n)]
    rows = rows.contiguous().view(torch.uint8)
    keep = (torch.arange(SEGB, device=out.device)[None, :]
            < torch.from_numpy(n).to(out.device)[:, None])
    return memoryview(to_host(rows[keep]).numpy())


def _split(flat: memoryview, n: np.ndarray) -> list:
    ends = np.cumsum(n).tolist()
    return [bytes(flat[e - k:e]) for e, k in zip(ends, n.tolist())]
