"""Greedy parse + lazy match extension over a batch of segments.

Kernel 2 of the port.  ``commit_walk`` replaces the Pallas kernel of
``moonbit_flate_tpu/ops/walk_pallas.py:walk_batch`` together with its
glue ``pipeline._commit_walk_batch`` with ``csrc/walk.cu``.  The parse
is serial within a segment: on the H100 it is bound by one thread's
chain of dependent loads, not by bytes or operations.  The design runs
one thread per segment through the whole segment in one loop (B
segments in one launch), skipping literal runs 32 positions at a time
through the match-presence bitmask and reading data bytes straight
from the staged buffer; making it fast is later work.

``commit_walk_ref`` is the plain PyTorch twin (the port of
``pipeline._commit_xla``): a vectorized extension of every candidate,
then a pointer-doubling greedy commit.  The wrapper takes the twin for
CPU tensors only; for CUDA tensors it launches the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..formats import constants as C
from ..kernels import build
from .matcher import extend_matches_xla, greedy_commit_xla, pack_match_info

BLOCK = C.MAX_STORE_BLOCK_SIZE

launches = 0  # kernel launches made by commit_walk

# data, data_stride, bits, minfo, minfo_out, ctx, n, batch, s_pad, stream
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def commit_walk_ref(data_padded: torch.Tensor, mlen: torch.Tensor,
                    dist: torch.Tensor, n, ctx, nb: int):
    """Greedy commit of B segments, the plain way.

    data_padded: uint8[B, nb*65535 + 320]; mlen, dist: int32[B, S] from
    the clipped matcher; n, ctx: B ints.  Returns bool[B, S] committed
    token starts, bool[B, S] committed match starts, and int32[B, S]
    final lengths and distances at match starts (0 elsewhere).
    """
    S = nb * BLOCK
    pos = torch.arange(S, dtype=torch.int32, device=mlen.device)
    out = []
    for b in range(data_padded.shape[0]):
        block_end = ctx[b] + (torch.clamp(pos - ctx[b], 0, S - 1) // BLOCK + 1) * BLOCK
        m = extend_matches_xla(data_padded[b], mlen[b], dist[b], n[b],
                               block_end - pos)
        m = torch.where(m >= C.MIN_MATCH_LENGTH, m, 0)
        committed = greedy_commit_xla(m, n[b], ctx[b])
        is_match = committed & (m > 0)
        out.append((committed, is_match, torch.where(is_match, m, 0),
                    torch.where(is_match, dist[b], 0)))
    return tuple(torch.stack(t) for t in zip(*out))


def commit_walk(data_padded: torch.Tensor, mlen: torch.Tensor,
                dist: torch.Tensor, n, ctx, nb: int):
    """Same contract as ``commit_walk_ref``; one launch of
    ``csrc/walk.cu`` for all B segments of CUDA tensors."""
    if not data_padded.is_cuda:
        return commit_walk_ref(data_padded, mlen, dist, n, ctx, nb)
    global launches
    B = data_padded.shape[0]
    S = nb * BLOCK
    S_pad = -(-S // 32) * 32
    if data_padded.dtype != torch.uint8 or data_padded.shape[1] != S + 320 \
            or mlen.shape != (B, S) or dist.shape != (B, S):
        raise ValueError("commit_walk takes uint8[B, S + 320] data and "
                         "int32[B, S] mlen, dist")
    dev = data_padded.device
    data_padded = data_padded.contiguous()
    n_t = torch.tensor(list(n), dtype=torch.int32, device=dev)
    ctx_t = torch.tensor(list(ctx), dtype=torch.int32, device=dev)
    minfo, grp = pack_match_info(mlen.int(), dist.int(), ctx_t, S_pad)
    minfo_out = torch.empty(B, S_pad, dtype=torch.int32, device=dev)
    fn = build.entry("walk", "walk_launch", _ARGTYPES)
    build.check(fn(data_padded.data_ptr(), data_padded.shape[1],
                   grp.data_ptr(), minfo.data_ptr(), minfo_out.data_ptr(),
                   ctx_t.data_ptr(), n_t.data_ptr(), B, S_pad,
                   torch.cuda.current_stream(dev).cuda_stream), "walk")
    launches += 1

    info = minfo_out[:, :S]
    match_start = info != 0
    mlen2 = info & 511
    dist2 = info >> 9
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    reach = torch.where(match_start, pos[None, :] + mlen2, 0)
    cmax = torch.cummax(reach, dim=1).values
    covered = torch.zeros_like(match_start)
    covered[:, 1:] = cmax[:, :-1] > pos[None, 1:]
    committed = ((match_start | ~covered)
                 & (pos[None, :] >= ctx_t[:, None])
                 & (pos[None, :] < n_t[:, None]))
    return committed, match_start, mlen2, dist2
