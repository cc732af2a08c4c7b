"""Greedy parse + lazy match extension over a batch of segments.

Kernel 2 of the port.  ``commit_walk`` replaces the Pallas kernel of
``moonbit_flate_tpu/ops/walk_pallas.py:walk_batch`` together with its
glue ``pipeline._commit_walk_batch`` with ``csrc/walk.cu``.

Walked as the TPU walks it, a segment is one chain of dependent loads
on one thread, and that latency, not bytes or operations, is what would
bound it on the H100.  The only state the walk carries is its cursor,
so ``csrc/walk.cu`` splits it: every candidate is verified and extended
in parallel into a per-position ``step`` (the final match length at an
accepted candidate, 1 anywhere else); the segment is cut into tiles of
``TILE`` positions whose steps are pointer-doubled in shared memory to
give, for each of the 258 offsets at which a walk can enter a tile, the
offset at which it enters the next; one thread a segment stitches the
tiles' entries together; and a second pass over the tiles spreads a
visited mark from each tile's true entry and writes all four outputs.
One call of ``commit_walk`` on CUDA tensors is four CUDA kernels
(extend, tile exits, stitch, mark) through one C entry point, counted
as one launch.  It reads the matcher's ``mlen`` and ``dist`` as they
are; no packed copy, bitmask, zeroing pass or scan is made around it.

``commit_walk_ref`` is the plain PyTorch twin (the port of
``pipeline._commit_xla``): a vectorized extension of every candidate,
then a pointer-doubling greedy commit over the whole segment.  The
wrapper takes the twin for CPU tensors only; for CUDA tensors it
launches the kernels.  ``commit_walk_tiled_ref`` is a plain model of
the kernels' decomposition (steps, tile exit tables, stitch, marks) for
the tests; nothing on the main path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from ..formats import constants as C
from ..kernels import build
from .matcher import extend_matches_xla, greedy_commit_xla

BLOCK = C.MAX_STORE_BLOCK_SIZE
TILE = 8192          # positions a tile (csrc/walk.cu: kTile)
MAX_STEP = C.MAX_MATCH_LENGTH   # a walk enters a tile at an offset below this
EXIT_SLOTS = 260     # a tile's exit table: 258 entries, the start's, a pad
ALL_PHASES = 15      # extend 1, tile exits 2, stitch 4, mark 8

launches = 0  # calls of commit_walk that reached the card

# data, data_stride, mlen, dist, ctx, n, step, exits, entry, committed,
# match_start, mlen2, dist2, batch, s, phases, stream
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 11
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _extended_lengths(data_padded, mlen, dist, n, ctx, nb):
    """Final match length of every candidate of one segment, clipped at
    n, 258 and the next block boundary; 0 where it is under 3."""
    S = nb * BLOCK
    pos = torch.arange(S, dtype=torch.int32, device=mlen.device)
    block_end = ctx + (torch.clamp(pos - ctx, 0, S - 1) // BLOCK + 1) * BLOCK
    m = extend_matches_xla(data_padded, mlen, dist, n, block_end - pos)
    return torch.where(m >= C.MIN_MATCH_LENGTH, m, 0)


def commit_walk_ref(data_padded: torch.Tensor, mlen: torch.Tensor,
                    dist: torch.Tensor, n, ctx, nb: int):
    """Greedy commit of B segments, the plain way.

    data_padded: uint8[B, nb*65535 + 320]; mlen, dist: int32[B, S] from
    the clipped matcher; n, ctx: B ints.  Returns bool[B, S] committed
    token starts, bool[B, S] committed match starts, and int32[B, S]
    final lengths and distances at match starts (0 elsewhere).
    """
    out = []
    for b in range(data_padded.shape[0]):
        m = _extended_lengths(data_padded[b], mlen[b], dist[b], n[b], ctx[b], nb)
        committed = greedy_commit_xla(m, n[b], ctx[b])
        is_match = committed & (m > 0)
        out.append((committed, is_match, torch.where(is_match, m, 0),
                    torch.where(is_match, dist[b], 0)))
    return tuple(torch.stack(t) for t in zip(*out))


def commit_walk_tiled_ref(data_padded: torch.Tensor, mlen: torch.Tensor,
                          dist: torch.Tensor, n, ctx, nb: int, tile: int = TILE):
    """Same contract as ``commit_walk_ref``, computed the way
    ``csrc/walk.cu`` does it, step by step (a model for the tests).

    1. step[q]: the extended length at a candidate at or past ctx, else 1.
    2. For every tile of ``tile`` positions, by pointer doubling inside
       the tile: from each entry offset 0..257 (and from ctx in the tile
       that holds it), the offset at which the walk enters the next tile.
    3. The stitch: each tile's true entry, tile after tile.
    4. The marks: doubling once more, spreading "visited" from the entry.
    """
    if tile < MAX_STEP:
        raise ValueError(f"a tile holds at least {MAX_STEP} positions")
    S = nb * BLOCK
    dev = mlen.device
    ntiles = -(-S // tile)
    width = tile + MAX_STEP
    rounds = max(1, (tile - 1).bit_length())
    pos = torch.arange(S, dtype=torch.int64, device=dev)
    offs = torch.arange(width, dtype=torch.int64, device=dev)
    out = []
    for b in range(data_padded.shape[0]):
        nn, cc = int(n[b]), int(ctx[b])
        m = _extended_lengths(data_padded[b], mlen[b], dist[b], nn, cc, nb).long()
        step = torch.where((m > 0) & (pos >= cc), m, 1)
        # jump[t, p] = p + step of position t * tile + p (1 past S), the
        # identity from offset tile on
        padded = torch.ones(ntiles * tile, dtype=torch.int64, device=dev)
        padded[:S] = step
        jump0 = offs.repeat(ntiles, 1)
        jump0[:, :tile] += padded.reshape(ntiles, tile)

        # 2. exit tables
        jump = jump0
        for _ in range(rounds):
            jump = jump.gather(1, jump)
        exits = jump[:, :MAX_STEP] - tile                      # [ntiles, 258]

        # 3. stitch
        t0 = min(max(cc, 0) // tile, ntiles)
        entry = torch.full((ntiles,), -1, dtype=torch.int64)
        if t0 < ntiles:
            entry[t0] = cc - t0 * tile
            e = int(jump[t0, cc - t0 * tile]) - tile
            for t in range(t0 + 1, ntiles):
                entry[t] = e
                e = int(exits[t, e])
        entry = entry.to(dev)

        # 4. marks: round k jumps exactly 2^k steps
        seen = torch.zeros(ntiles, width, dtype=torch.bool, device=dev)
        rows = (entry >= 0).nonzero()[:, 0]
        seen[rows, entry[rows]] = True
        jump = jump0
        for _ in range(rounds):
            r, p = seen.nonzero(as_tuple=True)
            seen[r, jump[r, p]] = True
            jump = jump.gather(1, jump)
        visited = seen[:, :tile].reshape(-1)[:S]

        committed = visited & (pos >= cc) & (pos < nn)
        is_match = committed & (step >= C.MIN_MATCH_LENGTH)
        out.append((committed, is_match, torch.where(is_match, step, 0).int(),
                    torch.where(is_match, dist[b], 0)))
    return tuple(torch.stack(t) for t in zip(*out))


def _launch(data_padded, mlen, dist, ctx_t, n_t, scratch, outputs, phases):
    """The C entry point of ``csrc/walk.cu`` on checked CUDA tensors."""
    B, S = mlen.shape
    build.launch("walk", "walk_launch", _ARGTYPES, mlen.device,
                 data_padded.data_ptr(), data_padded.shape[1], mlen.data_ptr(),
                 dist.data_ptr(), ctx_t.data_ptr(), n_t.data_ptr(),
                 *(t.data_ptr() for t in scratch),
                 *(t.data_ptr() for t in outputs), B, S, phases)


def _scratch(B: int, S: int, dev):
    """step [B, S], exit tables [B, tiles, EXIT_SLOTS] and entries
    [B, tiles]: 16-bit words that the kernels use unsigned, all written
    by the kernels before they are read."""
    ntiles = -(-S // TILE)
    return (torch.empty(B, S, dtype=torch.int16, device=dev),
            torch.empty(B, ntiles, EXIT_SLOTS, dtype=torch.int16, device=dev),
            torch.empty(B, ntiles, dtype=torch.int16, device=dev))


def _outputs(B: int, S: int, dev):
    """committed, match_start, mlen2, dist2; the mark kernel writes every
    element."""
    return (torch.empty(B, S, dtype=torch.bool, device=dev),
            torch.empty(B, S, dtype=torch.bool, device=dev),
            torch.empty(B, S, dtype=torch.int32, device=dev),
            torch.empty(B, S, dtype=torch.int32, device=dev))


def commit_walk(data_padded: torch.Tensor, mlen: torch.Tensor,
                dist: torch.Tensor, n, ctx, nb: int):
    """Same contract as ``commit_walk_ref``; the four kernels of
    ``csrc/walk.cu`` for all B segments of CUDA tensors."""
    if not data_padded.is_cuda:
        return commit_walk_ref(data_padded, mlen, dist, n, ctx, nb)
    global launches
    B = data_padded.shape[0]
    S = nb * BLOCK
    if data_padded.dtype != torch.uint8 or data_padded.shape[1] != S + 320 \
            or mlen.shape != (B, S) or dist.shape != (B, S):
        raise ValueError("commit_walk takes uint8[B, S + 320] data and "
                         "int32[B, S] mlen, dist")
    dev = data_padded.device
    n_t = torch.tensor(list(n), dtype=torch.int32, device=dev)
    ctx_t = torch.tensor(list(ctx), dtype=torch.int32, device=dev)
    outputs = _outputs(B, S, dev)
    _launch(data_padded.contiguous(), mlen.int().contiguous(),
            dist.int().contiguous(), ctx_t, n_t, _scratch(B, S, dev), outputs,
            ALL_PHASES)
    launches += 1
    return outputs
