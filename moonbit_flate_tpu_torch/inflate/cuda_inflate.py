"""Scalar-path decode: raw-DEFLATE streams of any size, one serial parse
a stream.

Port of ``moonbit_flate_tpu/inflate/tpu_inflate.py``.  DEFLATE decode
splits into two computations:

- *Stage A, symbol parsing*, is bit-serial by construction (variable
  length codes, tables defined mid-stream).  It runs either in the
  parse kernel (``ops/parse.py``, batched over independent streams, the
  whole decode on the device) or in the host C scanner
  (``mf_scan_tokens``).  Both emit the same packed int32 token records.
- *Stage B, byte materialization*, touches every output byte: the
  resolve kernel (``ops/resolve.py``) behind ``decompress_segments``,
  the plain pointer-doubling resolver behind ``decompress``.

Preset dictionaries (reader semantics) enter as literal tokens ahead of
the stream's own.  ``device=None`` means the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import native
from ..ops.parse import (OUT_CHUNK, ST_DONE, ST_MORE, ST_TRUNC, parse_batch,
                         parse_stream, stage_streams)
from ..ops.resolve import resolve_batch, resolve_tokens_batch
from ..utils.device import resolve_device, to_host
from ..utils.errors import CorruptInputError, UnexpectedEOFError

# Token bytes of one sub-batch of decompress_segments (4 B x capacity a
# stream).  On the card the token array, the output and the input words
# are all that a sub-batch holds.  On the CPU the plain resolver keeps
# some twenty int64 arrays of that many elements alive, so its sub-batch
# is smaller.
_SUB_TOKEN_BYTES = {"cuda": 1 << 30, "cpu": 32 << 20}


def scan_tokens(data: bytes, dictionary: bytes = b"") -> np.ndarray:
    """Stage A on the host: bitstream -> packed token records (the C
    scanner).  A match may reach len(dictionary) bytes before the start."""
    scan = native.scanner()
    data = bytes(data)
    cap = max(4096, len(data) * 9)
    while True:
        buf = (ctypes.c_int32 * cap)()
        res = scan(data, len(data), buf, cap, len(dictionary))
        if res == -5:
            cap *= 4
            continue
        if res == -4:
            raise UnexpectedEOFError()
        if res < 0:
            raise CorruptInputError(-1)
        return np.frombuffer(buf, dtype=np.int32, count=res).copy()


def resolve_tokens(tokens: torch.Tensor, n_tokens_max: int, n_out_max: int):
    """Stage B of one stream, the plain data-parallel way.

    tokens: int32[n_tokens_max], zeros past the real count (a zero is a
    literal 0 of one byte; callers slice the result).  Returns (out
    uint8[n_out_max], out_len int32 scalar tensor)."""
    out, out_len = resolve_tokens_batch(tokens[None], n_tokens_max, n_out_max)
    return out[0], out_len[0]


def _round_up(x: int, quantum: int = 1 << 18) -> int:
    return ((x + quantum - 1) // quantum) * quantum


def scan_tokens_device(data: bytes, max_out_bytes: int | None = None,
                       device=None) -> np.ndarray:
    """Stage A in the parse kernel.  Raises the error classes of the host
    scanner.  The token capacity starts from a modest estimate (most
    streams expand well under 16x) and grows by 4 while the parser
    reports that it ran out (status 0)."""
    data = bytes(data)
    if max_out_bytes is None:
        max_out_bytes = max(4096, len(data) * 16)
    n_chunks = -(-(max_out_bytes + 1) // OUT_CHUNK)
    while True:
        toks, status, _ = parse_stream(data, max_out_chunks=n_chunks, device=device)
        if status == ST_MORE:
            n_chunks *= 4
            continue
        if status == ST_TRUNC:
            raise UnexpectedEOFError()
        if status < 0:
            raise CorruptInputError(-1)
        return toks


def _parse_resolve(nbits, words, n_chunks):
    """Stage A then stage B of one sub-batch; the token array never
    leaves the device.  Every token is at least one output byte, so one
    capacity, n_chunks * OUT_CHUNK, serves as token count and as output
    bytes.  Returns (out int32[B, capacity / 4] words, cnt)."""
    cap = n_chunks * OUT_CHUNK
    toks, cnt = parse_batch(nbits, words, n_chunks)
    return resolve_batch(toks, cnt[:, 0].contiguous(), cap, cap), cnt


def _output_to_host(out: torch.Tensor) -> np.ndarray:
    """A sub-batch's output words as a host uint8 array, through a pinned
    buffer from the card (``utils.device.to_host``)."""
    return to_host(out).numpy().view(np.uint8)


def decompress_segments(streams: list[bytes], out_sizes: list[int],
                        device=None) -> list[bytes]:
    """Decode B independent raw-DEFLATE streams on the device: the parse
    kernel, then the resolve kernel, a sub-batch at a time.

    out_sizes are upper bounds on each stream's decompressed size.  A
    stream that decompresses to more than its entry raises ValueError; a
    truncated one UnexpectedEOFError, a corrupt one CorruptInputError.

    The output capacity bounds the token capacity beforehand, so stage B
    follows stage A with no round trip to the host for token counts.
    Streams go in sub-batches so that the token array (4 B x capacity a
    stream) stays under ``_SUB_TOKEN_BYTES``: device memory bounds it on the card, the
    plain resolver's int64 temporaries on the CPU.  Statuses and bytes
    come back once per sub-batch, the bytes through a pinned buffer."""
    if not streams:
        return []
    dev = resolve_device(device)
    cap = max(max(out_sizes), 1)
    # capacity in 8 KiB chunks, not a coarser quantum: callers pass exact
    # segment geometries, and stage B and the copy back scale with it
    n_chunks = -(-(cap + 1) // OUT_CHUNK)
    nbits, words = stage_streams(streams, dev)
    sub = max(1, _SUB_TOKEN_BYTES[dev.type] // (4 * n_chunks * OUT_CHUNK))
    outs: list[bytes] = []
    for lo in range(0, len(streams), sub):
        hi = min(lo + sub, len(streams))
        out, cnt = _parse_resolve(nbits[lo:hi], words[lo:hi], n_chunks)
        cnt_h = cnt.cpu().numpy()
        for i in range(lo, hi):
            _, status, n_out = cnt_h[i - lo].tolist()
            if status == ST_TRUNC:
                raise UnexpectedEOFError()
            if status == ST_MORE:
                raise ValueError(
                    f"stream {i}: token capacity exhausted — out_sizes[{i}]"
                    f"={out_sizes[i]} is below the true decompressed size")
            if status != ST_DONE:
                raise CorruptInputError(-1)
            if n_out > out_sizes[i]:
                raise ValueError(
                    f"stream {i}: decompressed size {n_out} "
                    f"exceeds caller bound {out_sizes[i]}")
        out_h = _output_to_host(out)
        outs += [out_h[i, :n].tobytes() for i, n in enumerate(cnt_h[:, 2].tolist())]
    return outs


def decompress(data: bytes, dictionary: bytes = b"",
               parse_on_device: bool = False, device=None) -> bytes:
    """Raw-DEFLATE decode of one stream: stage A in the host scanner (or
    the parse kernel with parse_on_device=True), stage B the plain
    pointer-doubling resolver on the device."""
    dev = resolve_device(device)
    dictionary = bytes(dictionary)[-32768:]
    if parse_on_device and not dictionary:
        # (with a preset dictionary the distance-vs-history check needs
        # the dictionary's length; the host scanner takes it, the kernel's
        # history starts at 0, so such streams go through the scanner)
        toks = scan_tokens_device(data, device=dev)
    else:
        toks = scan_tokens(data, dictionary)
    if dictionary:
        dict_toks = np.frombuffer(dictionary, np.uint8).astype(np.int32)
        toks = np.concatenate([dict_toks, toks])
    if len(toks) == 0:
        return b""
    lens = np.where(toks < 0, ((toks >> 15) & 0xFF) + 3, 1)
    n_out = int(lens.sum())

    nt_pad = _round_up(len(toks))
    # +1 so that padded tokens (clipped to the last slot) never land on
    # a real output byte
    no_pad = _round_up(n_out + 1)
    toks_p = np.zeros(nt_pad, np.int32)
    toks_p[: len(toks)] = toks
    out, _ = resolve_tokens(torch.from_numpy(toks_p).to(dev), nt_pad, no_pad)
    return out[len(dictionary):n_out].cpu().numpy().tobytes()
