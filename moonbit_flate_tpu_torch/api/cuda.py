"""One-shot compression on the card over the segment encoder.

Port of ``moonbit_flate_tpu/api/tpu.py``.  Segments (nb * 65535 payload
bytes) compress independently and each ends byte-aligned, so the host
concatenates segment bytes and appends the final empty stored block.
A context prefix feeds the matcher bytes that emit no tokens:
``dictionary=`` uses it for a reader-style preset dictionary (first
segment only), ``halo=True`` gives every segment the previous 32 KB of
input.  Every segment is staged up front, and up to ``_BATCH`` segments
share one launch of the greedy-walk kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import constants as C
from ..ops.pipeline import BLOCK, PAD, encode_segments
from ..utils.device import resolve_device

FINAL_EMPTY_BLOCK = bytes([0x01, 0x00, 0x00, 0xFF, 0xFF])
_BATCH = 16  # segments per encode_segments call (bounds device memory)


def stage_segment(context: bytes, seg: bytes, nb: int):
    """(uint8[nb*65535 + 320] buffer, n, ctx): context then payload,
    zero past n, as the segment encoder takes it."""
    ctx = len(context)
    n = ctx + len(seg)
    if n > nb * BLOCK:
        raise ValueError("context + segment exceed the segment size")
    buf = np.zeros(nb * BLOCK + PAD, np.uint8)
    buf[:ctx] = np.frombuffer(context, np.uint8)
    buf[ctx:n] = np.frombuffer(seg, np.uint8)
    return buf, n, ctx


class CUDACompressor:
    """Reusable compressor for one segment geometry and device."""

    def __init__(self, blocks_per_segment: int = 16, halo: bool = False,
                 device=None):
        self.nb = blocks_per_segment
        self.seg_bytes = self.nb * BLOCK
        self.halo = halo
        self.device = resolve_device(device)

    def _encode_staged(self, staged) -> list[bytes]:
        bufs, ns, ctxs = zip(*staged)
        data = torch.from_numpy(np.stack(bufs)).to(self.device)
        words, bits = encode_segments(data, ns, ctxs, self.nb)
        out = []
        for w, b in zip(words, bits.tolist()):
            if b % 8:
                raise RuntimeError("segment stream is not byte-aligned")
            w = w[: -(-b // 32)].cpu().numpy()
            out.append(w.view("<u4").tobytes()[: b // 8])
        return out

    def compress(self, data: bytes, dictionary: bytes | None = None) -> bytes:
        data = bytes(data)
        context = bytes(dictionary or b"")[-C.WINDOW_SIZE:]
        payload_cap = self.seg_bytes - (
            C.WINDOW_SIZE if (self.halo or context) else 0)
        if payload_cap <= 0:
            raise ValueError("segment too small for context")
        staged = []
        for start in range(0, max(len(data), 1), payload_cap):
            seg = data[start: start + payload_cap]
            staged.append(stage_segment(context, seg, self.nb))
            context = (context + seg)[-C.WINDOW_SIZE:] if self.halo else b""
        parts = []
        for i in range(0, len(staged), _BATCH):
            parts += self._encode_staged(staged[i: i + _BATCH])
        parts.append(FINAL_EMPTY_BLOCK)
        return b"".join(parts)


def compress(data: bytes, blocks_per_segment: int = 16,
             dictionary: bytes | None = None, halo: bool = False,
             device=None) -> bytes:
    return CUDACompressor(blocks_per_segment, halo, device).compress(
        data, dictionary)
