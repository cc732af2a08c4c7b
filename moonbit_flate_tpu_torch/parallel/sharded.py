"""Shard-manifest compression on one device.

Port of the single-device part of ``moonbit_flate_tpu/parallel/sharded.py``:
``ShardManifest``, ``compress_with_manifest`` and
``decompress_with_manifest``.  Segments are byte-aligned and
history-independent, so a stream is the concatenation of its shards'
streams, and the manifest (compressed and payload size of every shard)
lets a failed shard re-run alone and the decode run shard-parallel.
The JAX package encodes one shard per device of a mesh in each wave;
here a wave is a batch on one card: up to ``WAVE`` shards go through
one ``encode_segments_batched`` (one launch of the walk and of the
batched pack) and one ``compact_streams``, and one copy proportional to
the compressed size returns to the host.  The stream does not depend
on the wave size.

The multi-process layer (``make_sharded_encoder``, ``ShardedCompressor``,
``make_mesh``) is not ported yet: it comes with ``torch.distributed``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api.cuda import FINAL_EMPTY_BLOCK, stage_segment
from ..inflate.cuda_inflate import decompress_segments
from ..ops.lanes_inflate import IN_W, SEGB
from ..ops.lanes_resolve import decompress_shards
from ..ops.pipeline import BLOCK, compact_streams, encode_segments_batched
from ..utils.device import resolve_device

WAVE = 16  # shards per encode_segments_batched call (bounds device memory)


class ShardManifest:
    """Sidecar index of a sharded stream: per-shard compressed sizes and
    payload sizes.  ``segments()`` recovers each shard's byte range, so
    a failed shard re-runs alone and decode parallelizes per shard.
    Only halo-free, dictionary-free streams are segment-decodable in
    isolation."""

    def __init__(self, comp_sizes, payload_sizes, blocks_per_segment):
        self.comp_sizes = list(map(int, comp_sizes))
        self.payload_sizes = list(map(int, payload_sizes))
        self.blocks_per_segment = blocks_per_segment

    def segments(self, stream: bytes):
        """Split the stream body back into per-shard streams."""
        parts, off = [], 0
        for sz in self.comp_sizes:
            parts.append(stream[off: off + sz])
            off += sz
        return parts

    def to_dict(self):
        return {"version": 1, "blocks_per_segment": self.blocks_per_segment,
                "comp_sizes": self.comp_sizes,
                "payload_sizes": self.payload_sizes}

    @classmethod
    def from_dict(cls, d):
        assert d["version"] == 1
        return cls(d["comp_sizes"], d["payload_sizes"],
                   d["blocks_per_segment"])


def compress_with_manifest(data: bytes, blocks_per_segment: int = 16,
                           device=None):
    """Sharded compress returning (stream, ShardManifest).

    halo/dictionary are deliberately unsupported here: the manifest's
    point is shard-independent decode, which cross-shard history breaks.
    """
    dev = resolve_device(device)
    nb = blocks_per_segment
    seg = nb * BLOCK
    data = bytes(data)
    comp_sizes, payload_sizes, out = [], [], []
    for wstart in range(0, len(data), WAVE * seg):
        shards = [data[s: s + seg]
                  for s in range(wstart, min(len(data), wstart + WAVE * seg), seg)]
        bufs = np.stack([stage_segment(b"", s, nb)[0] for s in shards])
        ns = [len(s) for s in shards]
        words, bits = encode_segments_batched(
            torch.from_numpy(bufs).to(dev), ns, [0] * len(ns), nb)
        stream, _ = compact_streams(words, bits)
        bits = bits.tolist()
        if any(b % 8 for b in bits):
            raise RuntimeError("segment stream is not byte-aligned")
        sizes = [b // 8 for b in bits]
        out.append(stream.view(torch.uint8)[: sum(sizes)].cpu().numpy().tobytes())
        comp_sizes += sizes
        payload_sizes += ns
    out.append(FINAL_EMPTY_BLOCK)
    return b"".join(out), ShardManifest(comp_sizes, payload_sizes, nb)


def decompress_with_manifest(stream: bytes, manifest: ShardManifest,
                             device=None) -> bytes:
    """Shard-parallel decode driven by the manifest.

    Shards at or under the lane-inflate cap decode on the lane-parallel
    path (``decompress_shards``); larger shards go to the scalar-path
    batch (``decompress_segments``).  The route depends on the sizes
    alone."""
    body = stream[: sum(manifest.comp_sizes)]
    parts = manifest.segments(body)
    if not parts:
        return b""
    if (max(manifest.payload_sizes) <= SEGB
            and max(len(p) for p in parts) <= IN_W * 4):
        outs = decompress_shards(parts, manifest.payload_sizes, device=device)
    else:
        outs = decompress_segments(parts, manifest.payload_sizes, device=device)
    return b"".join(outs)
