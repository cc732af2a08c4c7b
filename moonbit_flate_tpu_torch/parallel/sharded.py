"""Data-parallel compression over several devices.

Port of ``moonbit_flate_tpu/parallel/sharded.py``.  DEFLATE blocks with
BFINAL=0 are concatenable, and the encoder's segments are byte-aligned
and history-independent, so scaling is pure data parallelism.  A mesh
takes one of two forms, and both give the same stream:

- ``LocalMesh``, the JAX package's form: one process drives a list of
  devices (``make_mesh()`` takes every visible card, as ``jax.devices()``
  does).  Shard ``d`` of every wave is encoded on ``devices[d]``, with
  that card current, one shard after another from the calling thread.
  The segment encode syncs with the host several times and spends most
  of its time issuing launches from Python, so a host thread a card
  contends for the interpreter lock: on four H100s it ran 4.1-5.6x
  slower than this loop (``torch_tools/local_mesh_threads.py``,
  PERF.md §6).
- ``ProcessMesh``: one process a rank of a ``torch.distributed`` process
  group (PyTorch's multi-host idiom).  Every rank calls the same entry
  point with the same bytes, encodes its own shard of each wave on its
  own device, and gets the same stream back.

A wave is

  encode each shard (``encode_segment_ctx``: the walk and pack kernels)
  -> gather the D shard sizes and each shard's first ``Wc`` words onto
  the stitching device -> a local stitch at the exclusive prefix sum of
  the sizes (``compact_streams``) -> the host appends the close-time
  final empty stored block.

The gather is the mesh's: a local mesh copies each shard's tensors to
``devices[0]`` (peer copies between cards) and stacks them; a process
mesh all-gathers them.  With NCCL the collectives run on the card.
Gloo's collectives run on the host, so there only the sizes and the
``Wc`` gathered words cross to the host and back; the encode stays on
the rank's device.  That is the backend's own path, not a fallback.

Context flows in as a per-shard prefix (reader-style preset dictionary):
``dictionary=`` seeds shard 0 of wave 0, and ``halo=True`` hands every
other shard the previous 32 KB of the data, so cross-shard matches survive
sharding and the stitched stream stays one ordinary DEFLATE stream.

``compress_with_manifest`` / ``decompress_with_manifest`` keep a sidecar
of every shard's compressed and payload size, so a failed shard re-runs
alone and the decode runs shard-parallel.  Without a mesh the manifest
encode runs on one card: a wave of up to ``WAVE`` shards goes through one
``encode_segments_batched`` (one launch of the walk and of the batched
pack) and one ``compact_streams``.  With a mesh it runs one shard a
device a wave.  Both give the same stream and manifest.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..api.cuda import FINAL_EMPTY_BLOCK, stage_segment
from ..formats import constants as C
from ..inflate.cuda_inflate import decompress_segments
from ..ops.lanes_inflate import IN_W, SEGB
from ..ops.lanes_resolve import decompress_shards
from ..ops.pipeline import (BLOCK, compact_streams, encode_segment_ctx,
                            encode_segments_batched, n_words_for)
from ..utils.device import resolve_device, to_host

WAVE = 16  # shards per encode_segments_batched call (bounds device memory)


@dataclass(frozen=True)
class ProcessMesh:
    """A mesh of processes: the default process group, its size D, this
    process's rank and the device this rank encodes on.  This process
    encodes shard ``rank`` of every wave."""

    group: object
    size: int
    rank: int
    device: torch.device
    backend: str

    @property
    def shards(self) -> tuple[int, ...]:
        return (self.rank,)

    def shard_device(self, d: int) -> torch.device:
        return self.device

    def run(self, fn, args: list) -> list:
        return [fn(a) for a in args]

    def gather(self, ts: list[torch.Tensor]) -> torch.Tensor:
        """[D, *shape]: every rank's one tensor, on this rank's device."""
        return _all_gather(self, ts[0])


@dataclass(frozen=True)
class LocalMesh:
    """A mesh of devices driven from one process: shard ``d`` of every
    wave on ``devices[d]``, the stitch on ``devices[0]`` (``device``).
    A device may repeat: ``["cuda:0"] * 4`` runs four shards a wave on
    one card."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def shards(self) -> range:
        return range(self.size)

    def shard_device(self, d: int) -> torch.device:
        return self.devices[d]

    def run(self, fn, args: list) -> list:
        """``fn(args[d])`` for every shard d in turn, with ``devices[d]``
        current; the results in shard order."""
        return [_on_device(dev, fn, a) for dev, a in zip(self.devices, args)]

    def gather(self, ts: list[torch.Tensor]) -> torch.Tensor:
        """[D, *shape]: every shard's tensor, copied to ``devices[0]``."""
        return torch.stack([t.to(self.device) for t in ts])


def _on_device(dev: torch.device, fn, arg):
    ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
    with ctx:
        return fn(arg)


def make_mesh(devices=None, axis_name: str = "data", device=None):
    """A mesh in the JAX package's call forms.

    A list or tuple of devices gives a ``LocalMesh`` over them.  ``None``
    gives, in a process that has initialised the default process group,
    that group's ``ProcessMesh``, and otherwise a ``LocalMesh`` over every
    visible card, as ``jax.devices()`` does (raises without one: there is
    no CPU fallback; ``make_mesh(["cpu"] * D)`` asks for the plain route).
    A single device, positional or as ``device=``, is the device of this
    rank's ``ProcessMesh`` and needs an initialised group.
    ``axis_name`` is kept for the JAX package's signature and ignored."""
    if isinstance(devices, (list, tuple)):
        if device is not None:
            raise ValueError("pass a list of devices or one device, not both")
        if not devices:
            raise ValueError("a mesh needs at least one device")
        return LocalMesh(tuple(_local_device(d) for d in devices))
    if devices is not None:
        if device is not None:
            raise ValueError("pass a list of devices or one device, not both")
        device = devices
    if dist.is_available() and dist.is_initialized():
        return _process_mesh(device)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass make_mesh(['cpu'] * D) "
                               "to run the plain PyTorch route")
        return LocalMesh(tuple(torch.device("cuda", i)
                               for i in range(torch.cuda.device_count())))
    raise RuntimeError("torch.distributed is not initialised: call "
                       "init_process_group before make_mesh, or pass a "
                       "list of devices")


def _local_device(device) -> torch.device:
    """A local mesh's device; a card without an index is the current one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _process_mesh(device) -> ProcessMesh:
    """The mesh of the already initialised default process group.  It
    starts no group itself.  ``device=None`` means ``cuda:<local rank>``
    with NCCL (``LOCAL_RANK`` where the launcher sets it, else the rank
    modulo the cards) and the card with any other backend; raises without
    one.  A card is made this process's current device, as NCCL expects."""
    group = dist.group.WORLD
    backend = str(dist.get_backend(group))
    rank = dist.get_rank(group)
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL collectives need a CUDA device")
    if dev.type == "cuda":
        if backend == "nccl" and device is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None
                               else rank % torch.cuda.device_count())
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return ProcessMesh(group, dist.get_world_size(group), rank, dev, backend)


def _all_gather(mesh: ProcessMesh, t: torch.Tensor) -> torch.Tensor:
    """[D, *t.shape]: every rank's ``t``, on ``t``'s device.  Gloo's
    collectives run on the host, so there ``t`` crosses to it and the
    result back: the backend's own path, not a fallback."""
    on_host = mesh.backend != "nccl"
    src = to_host(t) if on_host else t
    out = torch.empty((mesh.size, *src.shape), dtype=src.dtype,
                      device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=mesh.group)
    return out.to(t.device) if on_host else out


def make_sharded_encoder(mesh, nb: int, word_cap: int | None = None):
    """The encode + stitch step of one wave.

    Input:  one (data_row, n, ctx) for each of ``mesh.shards``, in that
            order: data_row uint8[nb*BLOCK + PAD] on the shard's device
            (``mesh.shard_device``), n the valid bytes (context +
            payload), ctx the context prefix.  A process mesh's rank
            passes its own shard; a local mesh takes all D.
    Output: stream int32[D*Wc + 1] holding the u32 words of the stitched
            stream, sizes int32[D] per-shard compressed bytes, total
            int32 stream bytes, on ``mesh.device``; the same on every
            rank.

    Each shard contributes its first ``Wc`` words to the gather.  ``Wc``
    defaults to the incompressible worst case; a caller that knows its
    data compresses passes a tighter ``word_cap``.  A shard larger than
    the cap is cut in the gather while sizes and total stay exact, so the
    caller checks the sizes and runs the wave again at the full cap.
    """
    W_full = n_words_for(nb)
    Wc = W_full if word_cap is None else min(word_cap, W_full)

    def encode(shard):
        words, bits = encode_segment_ctx(*shard, nb)
        return (bits // 8).reshape(1), words[:Wc]

    def step(shards: list):
        encoded = mesh.run(encode, shards)
        sizes = mesh.gather([s for s, _ in encoded]).reshape(-1)
        gathered = mesh.gather([w for _, w in encoded])       # [D, Wc]
        # a shard past the cap keeps only its gathered bytes (the stream
        # is then short and the caller retries at the full cap)
        stream, _ = compact_streams(gathered, torch.clamp(sizes, max=4 * Wc) * 8)
        return stream, sizes, sizes.sum().int()

    return step


def _stream_bytes(stream: torch.Tensor, total) -> bytes:
    return to_host(stream.view(torch.uint8)[: int(total)]).numpy().tobytes()


class ShardedCompressor:
    """Data-parallel one-shot compressor over a mesh (``make_mesh()``
    when none is given: every visible card, or the process group's ranks).

    On a process mesh every rank calls ``compress`` with the same bytes
    and returns the same stream.  ``dictionary=`` is a reader-style
    preset dictionary (the decoder must be constructed with the same
    dictionary); ``halo=True`` feeds each shard the previous 32 KB of the
    data as context, recovering cross-shard matches (the output is still
    one plain DEFLATE stream).
    """

    def __init__(self, mesh: LocalMesh | ProcessMesh | None = None,
                 blocks_per_segment: int = 16, halo: bool = False,
                 word_cap: int | None = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.nb = blocks_per_segment
        self.seg = self.nb * BLOCK
        self.halo = halo
        self.n_dev = self.mesh.size
        self.word_cap = word_cap
        self._step = make_sharded_encoder(self.mesh, self.nb, word_cap)
        self._step_full = (self._step if word_cap is None
                           else make_sharded_encoder(self.mesh, self.nb))

    def _upload(self, context: bytes, part: bytes, d: int):
        """Shard ``d``'s staged row on its device, with n and ctx."""
        buf, n, ctx = stage_segment(context, part, self.nb)
        return torch.from_numpy(buf).to(self.mesh.shard_device(d)), n, ctx

    def compress(self, data: bytes, dictionary: bytes | None = None) -> bytes:
        """A wave at a time: only this process's shards of the wave are
        staged and uploaded, and only the stitched bytes return."""
        waves = self._waves(bytes(data), dictionary)
        return b"".join(part for part, _, _ in waves) + FINAL_EMPTY_BLOCK

    def _waves(self, data: bytes, dictionary: bytes | None = None):
        """Yield each wave's stitched bytes, its shard sizes int32[D] and
        the D shards' payload lengths (0 past the data).  This is the one
        place that maps a shard to its bytes, which every rank must agree
        on."""
        D = self.n_dev
        context = bytes(dictionary or b"")[-C.WINDOW_SIZE:]
        payload_cap = self.seg - (
            C.WINDOW_SIZE if (self.halo or context) else 0)
        if payload_cap <= 0:
            raise ValueError("segment too small for context")
        wave = D * payload_cap
        for w in range(max(1, -(-len(data) // wave))):
            shards = []
            for d in self.mesh.shards:
                start = w * wave + d * payload_cap
                if w == 0 and d == 0:
                    ctxd = context
                elif self.halo:
                    ctxd = data[max(0, start - C.WINDOW_SIZE): start]
                else:
                    ctxd = b""
                shards.append(self._upload(ctxd, data[start: start + payload_cap], d))
            stream, sizes, total = self._step(shards)
            if self.word_cap is not None and bool(
                    (sizes > 4 * self.word_cap - 4).any()):
                # a shard overflowed the tight gather cap (incompressible
                # data): redo this wave at the worst-case cap
                stream, sizes, total = self._step_full(shards)
            ns = [max(0, min(payload_cap, len(data) - (w * wave + d * payload_cap)))
                  for d in range(D)]
            yield _stream_bytes(stream, total), sizes, ns


def compress(data: bytes, mesh: LocalMesh | ProcessMesh | None = None,
             blocks_per_segment: int = 16, halo: bool = False,
             dictionary: bytes | None = None) -> bytes:
    return ShardedCompressor(mesh, blocks_per_segment, halo).compress(
        data, dictionary)


# ---------------------------------------------------------------------------
# Per-shard progress manifest (SURVEY §5.4): the shard-granular state
# vector that makes recovery and parallel decode simple — blocks are
# independent, so a lost shard is re-run and a stored manifest turns
# decode into pure data parallelism as well.

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


def compress_with_manifest(data: bytes, mesh: LocalMesh | ProcessMesh | None = None,
                           blocks_per_segment: int = 16, device=None):
    """Sharded compress returning (stream, ShardManifest).

    Without a mesh the shards go in waves of ``WAVE`` through the batched
    encode on ``device`` (``None`` means the card); with a mesh, one shard
    a device a wave on the mesh's devices.  Same stream and manifest.
    halo/dictionary are deliberately unsupported here: the manifest's
    point is shard-independent decode, which cross-shard history breaks.
    """
    nb = blocks_per_segment
    data = bytes(data)
    comp_sizes, payload_sizes, out = [], [], []
    if mesh is not None:
        # the JAX form: one shard a device a wave through the sharded step,
        # the manifest from the gathered sizes
        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
        for part, sizes, ns in ShardedCompressor(mesh, nb)._waves(data):
            out.append(part)
            for size, n in zip(sizes.tolist(), ns):
                if n > 0:
                    comp_sizes.append(size)
                    payload_sizes.append(n)
        out.append(FINAL_EMPTY_BLOCK)
        return b"".join(out), ShardManifest(comp_sizes, payload_sizes, nb)
    dev = resolve_device(device)
    seg = nb * BLOCK
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
        out.append(_stream_bytes(stream, sum(sizes)))
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
