"""User-facing configuration (SURVEY §5.6).

The port's counterpart of ``moonbit_flate_tpu/config.py``.  The reference
exposes no knobs beyond its constructors (everything else is a
compile-time constant, formats/constants.py being the single source of
truth for those).  This frozen dataclass holds the knobs this framework
does add: segment geometry, backend selection, sharding, and context
semantics.  The backend names follow the port: ``'cuda'`` where the JAX
package says ``'tpu'``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .formats import constants as C


@dataclass(frozen=True)
class CodecConfig:
    """Immutable codec configuration.

    blocks_per_segment: DEFLATE blocks (65535 B) per segment — the
        geometry of the device pipeline.
    backend: 'auto' | 'native' | 'python' | 'cuda' (one-shot API;
        'auto' is 'native' where the C codec builds, else 'python', as
        in the JAX package; 'cuda' is the device pipeline).
    halo: feed each segment/shard the previous 32 KB as context
        (recovers cross-boundary matches; SURVEY §5.7).
    mesh_axis: name of the data-parallel mesh axis (parallel/sharded).
    """

    blocks_per_segment: int = 16
    backend: str = "auto"
    halo: bool = False
    mesh_axis: str = "data"

    def __post_init__(self):
        if self.blocks_per_segment < 1:
            raise ValueError("blocks_per_segment must be >= 1")
        if self.backend not in ("auto", "native", "python", "cuda"):
            raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def segment_bytes(self) -> int:
        return self.blocks_per_segment * C.MAX_STORE_BLOCK_SIZE

    def cuda_compressor(self, device=None):
        from .api.cuda import CUDACompressor

        return CUDACompressor(self.blocks_per_segment, self.halo, device)

    def sharded_compressor(self, mesh=None):
        from .parallel.sharded import ShardedCompressor

        return ShardedCompressor(mesh, self.blocks_per_segment, self.halo)
