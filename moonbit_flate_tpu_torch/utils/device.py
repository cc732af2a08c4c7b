"""Where the port's entry points run, and copies back to the host."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch route")
    return dev


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host.  From the card: one non-blocking copy into a
    pinned buffer (PyTorch's caching host allocator hands the same buffer
    back on the next call of that size) and a wait for the stream, which
    copies at the link's rate where a copy into pageable memory goes
    through a staging buffer."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host
