"""The synthetic corpus of the benchmarks.

The port's own copy of ``make_corpus`` in the JAX side's ``bench.py``:
the same generator, so that the same (total, seed) gives the same bytes.
"""

from __future__ import annotations

import numpy as np

_WORDS = [b"the", b"quick", b"compression", b"deflate", b"window",
          b"huffman", b"block", b"stream", b"symbol", b"match",
          b"of", b"and", b"entropy", b"parallel", b"kernel"]


def make_corpus(total: int = 16 * (1 << 20), seed: int = 0) -> bytes:
    """Synthetic Silesia stand-in of ``total`` bytes: mixed text /
    structured binary records / repetitive / incompressible sections
    drawn from ``seed``.  A smaller total is a prefix of a larger one."""
    rng = np.random.default_rng(seed)
    parts = []
    size = 0
    while size < total:
        kind = rng.integers(0, 4)
        if kind == 0:  # english-ish text
            n_words = int(rng.integers(2000, 8000))
            idx = rng.integers(0, len(_WORDS), n_words)
            part = b" ".join(_WORDS[i] for i in idx)
        elif kind == 1:  # structured binary records
            rec = rng.integers(0, 256, 64, np.uint8).tobytes()
            reps = int(rng.integers(200, 1200))
            noise = rng.integers(0, 256, 64, np.uint8)
            part = b"".join(rec[:48] + noise.tobytes()[:16] for _ in range(reps))
        elif kind == 2:  # highly repetitive
            unit = rng.integers(0, 256, int(rng.integers(3, 200)), np.uint8).tobytes()
            part = unit * int(rng.integers(500, 3000))
        else:  # incompressible
            part = rng.integers(0, 256, int(rng.integers(30000, 150000)),
                                np.uint8).tobytes()
        parts.append(part)
        size += len(part)
    return b"".join(parts)[:total]
