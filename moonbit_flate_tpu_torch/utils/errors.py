"""Error types of the codec (the port's own copy of the JAX package's
``utils/errors.py``; the port imports nothing from that package)."""

from __future__ import annotations


class FlateError(Exception):
    """Base class for all codec errors."""


class CorruptInputError(FlateError):
    """The input stream is not valid DEFLATE data; ``offset`` is the
    byte offset in the compressed stream at which corruption was found
    (-1 where the decoder cannot say)."""

    def __init__(self, offset: int):
        super().__init__(f"flate: corrupt input before offset {offset}")
        self.offset = offset


class UnexpectedEOFError(FlateError):
    """The stream ended in the middle of an element."""

    def __init__(self):
        super().__init__("flate: unexpected EOF")
