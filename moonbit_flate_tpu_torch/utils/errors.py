"""Error model for the codec (the port's own copy of the JAX package's
``utils/errors.py``; the port imports nothing from that package).

Mirrors the reference's distinguished error values (inflate.mbt:38-46,
deflate.mbt:154) and sticky-error semantics (SURVEY.md §2.9.7): once a
stream object errors, every subsequent operation re-raises the same error.
"""

from __future__ import annotations


class FlateError(Exception):
    """Base class for all codec errors."""


class CorruptInputError(FlateError):
    """The input stream is not valid DEFLATE data.

    Carries the byte offset in the compressed stream at which corruption
    was detected, matching the reference's `corrupt_input_error(offset)`
    (inflate.mbt:38-40).
    """

    def __init__(self, offset: int):
        super().__init__(f"flate: corrupt input before offset {offset}")
        self.offset = offset


class InternalError(FlateError):
    """An internal invariant was violated (inflate.mbt:44-46)."""

    def __init__(self, msg: str):
        super().__init__(f"flate: internal error: {msg}")


class WriterClosedError(FlateError):
    """Write after close (deflate.mbt:154)."""

    def __init__(self):
        super().__init__("flate: writer closed")


class UnexpectedEOFError(FlateError):
    """Stream ended mid-element (io.err_unexpected_eof analogue)."""

    def __init__(self):
        super().__init__("flate: unexpected EOF")


class EOFError_(FlateError):
    """Clean end-of-stream marker (io.eof analogue, inflate.mbt:19)."""

    def __init__(self):
        super().__init__("EOF")
