"""UTF-8 encoder/decoder helpers (the port's own copy of
``moonbit_flate_tpu/utils/utf8.py``).

Parity with the reference's test-only side packages (encoder/lib.mbt:5-38,
decoder/lib.mbt:5-45): an iterator-style codepoint<->byte transform that,
on decode, stops at the first invalid or incomplete sequence rather than
raising.  Kept as plain Python — these are test utilities, not a hot path.
"""

from __future__ import annotations

from typing import Iterable, Iterator


def utf8_encode(chars: Iterable[str]) -> Iterator[int]:
    """Encode an iterable of single characters to UTF-8 bytes (1-4 each)."""
    for ch in chars:
        cp = ord(ch)
        if cp < 0x80:
            yield cp
        elif cp < 0x800:
            yield 0xC0 | (cp >> 6)
            yield 0x80 | (cp & 0x3F)
        elif cp < 0x10000:
            yield 0xE0 | (cp >> 12)
            yield 0x80 | ((cp >> 6) & 0x3F)
            yield 0x80 | (cp & 0x3F)
        else:
            yield 0xF0 | (cp >> 18)
            yield 0x80 | ((cp >> 12) & 0x3F)
            yield 0x80 | ((cp >> 6) & 0x3F)
            yield 0x80 | (cp & 0x3F)


def utf8_decode(data: Iterable[int]) -> Iterator[str]:
    """Decode UTF-8 bytes to characters; stop at the first invalid/short
    sequence (matching decoder/lib.mbt's stop-on-invalid behavior)."""
    it = iter(data)
    while True:
        try:
            b0 = next(it)
        except StopIteration:
            return
        if b0 < 0x80:
            yield chr(b0)
            continue
        if b0 < 0xC0:
            return  # stray continuation byte
        if b0 < 0xE0:
            need, cp = 1, b0 & 0x1F
        elif b0 < 0xF0:
            need, cp = 2, b0 & 0x0F
        elif b0 < 0xF8:
            need, cp = 3, b0 & 0x07
        else:
            return
        for _ in range(need):
            try:
                b = next(it)
            except StopIteration:
                return
            if (b & 0xC0) != 0x80:
                return
            cp = (cp << 6) | (b & 0x3F)
        yield chr(cp)
