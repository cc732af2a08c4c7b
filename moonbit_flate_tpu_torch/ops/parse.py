"""Scalar-path DEFLATE inflate, stage A: the serial symbol parse of whole
raw-DEFLATE streams of any size, batched over independent streams.

Port of ``moonbit_flate_tpu/ops/parse_pallas.py``.  Each stream is read
block by block (stored, fixed, dynamic) into packed token records, the
ones the host scanner ``mf_scan_tokens`` emits: a literal is its byte
value, a match is ``1<<31 | (len-3)<<15 | (dist-1)``.  ``cnt`` holds
per stream the token count, the status and the output byte count.

Status: 1 = done, 0 = the token capacity ran out with the stream not
yet done, -3 = corrupt, -4 = truncated.  The rules that decide it:
fewer than 3 bits left at a block header is a clean end; a dynamic
header that is invalid *or cut short* is corrupt (the host scanner
calls the latter a clean end); a Huffman pattern with no code is
corrupt, a code that ends past the stream is truncated; in a match,
corrupt (symbol >= 286, distance symbol >= 30, distance beyond
min(output so far, 32768)) wins over truncated, with the bits past the
stream read as 0; each code must be empty, complete, or one code of
length 1.  One loop iteration emits at most one token and headers emit
none; the token array is 0 past each stream's tokens.

``parse_batch`` launches ``csrc/parse.cu`` for CUDA tensors, which
replaces the Pallas kernel ``parse_pallas.py:parse_batch``: one block a
stream, all streams in one launch.  A stream is one chain of dependent
steps, so what bounds the kernel on the H100 is the latency of the
machine operations on one lane's chain, not bytes or arithmetic.  The
design keeps that chain short: the warp moves the input through a ring in
shared memory and the tokens through a staging array (the parsing lane
touches no global memory), 32-bit table entries carry lengths, bases and
extra-bit counts (two short literals in one entry), a fast loop without
truncation checks runs while 48 bits remain and hands anything unusual,
at the token's first bit, to the step-by-step logic that decides every
status, the warp builds the tables together and expands stored blocks
itself, and the block zero-fills the token row's tail.
``parse_batch_ref`` is the plain PyTorch twin, one loop iteration of
every stream per step, and the wrapper takes it for CPU tensors only.
Bit positions are int32: ``stage_streams`` refuses a stream of 2**28
bytes or more and ``parse_batch`` a word array that wide.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import build
from ..utils.device import resolve_device
from .lanes_inflate import (CLS_BAD, CLS_EOB, CLS_LEN, CLS_LIT, NDIST_MAP,
                            NLIT_MAP, _M32, _huffman_build, _length_decode,
                            _peek)
from .tables import length_base_extra, offset_base_extra

OUT_CHUNK = 8192          # tokens per capacity chunk
SLACK_W = 8192            # zero words staged past the longest stream
MAX_STREAM_BYTES = 1 << 28

ST_MORE = 0               # capacity ran out (or still running)
ST_DONE = 1
ST_CORRUPT = -3
ST_TRUNC = -4

launches = 0  # kernel launches made by parse_batch

# nbits, words, toks, cnt, n_streams, stream_words, capacity, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def stage_streams(streams, device=None):
    """Pad B streams into the arrays ``parse_batch`` takes: nbits
    int32[B] and words int32[B, SW], little-endian words, zero past each
    stream, SW a multiple of 1024 with at least SLACK_W words of slack.
    ``device=None`` means the card."""
    dev = resolve_device(device)
    B = len(streams)
    longest = max(map(len, streams), default=0)
    if longest >= MAX_STREAM_BYTES:
        raise ValueError(f"a stream of {longest} bytes: bit positions are int32, "
                         f"streams must stay under {MAX_STREAM_BYTES} bytes")
    max_words = (longest + 3) // 4 if streams else 1
    SW = -(-(max_words + SLACK_W) // 1024) * 1024
    buf = bytearray(B * SW * 4)
    nbits = np.zeros(B, np.int32)
    for i, s in enumerate(streams):
        buf[i * SW * 4: i * SW * 4 + len(s)] = s
        nbits[i] = len(s) * 8
    words = (torch.frombuffer(buf, dtype=torch.int32) if B
             else torch.zeros(0, dtype=torch.int32)).reshape(B, SW)
    return torch.from_numpy(nbits).to(dev), words.to(dev)


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def parse_batch_ref(nbits: torch.Tensor, words: torch.Tensor, n_chunks: int,
                    out_chunk: int = OUT_CHUNK):
    """Kernel e, the plain way: the same (toks, cnt) as ``parse_batch``.
    Every live stream takes one loop iteration a step (a block header,
    a stored byte or a Huffman token); the loop ends when no stream is
    live, so short streams cost few steps."""
    B, SW = words.shape
    dev = words.device
    cap = n_chunks * out_chunk
    nb = nbits.long()
    w = torch.cat([words.long() & _M32,
                   torch.zeros(B, 2, dtype=torch.int64, device=dev)], 1)

    def zeros(*shape):
        return torch.zeros(B, *shape, dtype=torch.int64, device=dev)

    toks = torch.zeros(B, cap, dtype=torch.int32, device=dev)
    status, cursor, final, inblock = zeros(), zeros(), zeros(), zeros()
    sleft, ntok, outpos = zeros(), zeros(), zeros()
    fcl, bal, fcd, bad = zeros(15), zeros(15), zeros(15), zeros(15)
    maplit, mapdist = zeros(NLIT_MAP), zeros(NDIST_MAP)

    while True:
        live = (status == ST_MORE) & (ntok < cap)
        if not bool(live.any()):
            break
        in_hdr = live & (inblock == 0)
        in_huff = live & (inblock == 1)
        in_stored = live & (inblock == 2)
        lo = _peek(w, cursor)
        tok = zeros()
        emit = torch.zeros_like(live)

        # ---- one stored byte ------------------------------------------------
        if bool(in_stored.any()):
            tok = torch.where(in_stored, lo & 0xFF, tok)
            emit = emit | in_stored
            cursor = cursor + torch.where(in_stored, 8, 0)
            sleft = sleft - in_stored.long()
            ends = in_stored & (sleft == 0)
            inblock = torch.where(ends, 0, inblock)
            status = torch.where(ends & (final > 0), ST_DONE, status)

        # ---- one Huffman token ----------------------------------------------
        if bool(in_huff.any()):
            ln, rank, matched = _length_decode(lo, fcl, bal)
            e = maplit.gather(1, rank.clamp(max=NLIT_MAP - 1)[:, None])[:, 0]
            cls, pay = e >> 8, e & 255
            s_trunc = matched & (cursor + ln > nb)
            sym_ok = in_huff & matched & ~s_trunc
            is_lit = sym_ok & (cls == CLS_LIT)
            is_eob = sym_ok & (cls == CLS_EOB)
            is_len = sym_ok & (cls == CLS_LEN)
            # length, then the distance code and its extra bits; bits past
            # the stream read as 0 and corrupt wins over truncated
            lbase, leb = length_base_extra(pay.clamp(max=28))
            length = lbase + ((lo >> ln) & ((1 << leb) - 1))
            p_len = cursor + ln + leb
            lo2 = _peek(w, p_len)
            dl, drank, dmatched = _length_decode(lo2, fcd, bad)
            de_ = mapdist.gather(1, drank.clamp(max=NDIST_MAP - 1)[:, None])[:, 0]
            d_trunc = dmatched & (p_len + dl > nb)
            d_ok = dmatched & ~d_trunc
            bad_d = ~dmatched | (d_ok & ((de_ >> 8) == CLS_BAD))
            dbase, deb = offset_base_extra(torch.where(d_ok, de_ & 255, 0))
            dl = torch.where(d_ok, dl, 0)
            dist = dbase + ((lo2 >> dl) & ((1 << deb) - 1))
            p_end = p_len + dl + deb
            m_trunc = d_trunc | (p_end > nb)
            m_bad = bad_d | (dist > torch.clamp(outpos, max=32768))
            is_match = is_len & ~m_bad & ~m_trunc

            status = torch.where(
                in_huff & (~matched | (sym_ok & (cls == CLS_BAD)) | (is_len & m_bad)),
                ST_CORRUPT, torch.where(
                    in_huff & (s_trunc | (is_len & ~m_bad & m_trunc)), ST_TRUNC,
                    torch.where(is_eob & (final > 0), ST_DONE, status)))
            tok = torch.where(is_lit, pay, torch.where(
                is_match, (((length - 3) << 15) | (dist - 1)) - (1 << 31), tok))
            emit = emit | is_lit | is_match
            cursor = torch.where(is_lit | is_eob, cursor + ln,
                                 torch.where(is_match, p_end, cursor))
            outpos = outpos + torch.where(is_match, length - 1, 0)
            inblock = torch.where(is_eob, 0, inblock)

        # ---- one block header -------------------------------------------------
        if bool(in_hdr.any()):
            eof = in_hdr & (cursor + 3 > nb)
            status = torch.where(eof, ST_DONE, status)
            hdr = in_hdr & ~eof
            final = torch.where(hdr, lo & 1, final)
            typ = torch.where(hdr, (lo >> 1) & 3, -1)
            p3 = cursor + 3
            status = torch.where(typ == 3, ST_CORRUPT, status)

            t0 = typ == 0
            aligned = (p3 + 7) & ~7
            lens16 = _peek(w, aligned)
            ln16, nln16 = lens16 & 0xFFFF, lens16 >> 16
            ok_len = (ln16 ^ nln16) == 0xFFFF
            ok_sz = aligned + 32 + 8 * ln16 <= nb
            status = torch.where(t0 & ~ok_len, ST_CORRUPT, torch.where(
                t0 & ok_len & ~ok_sz, ST_TRUNC, status))
            t0ok = t0 & ok_len & ok_sz
            cursor = torch.where(t0ok, aligned + 32, cursor)
            sleft = torch.where(t0ok, ln16, sleft)
            inblock = torch.where(t0ok & (ln16 > 0), 2, inblock)
            status = torch.where(t0ok & (ln16 == 0) & (final > 0), ST_DONE, status)

            # Huffman blocks: only the streams that read one take part
            h = ((typ == 1) | (typ == 2)).nonzero()[:, 0]
            if len(h):
                bp_h, ok, tables, maps = _huffman_build(w[h], nb[h], typ[h] == 2, p3[h])
                status[h] = torch.where(ok, status[h], ST_CORRUPT)
                hk = h[ok]
                cursor[hk] = bp_h[ok]
                inblock[hk] = 1
                for dst, t in zip((fcl, bal, fcd, bad), tables):
                    dst[hk] = t[ok]
                maplit[hk] = maps[0][ok]
                mapdist[hk] = maps[1][ok]

        rows = emit.nonzero()[:, 0]
        toks[rows, ntok[rows]] = tok[rows].int()
        ntok = ntok + emit.long()
        outpos = outpos + emit.long()
    return toks, torch.stack([ntok, status, outpos], 1).int()


def parse_batch(nbits: torch.Tensor, words: torch.Tensor, n_chunks: int,
                out_chunk: int = OUT_CHUNK):
    """Parse B raw-DEFLATE streams.

    nbits: int32[B] bit length of each stream; words: int32[B, SW]
    little-endian input words, zero past each stream (``stage_streams``);
    the token capacity of a stream is n_chunks * out_chunk.  Returns
    (toks int32[B, n_chunks * out_chunk], cnt int32[B, 3]) with cnt[:, 0]
    the token count, cnt[:, 1] the status (1 done, 0 out of capacity, -3
    corrupt, -4 truncated) and cnt[:, 2] the output byte count.  One
    launch of ``csrc/parse.cu`` for CUDA tensors; the plain twin for CPU
    tensors."""
    if not words.is_cuda:
        return parse_batch_ref(nbits, words, n_chunks, out_chunk)
    global launches
    cap = n_chunks * out_chunk
    if nbits.dtype != torch.int32 or words.dtype != torch.int32 \
            or words.dim() != 2 or nbits.shape != words.shape[:1] \
            or nbits.device != words.device:
        raise ValueError("parse_batch takes int32[B] nbits and int32[B, SW] words "
                         "on one device")
    B, SW = words.shape
    if SW * 32 >= 1 << 31 or not 0 < cap < 1 << 31:
        raise ValueError(f"parse_batch: {SW} words a stream or a capacity of {cap} "
                         "tokens does not fit int32 positions")
    nbits = nbits.contiguous()
    words = words.contiguous()
    toks = torch.empty(B, cap, dtype=torch.int32, device=words.device)
    cnt = torch.empty(B, 3, dtype=torch.int32, device=words.device)
    build.launch("parse", "parse_launch", _ARGTYPES, words.device,
                 nbits.data_ptr(), words.data_ptr(), toks.data_ptr(),
                 cnt.data_ptr(), B, SW, cap)
    launches += 1
    return toks, cnt


def parse_stream(data: bytes, max_out_chunks: int = 256,
                 out_chunk: int = OUT_CHUNK, device=None):
    """Parse one raw-DEFLATE stream.  Returns (tokens int32[N] as numpy,
    status, out_bytes); the token capacity is max_out_chunks * out_chunk."""
    nbits, words = stage_streams([data], device)
    toks, cnt = parse_batch(nbits, words, max_out_chunks, out_chunk)
    ntok, status, outpos = cnt[0].tolist()
    return toks[0, :ntok].cpu().numpy(), status, outpos
