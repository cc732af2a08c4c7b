"""Lane-parallel DEFLATE inflate, kernel A: the symbol parse of many
shard streams at once.

Port of ``moonbit_flate_tpu/ops/lanes_inflate.py``.  Streams come in
waves of NSTR = 1024; each decodes to at most SEGB bytes.  Kernel A
reads every stream's block headers, builds its canonical-Huffman
tables and decodes its symbols into step-major token records: literal
``1<<30 | byte``, match ``1<<31 | len<<13 | dist``, 0 for a gap row.
``misc`` rows 0-2 carry each stream's status, output length and final
bit position; row 3 is 0.

The token rows follow the TPU kernel's schedule exactly, because they
are part of the output: grid step t of 128 symbol steps writes rows
t*128 .. t*128+127; a block header is read only at the start of a grid
step (a stream whose block ends pauses for the rest of that chunk); a
match takes two steps (a gap row for the length code, then the record
at the distance step); what is still active or paused after the last
chunk is ST_OVERFLOW.

``parse_waves`` launches ``csrc/lanes_parse.cu`` (a lane a stream, a
warp a block, all waves in one launch; rich root tables and an input
ring in shared memory) for CUDA tensors; ``parse_waves_ref`` is the
plain PyTorch twin, one symbol step per loop iteration over all streams,
and the wrapper takes it for CPU tensors only.  ``root_decode_ref`` is
the plain model of the kernel's table decode (a root entry where there
is one, else length counting, which the kernel does for codes one bit
longer than the root with a bitmap of their symbols), held against the
twin's ``_length_decode`` by the tests.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import build
from ..utils.device import resolve_device
from .tables import length_base_extra, offset_base_extra

SUB, LANE = 8, 128
NSTR = SUB * LANE          # streams per wave
SEGB = 4096                # max output bytes per stream (shard size)
TOK_ROWS = 35 * 128        # step-major token rows per stream
IN_W = 1152                # input words per stream
IN_CHUNKS = IN_W // LANE
TOK_CHUNKS = TOK_ROWS // 128

TOK_LIT = 1 << 30
TOK_MATCH = 1 << 31

# symbol-map entry classes: class(2) | payload(8)
CLS_LIT = 0      # payload = literal byte
CLS_LEN = 1      # payload = length-code (or distance-code) index
CLS_EOB = 2
CLS_BAD = 3      # invalid symbol

# per-stream status
ST_ACTIVE = 0
ST_DONE = 1
ST_PAUSED = 2    # block header pending
ST_CORRUPT = -3
ST_TRUNC = -4
ST_OVERFLOW = -5  # out of token rows / output bytes

CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
NSYM = 320       # lit/len + distance code lengths of one block, at most
NLIT_MAP = 288   # lit/len ranks
NDIST_MAP = 32   # distance ranks

launches = 0  # kernel launches made by parse_waves

# nbits, inw, tok, misc, scratch, n_streams, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
SCRATCH = 60 + (NLIT_MAP + NDIST_MAP) // 2   # int32 of kernel scratch a stream

_M32 = 0xFFFFFFFF


def stage_streams_lanes(streams, waves: int, device=None):
    """Pad B <= waves * NSTR raw-DEFLATE streams into the kernel inputs:
    nbits int32[waves, 8, 128] (stream r of a wave at (r // 128,
    r % 128)) and inw int32[waves, IN_CHUNKS, 1024, 128] (word w of
    stream r at [wave, w // 128, r, w % 128]), zero past each stream.
    Only the streams' bytes go to the device, joined end to end in one
    host buffer (pinned for the card, a wave at a time) and one
    non-blocking copy; there each stream's IN_W words are cut out of them
    (a window of IN_W * 4 bytes at the stream's offset, zero past its
    end) and laid out.
    ``device=None`` means the card."""
    dev = resolve_device(device)
    B = waves * NSTR
    stride = IN_W * 4
    if len(streams) > B:
        raise ValueError(f"{len(streams)} streams do not fit in {waves} waves")
    lens = np.zeros(B, np.int64)
    lens[:len(streams)] = np.fromiter(map(len, streams), np.int64, len(streams))
    if (lens > stride).any():
        i = int(np.argmax(lens > stride))
        raise ValueError(f"stream {i}: {lens[i]} bytes > {stride}")
    # a window of stride bytes starts at every stream's offset
    host = torch.empty(int(lens.sum()) + stride, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    buf, o = host.numpy(), 0
    # a wave's streams joined at a time: the join's memory comes back from
    # the heap, where one join of all of them would touch fresh pages
    for k in range(0, len(streams), NSTR):
        part = np.frombuffer(b"".join(streams[k:k + NSTR]), np.uint8)
        buf[o:o + len(part)] = part
        o += len(part)
    buf[o:] = 0
    joined = host.to(dev, non_blocking=True)
    n = torch.from_numpy(lens).to(dev, non_blocking=True)
    rows = joined.unfold(0, stride, 1).index_select(0, torch.cumsum(n, 0) - n)
    rows.masked_fill_(torch.arange(stride, device=dev)[None, :] >= n[:, None], 0)
    words = rows.view(torch.int32).reshape(waves, NSTR, IN_CHUNKS, LANE)
    return ((n * 8).to(torch.int32).reshape(waves, SUB, LANE),
            words.permute(0, 2, 1, 3).contiguous())


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def _wrap32(x):
    """int64 holding any integer -> the int32 value of its low 32 bits."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _peek(words, bp):
    """32 bits of each stream starting at bit bp (LSB first), zero past
    the stream's W words.  words: int64[B, W + 2] (u32 values, two zero
    words of padding); bp: int64[B] or int64[B, k]."""
    pos = bp if bp.dim() == 2 else bp[:, None]
    idx = torch.clamp(pos >> 5, max=words.shape[1] - 2)
    lo = words.gather(1, idx)
    hi = words.gather(1, idx + 1)
    v = (((hi << 32) | lo) >> (pos & 31)) & _M32
    return v if bp.dim() == 2 else v[:, 0]


def _length_decode(lo, fc, base):
    """Canonical decode by length counting, all code lengths at once.

    fc[:, l-1] = first code of length l << 9 | count (int32 value),
    base[:, l-1] = rank of that first code.  Returns (length, rank,
    matched): the first length l whose code (the next l bits, first bit
    most significant) falls in [first, first + count)."""
    maxb = fc.shape[1]
    ls = torch.arange(maxb, device=lo.device)
    bits = (lo[:, None] >> ls) & 1
    rev = (bits << (maxb - 1 - ls)).sum(1)           # first bit on top
    code = rev[:, None] >> (maxb - 1 - ls)          # next l bits, l = 1..maxb
    o = code - (fc >> 9)
    hit = (o >= 0) & (o < (fc & 511))
    matched = hit.any(1)
    first = hit.int().argmax(1, keepdim=True)
    ln = torch.where(matched, first[:, 0] + 1, 0)
    rank = torch.where(matched, (base.gather(1, first) + o.gather(1, first))[:, 0], 0)
    return ln, rank, matched


FIX_ROOT_BITS = (9, 5)   # kernel roots of the fixed code: literal/length, distance
DYN_ROOT_BITS = (8, 6)   # a dynamic block's roots


def root_table_ref(fc, base, entries, root_bits: int):
    """One code's root as ``csrc/lanes_parse.cu`` holds it: for each
    pattern of ``root_bits`` bits (first bit least significant) the code
    of length <= root_bits that it starts with, as its length (0 where
    none does) and its map entry.  fc, base: int64[15] (``_canonical``);
    entries: int64[n] rank -> class << 8 | payload."""
    length = torch.zeros(1 << root_bits, dtype=torch.int64)
    entry = torch.zeros_like(length)
    for l in range(1, root_bits + 1):
        first, count = int(fc[l - 1]) >> 9, int(fc[l - 1]) & 511
        for o in range(count):
            rev = int(f"{first + o:0{l}b}"[::-1], 2)
            length[rev::1 << l] = l
            entry[rev::1 << l] = entries[min(int(base[l - 1]) + o, len(entries) - 1)]
    return length, entry


def root_decode_ref(lo, root, root_bits: int, fc, base, entries):
    """The kernel's decode of the code at the head of each ``lo`` (int64[P],
    LSB first): the root entry where there is one, else length counting
    on the canonical tables.  Returns (length, map entry, matched) as the
    twin's ``_length_decode`` and rank map give them."""
    length, entry = root
    idx = lo & ((1 << root_bits) - 1)
    ln, rank, matched = _length_decode(lo, fc.expand(len(lo), -1), base.expand(len(lo), -1))
    slow = entries[rank.clamp(max=len(entries) - 1)]
    hit = length[idx] > 0
    return (torch.where(hit, length[idx], ln), torch.where(hit, entry[idx], slow),
            hit | matched)


def _canonical(counts):
    """counts int64[B, maxb] per-length code counts -> (fc, base, bad):
    packed first code << 9 | count and rank base per length (int32
    arithmetic, wrapping as the TPU kernel's does), and the rejection of
    a table whose Kraft sum is neither 0, complete, nor one code of
    length 1."""
    maxb = counts.shape[1]
    code = torch.zeros_like(counts[:, 0])
    b = torch.zeros_like(code)
    kraft = torch.zeros_like(code)
    mx = torch.zeros_like(code)
    fc, base = [], []
    for l in range(1, maxb + 1):
        c = counts[:, l - 1]
        fc.append(_wrap32((code << 9) | c))
        base.append(b)
        b = b + c
        code = _wrap32((code + c) << 1)
        kraft = kraft + (c << (maxb - l))
        mx = torch.where(c > 0, l, mx)
    full = 1 << maxb
    ok = (kraft == 0) | (kraft == full) | ((mx == 1) & (kraft == full // 2))
    return torch.stack(fc, 1), torch.stack(base, 1), ~ok


def _fixed_lens(device):
    i = torch.arange(NSYM, device=device)
    return torch.where(i >= 288, 5, torch.where(i < 144, 8, torch.where(
        i < 256, 9, torch.where(i < 280, 7, 8))))


def _huffman_build(words, nbits, dyn, bp):
    """Header and tables of k streams that read a fixed (dyn False) or
    dynamic block header at bit bp.  Returns (bp after the header, ok:
    tables good and the stream goes on, (fcl, bal, fcd, bad) tables,
    (maplit, mapdist) maps)."""
    dev = bp.device
    fixed = ~dyn
    lo = _peek(words, bp)
    nlit = torch.where(dyn, 257 + (lo & 31), 288)
    ndist = torch.where(dyn, 1 + ((lo >> 5) & 31), 32)
    nclen = torch.where(dyn, 4 + ((lo >> 10) & 15), 0)
    bp = bp + torch.where(dyn, 14, 0)
    dyn = dyn & ~((nlit > 286) | (ndist > 30))

    # code-length code lengths, 3 bits each in CL_ORDER
    k19 = torch.arange(19, device=dev)
    v = _peek(words, bp[:, None] + 3 * k19) & 7
    v = torch.where(dyn[:, None] & (k19 < nclen[:, None]), v, 0)
    cl_len = torch.zeros_like(v)
    cl_len[:, list(CL_ORDER)] = v
    bp = bp + torch.where(dyn, 3 * nclen, 0)
    oh_cl = torch.nn.functional.one_hot(cl_len, 8)          # [k, 19, 8]
    fc_cl, base_cl, cl_bad = _canonical(oh_cl.sum(1)[:, 1:])
    dyn = dyn & ~cl_bad
    build = fixed | dyn

    # CL rank -> symbol
    seen = torch.cumsum(oh_cl, 1) - oh_cl
    base8 = torch.cat([torch.zeros_like(base_cl[:, :1]), base_cl], 1)
    cl_rank = base8.gather(1, cl_len) + seen.gather(2, cl_len[..., None])[..., 0]
    cl_rank = torch.where(cl_len > 0, cl_rank, 19)
    clsym = torch.zeros(len(bp), 20, dtype=torch.int64, device=dev)
    clsym.scatter_(1, cl_rank.clamp(max=19), k19.expand_as(cl_rank).clone())
    clsym = clsym[:, :19]

    # code lengths: a serial pass over the positions of dynamic blocks
    ns = torch.where(build, nlit + ndist, 0)
    lens = torch.where(fixed[:, None], _fixed_lens(dev), 0)
    run_rem = torch.zeros_like(bp)
    run_len = torch.zeros_like(bp)
    badi = torch.zeros_like(dyn)
    for i in range(int(torch.where(dyn, ns, 0).max())):
        live = dyn & (i < ns)
        needc = live & (run_rem == 0)
        lo = _peek(words, bp)
        ln_c, rank_c, m_c = _length_decode(lo, fc_cl, base_cl)
        sym = clsym.gather(1, rank_c.clamp(max=18)[:, None])[:, 0]
        is16, is17, is18 = sym == 16, sym == 17, sym == 18
        eb = torch.where(is16, 2, torch.where(is17, 3, torch.where(is18, 7, 0)))
        extra = (lo >> ln_c) & ((1 << eb) - 1)
        rep = torch.where(is16 | is17, 3 + extra, torch.where(is18, 11 + extra, 1))
        newlen = torch.where(sym < 16, sym, torch.where(is16, run_len, 0))
        # a failed code reads as rank 0 and consumes nothing
        badi = badi | (needc & ~m_c)
        if i == 0:
            badi = badi | (needc & is16)
        nused = torch.where(needc & m_c, ln_c + eb, 0)
        badi = badi | (needc & (bp + nused > nbits))
        bp = bp + nused
        run_rem = torch.where(needc, rep, run_rem)
        run_len = torch.where(needc, newlen, run_len)
        lens[:, i] = torch.where(live, run_len, lens[:, i])
        run_rem = run_rem - live.long()
    bad = badi | (dyn & (run_rem > 0))

    # per-length counts and canonical tables of both alphabets
    pos = torch.arange(NSYM, device=dev)
    lens = torch.where(pos < ns[:, None], lens, 0)
    is_lit = pos < nlit[:, None]
    oh = torch.nn.functional.one_hot(lens, 16)              # [k, 320, 16]
    oh_l = oh * is_lit[..., None]
    oh_d = oh * ~is_lit[..., None]
    fc_l, ba_l, bad_l = _canonical(oh_l.sum(1)[:, 1:])
    fc_d, ba_d, bad_d = _canonical(oh_d.sum(1)[:, 1:])
    bad = bad | bad_l | bad_d

    # rank -> (class << 8 | payload) maps; unassigned ranks hold 0
    z1 = torch.zeros_like(ba_l[:, :1])
    bl16 = torch.cat([z1, ba_l], 1)
    bd16 = torch.cat([z1, ba_d], 1)
    seen_l = (torch.cumsum(oh_l, 1) - oh_l).gather(2, lens[..., None])[..., 0]
    seen_d = (torch.cumsum(oh_d, 1) - oh_d).gather(2, lens[..., None])[..., 0]
    rank = torch.where(is_lit, bl16.gather(1, lens) + seen_l,
                       bd16.gather(1, lens) + seen_d)
    sidx = torch.where(is_lit, pos, pos - nlit[:, None])
    cls = torch.where(
        is_lit,
        torch.where(sidx < 256, CLS_LIT, torch.where(
            sidx == 256, CLS_EOB, torch.where(sidx < 286, CLS_LEN, CLS_BAD))),
        torch.where(sidx < 30, CLS_LEN, CLS_BAD))
    pay = torch.where(is_lit, torch.where(sidx < 256, sidx,
                                          torch.clamp(sidx - 257, 0, 28)),
                      torch.clamp(sidx, 0, 29))
    entry = (cls << 8) | pay
    valid = lens > 0
    r_l = torch.where(valid & is_lit, rank.clamp(max=NLIT_MAP - 1), NLIT_MAP)
    r_d = torch.where(valid & ~is_lit, rank.clamp(max=NDIST_MAP - 1), NDIST_MAP)
    new_l = torch.zeros(len(bp), NLIT_MAP + 1, dtype=torch.int64, device=dev)
    new_d = torch.zeros(len(bp), NDIST_MAP + 1, dtype=torch.int64, device=dev)
    new_l.scatter_(1, r_l, entry)
    new_d.scatter_(1, r_d, entry)
    return (bp, build & ~bad, (fc_l, ba_l, fc_d, ba_d),
            (new_l[:, :NLIT_MAP], new_d[:, :NDIST_MAP]))


class _Lanes:
    """State of B streams, each field an int64[B] tensor (or [B, k])."""

    def __init__(self, nbits, inw, waves):
        B = waves * NSTR
        dev = inw.device
        self.nbits = nbits.reshape(B).long()
        w = inw.long().permute(0, 2, 1, 3).reshape(B, IN_W) & _M32
        self.words = torch.cat([w, torch.zeros(B, 2, dtype=torch.int64, device=dev)], 1)
        def zeros(*shape):
            return torch.zeros(B, *shape, dtype=torch.int64, device=dev)

        self.status = zeros() + ST_PAUSED
        self.bp, self.opos, self.blkmode, self.sleft = zeros(), zeros(), zeros(), zeros()
        self.final, self.expd, self.plen = zeros(), zeros(), zeros()
        self.fcl, self.bal, self.fcd, self.bad = zeros(15), zeros(15), zeros(15), zeros(15)
        self.maplit, self.mapdist = zeros(NLIT_MAP), zeros(NDIST_MAP)

    def peek(self):
        return _peek(self.words, self.bp)

    # ---- block header and table build (streams in ST_PAUSED) ---------------

    def build_wave(self):
        status = self.status
        paused = status == ST_PAUSED
        eof = paused & (self.bp + 3 > self.nbits)
        status = torch.where(eof, ST_DONE, status)
        hdr_act = paused & ~eof
        hdr = self.peek() & 7
        self.final = torch.where(hdr_act, hdr & 1, self.final)
        typ = torch.where(hdr_act, (hdr >> 1) & 3, -1)
        bp = self.bp + torch.where(hdr_act, 3, 0)
        status = torch.where(typ == 3, ST_CORRUPT, status)

        # stored blocks
        t0 = typ == 0
        bp = bp + torch.where(t0, (8 - (bp & 7)) & 7, 0)
        ln16 = _peek(self.words, bp) & 0xFFFF
        bp = bp + torch.where(t0, 16, 0)
        nln16 = _peek(self.words, bp) & 0xFFFF
        bp = bp + torch.where(t0, 16, 0)
        ok_len = ((ln16 ^ nln16) & 0xFFFF) == 0xFFFF
        ok_sz = bp + 8 * ln16 <= self.nbits
        ovf = self.opos + ln16 > SEGB
        status = torch.where(t0 & ~ok_len, ST_CORRUPT, status)
        status = torch.where(t0 & ok_len & ~ok_sz, ST_TRUNC, status)
        status = torch.where(t0 & ok_len & ok_sz & ovf, ST_OVERFLOW, status)
        t0ok = t0 & ok_len & ok_sz & ~ovf
        self.sleft = torch.where(t0ok, ln16, self.sleft)
        self.blkmode = torch.where(t0ok & (ln16 > 0), 2, self.blkmode)
        status = torch.where(t0ok, torch.where(
            ln16 > 0, ST_ACTIVE, torch.where(self.final > 0, ST_DONE, ST_PAUSED)),
            status)

        # Huffman blocks: only the streams that read one take part
        h = ((typ == 1) | (typ == 2)).nonzero()[:, 0]
        if len(h):
            bp_h, ok, tables, maps = _huffman_build(
                self.words[h], self.nbits[h], typ[h] == 2, bp[h])
            bp[h] = bp_h
            status[h] = torch.where(ok, ST_ACTIVE, ST_CORRUPT)
            self.blkmode[h] = torch.where(ok, 1, self.blkmode[h])
            self.expd[h] = torch.where(ok, 0, self.expd[h])
            # a stream whose tables are bad is corrupt and decodes no more
            hk = h[ok]
            for name, t in zip(("fcl", "bal", "fcd", "bad"), tables):
                getattr(self, name)[hk] = t[ok]
            self.maplit[hk] = maps[0][ok]
            self.mapdist[hk] = maps[1][ok]
        self.status = status
        self.bp = bp

    # ---- one symbol step of every active stream ----------------------------

    def sym_step(self):
        """Returns the step's token record of each stream (0 if none)."""
        active = self.status == ST_ACTIVE
        in_huff = active & (self.blkmode == 1)
        in_stored = active & (self.blkmode == 2)
        isd = self.expd > 0
        lo = self.peek()
        i2 = isd[:, None]
        ln, rank, matched = _length_decode(
            lo, torch.where(i2, self.fcd, self.fcl), torch.where(i2, self.bad, self.bal))
        e = torch.where(
            isd, self.mapdist.gather(1, rank.clamp(max=NDIST_MAP - 1)[:, None])[:, 0],
            self.maplit.gather(1, rank.clamp(max=NLIT_MAP - 1)[:, None])[:, 0])
        cls, payload = e >> 8, e & 255

        hm = in_huff & matched
        is_lit = hm & ~isd & (cls == CLS_LIT)
        is_len = hm & ~isd & (cls == CLS_LEN)
        is_eob = hm & ~isd & (cls == CLS_EOB)
        is_dst = hm & isd & (cls == CLS_LEN)
        bad_code = in_huff & (~matched | (cls == CLS_BAD) | (isd & (cls != CLS_LEN)))

        lbase, leb = length_base_extra(torch.clamp(payload, 0, 28))
        length = lbase + ((lo >> ln) & ((1 << leb) - 1))
        dbase, deb = offset_base_extra(torch.clamp(payload, 0, 29))
        dist = dbase + ((lo >> ln) & ((1 << deb) - 1))

        nused = torch.where(in_stored, 8, torch.where(
            is_lit | is_eob, ln, torch.where(
                is_len, ln + leb, torch.where(is_dst, ln + deb, 0))))
        trunc = (in_huff | in_stored) & (self.bp + nused > self.nbits) & ~bad_code
        ok = (in_huff | in_stored) & ~trunc & ~bad_code

        emit_lit = ok & (in_stored | is_lit)
        lit_b = torch.where(in_stored, lo & 0xFF, payload)
        dist_over = ok & is_dst & (dist > self.opos)
        emit_match = ok & is_dst & ~dist_over
        len_over = emit_match & (self.opos + self.plen > SEGB)
        lit_over = emit_lit & (self.opos + 1 > SEGB)
        emit_match = emit_match & ~len_over
        emit_lit = emit_lit & ~lit_over

        tok = torch.where(emit_lit, TOK_LIT | lit_b, torch.where(
            emit_match, ((self.plen << 13) | dist) - TOK_MATCH, 0))

        do_adv = ok & ~dist_over & ~len_over & ~lit_over
        self.bp = self.bp + torch.where(do_adv, nused, 0)
        self.opos = self.opos + torch.where(emit_lit, 1, torch.where(emit_match, self.plen, 0))
        self.expd = torch.where(do_adv & is_len, 1, torch.where(do_adv & is_dst, 0, self.expd))
        self.plen = torch.where(do_adv & is_len, length, self.plen)
        self.sleft = self.sleft - (do_adv & in_stored).long()
        block_end = (in_stored & do_adv & (self.sleft == 0)) | (do_adv & is_eob)
        self.status = torch.where(trunc, ST_TRUNC, torch.where(
            bad_code | dist_over, ST_CORRUPT, torch.where(
                len_over | lit_over, ST_OVERFLOW, torch.where(
                    block_end, torch.where(self.final > 0, ST_DONE, ST_PAUSED),
                    self.status))))
        self.blkmode = torch.where(block_end, 0, self.blkmode)
        return tok


def parse_waves_ref(nbits: torch.Tensor, inw: torch.Tensor, waves: int):
    """Kernel A, the plain way: the same (tok, misc) as ``parse_waves``."""
    st = _Lanes(nbits, inw, waves)
    B = waves * NSTR
    tok = torch.zeros(TOK_ROWS, B, dtype=torch.int32, device=inw.device)
    for t in range(TOK_CHUNKS):
        if bool((st.status == ST_PAUSED).any()):
            st.build_wave()
        for j in range(128):
            if not bool((st.status == ST_ACTIVE).any()):
                break
            tok[t * 128 + j] = st.sym_step().int()
    st.status = torch.where((st.status == ST_ACTIVE) | (st.status == ST_PAUSED),
                            ST_OVERFLOW, st.status)
    misc = torch.stack([st.status, st.opos, st.bp, torch.zeros_like(st.bp)])
    misc = misc.int().reshape(4, waves, SUB, LANE).permute(1, 0, 2, 3).contiguous()
    tok = tok.reshape(TOK_CHUNKS, 128, waves, SUB, LANE).permute(2, 0, 1, 3, 4)
    return tok.contiguous(), misc


def parse_waves(nbits: torch.Tensor, inw: torch.Tensor, waves: int):
    """Kernel A over ``waves`` waves of 1024 streams.

    nbits: int32[waves, 8, 128] per-stream bit counts; inw: int32[waves,
    IN_CHUNKS, 1024, 128] input words (``stage_streams_lanes``).
    Returns tok int32[waves, TOK_CHUNKS, 128, 8, 128] (step-major token
    rows) and misc int32[waves, 4, 8, 128] (status, output length, bit
    position, 0).  One launch of ``csrc/lanes_parse.cu`` for CUDA
    tensors; the plain twin for CPU tensors."""
    if not inw.is_cuda:
        return parse_waves_ref(nbits, inw, waves)
    global launches
    if nbits.dtype != torch.int32 or inw.dtype != torch.int32 \
            or nbits.shape != (waves, SUB, LANE) \
            or inw.shape != (waves, IN_CHUNKS, NSTR, LANE):
        raise ValueError("parse_waves takes int32[waves, 8, 128] nbits and "
                         "int32[waves, IN_CHUNKS, 1024, 128] inw")
    nbits = nbits.contiguous()
    inw = inw.contiguous()
    bufs = _buffers(waves, inw.device)
    _launch(nbits, inw, waves, bufs)
    launches += 1
    return bufs[0], bufs[1]


def _buffers(waves: int, device):
    """tok, misc and the kernel's scratch rows, as ``parse_waves`` fills them."""
    return (torch.empty(waves, TOK_CHUNKS, 128, SUB, LANE, dtype=torch.int32, device=device),
            torch.empty(waves, 4, SUB, LANE, dtype=torch.int32, device=device),
            torch.empty(waves * NSTR * SCRATCH, dtype=torch.int32, device=device))


def _launch(nbits, inw, waves: int, bufs):
    """One checked call of ``lanes_parse_launch`` on the wrapper's buffers."""
    tok, misc, scratch = bufs
    build.launch("lanes_parse", "lanes_parse_launch", _ARGTYPES, inw.device,
                 nbits.data_ptr(), inw.data_ptr(), tok.data_ptr(), misc.data_ptr(),
                 scratch.data_ptr(), waves * NSTR)
