"""The segment encoder: bytes in, DEFLATE bitstream out.

Port of ``moonbit_flate_tpu/ops/pipeline.py``.  One segment (nb blocks
of 65535 bytes, the first ``ctx`` bytes context only) goes through

  match find -> greedy commit (kernel 2, ops/walk.py) -> per-block
  histograms -> package-merge Huffman -> codegen RLE headers ->
  per-block dynamic-vs-stored policy -> unit assembly -> bit packing
  (kernel 1, ops/pack.py) -> one byte-aligned bitstream,

with the same wire-level choices as the JAX version, so both emit the
same bytes.  The tensor's device picks the route: CUDA tensors launch
the kernels, CPU tensors take their plain twins.  Every stage takes a
leading segment axis.  ``encode_segments`` runs the matcher, the unit
assembly and the one-segment pack kernel once per segment around one
walk launch; ``encode_segments_batched`` runs every stage once for all
B segments and packs them with one launch of the batched pack kernel, and
``compact_streams`` joins the B byte-aligned streams on the device.
``encode_segment_ctx(..., stage_cut=k)`` stops after stage k and
returns a checksum of that stage's live outputs (``_cksum``), the JAX
version's profiling hook.  The per-block policy is a loop over the nb
blocks on the host, on vectors of B (one copy of B * nb sizes per
call).  Bit work on u32 values is done in int64 masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import constants as C
from ..utils.bits import wrap32
from . import tables as T
from .dense import hist_rows, take_rows
from .header import SEQ_LEN, codegen_emissions
from .huffman_torch import build_codes
from .matcher import _u32_to_i32, find_matches_batch
from .pack import pack_units_dense, pack_units_dense_batch
from .walk import commit_walk as _commit_walk_batch
from .walk import commit_xla as _commit_xla

BLOCK = C.MAX_STORE_BLOCK_SIZE          # 65535
PAD = 320                               # matcher gather slack

_ORDER_NP = np.asarray(C.CODEGEN_ORDER, np.int64)


def _cksum(*tensors: torch.Tensor) -> torch.Tensor:
    """Order-dependent checksum of every input: the sum of all their
    elements, each cast to int32 first (bool 0/1, uint8 its value, an
    int64 holding a u32 its bit pattern), wrapped to int32 as JAX's
    ``jnp.sum`` on int32 wraps.  An int32 scalar tensor on the inputs'
    device; nothing is copied to the host."""
    acc = 0
    for t in tensors:
        acc = acc + t.to(torch.int32).sum(dtype=torch.int64)
    return wrap32(acc).to(torch.int32)


def _cut(*tensors: torch.Tensor):
    """What a stage cut returns: (``_cksum`` of the stage's outputs,
    int32 0), as the JAX version returns."""
    ck = _cksum(*tensors)
    return ck, torch.zeros_like(ck)


def n_words_for(nb: int) -> int:
    """Output words of one segment: room for every byte stored plus
    headers and the trailer."""
    return (8 * nb * BLOCK + nb * 64 + 64) // 32 + 2


def _find_clip_batch(data_padded: torch.Tensor, n: torch.Tensor,
                     ctx: torch.Tensor, nb: int):
    """Stage 1a: candidate matches of B segments, clipped at the
    65535-byte block boundaries so token groups equal byte ranges.
    data_padded: uint8[B, S + 320]; n, ctx: int32[B] on its device."""
    S = nb * BLOCK
    pos = torch.arange(S, dtype=torch.int32, device=data_padded.device)
    ctx = ctx[:, None]
    blk_orig = torch.clamp(pos - ctx, 0, S - 1) // BLOCK
    mlen, dist = find_matches_batch(data_padded, n)
    block_end = ctx + (blk_orig + 1) * BLOCK
    mlen = torch.minimum(mlen, block_end - pos)
    mlen = torch.where(mlen >= C.MIN_MATCH_LENGTH, mlen, 0)
    return mlen, dist


def _find_clip(data_padded: torch.Tensor, n: int, ctx: int, nb: int):
    """Stage 1a of one segment (``_find_clip_batch`` with one row)."""
    n_ctx = torch.tensor([[n], [ctx]], dtype=torch.int32,
                         device=data_padded.device)
    mlen, dist = _find_clip_batch(data_padded[None], n_ctx[0], n_ctx[1], nb)
    return mlen[0], dist[0]


def encode_segment_ctx(data_padded: torch.Tensor, n: int, ctx: int, nb: int,
                       stage_cut: int | None = None):
    """Compress one segment of up to nb*65535 payload bytes.

    data_padded: uint8[nb*65535 + 320], zero past n.  The first ``ctx``
    bytes are context only (preset dictionary or halo): matches may
    reference them, but no tokens are emitted for them.  n counts
    context plus payload.  Returns (words int32[W] holding the stream's
    u32 words, total_bits int32 scalar tensor, a multiple of 8).

    stage_cut (profiling only): k in 1-7 stops after stage k and returns
    (``_cksum`` of that stage's live outputs, int32 0) instead; nothing
    after the cut is computed or launched (cut 1 launches no walk, no
    cut a pack).  Stages: 1 matches clipped at the blocks, 2 the commit,
    3 token attributes in block layout, 4 histograms, 5 Huffman codes,
    6 codegen headers and dynamic sizes, 7 policy and unit assembly.
    """
    if stage_cut is not None:
        return _encode_cut(data_padded[None], n, ctx, nb, stage_cut)
    words, bits = encode_segments(data_padded[None], [n], [ctx], nb)
    return words[0], bits[0]


def _encode_cut(data_padded: torch.Tensor, n: int, ctx: int, nb: int,
                stage_cut: int):
    """``encode_segment_ctx`` cut after stage ``stage_cut``, on its one
    segment held with a leading axis of 1."""
    if stage_cut not in range(1, 8):
        raise ValueError(f"stage_cut must be 1-7, not {stage_cut}")
    n, ctx = _segment_args(data_padded, [n], [ctx], nb)
    mlen, dist = (t[None] for t in _find_clip(data_padded[0], n[0], ctx[0], nb))
    if stage_cut == 1:
        return _cut(mlen, dist)
    if stage_cut == 2 and not data_padded.is_cuda:
        # the JAX package's CPU route sums _commit_xla's outputs, whose
        # lengths and distances are not masked to the committed matches
        return _cut(*_commit_xla(data_padded, mlen, dist, n, ctx, nb))
    committed, is_match, mlen, dist = _commit_walk_batch(
        data_padded, mlen, dist, n, ctx, nb)
    if stage_cut == 2:
        return _cut(committed, is_match, mlen, dist)
    return _tokens_to_units(data_padded, n, ctx, committed, is_match, mlen,
                            dist, nb, stage_cut)


def encode_segment(data_padded: torch.Tensor, n: int, nb: int):
    """Context-free segment encode (the common path)."""
    return encode_segment_ctx(data_padded, n, 0, nb)


def _segment_args(data_padded: torch.Tensor, n, ctx, nb: int):
    """Check the buffer's width; n and ctx as lists of ints."""
    if data_padded.shape[1] != nb * BLOCK + PAD:
        raise ValueError(f"segment buffer must be {nb * BLOCK + PAD} bytes")
    return [int(x) for x in n], [int(x) for x in ctx]


def encode_segments(data_padded: torch.Tensor, n, ctx, nb: int):
    """Encode B independent segments: the matcher per segment, ONE walk
    launch for all of them, then units and packing per segment.

    data_padded: uint8[B, nb*65535 + 320]; n, ctx: B ints.
    Returns (words int32[B, W], total_bits int32[B]).
    """
    n, ctx = _segment_args(data_padded, n, ctx, nb)
    clipped = [_find_clip(d, nn, cc, nb) for d, nn, cc in zip(data_padded, n, ctx)]
    mlen = torch.stack([m for m, _ in clipped])
    dist = torch.stack([d for _, d in clipped])
    del clipped
    # one walk launch for CUDA tensors; the plain twin (the port of the
    # JAX _commit_xla) for CPU tensors
    committed, is_match, mlen, dist = _commit_walk_batch(
        data_padded, mlen, dist, n, ctx, nb)
    n_words = n_words_for(nb)
    words, bits = [], []
    for r in (slice(b, b + 1) for b in range(len(n))):
        vals, wids = _tokens_to_units(data_padded[r], n[r], ctx[r],
                                      committed[r], is_match[r], mlen[r],
                                      dist[r], nb)
        w, t = pack_units_dense(vals[0], wids[0], n_words)
        words.append(w)
        bits.append(t)
    return torch.stack(words), torch.stack(bits)


def encode_segments_batched(data_padded: torch.Tensor, n, ctx, nb: int):
    """Encode B independent segments with every stage batched over B:
    one matcher pass ([B * windows, 65536] sorts), one walk launch, one
    unit assembly on [B * nb] block rows and one launch of the batched
    pack.  Same arguments, results and bytes as ``encode_segments``.
    """
    n, ctx = _segment_args(data_padded, n, ctx, nb)
    n_ctx = torch.tensor([n, ctx], dtype=torch.int32, device=data_padded.device)
    mlen, dist = _find_clip_batch(data_padded, n_ctx[0], n_ctx[1], nb)
    committed, is_match, mlen, dist = _commit_walk_batch(
        data_padded, mlen, dist, n, ctx, nb)
    vals, wids = _tokens_to_units(data_padded, n, ctx, committed, is_match,
                                  mlen, dist, nb)
    del committed, is_match, mlen, dist
    return pack_units_dense_batch(vals, wids, n_words_for(nb))


def compact_streams(words: torch.Tensor, bits: torch.Tensor):
    """Concatenate B byte-aligned segment streams on the device.

    words: int32[B, W] stream words, zero past each segment's end;
    bits: int32[B] bit counts (multiples of 8).  Returns (stream
    int32[B*W + 1] holding the u32 patterns: row b's first bits[b] // 8
    bytes at the exclusive prefix sum of the sizes, zero elsewhere;
    total_bytes int32 scalar tensor).  The copy to the host is then
    proportional to the compressed size.  The JAX version shifts whole
    rows word-wise; here every byte of the rows is scattered to its
    place through a byte view, which gives the same array.
    """
    B, W = words.shape
    dev = words.device
    sizes = (bits // 8).long()
    csum = torch.cumsum(sizes, 0)
    col = torch.arange(4 * W, dtype=torch.int64, device=dev)
    keep = col[None, :] < sizes[:, None]
    # bytes past a row's size go, as zeros, to a slot no row reaches
    dest = torch.where(keep, (csum - sizes)[:, None] + col[None, :], 4 * B * W)
    src = torch.where(keep, words.contiguous().view(torch.uint8), 0)
    out = torch.zeros(4 * (B * W + 1), dtype=torch.uint8, device=dev)
    out.scatter_(0, dest.reshape(-1), src.reshape(-1))
    return out.view(torch.int32), csum[-1].int()


def _tokens_to_units(data_padded: torch.Tensor, n, ctx,
                     committed: torch.Tensor, is_match: torch.Tensor,
                     mlen: torch.Tensor, dist: torch.Tensor, nb: int,
                     stage_cut: int | None = None):
    """Stages 3-7 of B segments: committed tokens -> (value, width)
    unit arrays, int32[B, nb*(339 + 65535 + 1) + 4] each.  n, ctx: B
    ints; the tensors carry a leading axis of B.  All per-block work
    runs on the B * nb block rows at once.  stage_cut k in 3-7 returns
    (``_cksum`` of stage k's outputs, int32 0) after stage k, as
    ``encode_segment_ctx`` does."""
    S = nb * BLOCK
    B = data_padded.shape[0]
    R = B * nb
    dev = data_padded.device
    xlen = torch.where(is_match, mlen - 3, 0)
    xoff = torch.where(is_match, dist - 1, 0)
    lc = T.length_code(torch.clamp(xlen, 0, 255))
    dc = T.offset_code(xoff)
    data = data_padded[:, :S].int()
    sym = torch.where(is_match, 257 + lc, data)

    # ---- roll each row to its block-aligned payload layout [R, BLOCK] ------
    payload = np.asarray(n, np.int64) - np.asarray(ctx, np.int64)
    pos = torch.arange(S, device=dev)
    if any(ctx):
        ctx_t = torch.tensor(ctx, dtype=torch.int64, device=dev)
        src = (pos[None, :] + ctx_t[:, None]) % S

        def blkify(a):
            return torch.gather(a, 1, src).reshape(R, BLOCK)
    else:
        def blkify(a):
            return a.reshape(R, BLOCK)

    valid = (pos[None, :] < torch.as_tensor(payload, device=dev)[:, None]
             ).reshape(R, BLOCK)
    committed_b = blkify(committed) & valid
    is_match_b = blkify(is_match) & valid
    sym_b = blkify(sym)
    lc_b = blkify(lc)
    dc_b = blkify(dc)
    xlen_b = blkify(xlen)
    xoff_b = blkify(xoff)
    data_b = blkify(data)
    del xlen, xoff, lc, dc, data, sym

    # per-block byte counts, on the host [B, nb] and on the device [R]
    n_b_host = np.clip(payload[:, None] - np.arange(nb) * BLOCK, 0, BLOCK)
    n_b = torch.as_tensor(n_b_host.reshape(R), dtype=torch.int32, device=dev)
    live_b = n_b > 0
    if stage_cut == 3:
        return _cut(committed_b, is_match_b, sym_b, lc_b, dc_b, xlen_b, xoff_b,
                    data_b, n_b)

    # ---- histograms ----------------------------------------------------------
    lit_freq = hist_rows(torch.where(committed_b, sym_b, 286), 286)
    lit_freq[:, C.END_BLOCK_MARKER] += live_b.int()
    off_freq = hist_rows(torch.where(is_match_b, dc_b, 30), 30)

    def n_used(freq):
        k = torch.arange(freq.shape[1], dtype=torch.int32, device=dev)
        return 1 + torch.where(freq > 0, k[None, :], -1).amax(1)

    nl_b = n_used(lit_freq)
    no_b = n_used(off_freq)
    # no matches at all: keep the offset tree encodable
    need_fake = live_b & (no_b == 0)
    off_freq[:, 0] += need_fake.int()
    no_b = torch.maximum(no_b, live_b.int())
    if stage_cut == 4:
        return _cut(lit_freq, off_freq, nl_b, no_b)

    # ---- Huffman tables: both alphabets in one batched build ---------------
    both_freq = torch.cat(
        [lit_freq, torch.nn.functional.pad(off_freq, (0, 286 - 30))], dim=0)
    both_codes, both_lens = build_codes(both_freq, C.LIT_LEN_MAX_BITS)
    lit_codes, lit_lens = both_codes[:R], both_lens[:R]
    off_codes, off_lens = both_codes[R:, :30], both_lens[R:, :30]
    if stage_cut == 5:
        return _cut(lit_codes, lit_lens, off_codes, off_lens)

    # ---- codegen RLE + header sizes -----------------------------------------
    jpos = torch.arange(SEQ_LEN, dtype=torch.int32, device=dev)
    lit_part = take_rows(lit_lens, torch.clamp(jpos, 0, 285)[None, :].expand(R, -1))
    off_part = take_rows(off_lens, torch.clamp(jpos[None, :] - nl_b[:, None], 0, 29))
    seq = torch.where(jpos[None, :] < nl_b[:, None], lit_part, off_part)
    cg_sym, cg_pv, cg_pw, cg_freq = codegen_emissions(seq, nl_b + no_b)
    cg_codes, cg_lens = build_codes(cg_freq, C.CODEGEN_MAX_BITS)

    order = torch.as_tensor(_ORDER_NP, device=dev)
    idx19 = torch.arange(19, dtype=torch.int32, device=dev)
    ncg_b = torch.clamp(
        1 + torch.where(cg_freq[:, order] > 0, idx19[None, :], -1).amax(1), min=4)

    len_eb_tab, off_eb_tab = T.extra_bits_tables(dev)
    extra_l = (lit_freq[:, 257:286] * len_eb_tab[None, :]).sum(1)
    extra_o = (off_freq * off_eb_tab[None, :]).sum(1)
    cg_hdr = ((cg_freq * cg_lens).sum(1) + cg_freq[:, 16] * 2
              + cg_freq[:, 17] * 3 + cg_freq[:, 18] * 7)
    dyn_bits = (17 + 3 * ncg_b + cg_hdr + (lit_freq * lit_lens).sum(1)
                + (off_freq * off_lens).sum(1) + extra_l + extra_o)
    if stage_cut == 6:
        return _cut(cg_sym, cg_pv, cg_pw, cg_codes, cg_lens, ncg_b, dyn_bits)

    # ---- per-block policy (dynamic vs stored), carrying bit alignment ------
    # the carry runs over the nb blocks of a segment; segments are
    # independent, so each step works on vectors of B
    dyn_host = dyn_bits.reshape(B, nb).cpu().numpy().astype(np.int64)
    bitpos8 = np.zeros(B, np.int64)
    use_stored = np.zeros((B, nb), bool)
    pad_host = np.zeros((B, nb), np.int32)
    for k in range(nb):
        live = n_b_host[:, k] > 0
        pad = (8 - ((bitpos8 + 3) % 8)) % 8
        stored = 3 + pad + 32 + 8 * n_b_host[:, k]
        use_stored[:, k] = live & (stored < dyn_host[:, k])
        chosen = np.where(use_stored[:, k], stored, dyn_host[:, k])
        bitpos8 = (bitpos8 + np.where(live, chosen, 0)) % 8
        pad_host[:, k] = pad
    st = torch.as_tensor(use_stored.reshape(R), device=dev)
    pad_b = torch.as_tensor(pad_host.reshape(R), device=dev)

    # ---- unit assembly ---------------------------------------------------------
    live_i = live_b.int()
    dyn_sel = live_b & ~st

    # header zone: [nb, 4 + 19 + SEQ_LEN]
    h0v = torch.where(st, 0, 4)
    h0w = 3 * live_i
    h1v = torch.where(st, 0, nl_b - 257)
    h1w = torch.where(st, pad_b, 5) * live_i
    h2v = torch.where(st, n_b, no_b - 1)
    h2w = torch.where(st, 16, 5) * live_i
    h3v = torch.where(st, (~n_b) & 0xFFFF, ncg_b - 4)
    h3w = torch.where(st, 16, 4) * live_i
    head4_v = torch.stack([h0v, h1v, h2v, h3v], dim=1).int()
    head4_w = torch.stack([h0w, h1w, h2w, h3w], dim=1).int()

    cl_v = torch.where(dyn_sel[:, None], cg_lens[:, order], 0)
    cl_w = torch.where(dyn_sel[:, None] & (idx19[None, :] < ncg_b[:, None]), 3, 0)

    # codegen stream: one fused unit per emission (code | payload << len)
    cg_g = take_rows(cg_codes | (cg_lens << 16), torch.clamp(cg_sym, 0, 18))
    cg_code_u, cg_len_u = cg_g & 0xFFFF, cg_g >> 16
    emit = dyn_sel[:, None] & (cg_sym >= 0)
    cgu_v = torch.where(emit, cg_code_u | (cg_pv << cg_len_u), 0)
    cgu_w = torch.where(emit, cg_len_u + cg_pw, 0)

    hdr_vals = torch.cat([head4_v, cl_v.int(), cgu_v.int()], dim=1)
    hdr_wids = torch.cat([head4_w, cl_w.int(), cgu_w.int()], dim=1)

    # token zone: [nb, BLOCK]
    lit_g = take_rows(lit_codes | (lit_lens << 16), sym_b)
    lit_code_g, lit_len_g = lit_g & 0xFFFF, lit_g >> 16
    len_base_b, len_eb_b = T.length_base_extra(lc_b)
    leb = torch.where(is_match_b, len_eb_b, 0)
    len_ev = torch.where(is_match_b, xlen_b - (len_base_b - 3), 0)

    st_b = st[:, None]
    dyn_b = dyn_sel[:, None]
    u0_dyn = committed_b & dyn_b
    m_dyn = is_match_b & dyn_b

    off_g = take_rows(off_codes | (off_lens << 16), dc_b)
    off_code_g, off_len_g = off_g & 0xFFFF, off_g >> 16
    off_base_b, oeb = T.offset_base_extra(dc_b)
    off_ev = xoff_b - (off_base_b - 1)

    # ONE unit slot per position: each committed position fuses its
    # whole emission (lit/len code, length extra, offset code, offset
    # extra; <= 48 bits) and splits at the 28-bit unit cap.  The tail
    # spills into the NEXT position's slot, which a match (>= 4 bytes)
    # always covers, so it never holds an emission of its own.
    a_val = (lit_code_g | (len_ev << lit_len_g)).long()
    a_w = (lit_len_g + leb).long()                               # <= 20
    b_val = torch.where(m_dyn, off_code_g | (off_ev << off_len_g), 0).long()
    b_w = torch.where(m_dyn, off_len_g + oeb, 0).long()          # <= 28
    lo48 = (a_val | (b_val << a_w)) & 0xFFFFFFFF
    hi48 = (b_val >> 1) >> (31 - a_w)                            # b >> (32 - s1)
    w48 = a_w + b_w
    u0_w = torch.clamp(w48, max=28)
    sp_w = w48 - u0_w                                            # <= 20
    u0_val48 = lo48 & ((1 << u0_w) - 1)
    sp_val = ((lo48 >> u0_w) | (((hi48 << 1) << (31 - u0_w)) & 0xFFFFFFFF))

    u0_val = torch.where(st_b, data_b, torch.where(u0_dyn, u0_val48.int(), 0))
    u0_wid = torch.where(st_b & valid, 8, torch.where(u0_dyn, u0_w.int(), 0))
    sp_v = torch.where(m_dyn, _u32_to_i32(sp_val), 0)
    sp_wg = torch.where(m_dyn, sp_w.int(), 0)
    spill_v = torch.nn.functional.pad(sp_v[:, :-1], (1, 0))
    spill_w = torch.nn.functional.pad(sp_wg[:, :-1], (1, 0))
    tok_vals = u0_val | spill_v
    tok_wids = u0_wid + spill_w

    # EOB unit per block
    eob_v = torch.where(dyn_sel, lit_codes[:, C.END_BLOCK_MARKER], 0)[:, None]
    eob_w = torch.where(dyn_sel, lit_lens[:, C.END_BLOCK_MARKER], 0)[:, None]

    flat_vals = torch.cat([hdr_vals, tok_vals.int(), eob_v.int()], dim=1).reshape(B, -1)
    flat_wids = torch.cat([hdr_wids, tok_wids.int(), eob_w.int()], dim=1).reshape(B, -1)

    # ---- segment trailer: an empty stored block realigns a segment that
    # would end mid-byte --------------------------------------------------------
    body_bits = flat_wids.sum(1)
    t_pad = (8 - ((body_bits + 3) % 8)) % 8
    trailer_vals = torch.tensor([0, 0, 0, 0xFFFF], dtype=torch.int32,
                                device=dev).expand(B, 4)
    trailer_wids = torch.stack(
        [torch.full_like(t_pad, 3), t_pad, torch.full_like(t_pad, 16),
         torch.full_like(t_pad, 16)], dim=1)
    trailer_wids = torch.where((body_bits % 8 != 0)[:, None], trailer_wids, 0).int()
    all_vals = torch.cat([flat_vals, trailer_vals], dim=1)
    all_wids = torch.cat([flat_wids, trailer_wids], dim=1)
    if stage_cut == 7:
        return _cut(all_vals, all_wids)
    return all_vals, all_wids
