"""The segment encoder: bytes in, DEFLATE bitstream out.

Port of ``moonbit_flate_tpu/ops/pipeline.py``.  One segment (nb blocks
of 65535 bytes, the first ``ctx`` bytes context only) goes through

  match find -> greedy commit (kernel 2, ops/walk.py) -> per-block
  histograms -> package-merge Huffman -> codegen RLE headers ->
  per-block dynamic-vs-stored policy -> unit assembly -> bit packing
  (kernel 1, ops/pack.py) -> one byte-aligned bitstream,

with the same wire-level choices as the JAX version, so both emit the
same bytes.  The tensor's device picks the route: CUDA tensors launch
the kernels, CPU tensors take their plain twins.  The per-block policy
is a short loop over the blocks on the host (one copy of nb sizes per
segment).  Bit work on u32 values is done in int64 masked to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import constants as C
from . import tables as T
from .dense import hist_rows, take_rows
from .header import SEQ_LEN, codegen_emissions
from .huffman_torch import build_codes
from .matcher import _u32_to_i32, find_matches
from .pack import pack_units_dense
from .walk import commit_walk as _commit_walk_batch

BLOCK = C.MAX_STORE_BLOCK_SIZE          # 65535
PAD = 320                               # matcher gather slack

_ORDER_NP = np.asarray(C.CODEGEN_ORDER, np.int64)


def n_words_for(nb: int) -> int:
    """Output words of one segment: room for every byte stored plus
    headers and the trailer."""
    return (8 * nb * BLOCK + nb * 64 + 64) // 32 + 2


def _find_clip(data_padded: torch.Tensor, n: int, ctx: int, nb: int):
    """Stage 1a: candidate matches of one segment, clipped at the
    65535-byte block boundaries so token groups equal byte ranges."""
    S = nb * BLOCK
    pos = torch.arange(S, dtype=torch.int32, device=data_padded.device)
    blk_orig = torch.clamp(pos - ctx, 0, S - 1) // BLOCK
    mlen, dist = find_matches(data_padded, n)
    block_end = ctx + (blk_orig + 1) * BLOCK
    mlen = torch.minimum(mlen, block_end - pos)
    mlen = torch.where(mlen >= C.MIN_MATCH_LENGTH, mlen, 0)
    return mlen, dist


def encode_segment_ctx(data_padded: torch.Tensor, n: int, ctx: int, nb: int):
    """Compress one segment of up to nb*65535 payload bytes.

    data_padded: uint8[nb*65535 + 320], zero past n.  The first ``ctx``
    bytes are context only (preset dictionary or halo): matches may
    reference them, but no tokens are emitted for them.  n counts
    context plus payload.  Returns (words int32[W] holding the stream's
    u32 words, total_bits int32 scalar tensor, a multiple of 8).
    """
    words, bits = encode_segments(data_padded[None], [n], [ctx], nb)
    return words[0], bits[0]


def encode_segment(data_padded: torch.Tensor, n: int, nb: int):
    """Context-free segment encode (the common path)."""
    return encode_segment_ctx(data_padded, n, 0, nb)


def encode_segments(data_padded: torch.Tensor, n, ctx, nb: int):
    """Encode B independent segments: the matcher per segment, ONE walk
    launch for all of them, then units and packing per segment.

    data_padded: uint8[B, nb*65535 + 320]; n, ctx: B ints.
    Returns (words int32[B, W], total_bits int32[B]).
    """
    S = nb * BLOCK
    if data_padded.shape[1] != S + PAD:
        raise ValueError(f"segment buffer must be {S + PAD} bytes")
    n = [int(x) for x in n]
    ctx = [int(x) for x in ctx]
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
    for b in range(data_padded.shape[0]):
        vals, wids = _tokens_to_units(data_padded[b], n[b], ctx[b],
                                      committed[b], is_match[b], mlen[b],
                                      dist[b], nb)
        w, t = pack_units_dense(vals, wids, n_words)
        words.append(w)
        bits.append(t)
    return torch.stack(words), torch.stack(bits)


def _tokens_to_units(data_padded: torch.Tensor, n: int, ctx: int,
                     committed: torch.Tensor, is_match: torch.Tensor,
                     mlen: torch.Tensor, dist: torch.Tensor, nb: int):
    """Stages 2-7 of one segment: committed tokens -> flat (value,
    width) unit arrays, int32[nb*(339 + 65535 + 1) + 4] each."""
    S = nb * BLOCK
    dev = data_padded.device
    xlen = torch.where(is_match, mlen - 3, 0)
    xoff = torch.where(is_match, dist - 1, 0)
    lc = T.length_code(torch.clamp(xlen, 0, 255))
    dc = T.offset_code(xoff)
    data = data_padded[:S].int()
    sym = torch.where(is_match, 257 + lc, data)

    # ---- roll to block-aligned payload layout [nb, BLOCK] ------------------
    def blkify(a):
        return (torch.roll(a, -ctx, 0) if ctx else a).reshape(nb, BLOCK)

    valid = (torch.arange(S, device=dev) < n - ctx).reshape(nb, BLOCK)
    committed_b = blkify(committed) & valid
    is_match_b = blkify(is_match) & valid
    sym_b = blkify(sym)
    lc_b = blkify(lc)
    dc_b = blkify(dc)
    xlen_b = blkify(xlen)
    xoff_b = blkify(xoff)
    data_b = blkify(data)

    # per-block byte counts (host ints)
    n_b_list = [min(max(n - ctx - k * BLOCK, 0), BLOCK) for k in range(nb)]
    n_b = torch.tensor(n_b_list, dtype=torch.int32, device=dev)
    live_b = n_b > 0

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

    # ---- Huffman tables: both alphabets in one batched build ---------------
    both_freq = torch.cat(
        [lit_freq, torch.nn.functional.pad(off_freq, (0, 286 - 30))], dim=0)
    both_codes, both_lens = build_codes(both_freq, C.LIT_LEN_MAX_BITS)
    lit_codes, lit_lens = both_codes[:nb], both_lens[:nb]
    off_codes, off_lens = both_codes[nb:, :30], both_lens[nb:, :30]

    # ---- codegen RLE + header sizes -----------------------------------------
    jpos = torch.arange(SEQ_LEN, dtype=torch.int32, device=dev)
    lit_part = take_rows(lit_lens, torch.clamp(jpos, 0, 285)[None, :].expand(nb, -1))
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

    # ---- per-block policy (dynamic vs stored), carrying bit alignment ------
    bitpos8 = 0
    use_stored, pad_list = [], []
    for dyn, nbytes in zip(dyn_bits.tolist(), n_b_list):
        live = nbytes > 0
        pad = (8 - ((bitpos8 + 3) % 8)) % 8
        stored = 3 + pad + 32 + 8 * nbytes
        st = live and stored < dyn
        chosen = (stored if st else dyn) if live else 0
        bitpos8 = (bitpos8 + chosen) % 8
        use_stored.append(st)
        pad_list.append(pad)
    st = torch.tensor(use_stored, dtype=torch.bool, device=dev)
    pad_b = torch.tensor(pad_list, dtype=torch.int32, device=dev)

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

    flat_vals = torch.cat([hdr_vals, tok_vals.int(), eob_v.int()], dim=1).reshape(-1)
    flat_wids = torch.cat([hdr_wids, tok_wids.int(), eob_w.int()], dim=1).reshape(-1)

    # ---- segment trailer: an empty stored block realigns a segment that
    # would end mid-byte --------------------------------------------------------
    body_bits = int(flat_wids.sum())
    t_pad = (8 - ((body_bits + 3) % 8)) % 8
    trailer_vals = torch.tensor([0, 0, 0, 0xFFFF], dtype=torch.int32, device=dev)
    trailer_wids = torch.tensor([3, t_pad, 16, 16] if body_bits % 8 else [0] * 4,
                                dtype=torch.int32, device=dev)
    return (torch.cat([flat_vals, trailer_vals]),
            torch.cat([flat_wids, trailer_wids]))
