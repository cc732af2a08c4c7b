// Stage A of the scalar-path decode: the serial symbol parse of whole
// raw-DEFLATE streams of any size into packed token records.
//
// Replaces moonbit_flate_tpu/ops/parse_pallas.py:parse_batch (the Pallas
// kernel _make_kernel).  The TPU kernel runs on the scalar core over a
// (stream, token chunk) grid, with an 8192-word input window in SMEM that
// it refills by DMA, two-level decode tables in SMEM arenas and closed
// forms where it cannot index constants.  None of that carries over.  On
// the H100 each stream gets one warp of its own block: lane 0 walks the
// stream from its first bit to its end in one loop, reading "the 32 bits
// at bit pos, zero past the stream's words" from global memory through a
// two-word register window, with its three code tables (code lengths,
// literal/length, distance) in shared memory, and stores each token as it
// goes; then the whole warp zero-fills the token row past the last token,
// so every word of the row is written once.  What bounds it is the
// dependent chain of one stream (bit read, table lookup, branch), not
// bytes or arithmetic; the card is filled only by the number of streams.
//
// A table is a 1024-entry root indexed by the next 10 bits (entry =
// symbol << 4 | length, 0 = not here) over the canonical form (codes per
// length, symbols in code order), which decodes longer codes by length
// counting and finds that a pattern has no code.
//
// The output equals the TPU kernel's on every stream, corrupt and
// truncated ones too (tokens, token count, status, output bytes):
//   * fewer than 3 bits left at a block header is a clean end (status 1);
//   * a dynamic header that is invalid or cut short is corrupt (-3);
//   * a pattern with no code is corrupt, a code that ends past the
//     stream is truncated (-4), checked in that order on bits that read
//     as 0 past the stream;
//   * in a match, corrupt (symbol >= 286, distance symbol >= 30, distance
//     beyond min(output so far, 32768)) wins over truncated;
//   * a code must be empty, complete, or one code of length 1;
//   * status 0: the token capacity ran out before the stream was done.
// Bit positions are int32 (a stream is under 2^28 bytes; the wrapper
// refuses wider inputs).
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#define PS_FN __device__ __forceinline__

namespace ps {

constexpr int ROOT_BITS = 10;
constexpr int ROOT = 1 << ROOT_BITS;
constexpr int NLIT = 288;
constexpr int NLENS = 320;        // literal/length + distance code lengths
constexpr int ST_DONE = 1, ST_CORRUPT = -3, ST_TRUNC = -4;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Table {
  uint16_t root[ROOT];    // symbol << 4 | length by the next ROOT_BITS bits
  uint16_t count[16];     // codes of each length
  uint16_t symbol[NLIT];  // symbols in code order
};

// The words of one stream, zero past sw.  peek(pos) gives the 32 bits
// from bit pos on, LSB first.
struct Bits {
  const int32_t* base;
  int sw;
  int cw;               // index of c0
  uint32_t c0, c1;

  PS_FN uint32_t word(int k) const { return k < sw ? (uint32_t)base[k] : 0u; }
  PS_FN void init(const int32_t* b, int n) {
    base = b;
    sw = n;
    cw = 0;
    c0 = word(0);
    c1 = word(1);
  }
  PS_FN uint32_t peek(int pos) {
    int w = pos >> 5;
    if (w != cw) {
      c0 = w == cw + 1 ? c1 : word(w);
      c1 = word(w + 1);
      cw = w;
    }
    return (uint32_t)(((((uint64_t)c1) << 32) | c0) >> (pos & 31));
  }
};

PS_FN uint32_t rev_bits(uint32_t code, int len) { return __brev(code) >> (32 - len); }

// Canonical table of n code lengths.  Returns false where the code is
// neither empty, complete, nor one code of length 1; the table is then
// not usable.
PS_FN bool build(Table& t, const uint8_t* lens, int n) {
  for (int l = 0; l < 16; ++l) t.count[l] = 0;
  for (int i = 0; i < n; ++i) t.count[lens[i]] += 1;
  t.count[0] = 0;
  int kraft = 0, mx = 0;
  for (int l = 1; l < 16; ++l) {
    kraft += (int)t.count[l] << (15 - l);
    if (t.count[l]) mx = l;
  }
  if (!(kraft == 0 || kraft == 1 << 15 || (mx == 1 && kraft == 1 << 14))) return false;
  int offs[16], next[16];
  int o = 0, code = 0;
  for (int l = 1; l < 16; ++l) {
    offs[l] = o;
    o += t.count[l];
    next[l] = code;
    code = (code + t.count[l]) << 1;
  }
  for (int j = 0; j < ROOT; ++j) t.root[j] = 0;
  for (int i = 0; i < n; ++i) {
    const int l = lens[i];
    if (l == 0) continue;
    t.symbol[offs[l]++] = (uint16_t)i;
    const uint32_t c = (uint32_t)next[l]++;
    if (l <= ROOT_BITS) {
      const uint16_t e = (uint16_t)((i << 4) | l);
      for (uint32_t j = rev_bits(c, l); j < ROOT; j += 1u << l) t.root[j] = e;
    }
  }
  return true;
}

// The code at the head of bits (LSB first): its length, 0 if the pattern
// has no code, and its symbol.
PS_FN int decode(const Table& t, uint32_t bits, int& sym) {
  const uint16_t e = t.root[bits & (ROOT - 1)];
  if (e) {
    sym = e >> 4;
    return e & 15;
  }
  int code = 0, first = 0, index = 0;
  for (int l = 1; l < 16; ++l) {
    code |= (int)(bits & 1u);
    bits >>= 1;
    const int c = t.count[l];
    if (code - c < first) {
      sym = t.symbol[index + (code - first)];
      return l;
    }
    index += c;
    first = (first + c) << 1;
    code <<= 1;
  }
  sym = 0;
  return 0;
}

struct Parser {
  Bits in;
  int nbits, cap;
  int status, pos, fin, inblock, sleft, ntok, outpos;
  int32_t* trow;
  Table *cl, *lit, *dist;
  uint8_t* lens;

  // Block header at pos; emits no token.
  PS_FN void header() {
    if (pos + 3 > nbits) {        // fewer than 3 bits left: a clean end
      status = ST_DONE;
      return;
    }
    const uint32_t hdr = in.peek(pos);
    fin = (int)(hdr & 1u);
    const int typ = (int)((hdr >> 1) & 3u);
    const int p3 = pos + 3;
    if (typ == 3) {
      status = ST_CORRUPT;
      return;
    }
    if (typ == 0) {               // stored
      const int aligned = (p3 + 7) & ~7;
      const uint32_t v = in.peek(aligned);
      const int ln = (int)(v & 0xFFFFu);
      if (((v >> 16) ^ (uint32_t)ln) != 0xFFFFu) {
        status = ST_CORRUPT;
      } else if (aligned + 32 + 8 * ln > nbits) {
        status = ST_TRUNC;
      } else {
        pos = aligned + 32;
        sleft = ln;
        inblock = ln > 0 ? 2 : 0;
        if (ln == 0 && fin) status = ST_DONE;
      }
      return;
    }
    int nlit = NLIT, ndist = 32;
    if (typ == 1) {               // fixed: 5-bit distance codes, read as a table
      for (int i = 0; i < NLENS; ++i)
        lens[i] = i >= 288 ? 5 : i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
      pos = p3;
    } else {                      // dynamic: any fault here is corrupt
      const uint32_t v = in.peek(p3);
      nlit = 257 + (int)(v & 31u);
      ndist = 1 + (int)((v >> 5) & 31u);
      const int nclen = 4 + (int)((v >> 10) & 15u);
      int pp = p3 + 14;
      status = ST_CORRUPT;        // until the header is through
      if (nlit > 286 || ndist > 30 || pp + 3 * nclen > nbits) return;
      const int order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3,
                             13, 2, 14, 1, 15};
      for (int k = 0; k < 19; ++k) lens[k] = 0;
      for (int k = 0; k < nclen; ++k) {
        lens[order[k]] = (uint8_t)(in.peek(pp) & 7u);
        pp += 3;
      }
      if (!build(*cl, lens, 19)) return;
      const int n = nlit + ndist;
      int i = 0;
      while (i < n) {
        const uint32_t lo = in.peek(pp);
        int sym;
        const int l = decode(*cl, lo, sym);
        if (l == 0 || pp + l > nbits) return;
        pp += l;
        if (sym < 16) {
          lens[i++] = (uint8_t)sym;
          continue;
        }
        if (sym == 16 && i == 0) return;
        const int eb = sym == 16 ? 2 : sym == 17 ? 3 : 7;
        const int rep = (sym == 18 ? 11 : 3) + (int)((lo >> l) & ((1u << eb) - 1u));
        pp += eb;
        if (i + rep > n || pp > nbits) return;
        const uint8_t val = sym == 16 ? lens[i - 1] : 0;
        for (int j = 0; j < rep; ++j) lens[i++] = val;
      }
      pos = pp;
      status = 0;
    }
    const bool ok_l = build(*lit, lens, nlit);
    const bool ok_d = build(*dist, lens + nlit, ndist);
    if (ok_l && ok_d) {
      inblock = 1;
    } else {
      status = ST_CORRUPT;
    }
  }

  // One token of a Huffman block (or its end).
  PS_FN void token() {
    const uint32_t lo = in.peek(pos);
    int sym;
    const int ln = decode(*lit, lo, sym);
    if (ln == 0) {
      status = ST_CORRUPT;
      return;
    }
    if (pos + ln > nbits) {
      status = ST_TRUNC;
      return;
    }
    if (sym < 256) {
      trow[ntok++] = sym;
      pos += ln;
      outpos += 1;
      return;
    }
    if (sym == 256) {
      pos += ln;
      inblock = 0;
      if (fin) status = ST_DONE;
      return;
    }
    if (sym >= 286) {
      status = ST_CORRUPT;
      return;
    }
    const int lc = sym - 257;
    int leb = lc < 8 ? 0 : (lc - 4) >> 2;
    int lbase = lc < 8 ? 3 + lc : (1 << (leb + 2)) + 3 + ((lc & 3) << leb);
    if (lc >= 28) {
      lbase = 258;
      leb = 0;
    }
    const int length = lbase + (int)((lo >> ln) & ((1u << leb) - 1u));
    const int p_len = pos + ln + leb;
    const uint32_t lo2 = in.peek(p_len);
    int dsym;
    const int dl = decode(*dist, lo2, dsym);
    if (dl == 0 || (p_len + dl <= nbits && dsym >= 30)) {
      status = ST_CORRUPT;
      return;
    }
    if (p_len + dl > nbits) {     // the distance reads as 1 here
      status = outpos == 0 ? ST_CORRUPT : ST_TRUNC;
      return;
    }
    const int deb = dsym < 4 ? 0 : (dsym - 2) >> 1;
    const int dbase = dsym < 4 ? dsym + 1 : (1 << (deb + 1)) + 1 + ((dsym & 1) << deb);
    const int d = dbase + (int)((lo2 >> dl) & ((1u << deb) - 1u));
    const int p_end = p_len + dl + deb;
    if (d > (outpos < 32768 ? outpos : 32768)) {
      status = ST_CORRUPT;
      return;
    }
    if (p_end > nbits) {
      status = ST_TRUNC;
      return;
    }
    trow[ntok++] = (int32_t)(0x80000000u | ((uint32_t)(length - 3) << 15) | (uint32_t)(d - 1));
    pos = p_end;
    outpos += length;
  }

  PS_FN void run() {
    while (status == 0 && ntok < cap) {
      if (inblock == 2) {         // stored: one byte a step
        trow[ntok++] = (int32_t)(in.peek(pos) & 0xFFu);
        pos += 8;
        outpos += 1;
        if (--sleft == 0) {
          inblock = 0;
          if (fin) status = ST_DONE;
        }
      } else if (inblock == 1) {
        token();
      } else {
        header();
      }
    }
  }
};

}  // namespace ps

__global__ void __launch_bounds__(32)
parse_kernel(const int32_t* __restrict__ nbits, const int32_t* __restrict__ words,
             int32_t* __restrict__ toks, int32_t* __restrict__ cnt, int sw, int cap) {
  __shared__ ps::Table tables[3];
  __shared__ uint8_t lens[ps::NLENS];
  const int b = blockIdx.x, lane = threadIdx.x;
  int32_t* trow = toks + (size_t)b * cap;
  int ntok = 0;
  if (lane == 0) {
    ps::Parser p;
    p.in.init(words + (size_t)b * sw, sw);
    p.nbits = nbits[b];
    p.cap = cap;
    p.status = p.pos = p.fin = p.inblock = p.sleft = p.ntok = p.outpos = 0;
    p.trow = trow;
    p.cl = &tables[0];
    p.lit = &tables[1];
    p.dist = &tables[2];
    p.lens = lens;
    p.run();
    cnt[b * 3 + 0] = p.ntok;
    cnt[b * 3 + 1] = p.status;
    cnt[b * 3 + 2] = p.outpos;
    ntok = p.ntok;
  }
  __syncwarp();
  ntok = __shfl_sync(ps::FULL, ntok, 0);
  for (int i = ntok + lane; i < cap; i += 32) trow[i] = 0;
}

extern "C" int parse_launch(const void* nbits, const void* words, void* toks, void* cnt,
                            int n_streams, int sw, int cap, void* stream) {
  if (n_streams > 0) {
    parse_kernel<<<n_streams, 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)nbits, (const int32_t*)words, (int32_t*)toks, (int32_t*)cnt,
        sw, cap);
  }
  return (int)cudaGetLastError();
}
