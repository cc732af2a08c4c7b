// Stage A of the scalar-path decode: the serial symbol parse of whole
// raw-DEFLATE streams of any size into packed token records.
//
// Replaces moonbit_flate_tpu/ops/parse_pallas.py:parse_batch (the Pallas
// kernel _make_kernel).  The TPU kernel runs on the scalar core over a
// (stream, token chunk) grid, with an 8192-word input window in SMEM that
// it refills by DMA, two-level decode tables in SMEM arenas and closed
// forms where it cannot index constants.
//
// What bounds it on the H100: the parse of one stream is one chain of
// dependent steps (bits -> table entry -> code length -> next bits), so a
// stream runs on one lane and the card is filled only by the number of
// streams; neither bytes nor arithmetic come near their limits.  A lane
// alone pays the latency of every dependent machine operation and every
// branch in full (4 to 5 cycles each, some 30 for a shared-memory load),
// so the time is the number of such steps on the chain.  The design
// takes off that chain everything it can:
//
//   * Input through shared memory.  The stream's words pass through a
//     ring of RING_W words that the whole warp refills with coalesced
//     loads, BATCH a lane in flight, between the parsing lane's turns;
//     the lane never waits for global memory.  A refill costs a few
//     memory latencies for every ~7 KB of input (under 2% of the parse),
//     so it is a plain synchronous copy, not an asynchronous one: there
//     is nothing left to overlap.  Words at and past sw are written to
//     the ring as 0.
//   * Tokens through shared memory.  The lane stores tokens into a
//     staging array; the warp writes them to the token row in full lines
//     after each turn, and the whole block zero-fills the row's tail with
//     16-byte stores, so every word of the row is still written once.
//   * Rich, wide tables.  The literal/length root takes the next 12 bits,
//     the distance root 10; an entry holds the code length, the
//     extra-bit count, a kind flag and the literal byte or the
//     length/distance base, so a token costs one lookup (a match two)
//     and no arithmetic on the symbol.  Where the bits after a literal's
//     code hold a second literal's whole code, the entry yields both (a
//     pass over the root after each build pairs them).  Codes longer
//     than the root, the end of block and the invalid symbols have no
//     fast entry.
//   * A fast loop and the careful path.  While at least 48 bits remain
//     before nbits (a token takes at most 15 + 5 + 15 + 13) the fast loop
//     decodes from a 64-bit bit buffer that it refills from the ring,
//     checks no truncation, and emits a token only where the careful path
//     would emit the same one.  Anything else (no fast entry, a distance
//     beyond the history, fewer bits left) leaves the loop at the token's
//     first bit, and the careful path, which is the step-by-step logic
//     with every rule in its order, produces the token or the status.
//     The fast loop never decides a status.  Its refill is predicated,
//     a round looks up twice, its shared-memory addresses are made once
//     (see smem_addr), and its branch waits for no loaded value.
//   * Stored blocks by the whole warp.  A stored block is one token a
//     byte; the parsing lane reads its header and the warp then expands
//     its bytes from the stream's words to the token row, a word a lane
//     a step, as many as the capacity takes.
//   * Warp-cooperative table builds.  Counting, code assignment and the
//     root fill of the literal/length and distance tables run on all 32
//     lanes (ranks within a length by __match_any_sync, codes with many
//     root replicas filled by the whole warp); only the Kraft sum and the
//     first codes of 15 lengths are serial.  The 19-symbol code-length
//     table stays on the parsing lane.
//
// What is left on the chain is some 60 cycles a literal lookup and 350 a
// match.  Splitting one stream among several warps (speculative starts)
// is the step after; it is not done here.
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

constexpr int LIT_BITS = 12;      // root of the literal/length table
constexpr int DIST_BITS = 10;     // root of the distance table
constexpr int CL_BITS = 7;        // the code-length code has at most 7 bits
constexpr int NLIT = 288;
constexpr int NLENS = 320;        // literal/length + distance code lengths
constexpr int RING_W = 2048;      // input ring, words (a power of two)
constexpr int MARGIN_W = 256;     // one careful step reads less than this ahead
                                  // (a dynamic header is under 4,600 bits)
constexpr int STAGE = 2048;       // tokens staged between two flushes
constexpr int BATCH = 8;          // loads a lane keeps in flight in the warp's copies
constexpr int THREADS = 128;      // warp 0 parses; all four zero the tail
constexpr int ST_DONE = 1, ST_CORRUPT = -3, ST_TRUNC = -4;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int GO_ON = 0, BUILD = 1, COPY = 2;   // what a turn of the parsing lane asks for

// a root entry: value << 16 | kind | extra bits << 4 | code length
constexpr uint32_t F_LIT = 0x100;    // value = the literal byte
constexpr uint32_t F_LEN = 0x200;    // value = the length base
constexpr uint32_t F_DIST = 0x400;   // value = the distance base
constexpr uint32_t F_OTHER = 0x800;  // end of block or an invalid symbol
// two literals in one entry: second << 24 | first << 16 | F_LIT | F_LIT2 |
// first code length << 4 | both lengths together
constexpr uint32_t F_LIT2 = 0x1000;

// Canonical form of a code: codes per length and symbols in code order.
// It decodes any code by length counting and finds that a pattern has none.
struct Canon {
  uint16_t count[16];
  uint16_t symbol[NLIT];
};

struct Shared {
  alignas(16) uint32_t lit_root[1 << LIT_BITS];
  alignas(16) uint32_t dist_root[1 << DIST_BITS];
  alignas(16) uint32_t ring[RING_W];   // word k of the stream at k % RING_W
  alignas(16) int32_t stage[STAGE];
  Canon cl, lit, dist;
  uint16_t cl_root[1 << CL_BITS];      // symbol << 4 | length
  uint16_t first[16], offs[16], running[16];
  uint8_t lens[NLENS];
  int ntok;
};

// Shared memory by its 32-bit shared-space address, for the fast loop.
// Through a C++ reference the compiler re-derives the shared window's
// base (a special-register read) inside the loop, on the chain of every
// lookup; an address made once and kept opaque stays in a register.
#ifdef __CUDACC__
typedef uint32_t SAddr;
PS_FN SAddr smem_addr(const void* p) {
  SAddr a = (SAddr)__cvta_generic_to_shared(p);
  asm volatile("" : "+r"(a));
  return a;
}
PS_FN uint32_t lds(SAddr a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
PS_FN void sts(SAddr a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" : : "r"(a), "r"(v) : "memory");
}
#else   // a host compiler (kernels/emulate.py): plain pointers
typedef uintptr_t SAddr;
PS_FN SAddr smem_addr(const void* p) { return (SAddr)p; }
PS_FN uint32_t lds(SAddr a) { return *(const volatile uint32_t*)a; }
PS_FN void sts(SAddr a, uint32_t v) { *(volatile uint32_t*)a = v; }
#endif

PS_FN uint32_t rev_bits(uint32_t code, int len) { return __brev(code) >> (32 - len); }

PS_FN void length_base_extra(int lc, int& base, int& eb) {
  eb = lc < 8 ? 0 : (lc - 4) >> 2;
  base = lc < 8 ? 3 + lc : (1 << (eb + 2)) + 3 + ((lc & 3) << eb);
  if (lc >= 28) {
    base = 258;
    eb = 0;
  }
}

PS_FN void dist_base_extra(int ds, int& base, int& eb) {
  eb = ds < 4 ? 0 : (ds - 2) >> 1;
  base = ds < 4 ? ds + 1 : (1 << (eb + 1)) + 1 + ((ds & 1) << eb);
}

PS_FN uint32_t lit_entry(int sym, int l) {
  if (sym < 256) return ((uint32_t)sym << 16) | F_LIT | (uint32_t)l;
  if (sym == 256 || sym >= 286) return F_OTHER | (uint32_t)l;
  int base, eb;
  length_base_extra(sym - 257, base, eb);
  return ((uint32_t)base << 16) | F_LEN | ((uint32_t)eb << 4) | (uint32_t)l;
}

PS_FN uint32_t dist_entry(int sym, int l) {
  if (sym >= 30) return F_OTHER | (uint32_t)l;
  int base, eb;
  dist_base_extra(sym, base, eb);
  return ((uint32_t)base << 16) | F_DIST | ((uint32_t)eb << 4) | (uint32_t)l;
}

// True where the counted code is empty, complete, or one code of length 1.
PS_FN bool usable(const uint16_t* count) {
  int kraft = 0, mx = 0;
  for (int l = 1; l < 16; ++l) {
    kraft += (int)count[l] << (15 - l);
    if (count[l]) mx = l;
  }
  return kraft == 0 || kraft == 1 << 15 || (mx == 1 && kraft == 1 << 14);
}

// The code-length table (19 symbols), built by one lane.  Returns false
// where the code is not usable.
PS_FN bool build_cl(Shared& sh) {
  Canon& t = sh.cl;
  const uint8_t* lens = sh.lens;
  for (int l = 0; l < 16; ++l) t.count[l] = 0;
  for (int i = 0; i < 19; ++i) t.count[lens[i]] += 1;
  t.count[0] = 0;
  if (!usable(t.count)) return false;
  int offs[8], next[8];
  int o = 0, code = 0;
  for (int l = 1; l < 8; ++l) {
    offs[l] = o;
    o += t.count[l];
    next[l] = code;
    code = (code + t.count[l]) << 1;
  }
  for (int j = 0; j < 1 << CL_BITS; ++j) sh.cl_root[j] = 0;
  for (int i = 0; i < 19; ++i) {
    const int l = lens[i];
    if (l == 0) continue;
    t.symbol[offs[l]++] = (uint16_t)i;
    const uint32_t c = (uint32_t)next[l]++;
    const uint16_t e = (uint16_t)((i << 4) | l);
    for (uint32_t j = rev_bits(c, l); j < 1u << CL_BITS; j += 1u << l) sh.cl_root[j] = e;
  }
  return true;
}

// The literal/length (DIST false) or distance (DIST true) table of n code
// lengths, built by the whole warp: the canonical form and the root.
// Every lane returns the same answer, false where the code is not usable.
template <bool DIST>
PS_FN bool build_warp(Shared& sh, Canon& t, const uint8_t* lens, int n, uint32_t* root,
                      int root_bits, int lane) {
  const unsigned below = (1u << lane) - 1u;
  if (lane < 16) {
    t.count[lane] = 0;
    sh.running[lane] = 0;
  }
  __syncwarp();
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int l = i < n ? lens[i] : 0;
    const unsigned peers = __match_any_sync(FULL, l);
    if (l && (peers & below) == 0) t.count[l] += (uint16_t)__popc(peers);
    __syncwarp();
  }
  if (!usable(t.count)) return false;
  if (lane == 0) {
    int o = 0, code = 0;
    for (int l = 1; l < 16; ++l) {
      sh.offs[l] = (uint16_t)o;
      o += t.count[l];
      sh.first[l] = (uint16_t)code;
      code = (code + t.count[l]) << 1;
    }
  }
  uint4* root4 = (uint4*)root;
  for (int j = lane; j < (1 << root_bits) / 4; j += 32) root4[j] = make_uint4(0, 0, 0, 0);
  __syncwarp();
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int l = i < n ? lens[i] : 0;
    const unsigned peers = __match_any_sync(FULL, l);
    const int rank = (int)sh.running[l] + __popc(peers & below);
    __syncwarp();
    if (l && (peers & below) == 0) sh.running[l] += (uint16_t)__popc(peers);
    uint32_t e = 0, r = 0;
    const bool in_root = l > 0 && l <= root_bits;
    if (l) {
      t.symbol[sh.offs[l] + rank] = (uint16_t)i;
      if (in_root) {
        e = DIST ? dist_entry(i, l) : lit_entry(i, l);
        r = rev_bits((uint32_t)sh.first[l] + (uint32_t)rank, l);
      }
    }
    // a code with 64 or more root replicas is filled by the whole warp
    const bool wide = in_root && root_bits - l >= 6;
    if (in_root && !wide) {
      for (uint32_t j = r; j < 1u << root_bits; j += 1u << l) root[j] = e;
    }
    unsigned todo = __ballot_sync(FULL, wide);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const uint32_t r_ = __shfl_sync(FULL, r, src);
      const uint32_t e_ = __shfl_sync(FULL, e, src);
      const int l_ = __shfl_sync(FULL, l, src);
      for (uint32_t j = r_ + ((uint32_t)lane << l_); j < 1u << root_bits; j += 32u << l_)
        root[j] = e_;
    }
    __syncwarp();
  }
  if (!DIST) {
    // pair literals: where the bits after a literal's code hold another
    // literal's whole code, the entry yields both.  An entry reads the
    // same first literal and first length before and after it is paired,
    // so the pass runs in place.
    for (int j = lane; j < 1 << root_bits; j += 32) {
      const uint32_t e = root[j];
      if (!(e & F_LIT)) continue;
      const int l1 = (int)(e & 15u);
      const uint32_t e2 = root[j >> l1];
      const int l2 = (int)((e2 & F_LIT2) ? (e2 >> 4) & 15u : e2 & 15u);
      if ((e2 & F_LIT) && l1 + l2 <= root_bits)
        root[j] = ((e2 & 0x00FF0000u) << 8) | (e & 0x00FF0000u) | F_LIT | F_LIT2
                  | ((uint32_t)l1 << 4) | (uint32_t)(l1 + l2);
    }
    __syncwarp();
  }
  return true;
}

// The code at the head of bits (LSB first): its length, 0 if the pattern
// has no code, and its symbol.
PS_FN int decode(const Canon& t, uint32_t bits, int& sym) {
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

// The parsing lane's state.  Tokens of the running turn sit in
// sh.stage[0..nstage); ntok counts the tokens of earlier turns.
struct Parser {
  int nbits, cap;
  int status, pos, fin, inblock, sleft, ntok, outpos;
  int nlit, ndist;      // set by header() where it asks for a table build
  int nstage;

  // The 32 bits from bit p on, LSB first, through the ring.
  PS_FN uint32_t peek(const Shared& sh, int p) const {
    const int w = p >> 5;
    return __funnelshift_r(sh.ring[w & (RING_W - 1)], sh.ring[(w + 1) & (RING_W - 1)],
                           p & 31);
  }

  PS_FN int decode_cl(const Shared& sh, uint32_t bits, int& sym) const {
    const uint16_t e = sh.cl_root[bits & ((1u << CL_BITS) - 1u)];
    if (e) {
      sym = e >> 4;
      return e & 15;
    }
    return decode(sh.cl, bits, sym);
  }

  // Block header at pos; emits no token.  Returns true where the
  // literal/length and distance tables of sh.lens are to be built.
  PS_FN bool header(Shared& sh) {
    if (pos + 3 > nbits) {        // fewer than 3 bits left: a clean end
      status = ST_DONE;
      return false;
    }
    const uint32_t hdr = peek(sh, pos);
    fin = (int)(hdr & 1u);
    const int typ = (int)((hdr >> 1) & 3u);
    const int p3 = pos + 3;
    if (typ == 3) {
      status = ST_CORRUPT;
      return false;
    }
    if (typ == 0) {               // stored
      const int aligned = (p3 + 7) & ~7;
      const uint32_t v = peek(sh, aligned);
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
      return false;
    }
    uint8_t* lens = sh.lens;
    nlit = NLIT;
    ndist = 32;
    if (typ == 1) {               // fixed: 5-bit distance codes, read as a table
      for (int i = 0; i < NLENS; ++i)
        lens[i] = i >= 288 ? 5 : i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
      pos = p3;
      return true;
    }
    // dynamic: any fault here is corrupt
    const uint32_t v = peek(sh, p3);
    nlit = 257 + (int)(v & 31u);
    ndist = 1 + (int)((v >> 5) & 31u);
    const int nclen = 4 + (int)((v >> 10) & 15u);
    int pp = p3 + 14;
    status = ST_CORRUPT;          // until the header is through
    if (nlit > 286 || ndist > 30 || pp + 3 * nclen > nbits) return false;
    const int order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3,
                           13, 2, 14, 1, 15};
    for (int k = 0; k < 19; ++k) lens[k] = 0;
    for (int k = 0; k < nclen; ++k) {
      lens[order[k]] = (uint8_t)(peek(sh, pp) & 7u);
      pp += 3;
    }
    if (!build_cl(sh)) return false;
    const int n = nlit + ndist;
    int i = 0;
    while (i < n) {
      const uint32_t lo = peek(sh, pp);
      int sym;
      const int l = decode_cl(sh, lo, sym);
      if (l == 0 || pp + l > nbits) return false;
      pp += l;
      if (sym < 16) {
        lens[i++] = (uint8_t)sym;
        continue;
      }
      if (sym == 16 && i == 0) return false;
      const int eb = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      const int rep = (sym == 18 ? 11 : 3) + (int)((lo >> l) & ((1u << eb) - 1u));
      pp += eb;
      if (i + rep > n || pp > nbits) return false;
      const uint8_t val = sym == 16 ? lens[i - 1] : 0;
      for (int j = 0; j < rep; ++j) lens[i++] = val;
    }
    pos = pp;
    status = 0;
    return true;
  }

  // One token of a Huffman block (or its end), every rule in its order.
  PS_FN void token(Shared& sh) {
    const uint32_t lo = peek(sh, pos);
    int sym;
    const int ln = decode(sh.lit, lo, sym);
    if (ln == 0) {
      status = ST_CORRUPT;
      return;
    }
    if (pos + ln > nbits) {
      status = ST_TRUNC;
      return;
    }
    if (sym < 256) {
      sh.stage[nstage++] = sym;
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
    int lbase, leb;
    length_base_extra(sym - 257, lbase, leb);
    const int length = lbase + (int)((lo >> ln) & ((1u << leb) - 1u));
    const int p_len = pos + ln + leb;
    const uint32_t lo2 = peek(sh, p_len);
    int dsym;
    const int dl = decode(sh.dist, lo2, dsym);
    if (dl == 0 || (p_len + dl <= nbits && dsym >= 30)) {
      status = ST_CORRUPT;
      return;
    }
    if (p_len + dl > nbits) {     // the distance reads as 1 here
      status = outpos == 0 ? ST_CORRUPT : ST_TRUNC;
      return;
    }
    int dbase, deb;
    dist_base_extra(dsym, dbase, deb);
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
    sh.stage[nstage++] =
        (int32_t)(0x80000000u | ((uint32_t)(length - 3) << 15) | (uint32_t)(d - 1));
    pos = p_end;
    outpos += length;
  }

  // Tokens of a Huffman block while no rule can apply.  The bit buffer
  // takes words below wp_limit only, which keeps every token it starts
  // at least 48 bits before nbits and inside the ring; at most room
  // tokens are staged.  It stops at the first bit of a token it does not
  // take.  One lane alone pays every dependent machine operation and
  // every branch in full, so the loop keeps both few: the refill is
  // predicated, a round looks up twice (up to four literals), and what
  // the loop's branch waits for is kept off the data (a round count
  // stands for the room, the word index for the position, and the
  // output count follows from the staged count).
  PS_FN void fast(Shared& sh, int wp_limit, int room) {
    // cnt valid bits in buf, the next word to take is wp, already loaded
    // as nextw; the position is wp * 32 - cnt
    int wp = (pos >> 5) + 2;
    if (wp > wp_limit) return;
    const SAddr lit = smem_addr(sh.lit_root), dist = smem_addr(sh.dist_root);
    const SAddr ring = smem_addr(sh.ring), stage = smem_addr(sh.stage);
    const uint32_t lit_mask = (1u << LIT_BITS) - 1u, dist_mask = (1u << DIST_BITS) - 1u;
    const int s = pos & 31;
    uint64_t buf = (((uint64_t)lds(ring + 4 * ((wp - 1) & (RING_W - 1))) << 32)
                    | lds(ring + 4 * ((wp - 2) & (RING_W - 1)))) >> s;
    int cnt = 64 - s;
    uint32_t nextw = lds(ring + 4 * (wp & (RING_W - 1)));
    int n = nstage;
    int out_base = outpos - n;    // output so far = out_base + n
    // a round stages at most four tokens; rounds that run out before the
    // room does are counted anew
    for (int rounds = (room - n) >> 2; rounds > 0; rounds = (room - n) >> 2) {
    for (; rounds > 0 && wp <= wp_limit; --rounds) {
      // with 32 bits or fewer left the next word comes in: 33 or more after
      bool take = cnt <= 32;
      buf |= take ? (uint64_t)nextw << (cnt & 63) : 0ull;
      cnt += take ? 32 : 0;
      wp += take ? 1 : 0;
      nextw = lds(ring + 4 * (wp & (RING_W - 1)));
      uint32_t e = lds(lit + 4 * ((uint32_t)buf & lit_mask));
      int l = (int)(e & 15u);
      if (e & F_LIT) {            // one literal, or two where F_LIT2 is set
        sts(stage + 4 * n, (e >> 16) & 0xFFu);
        sts(stage + 4 * n + 4, e >> 24);
        n += 1 + (int)((e / F_LIT2) & 1u);
        buf >>= l;
        cnt -= l;
        // once more in the same round, taken only if it is a literal again:
        // at least 21 bits are left and a literal entry takes at most 12.
        // What it stores is kept only where n moves on.
        e = lds(lit + 4 * ((uint32_t)buf & lit_mask));
        const bool again = (e & F_LIT) != 0;
        l = again ? (int)(e & 15u) : 0;
        sts(stage + 4 * n, (e >> 16) & 0xFFu);
        sts(stage + 4 * n + 4, e >> 24);
        n += again ? 1 + (int)((e / F_LIT2) & 1u) : 0;
        buf >>= l;
        cnt -= l;
        continue;
      }
      if (!(e & F_LEN)) break;    // a long code, no code, end of block, bad symbol
      const int leb = (int)((e >> 4) & 15u);
      const int length = (int)(e >> 16) + (int)(((uint32_t)buf >> l) & ((1u << leb) - 1u));
      uint64_t b2 = buf >> (l + leb);
      int c2 = cnt - (l + leb);
      take = c2 <= 32;
      b2 |= take ? (uint64_t)nextw << (c2 & 63) : 0ull;
      c2 += take ? 32 : 0;
      const int w2 = wp + (take ? 1 : 0);
      const uint32_t de = lds(dist + 4 * ((uint32_t)b2 & dist_mask));
      const int dl = (int)(de & 15u), deb = (int)((de >> 4) & 15u);
      const int d = (int)(de >> 16) + (int)(((uint32_t)b2 >> dl) & ((1u << deb) - 1u));
      const int out = out_base + n;
      if (!(de & F_DIST) || d > (out < 32768 ? out : 32768)) break;
      sts(stage + 4 * n, 0x80000000u | ((uint32_t)(length - 3) << 15) | (uint32_t)(d - 1));
      n += 1;
      out_base += length - 1;
      buf = b2 >> (dl + deb);
      cnt = c2 - (dl + deb);
      wp = w2;
      nextw = lds(ring + 4 * (wp & (RING_W - 1)));
    }
    if (rounds > 0) break;        // left on a token or a limit, not on the count
    }
    pos = wp * 32 - cnt;
    nstage = n;
    outpos = out_base + n;
  }

  // One turn of the parsing lane: steps while the stream is live, the
  // staging has room and pos is before word win_words - 1 (what a step reads
  // beyond it is in the ring; win_words = the ring's last word less the
  // margin).  Returns what the warp is to do next:
  // GO_ON (flush, refill, another turn), BUILD (the tables of sh.lens)
  // or COPY (the bytes of a stored block).
  PS_FN int turn(Shared& sh, int win_words) {
    const int room = min(STAGE, cap - ntok);
    // the fast loop takes words below this one; a careful step starts
    // only where the fast loop cannot (so a turn ends with it)
    const int wp_limit = min(win_words, (nbits - 47) >> 5);
    const long long lim = (long long)(win_words - 1) * 32 - 1;
    const int win_limit = (int)(lim < 0x7FFFFFFFLL ? lim : 0x7FFFFFFFLL);
    nstage = 0;
    while (status == 0 && nstage < room && pos <= win_limit) {
      if (inblock == 2) return COPY;
      if (inblock == 1) {
        fast(sh, wp_limit, room);
        if (nstage < room && pos <= win_limit) token(sh);
      } else if (header(sh)) {
        return BUILD;
      }
    }
    return GO_ON;
  }
};

}  // namespace ps

__global__ void __launch_bounds__(ps::THREADS)
parse_kernel(const int32_t* __restrict__ nbits, const int32_t* __restrict__ words,
             int32_t* __restrict__ toks, int32_t* __restrict__ cnt, int sw, int cap) {
  using namespace ps;
  __shared__ Shared sh;
  const int b = blockIdx.x, tid = threadIdx.x;
  int32_t* trow = toks + (size_t)b * cap;
  if (tid < 32) {
    const int lane = tid;
    const uint32_t* in = (const uint32_t*)words + (size_t)b * sw;
    Parser p;
    p.nbits = nbits[b];
    p.cap = cap;
    p.status = p.pos = p.fin = p.inblock = p.sleft = p.ntok = p.outpos = 0;
    p.nlit = p.ndist = p.nstage = 0;
    int filled = 0;               // words below this index are in the ring
    for (;;) {
      // refill: from the 32-word line that holds pos, RING_W words on
      const int pos = __shfl_sync(FULL, p.pos, 0);
      const int target = ((pos >> 5) & ~31) + RING_W;
      // (eight loads a lane in flight: a refill costs a few memory
      // latencies, not one a line)
      for (int w = max(filled, target - RING_W) + lane; w < target; w += 32 * BATCH) {
        uint32_t v[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int wu = w + 32 * u;
          v[u] = wu < target && wu < sw ? in[wu] : 0u;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int wu = w + 32 * u;
          if (wu < target) sh.ring[wu & (RING_W - 1)] = v[u];
        }
      }
      filled = target;
      __syncwarp();
      int ask = GO_ON;
      if (lane == 0) ask = p.turn(sh, filled - MARGIN_W);
      __syncwarp();
      // flush the turn's tokens
      const int nstage = __shfl_sync(FULL, p.nstage, 0);
      const int ntok = __shfl_sync(FULL, p.ntok, 0);
      for (int i = lane; i < nstage; i += 32) trow[ntok + i] = sh.stage[i];
      p.ntok = ntok + nstage;
      p.nstage = 0;
      ask = __shfl_sync(FULL, ask, 0);
      if (ask == BUILD) {
        const int nlit = __shfl_sync(FULL, p.nlit, 0);
        const int ndist = __shfl_sync(FULL, p.ndist, 0);
        const bool ok_l = build_warp<false>(sh, sh.lit, sh.lens, nlit, sh.lit_root,
                                            LIT_BITS, lane);
        const bool ok_d = build_warp<true>(sh, sh.dist, sh.lens + nlit, ndist,
                                           sh.dist_root, DIST_BITS, lane);
        if (ok_l && ok_d) {
          p.inblock = 1;
        } else {
          p.status = ST_CORRUPT;
        }
        __syncwarp();
      } else if (ask == COPY) {
        // a stored block: one token a byte, as many as the capacity takes,
        // straight from the stream's words to the token row
        const int left = __shfl_sync(FULL, p.sleft, 0);
        const int count = min(left, cap - p.ntok);
        const int at = __shfl_sync(FULL, p.pos, 0) >> 3;
        // a lane takes a word (four tokens) a step, BATCH words in flight
        int32_t* const dst = trow + p.ntok;        // the token of byte at + j is dst[j]
        const int w_end = (at + count + 3) >> 2;
        for (int w = (at >> 2) + lane; w < w_end; w += 32 * BATCH) {
          uint32_t v[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            const int wu = w + 32 * u;
            v[u] = wu < w_end && wu < sw ? in[wu] : 0u;
          }
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int k = 4 * (w + 32 * u) + t;
              if (k >= at && k < at + count) dst[k - at] = (int32_t)((v[u] >> (8 * t)) & 0xFFu);
            }
          }
        }
        p.ntok += count;
        p.pos += 8 * count;
        p.outpos += count;
        p.sleft = left - count;
        if (p.sleft == 0) {
          p.inblock = 0;
          if (p.fin) p.status = ST_DONE;
        }
      }
      const int live = __shfl_sync(FULL, (int)(p.status == 0 && p.ntok < cap), 0);
      if (!live) break;
    }
    if (lane == 0) {
      cnt[b * 3 + 0] = p.ntok;
      cnt[b * 3 + 1] = p.status;
      cnt[b * 3 + 2] = p.outpos;
      sh.ntok = p.ntok;
    }
  }
  __syncthreads();
  // zero the row past the last token: single words up to a 16-byte
  // boundary, then 16-byte stores, then the last words
  int32_t* z = trow + sh.ntok;
  int32_t* const end = trow + cap;
  const int head = (int)(((16u - (unsigned)((uintptr_t)z & 15u)) & 15u) >> 2);
  if (tid < head && z + tid < end) z[tid] = 0;
  z = z + head < end ? z + head : end;
  const size_t n4 = (size_t)(end - z) / 4;
  uint4* z4 = (uint4*)z;
  for (size_t i = tid; i < n4; i += THREADS) z4[i] = make_uint4(0, 0, 0, 0);
  z += n4 * 4;
  if (z + tid < end) z[tid] = 0;
}

extern "C" int parse_launch(const void* nbits, const void* words, void* toks, void* cnt,
                            int n_streams, int sw, int cap, void* stream) {
  if (n_streams > 0) {
    parse_kernel<<<n_streams, ps::THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)nbits, (const int32_t*)words, (int32_t*)toks, (int32_t*)cnt,
        sw, cap);
  }
  return (int)cudaGetLastError();
}
