// Kernel A of the lane shard decode: DEFLATE block headers, table
// builds and canonical-Huffman symbol decode of many shard streams.
//
// Replaces moonbit_flate_tpu/ops/lanes_inflate.py:parse_waves (the Pallas
// kernel _make_kernel_a).  The TPU kernel decodes 1024 streams a wave in
// vector lanes, 128 symbol steps a grid step, with masked "build waves"
// for block headers at grid-step starts, and decodes a symbol by length
// counting because it has no cheap gather.
//
// On the H100 a stream is one lane, a warp (one block) takes 32 streams
// and all waves go in one launch.  Nothing here comes near the card's
// byte or operation rates: the launch lasts as long as its slowest warp's
// chain of dependent symbol steps (up to 35 x 128 of them), so the design
// cuts the chain of a step, and sizes shared memory (27.7 KB a block) so
// that the blocks of 32 waves (1024) are all resident on 132 SMs at once,
// 8 an SM:
//
//   * Rich root tables.  A 16-bit entry holds a code's length, class and
//     payload (literal byte, length or distance code), so a symbol is one
//     shared-memory lookup on the next ROOT bits, and a second small one
//     gives the extra-bit count and base of a length or distance code.
//     The fixed code has one 9-bit literal/length root and one 5-bit
//     distance root for the whole block, built once at its start; they
//     hold every fixed code.  A dynamic block gets the lane's own 8-bit
//     and 6-bit roots.  Past the root, a code one bit longer is the k-th
//     symbol of that length, found by popcounts in a bitmap of those
//     symbols the lane keeps in shared memory; anything longer (a
//     literal/length code of 10 bits or more, a distance code of 8 or
//     more: rare in dynamic blocks of 4 KiB shards), or a pattern
//     with no code, takes the old length counting on the stream's
//     canonical tables and rank maps in a global scratch row.  Each tier
//     answers only where length counting would find the same code, so
//     "not matched" comes out the same (an empty code, or one code of
//     length 1, where half of all patterns have no code).
//   * Input through a ring in shared memory.  Each lane decodes from a
//     64-bit bit buffer in registers that takes one 32-bit word a step at
//     most, from its stream's ring of RING words.  Every eighth step the
//     warp finds by __ballot_sync the lanes whose buffer has entered the
//     ring's newer half, and copies the next RING / 2 words of each into
//     the older half with cp.async: 16 lanes a stream, one coalesced 64-byte
//     read, waited for only at the next check: a step takes at most one
//     word, so the lane is still at least 8 words short of the new half
//     then (and loads the word it takes next one step ahead, off the
//     chain).  Words at and past IN_W read as 0, as
//     do the staged zeros past a stream: the ring holds the staged words
//     themselves.
//   * A step with few branches.  A stored byte is the buffer's low byte
//     (the block header already checked that the block fits); a Huffman
//     symbol's rules are selects on the looked-up values, checked in the
//     TPU kernel's order.
//   * Coalesced stores.  Rows are step-major with the stream innermost,
//     so the warp's 32 lanes store one 128-byte line a step; once no lane
//     of the warp is active, the rest of the chunk's rows go out as 16-byte
//     stores of the whole warp.
//   * Block headers one lane each, reading the stream's words from global
//     memory, with no local memory (which would wait on L2): the
//     code-length code's root and the code lengths live in the lane's own
//     shared columns.  The tables of a dynamic block are then built by the
//     whole warp, 32 symbols a round (build_tables), and the warp reloads
//     the ring of each lane that starts a block.
//
// The output equals the TPU kernel's bit for bit, corrupt streams
// included, because each lane keeps each stream's schedule: a block header
// is read only at the start of a 128-row chunk (a block end leaves the
// rest of its chunk 0), a match takes a gap row and then its record, and
// a stream still active or paused after the last chunk is ST_OVERFLOW.  A
// dynamic header whose code-length codes fail keeps running to nlit +
// ndist as the lane code's masked arithmetic does (a failed code consumes
// 0 bits, its rank-0 symbol still sets the repeat), so the final bit
// position agrees too.  Shifts that can overflow are done on uint32_t, as
// the TPU's int32 shifts wrap.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#define LP_FN __device__ __forceinline__

namespace lp {

constexpr int NSTR = 1024;        // streams per wave
constexpr int LANE = 128;
constexpr int SEGB = 4096;        // output bytes per stream, at most
constexpr int TOK_CHUNKS = 35;
constexpr int TOK_ROWS = TOK_CHUNKS * 128;
constexpr int IN_W = 1152;        // input words per stream
constexpr int IN_CHUNKS = IN_W / LANE;
constexpr int NLIT_MAP = 288;
constexpr int NDIST_MAP = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr int ST_ACTIVE = 0, ST_DONE = 1, ST_PAUSED = 2;
constexpr int ST_CORRUPT = -3, ST_TRUNC = -4, ST_OVERFLOW = -5;
constexpr int CLS_LIT = 0, CLS_LEN = 1, CLS_EOB = 2, CLS_BAD = 3;
constexpr int32_t TOK_LIT = 1 << 30;
constexpr uint32_t TOK_MATCH = 1u << 31;

constexpr int FIX_LIT_BITS = 9, FIX_DIST_BITS = 5;   // roots of the fixed code
constexpr int DYN_LIT_BITS = 8, DYN_DIST_BITS = 6;   // roots of a lane's dynamic code
constexpr int RING = 32;          // ring words a lane (a power of two)
constexpr int HALF = RING / 2;
constexpr int CHECK = 8;          // steps between two ring checks

// A stream's row of global scratch (int32): the canonical tables of its
// current dynamic block, first code << 9 | count and rank base for
// lengths 1..15, literal/length then distance, and the rank -> (class <<
// 8 | payload) maps as uint16 (literal ranks 0..287, distance 288..319).
constexpr int S_FCL = 0, S_BAL = 15, S_FCD = 30, S_BAD = 45, S_MAP = 60;
constexpr int SCRATCH = S_MAP + (NLIT_MAP + NDIST_MAP) / 2;   // int32 a stream

// a root entry: payload << 6 | class << 4 | code length; 0 = no entry
LP_FN uint32_t entry(int len, int cls, int pay) {
  return (uint32_t)len | ((uint32_t)cls << 4) | ((uint32_t)pay << 6);
}
LP_FN void lit_class(int i, int& cls, int& pay) {
  cls = i < 256 ? CLS_LIT : i == 256 ? CLS_EOB : i < 286 ? CLS_LEN : CLS_BAD;
  pay = i < 256 ? i : (i - 257 < 0 ? 0 : i - 257 > 28 ? 28 : i - 257);
}
LP_FN void dist_class(int s, int& cls, int& pay) {
  cls = s < 30 ? CLS_LEN : CLS_BAD;
  pay = s > 29 ? 29 : s;
}
LP_FN uint32_t rev_bits(uint32_t code, int len) { return __brev(code) >> (32 - len); }

struct Shared {
  uint32_t extra[64];   // base | extra bits << 16 of length code c at c, distance code c at 32 + c
  uint16_t fix_lit[1 << FIX_LIT_BITS];
  uint16_t fix_dist[1 << FIX_DIST_BITS];
  uint16_t dyn_lit[(1 << DYN_LIT_BITS) * 32];     // entry x of lane l at [x * 32 + l]
  uint16_t dyn_dist[(1 << DYN_DIST_BITS) * 32];
  uint32_t ring[RING * 32];                       // word k of lane l at [(k % RING) * 32 + l]
  // the codes one bit longer than a lane's dynamic roots: which symbols
  // have them (literal/length: words 0..8, distance: word 9; word i of
  // lane l at [i * 32 + l]), and their first code << 16 | count
  uint32_t next_bits[10 * 32];
  uint32_t next_code[2 * 32];
  // a warp table build: count, first code, rank base and running count
  // of each (alphabet * 16 + length)
  uint16_t b_count[32], b_first[32], b_base[32], b_run[32];
};

// Shared memory by its 32-bit shared-space address, so that the step's
// loads are ld.shared and the address stays in a register; asynchronous
// copies of one word from global into shared memory.  A host compiler
// (kernels/emulate.py) takes plain pointers and copies at once.
#ifdef __CUDACC__
typedef uint32_t SAddr;
LP_FN SAddr smem_addr(const void* p) { return (SAddr)__cvta_generic_to_shared(p); }
LP_FN uint32_t lds16(SAddr a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(a) : "memory");
  return v;
}
LP_FN uint32_t lds32(SAddr a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
LP_FN void copy_word(uint32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               : : "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
LP_FN void copies_commit() { asm volatile("cp.async.commit_group;" : : : "memory"); }
LP_FN void copies_wait_older() { asm volatile("cp.async.wait_group 1;" : : : "memory"); }
LP_FN void copies_wait_all() { asm volatile("cp.async.wait_all;" : : : "memory"); }
#else
typedef uintptr_t SAddr;
LP_FN SAddr smem_addr(const void* p) { return (SAddr)p; }
LP_FN uint32_t lds16(SAddr a) { return *(const volatile uint16_t*)a; }
LP_FN uint32_t lds32(SAddr a) { return *(const volatile uint32_t*)a; }
LP_FN void copy_word(uint32_t* dst, const int32_t* src) { *dst = (uint32_t)*src; }
LP_FN void copies_commit() {}
LP_FN void copies_wait_older() {}
LP_FN void copies_wait_all() {}
#endif

// Word k of the stream whose word 0 is at base: chunks of 128 words lie
// NSTR * LANE apart; zero at and past IN_W.
LP_FN const int32_t* word_at(const int32_t* base, int k) {
  return base + (size_t)(k >> 7) * (NSTR * LANE) + (k & 127);
}
LP_FN uint32_t load_word(const int32_t* base, int k) {
  return k < IN_W ? (uint32_t)*word_at(base, k) : 0u;
}

// Canonical decode by length counting: the first length l whose next l
// bits (first bit most significant) fall in [first, first + count).
// fc[l-1] = first << 9 | count as an int32 (first sign-extended from 23
// bits, as the TPU kernel's arithmetic shift gives it back).
LP_FN void length_decode(uint32_t lo, const int32_t* fc, const int32_t* base, int maxb,
                         int& ln, int& rank, bool& matched) {
  int code = 0;
  ln = 0;
  rank = 0;
  matched = false;
  for (int l = 1; l <= maxb; ++l) {
    code = (code << 1) | (int)((lo >> (l - 1)) & 1u);
    const int32_t f = fc[l - 1];
    const int o = code - (f >> 9);
    if (o >= 0 && o < (f & 511)) {
      ln = l;
      rank = base[l - 1] + o;
      matched = true;
      return;
    }
  }
}

// The fixed code's roots, built by the warp at the block's start.
LP_FN void build_fixed(Shared& sh, int lane) {
  for (int i = lane; i < NLIT_MAP; i += 32) {
    const int len = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    const uint32_t code = i < 144 ? 0x30 + i : i < 256 ? 0x190 + (i - 144)
                        : i < 280 ? (uint32_t)(i - 256) : 0xC0 + (i - 280);
    int cls, pay;
    lit_class(i, cls, pay);
    const uint16_t e = (uint16_t)entry(len, cls, pay);
    for (uint32_t x = rev_bits(code, len); x < 1u << FIX_LIT_BITS; x += 1u << len)
      sh.fix_lit[x] = e;
  }
  int cls, pay;
  dist_class(lane, cls, pay);
  sh.fix_dist[rev_bits((uint32_t)lane, 5)] = (uint16_t)entry(5, cls, pay);
  // extra-bit counts and bases of length codes 0..28 and distance codes 0..29;
  // 0 elsewhere (entry 63 serves literals and ends of block)
  const int lc = lane;
  int leb = lc < 8 ? 0 : (lc - 4) >> 2;
  int lbase = lc < 8 ? 3 + lc : (1 << (leb + 2)) + 3 + ((lc & 3) << leb);
  if (lc == 28) {
    lbase = 258;
    leb = 0;
  }
  const int dc = lane;
  const int deb = dc < 4 ? 0 : (dc - 2) >> 1;
  const int dbase = dc < 4 ? dc + 1 : (1 << (deb + 1)) + 1 + ((dc & 1) << deb);
  sh.extra[lane] = lc < 29 ? (uint32_t)lbase | ((uint32_t)leb << 16) : 0u;
  sh.extra[32 + lane] = dc < 30 ? (uint32_t)dbase | ((uint32_t)deb << 16) : 0u;
}

// One stream on one lane.
struct Stream {
  const int32_t* in;    // word 0 of the stream (word_at)
  int32_t* scr;         // the stream's scratch row
  uint16_t* dl;         // the lane's dynamic roots: entry x at [x * 32]
  uint16_t* dd;
  SAddr ring;           // the lane's ring: word k at [(k % RING) * 32]
  SAddr extra;          // Shared::extra
  SAddr nbits_at, ncode_at;   // the lane's next_bits and next_code
  uint32_t *next_bits, *ring_col;
  int nbits;
  int status, bp, opos, blkmode, sleft, fin, expd, plen;
  // roots of the running Huffman block: address, log2 of the stride, mask
  SAddr lt, dt;
  int ls, ds;
  uint32_t lm, dm;
  bool dyn;
  // bit buffer: bits bp.. in buf (cnt of them); wp = next word to take;
  // the ring holds words requested below `filled`
  uint64_t buf;
  int cnt, wp, filled;
  uint32_t nextw;       // ring word wp
  // a dynamic header read, its tables still to build
  bool tables;
  int t_nlit, t_ns;

  // code length i of the block being built, a nibble of the lane's ring
  // and next_bits columns
  LP_FN uint32_t* len_word(int i) const {
    const int w = i >> 3;
    return w < RING ? ring_col + w * 32 : next_bits + (w - RING) * 32;
  }
  LP_FN void set_len(int i, int v) {
    uint32_t* p = len_word(i);
    const int sh = 4 * (i & 7);
    *p = (*p & ~(15u << sh)) | ((uint32_t)v << sh);
  }

  LP_FN uint32_t peek(int p) const {
    const int w = p >> 5;
    return (uint32_t)((((uint64_t)load_word(in, w + 1) << 32) | load_word(in, w)) >> (p & 31));
  }

  // Block header and table build of a stream in ST_PAUSED.
  LP_FN void build_wave() {
    if (bp + 3 > nbits) {         // fewer than 3 bits left: the stream ends
      status = ST_DONE;
      return;
    }
    const uint32_t hdr = peek(bp) & 7u;
    fin = (int)(hdr & 1u);
    const int typ = (int)(hdr >> 1);
    bp += 3;
    if (typ == 3) {
      status = ST_CORRUPT;
      return;
    }
    if (typ == 0) {               // stored
      bp += (8 - (bp & 7)) & 7;
      const int ln16 = (int)(peek(bp) & 0xFFFFu);
      bp += 16;
      const int nln16 = (int)(peek(bp) & 0xFFFFu);
      bp += 16;
      if (((ln16 ^ nln16) & 0xFFFF) != 0xFFFF) {
        status = ST_CORRUPT;
      } else if (bp + 8 * ln16 > nbits) {
        status = ST_TRUNC;
      } else if (opos + ln16 > SEGB) {
        status = ST_OVERFLOW;
      } else {
        sleft = ln16;
        if (ln16 > 0) {
          blkmode = 2;
          status = ST_ACTIVE;
        } else {
          status = fin ? ST_DONE : ST_PAUSED;
        }
      }
      return;
    }
    if (typ == 1) {               // fixed: the block's shared roots
      dyn = false;
      status = ST_ACTIVE;
      blkmode = 1;
      expd = 0;
      return;
    }
    // dynamic.  Nothing here goes through local memory (which would wait
    // on L2 each time): the code-length code's 7-bit root lives in the
    // lane's distance-root column, the code lengths as nibbles in its ring
    // and next_bits columns, and counts, first codes and ranks in
    // registers, indexed by unrolled selects.
    uint32_t lo = peek(bp);
    const int nlit = 257 + (int)(lo & 31u);
    const int ndist = 1 + (int)((lo >> 5) & 31u);
    const int nclen = 4 + (int)((lo >> 10) & 15u);
    bp += 14;
    if (nlit > 286 || ndist > 30) {
      status = ST_CORRUPT;
      return;
    }
    constexpr int order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3,
                               13, 2, 14, 1, 15};
    uint64_t clp = 0;             // code-length code length of symbol k at bits 3k
#pragma unroll
    for (int k = 0; k < 19; ++k) {
      if (k < nclen) {
        clp |= (uint64_t)(peek(bp) & 7u) << (3 * order[k]);
        bp += 3;
      }
    }
    int ccnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 19; ++k) {
      const int lk = (int)((clp >> (3 * k)) & 7u);
#pragma unroll
      for (int l = 1; l < 8; ++l) ccnt[l] += lk == l;
    }
    int kraft = 0, mx = 0;
#pragma unroll
    for (int l = 1; l < 8; ++l) {
      kraft += ccnt[l] << (7 - l);
      mx = ccnt[l] ? l : mx;
    }
    if (!(kraft == 0 || kraft == 128 || (mx == 1 && kraft == 64))) {
      status = ST_CORRUPT;
      return;
    }
    // the root: length << 5 | symbol, 0 where a pattern has no code (the
    // code is complete, one code of length 1 or empty, so length counting
    // finds no other); the rank-0 symbol stands in for a failed code
    uint8_t* clroot = reinterpret_cast<uint8_t*>(dd);   // entry x at byte (x >> 1) * 64 + (x & 1)
    for (int x = 0; x < 64; ++x) dd[x * 32] = 0;
    int sym0 = 0;
    {
      uint32_t code = 0;
      bool first = true;
      for (int l = 1; l < 8; ++l) {
        for (int k = 0; k < 19; ++k) {
          if ((int)((clp >> (3 * k)) & 7u) != l) continue;
          sym0 = first ? k : sym0;
          first = false;
          for (uint32_t x = rev_bits(code, l); x < 128; x += 1u << l)
            clroot[(x >> 1) * 64 + (x & 1)] = (uint8_t)((l << 5) | k);
          ++code;
        }
        code <<= 1;
      }
    }

    // code lengths of both alphabets, nibble i at word i / 8 of the ring
    // column (words 32.. in the next_bits column)
    const int ns = nlit + ndist;
    bool bad = false;
    int run_rem = 0, run_len = 0;
    for (int i = 0; i < ns; ++i) {
      if (run_rem == 0) {
        lo = peek(bp);
        const int ce = clroot[((lo & 127u) >> 1) * 64 + (lo & 1u)];
        const bool m_c = ce != 0;
        const int ln_c = ce >> 5;
        // a failed code reads as rank 0 and consumes nothing
        const int sym = m_c ? ce & 31 : sym0;
        const int eb = sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
        const int extra = (int)((lo >> ln_c) & ((1u << eb) - 1u));
        const int rep = (sym == 16 || sym == 17) ? 3 + extra : sym == 18 ? 11 + extra : 1;
        const int newlen = sym < 16 ? sym : sym == 16 ? run_len : 0;
        if (!m_c || (sym == 16 && i == 0)) bad = true;
        const int nused = m_c ? ln_c + eb : 0;
        if (bp + nused > nbits) bad = true;
        bp += nused;
        run_rem = rep;
        run_len = newlen;
      }
      set_len(i, run_len);
      run_rem -= 1;
    }
    if (run_rem > 0) bad = true;

    if (bad) {
      status = ST_CORRUPT;
      return;
    }
    // the warp builds the tables from here (build_tables)
    t_nlit = nlit;
    t_ns = ns;
    tables = true;
  }

  // Past the root: a code one bit longer than the root is the k-th symbol
  // of that length (k = its code less the length's first code), found in
  // the lane's bitmap of those symbols; anything longer, or no code, is
  // length counting on the scratch tables.
  LP_FN uint32_t long_entry(uint32_t lo, bool isd) const {
    const int len = (isd ? DYN_DIST_BITS : DYN_LIT_BITS) + 1;
    const uint32_t fc = lds32(ncode_at + (isd ? 128u : 0u));
    const uint32_t k = (__brev(lo) >> (32 - len)) - (fc >> 16);
    if (k >= (fc & 0xFFFFu)) return slow_entry(lo, isd);
    // the word of the bitmap that holds the k-th set bit, then the bit
    uint32_t word = 0, base = 0, left = k;
    const int nw = isd ? 1 : 9;
    for (int w = 0; w < nw; ++w) {
      const uint32_t b = lds32(nbits_at + (uint32_t)((isd ? 9 : 0) + w) * 128u);
      const uint32_t c = (uint32_t)__popc(b);
      if (left < c) {
        word = b;
        base = 32u * (uint32_t)w;
        break;
      }
      left -= c;
    }
    uint32_t pos = 0;
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) {
      const uint32_t c = (uint32_t)__popc(word & ((1u << h) - 1u));
      const bool up = left >= c;
      left -= up ? c : 0u;
      word >>= up ? h : 0;
      pos += up ? h : 0;
    }
    int cls, pay;
    if (isd) dist_class((int)pos, cls, pay);
    else lit_class((int)(base + pos), cls, pay);
    return entry(len, cls, pay);
  }

  // The slow path: length counting on the scratch tables, all 15 of a
  // table's rows loaded at once.
  LP_FN uint32_t slow_entry(uint32_t lo, bool isd) const {
    int32_t fc[15], bs[15];
    const int32_t* f = scr + (isd ? S_FCD : S_FCL);
    const int32_t* b = scr + (isd ? S_BAD : S_BAL);
#pragma unroll
    for (int l = 0; l < 15; ++l) {
      fc[l] = f[l];
      bs[l] = b[l];
    }
    int ln, rank;
    bool matched;
    length_decode(lo, fc, bs, 15, ln, rank, matched);
    if (!matched) return 0;
    const uint16_t* map = reinterpret_cast<const uint16_t*>(scr + S_MAP);
    const int e = isd ? map[NLIT_MAP + (rank < NDIST_MAP ? rank : NDIST_MAP - 1)]
                      : map[rank < NLIT_MAP ? rank : NLIT_MAP - 1];
    return entry(ln, e >> 8, e & 255);
  }

  // One symbol step of an ST_ACTIVE stream; returns its token record.
  LP_FN int32_t step() {
    // the buffer takes one word when 32 bits or fewer are left, so a step
    // always sees at least 33 (a step takes at most 28)
    // (the word it takes was loaded a step before, off the chain)
    const bool take = cnt <= 32;
    buf |= take ? (uint64_t)nextw << cnt : 0ull;
    cnt += take ? 32 : 0;
    wp += take ? 1 : 0;
    if (take) nextw = lds32(ring + (uint32_t)(wp & (RING - 1)) * 128u);
    const uint32_t lo = (uint32_t)buf;
    if (blkmode == 2) {
      // a stored byte: the header made sure that the block's bytes are in
      // the stream and fit in the output
      bp += 8;
      buf >>= 8;
      cnt -= 8;
      opos += 1;
      if (--sleft == 0) {
        status = fin ? ST_DONE : ST_PAUSED;
        blkmode = 0;
      }
      return TOK_LIT | (int32_t)(lo & 0xFFu);
    }
    // a Huffman symbol: one root lookup, the rules as selects
    const bool isd = expd > 0;
    const SAddr ta = isd ? dt : lt;
    const int tsh = isd ? ds : ls;
    uint32_t e = lds16(ta + (((lo & (isd ? dm : lm)) << tsh) << 1));
    if (e == 0 && dyn) e = long_entry(lo, isd);
    const int ln = (int)(e & 15u), cls = (int)((e >> 4) & 3u), pay = (int)(e >> 6);
    const bool is_len = cls == CLS_LEN;
    const uint32_t x = lds32(extra + 4u * (uint32_t)(is_len ? (isd ? 32 : 0) + pay : 63));
    const int eb = (int)(x >> 16);
    const int value = (int)(x & 0xFFFFu) + (int)((lo >> ln) & ((1u << eb) - 1u));
    const int nused = ln + eb;
    const bool eob = !isd && cls == CLS_EOB;
    const bool lit = !isd && cls == CLS_LIT;
    const int add = isd ? plen : lit ? 1 : 0;       // output bytes
    // the rules in the TPU kernel's order: no code or a bad symbol, the
    // code past the stream, a distance beyond the output, the output full
    const bool bad = ln == 0 || cls == CLS_BAD || (isd && !is_len);
    const bool trunc = bp + nused > nbits;
    const bool far = isd && value > opos;
    const bool over = !eob && opos + add > SEGB;
    const bool ok = !(bad || trunc || far || over);
    // a lane that is not ok stops for good, so only bp keeps its place;
    // the buffer moves on regardless, which keeps ok off the chain
    bp += ok ? nused : 0;
    buf >>= nused;
    cnt -= nused;
    opos += ok ? add : 0;
    const int32_t tok = !ok ? 0
                      : isd ? (int32_t)(TOK_MATCH | ((uint32_t)plen << 13) | (uint32_t)value)
                      : lit ? TOK_LIT | pay : 0;
    plen = ok && !isd && is_len ? value : plen;
    expd = ok ? (isd ? 0 : is_len ? 1 : expd) : expd;
    status = ok ? (eob ? (fin ? ST_DONE : ST_PAUSED) : ST_ACTIVE)
                : bad || far ? ST_CORRUPT : trunc ? ST_TRUNC : ST_OVERFLOW;
    blkmode = ok && eob ? 0 : blkmode;
    return tok;
  }
};

// The literal/length and distance tables of lane src's dynamic block,
// built by the whole warp from the code lengths in src's ring and
// next_bits columns (nlit of ns for literals/lengths), 32 symbols a round:
// counts and ranks within a length by __match_any_sync, first codes and
// rank bases by one lane each alphabet.  Writes src's roots, bitmaps and
// next codes, and the canonical tables and long-code rank maps into its
// scratch row scr.  Returns on every lane whether both codes are usable.
LP_FN bool build_tables(Shared& sh, int src, int nlit, int ns, int32_t* scr, int lane) {
  const unsigned below = (1u << lane) - 1u;
  int len[10];
#pragma unroll
  for (int m = 0; m < 10; ++m) {
    const int i = m * 32 + lane;
    const int w = i >> 3;
    const uint32_t word = w < RING ? sh.ring[w * 32 + src] : sh.next_bits[(w - RING) * 32 + src];
    len[m] = i < ns ? (int)((word >> (4 * (i & 7))) & 15u) : 0;
  }
  sh.b_count[lane] = 0;
  sh.b_run[lane] = 0;
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 10; ++m) {
    const int i = m * 32 + lane;
    const int key = len[m] ? (i < nlit ? 0 : 16) + len[m] : 0;
    const unsigned peers = __match_any_sync(FULL, key);
    if (key && (peers & below) == 0) sh.b_count[key] += (uint16_t)__popc(peers);
    __syncwarp();
  }
  bool ok = true;
  if (lane < 2) {                 // lane 0 literals/lengths, lane 1 distances
    const int a = 16 * lane;
    int32_t* fc = scr + (lane ? S_FCD : S_FCL);
    int32_t* bs = scr + (lane ? S_BAD : S_BAL);
    uint32_t code = 0;
    int b = 0, kraft = 0, mx = 0;
    for (int l = 1; l < 16; ++l) {
      const int c = sh.b_count[a + l];
      fc[l - 1] = (int32_t)((code << 9) | (uint32_t)c);
      bs[l - 1] = b;
      sh.b_first[a + l] = (uint16_t)code;
      sh.b_base[a + l] = (uint16_t)b;
      b += c;
      code = (code + (uint32_t)c) << 1;
      kraft += c << (15 - l);
      mx = c ? l : mx;
    }
    ok = kraft == 0 || kraft == 1 << 15 || (mx == 1 && kraft == 1 << 14);
  }
  if (__ballot_sync(FULL, !ok)) return false;
  for (int x = lane; x < 1 << DYN_LIT_BITS; x += 32) sh.dyn_lit[x * 32 + src] = 0;
  for (int x = lane; x < 1 << DYN_DIST_BITS; x += 32) sh.dyn_dist[x * 32 + src] = 0;
  if (lane < 10) sh.next_bits[lane * 32 + src] = 0;
  __syncwarp();
  uint16_t* map = reinterpret_cast<uint16_t*>(scr + S_MAP);
#pragma unroll
  for (int m = 0; m < 10; ++m) {
    const int i = m * 32 + lane;
    const int l = len[m];
    const bool lit = i < nlit;
    const int key = l ? (lit ? 0 : 16) + l : 0;
    const unsigned peers = __match_any_sync(FULL, key);
    const int k = sh.b_run[key] + __popc(peers & below);
    __syncwarp();
    if (key && (peers & below) == 0) sh.b_run[key] += (uint16_t)__popc(peers);
    if (l) {
      const int sy = lit ? i : i - nlit;
      const uint32_t code = (uint32_t)sh.b_first[key] + (uint32_t)k;
      const int r = sh.b_base[key] + k;
      int cls, pay;
      if (lit) lit_class(sy, cls, pay);
      else dist_class(sy, cls, pay);
      const int rb = lit ? DYN_LIT_BITS : DYN_DIST_BITS;
      if (l <= rb) {              // the code's root replicas
        uint16_t* root = (lit ? sh.dyn_lit : sh.dyn_dist) + src;
        const uint16_t e = (uint16_t)entry(l, cls, pay);
        for (uint32_t x = rev_bits(code, l); x < 1u << rb; x += 1u << l) root[x * 32] = e;
      } else if (l == rb + 1) {   // one bit longer: a bit of the bitmap
        atomicOr(&sh.next_bits[(lit ? sy >> 5 : 9) * 32 + src], 1u << (sy & 31));
      } else if (lit ? r < NLIT_MAP : r < NDIST_MAP) {
        map[(lit ? 0 : NLIT_MAP) + r] = (uint16_t)((cls << 8) | pay);
      }
    }
    __syncwarp();
  }
  if (lane < 2) {
    const int key = lane ? 16 + DYN_DIST_BITS + 1 : DYN_LIT_BITS + 1;
    sh.next_code[lane * 32 + src] = ((uint32_t)sh.b_first[key] << 16) | sh.b_count[key];
  }
  __syncwarp();
  return true;
}

}  // namespace lp

constexpr int NT = 32;   // one warp, 32 streams, a block

__global__ void __launch_bounds__(NT, 8)
lanes_parse_kernel(const int32_t* __restrict__ nbits, const int32_t* __restrict__ inw,
                   int32_t* __restrict__ tok, int32_t* __restrict__ misc,
                   int32_t* __restrict__ scratch) {
  using namespace lp;
  __shared__ Shared sh;
  const int lane = threadIdx.x;
  const int sid0 = blockIdx.x * NT, sid = sid0 + lane;
  const int w = sid0 / NSTR, r0 = sid0 % NSTR;
  build_fixed(sh, lane);
  // word 0 of stream r0 + l at in0 + l * LANE
  const int32_t* in0 = inw + (size_t)w * IN_CHUNKS * NSTR * LANE + (size_t)r0 * LANE;
  Stream s;
  s.in = in0 + lane * LANE;
  s.scr = scratch + (size_t)sid * SCRATCH;
  s.dl = sh.dyn_lit + lane;
  s.dd = sh.dyn_dist + lane;
  s.ring = smem_addr(sh.ring + lane);
  s.extra = smem_addr(sh.extra);
  s.nbits_at = smem_addr(sh.next_bits + lane);
  s.ncode_at = smem_addr(sh.next_code + lane);
  s.next_bits = sh.next_bits + lane;
  s.ring_col = sh.ring + lane;
  s.nbits = nbits[sid];
  s.status = ST_PAUSED;
  s.bp = s.opos = s.blkmode = s.sleft = s.fin = s.expd = s.plen = 0;
  s.lt = s.dt = smem_addr(sh.fix_lit);
  s.ls = s.ds = 0;
  s.lm = s.dm = 0;
  s.dyn = false;
  s.buf = 0;
  s.cnt = s.wp = s.filled = 0;
  s.nextw = 0;
  // row k of stream r0 + l at rows + k * NSTR + l
  int32_t* rows = tok + (size_t)w * TOK_ROWS * NSTR + r0;
  __syncwarp();

  for (int t = 0; t < TOK_CHUNKS; ++t) {
    // no copy into a ring may land after the reload below
    copies_wait_all();
    __syncwarp();
    bool starts = false;
    s.tables = false;
    if (s.status == ST_PAUSED) {
      s.build_wave();
      starts = s.status == ST_ACTIVE;
    }
    if (s.tables) s.dyn = true;
    for (unsigned todo = __ballot_sync(FULL, s.tables); todo; todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const int nlit = __shfl_sync(FULL, s.t_nlit, src);
      const int ns = __shfl_sync(FULL, s.t_ns, src);
      const bool ok = build_tables(sh, src, nlit, ns, scratch + (size_t)(sid0 + src) * SCRATCH,
                                   lane);
      if (lane == src) {
        s.status = ok ? ST_ACTIVE : ST_CORRUPT;
        s.blkmode = ok ? 1 : s.blkmode;
        s.expd = ok ? 0 : s.expd;
        starts = ok;
      }
    }
    if (starts) {
      s.lt = smem_addr(s.dyn ? s.dl : sh.fix_lit);
      s.dt = smem_addr(s.dyn ? s.dd : sh.fix_dist);
      s.ls = s.ds = s.dyn ? 5 : 0;
      s.lm = s.dyn ? (1u << DYN_LIT_BITS) - 1 : (1u << FIX_LIT_BITS) - 1;
      s.dm = s.dyn ? (1u << DYN_DIST_BITS) - 1 : (1u << FIX_DIST_BITS) - 1;
    }
    // a lane that starts a block gets its ring reloaded from the half-ring
    // boundary at or below its position, RING words, a lane a word
    const int w0 = (s.bp >> 5) & ~(HALF - 1);
    for (unsigned todo = __ballot_sync(FULL, starts); todo; todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const int k = __shfl_sync(FULL, w0, src) + lane;
      uint32_t* dst = sh.ring + (k & (RING - 1)) * 32 + src;
      if (k < IN_W) copy_word(dst, word_at(in0 + src * LANE, k));
      else *dst = 0u;
    }
    copies_commit();
    copies_wait_all();
    __syncwarp();
    if (starts) {
      const int wp = s.bp >> 5, sft = s.bp & 31;
      s.buf = ((uint64_t)lds32(s.ring + (uint32_t)((wp + 1) & (RING - 1)) * 128u) << 32
               | lds32(s.ring + (uint32_t)(wp & (RING - 1)) * 128u)) >> sft;
      s.cnt = 64 - sft;
      s.wp = wp + 2;
      s.nextw = lds32(s.ring + (uint32_t)((wp + 2) & (RING - 1)) * 128u);
      s.filled = w0 + RING;
    }

    int32_t* row = rows + (size_t)t * 128 * NSTR + lane;
    int j = 0;
    for (; j < 128; ++j, row += NSTR) {
      const bool active = s.status == ST_ACTIVE;
      if (j % CHECK == 0) {
        // the chunk ends for the warp once no lane is active (a lane that
        // stops between two checks writes 0 rows, as the rest would);
        // rings whose buffer has entered the newer half: the next HALF
        // words go into the older one, two streams at a time
        if (!__ballot_sync(FULL, active)) break;
        const bool want = active && s.wp >= s.filled - HALF;
        unsigned todo = __ballot_sync(FULL, want);
        while (todo) {
          const int a = __ffs(todo) - 1;
          todo &= todo - 1;
          const int b = todo ? __ffs(todo) - 1 : -1;
          if (b >= 0) todo &= todo - 1;
          const int fa = __shfl_sync(FULL, s.filled, a);
          const int fb = __shfl_sync(FULL, s.filled, b < 0 ? a : b);
          const int src = lane < HALF ? a : b;
          const int k = (lane < HALF ? fa : fb) + (lane & (HALF - 1));
          if (src >= 0) {
            uint32_t* dst = sh.ring + (k & (RING - 1)) * 32 + src;
            if (k < IN_W) copy_word(dst, word_at(in0 + src * LANE, k));
            else *dst = 0u;
          }
        }
        if (want) s.filled += HALF;
        copies_commit();
        copies_wait_older();
        __syncwarp();
      }
      *row = active ? s.step() : 0;
    }
    // the chunk's remaining rows: four rows of the 32 streams a store
    for (int q = j * 8 + lane; q < 128 * 8; q += 32) {
      int4* dst = reinterpret_cast<int4*>(rows + (size_t)(t * 128 + q / 8) * NSTR) + q % 8;
      *dst = make_int4(0, 0, 0, 0);
    }
  }
  copies_wait_all();
  if (s.status == ST_ACTIVE || s.status == ST_PAUSED) s.status = ST_OVERFLOW;
  int32_t* m = misc + (size_t)w * 4 * NSTR + r0 + lane;
  m[0] = s.status;
  m[NSTR] = s.opos;
  m[2 * NSTR] = s.bp;
  m[3 * NSTR] = 0;
}

// n streams (a multiple of 32, as whole waves are); scratch holds
// lp::SCRATCH int32 a stream.
extern "C" int lanes_parse_launch(const void* nbits, const void* inw, void* tok,
                                  void* misc, void* scratch, int n, void* stream) {
  if (n % NT) return (int)cudaErrorInvalidConfiguration;
  if (n > 0) {
    lanes_parse_kernel<<<n / NT, NT, 0, (cudaStream_t)stream>>>(
        (const int32_t*)nbits, (const int32_t*)inw, (int32_t*)tok, (int32_t*)misc,
        (int32_t*)scratch);
  }
  return (int)cudaGetLastError();
}
