// Kernel A of the lane shard decode: DEFLATE block headers, table
// builds and canonical-Huffman symbol decode of many shard streams.
//
// Replaces moonbit_flate_tpu/ops/lanes_inflate.py:parse_waves (the Pallas
// kernel _make_kernel_a).  The TPU kernel decodes 1024 streams a wave in
// vector lanes, 128 symbol steps a grid step, with masked "build waves"
// for block headers at grid-step starts.  On the H100 each stream gets
// one thread that walks it serially, all waves in one launch.  What
// bounds it here is the dependent chain inside one stream (bit reads,
// table lookups, branches), not bytes or arithmetic: each thread keeps
// its code tables and symbol maps in shared memory, entry-major
// ([entry][thread], no bank conflicts), its 64-bit input window in
// registers, and writes its token rows as it goes (the row-major layout
// puts the stream index innermost, so a warp's stores are coalesced).
//
// The output equals the TPU kernel's bit for bit, corrupt streams
// included, because the thread reproduces each stream's schedule: a
// block header is read only at the start of a 128-row chunk (a block end
// leaves the rest of its chunk 0), a match takes a gap row and then its
// record, and a stream still active or paused after the last chunk is
// ST_OVERFLOW.  A dynamic header whose code-length codes fail keeps
// running to nlit + ndist as the lane code's masked arithmetic does (a
// failed code consumes 0 bits, its rank-0 symbol still sets the repeat),
// so the final bit position agrees too.  Shifts that can overflow are
// done on uint32_t, as the TPU's int32 shifts wrap.
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
constexpr int NSYM = 320;         // lit/len + distance code lengths
constexpr int NLIT_MAP = 288;
constexpr int NDIST_MAP = 32;

constexpr int ST_ACTIVE = 0, ST_DONE = 1, ST_PAUSED = 2;
constexpr int ST_CORRUPT = -3, ST_TRUNC = -4, ST_OVERFLOW = -5;
constexpr int CLS_LIT = 0, CLS_LEN = 1, CLS_EOB = 2, CLS_BAD = 3;
constexpr int32_t TOK_LIT = 1 << 30;
constexpr uint32_t TOK_MATCH = 1u << 31;

// shared tables of one thread: int rows, entry-major with stride NT
constexpr int T_FCL = 0, T_BAL = 15, T_FCD = 30, T_BAD = 45, T_ROWS = 60;

// Input words of one stream: word k at base[(k / 128) * NSTR * LANE + k % 128],
// zero past IN_W.  peek(bp) gives the 32 bits from bit bp on, LSB first.
struct Bits {
  const int32_t* base;
  int cw;               // index of c0
  uint32_t c0, c1;

  LP_FN uint32_t word(int k) const {
    return k < IN_W ? (uint32_t)base[(k >> 7) * (NSTR * LANE) + (k & 127)] : 0u;
  }
  LP_FN void init(const int32_t* b) {
    base = b;
    cw = 0;
    c0 = word(0);
    c1 = word(1);
  }
  LP_FN uint32_t peek(int bp) {
    int w = bp >> 5;
    if (w != cw) {
      if (w == cw + 1) {
        c0 = c1;
      } else {
        c0 = word(w);
      }
      c1 = word(w + 1);
      cw = w;
    }
    return (uint32_t)(((((uint64_t)c1) << 32) | c0) >> (bp & 31));
  }
};

// Canonical decode by length counting: the first length l whose next l
// bits (first bit most significant) fall in [first, first + count).
// fc[l-1] = first << 9 | count as an int32 (first sign-extended from 23
// bits, as the TPU kernel's arithmetic shift gives it back).
LP_FN void length_decode(uint32_t lo, const int32_t* fc, const int32_t* base,
                         int stride, int maxb, int& ln, int& rank, bool& matched) {
  int code = 0;
  ln = 0;
  rank = 0;
  matched = false;
  for (int l = 1; l <= maxb; ++l) {
    code = (code << 1) | (int)((lo >> (l - 1)) & 1u);
    int32_t f = fc[(l - 1) * stride];
    int o = code - (f >> 9);
    if (o >= 0 && o < (f & 511)) {
      ln = l;
      rank = base[(l - 1) * stride] + o;
      matched = true;
      return;
    }
  }
}

// counts[l-1] codes of length l -> packed first codes and rank bases;
// returns true where the table is rejected (Kraft sum neither 0,
// complete, nor one code of length 1).
LP_FN bool canonical(const int* counts, int maxb, int32_t* fc, int32_t* base,
                     int stride) {
  uint32_t code = 0;
  int b = 0, kraft = 0, mx = 0;
  for (int l = 1; l <= maxb; ++l) {
    int c = counts[l - 1];
    fc[(l - 1) * stride] = (int32_t)((code << 9) | (uint32_t)c);
    base[(l - 1) * stride] = b;
    b += c;
    code = (code + (uint32_t)c) << 1;
    kraft += c << (maxb - l);
    if (c > 0) mx = l;
  }
  int full = 1 << maxb;
  return !(kraft == 0 || kraft == full || (mx == 1 && kraft == full / 2));
}

struct Stream {
  Bits in;
  int nbits;
  int status, bp, opos, blkmode, sleft, fin, expd, plen;
  int32_t* tab;         // shared int rows: tab[row * stride]
  uint16_t* map;        // shared map entries: lit ranks 0..287, dist 288..319
  int stride;

  LP_FN int32_t& T(int row) { return tab[row * stride]; }
  LP_FN uint16_t& M(int i) { return map[i * stride]; }

  // Block header and table build of a stream in ST_PAUSED.
  LP_FN void build_wave() {
    if (bp + 3 > nbits) {         // fewer than 3 bits left: the stream ends
      status = ST_DONE;
      return;
    }
    uint32_t hdr = in.peek(bp) & 7u;
    fin = (int)(hdr & 1u);
    int typ = (int)(hdr >> 1);
    bp += 3;
    if (typ == 3) {
      status = ST_CORRUPT;
      return;
    }
    if (typ == 0) {               // stored
      bp += (8 - (bp & 7)) & 7;
      int ln16 = (int)(in.peek(bp) & 0xFFFFu);
      bp += 16;
      int nln16 = (int)(in.peek(bp) & 0xFFFFu);
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
    const bool dyn = typ == 2;
    int nlit = 288, ndist = 32;
    int32_t fc_cl[7], base_cl[7];
    int clsym[19];
    if (dyn) {
      uint32_t lo = in.peek(bp);
      nlit = 257 + (int)(lo & 31u);
      ndist = 1 + (int)((lo >> 5) & 31u);
      int nclen = 4 + (int)((lo >> 10) & 15u);
      bp += 14;
      if (nlit > 286 || ndist > 30) {
        status = ST_CORRUPT;
        return;
      }
      const int order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3,
                             13, 2, 14, 1, 15};
      int cl_len[19];
      for (int k = 0; k < 19; ++k) cl_len[k] = 0;
      for (int k = 0; k < nclen; ++k) {
        cl_len[order[k]] = (int)(in.peek(bp) & 7u);
        bp += 3;
      }
      int ccnt[7] = {0, 0, 0, 0, 0, 0, 0};
      for (int k = 0; k < 19; ++k)
        if (cl_len[k] > 0) ccnt[cl_len[k] - 1] += 1;
      if (canonical(ccnt, 7, fc_cl, base_cl, 1)) {
        status = ST_CORRUPT;
        return;
      }
      int seen[7] = {0, 0, 0, 0, 0, 0, 0};
      for (int k = 0; k < 19; ++k) clsym[k] = 0;
      for (int k = 0; k < 19; ++k) {
        int lk = cl_len[k];
        if (lk > 0) {
          int r = base_cl[lk - 1] + seen[lk - 1]++;
          if (r < 19) clsym[r] = k;
        }
      }
    }

    // code lengths of both alphabets
    const int ns = nlit + ndist;
    uint8_t lens[NSYM];
    bool bad = false;
    if (dyn) {
      int run_rem = 0, run_len = 0;
      for (int i = 0; i < ns; ++i) {
        if (run_rem == 0) {
          uint32_t lo = in.peek(bp);
          int ln_c, rank_c;
          bool m_c;
          length_decode(lo, fc_cl, base_cl, 1, 7, ln_c, rank_c, m_c);
          // a failed code reads as rank 0 and consumes nothing
          int sym = clsym[rank_c < 19 ? rank_c : 18];
          int eb = sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
          int extra = (int)((lo >> ln_c) & ((1u << eb) - 1u));
          int rep = (sym == 16 || sym == 17) ? 3 + extra : sym == 18 ? 11 + extra : 1;
          int newlen = sym < 16 ? sym : sym == 16 ? run_len : 0;
          if (!m_c || (sym == 16 && i == 0)) bad = true;
          int nused = m_c ? ln_c + eb : 0;
          if (bp + nused > nbits) bad = true;
          bp += nused;
          run_rem = rep;
          run_len = newlen;
        }
        lens[i] = (uint8_t)run_len;
        run_rem -= 1;
      }
      if (run_rem > 0) bad = true;
    } else {
      for (int i = 0; i < NSYM; ++i)
        lens[i] = i >= 288 ? 5 : i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    }

    int cl15[15], cd15[15];
    for (int l = 0; l < 15; ++l) cl15[l] = cd15[l] = 0;
    for (int i = 0; i < ns; ++i) {
      int li = lens[i];
      if (li > 0) {
        if (i < nlit) cl15[li - 1] += 1;
        else cd15[li - 1] += 1;
      }
    }
    bool bad_l = canonical(cl15, 15, &T(T_FCL), &T(T_BAL), stride);
    bool bad_d = canonical(cd15, 15, &T(T_FCD), &T(T_BAD), stride);
    bad = bad || bad_l || bad_d;

    // rank -> (class << 8 | payload) maps; unassigned ranks hold 0
    for (int r = 0; r < NLIT_MAP + NDIST_MAP; ++r) M(r) = 0;
    int seen_l[15], seen_d[15];
    for (int l = 0; l < 15; ++l) seen_l[l] = seen_d[l] = 0;
    for (int i = 0; i < ns; ++i) {
      int li = lens[i];
      if (li == 0) continue;
      if (i < nlit) {
        int r = T(T_BAL + li - 1) + seen_l[li - 1]++;
        int cls = i < 256 ? CLS_LIT : i == 256 ? CLS_EOB : i < 286 ? CLS_LEN : CLS_BAD;
        int pay = i < 256 ? i : (i - 257 < 0 ? 0 : i - 257 > 28 ? 28 : i - 257);
        if (r < NLIT_MAP) M(r) = (uint16_t)((cls << 8) | pay);
      } else {
        int s = i - nlit;
        int r = T(T_BAD + li - 1) + seen_d[li - 1]++;
        int cls = s < 30 ? CLS_LEN : CLS_BAD;
        int pay = s > 29 ? 29 : s;
        if (r < NDIST_MAP) M(NLIT_MAP + r) = (uint16_t)((cls << 8) | pay);
      }
    }
    if (bad) {
      status = ST_CORRUPT;
    } else {
      status = ST_ACTIVE;
      blkmode = 1;
      expd = 0;
    }
  }

  // One symbol step of an ST_ACTIVE stream; returns its token record.
  LP_FN int32_t sym_step() {
    uint32_t lo = in.peek(bp);
    if (blkmode == 2) {           // stored: one byte a step
      if (bp + 8 > nbits) {
        status = ST_TRUNC;
        return 0;
      }
      if (opos + 1 > SEGB) {
        status = ST_OVERFLOW;
        return 0;
      }
      opos += 1;
      bp += 8;
      sleft -= 1;
      if (sleft == 0) {
        status = fin ? ST_DONE : ST_PAUSED;
        blkmode = 0;
      }
      return TOK_LIT | (int32_t)(lo & 0xFFu);
    }
    if (blkmode != 1) return 0;
    const bool isd = expd > 0;
    int ln, rank;
    bool matched;
    length_decode(lo, &T(isd ? T_FCD : T_FCL), &T(isd ? T_BAD : T_BAL), stride, 15,
                  ln, rank, matched);
    int e = isd ? M(NLIT_MAP + (rank < NDIST_MAP ? rank : NDIST_MAP - 1))
                : M(rank < NLIT_MAP ? rank : NLIT_MAP - 1);
    int cls = e >> 8, pay = e & 255;
    if (!matched || cls == CLS_BAD || (isd && cls != CLS_LEN)) {
      status = ST_CORRUPT;
      return 0;
    }
    if (isd) {                    // distance code of a match
      int dc = pay > 29 ? 29 : pay;
      int deb = dc < 4 ? 0 : (dc - 2) >> 1;
      int dbase = dc < 4 ? dc + 1 : (1 << (deb + 1)) + 1 + ((dc & 1) << deb);
      int dist = dbase + (int)((lo >> ln) & ((1u << deb) - 1u));
      int nused = ln + deb;
      if (bp + nused > nbits) {
        status = ST_TRUNC;
        return 0;
      }
      if (dist > opos) {
        status = ST_CORRUPT;
        return 0;
      }
      if (opos + plen > SEGB) {
        status = ST_OVERFLOW;
        return 0;
      }
      bp += nused;
      opos += plen;
      expd = 0;
      return (int32_t)(TOK_MATCH | ((uint32_t)plen << 13) | (uint32_t)dist);
    }
    if (cls == CLS_LEN) {         // length code: a gap row, distance next
      int lc = pay > 28 ? 28 : pay;
      int leb = lc < 8 ? 0 : (lc - 4) >> 2;
      int lbase = lc < 8 ? 3 + lc : (1 << (leb + 2)) + 3 + ((lc & 3) << leb);
      if (lc >= 28) {
        lbase = 258;
        leb = 0;
      }
      int nused = ln + leb;
      if (bp + nused > nbits) {
        status = ST_TRUNC;
        return 0;
      }
      bp += nused;
      expd = 1;
      plen = lbase + (int)((lo >> ln) & ((1u << leb) - 1u));
      return 0;
    }
    if (bp + ln > nbits) {
      status = ST_TRUNC;
      return 0;
    }
    if (cls == CLS_EOB) {
      bp += ln;
      status = fin ? ST_DONE : ST_PAUSED;
      blkmode = 0;
      return 0;
    }
    if (opos + 1 > SEGB) {        // literal
      status = ST_OVERFLOW;
      return 0;
    }
    bp += ln;
    opos += 1;
    return TOK_LIT | pay;
  }
};

// Stream r of wave w: nbits at nbits[w * NSTR + r]; token row k at
// tok[(w * TOK_ROWS + k) * NSTR + r]; misc row q at misc[(w * 4 + q) * NSTR + r].
LP_FN void parse_stream(const int32_t* nbits, const int32_t* inw, int32_t* tok,
                        int32_t* misc, int sid, int32_t* tab, uint16_t* map,
                        int stride) {
  const int w = sid / NSTR, r = sid % NSTR;
  Stream s;
  s.in.init(inw + (size_t)w * IN_CHUNKS * NSTR * LANE + (size_t)r * LANE);
  s.nbits = nbits[sid];
  s.status = ST_PAUSED;
  s.bp = s.opos = s.blkmode = s.sleft = s.fin = s.expd = s.plen = 0;
  s.tab = tab;
  s.map = map;
  s.stride = stride;
  int32_t* trow = tok + (size_t)w * TOK_ROWS * NSTR + r;
  for (int t = 0; t < TOK_CHUNKS; ++t) {
    if (s.status == ST_PAUSED) s.build_wave();
    int j = 0;
    for (; j < 128 && s.status == ST_ACTIVE; ++j)
      trow[(size_t)(t * 128 + j) * NSTR] = s.sym_step();
    for (; j < 128; ++j) trow[(size_t)(t * 128 + j) * NSTR] = 0;
  }
  if (s.status == ST_ACTIVE || s.status == ST_PAUSED) s.status = ST_OVERFLOW;
  int32_t* m = misc + (size_t)w * 4 * NSTR + r;
  m[0] = s.status;
  m[NSTR] = s.opos;
  m[2 * NSTR] = s.bp;
  m[3 * NSTR] = 0;
}

}  // namespace lp

constexpr int NT = 32;   // threads (streams) per block

__global__ void __launch_bounds__(NT)
lanes_parse_kernel(const int32_t* __restrict__ nbits, const int32_t* __restrict__ inw,
                   int32_t* __restrict__ tok, int32_t* __restrict__ misc, int n) {
  __shared__ int32_t tab[lp::T_ROWS * NT];
  __shared__ uint16_t map[(lp::NLIT_MAP + lp::NDIST_MAP) * NT];
  const int sid = blockIdx.x * NT + threadIdx.x;
  if (sid >= n) return;
  lp::parse_stream(nbits, inw, tok, misc, sid, tab + threadIdx.x, map + threadIdx.x, NT);
}

extern "C" int lanes_parse_launch(const void* nbits, const void* inw, void* tok,
                                  void* misc, int n, void* stream) {
  if (n > 0) {
    lanes_parse_kernel<<<(n + NT - 1) / NT, NT, 0, (cudaStream_t)stream>>>(
        (const int32_t*)nbits, (const int32_t*)inw, (int32_t*)tok, (int32_t*)misc, n);
  }
  return (int)cudaGetLastError();
}
