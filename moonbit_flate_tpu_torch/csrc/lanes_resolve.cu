// Kernel BC of the lane shard decode: token records -> output bytes.
//
// Replaces moonbit_flate_tpu/ops/lanes_resolve.py:resolve_waves (the
// Pallas kernel _make_kernel_bc).  The TPU has no scatter, so its kernel
// advances every stream one output byte a step and resolves copy chains
// by pointer doubling inside 128-byte blocks.  What it computes is plain
// LZ77 expansion: byte p < outlen of a stream is its literal or the byte
// dist before it, overlapping copies (len > dist) byte by byte, and bytes
// past outlen are 0.  Zero rows (kernel A's gap rows) are skipped.
//
// It reads the tokens where kernel A wrote them, step-major: row k of
// stream r of wave w at tok[(w * TOK_ROWS + k) * NSTR + r], so one row of
// 8 consecutive streams is one 32-byte sector.
//
// The bound is the bytes it must move (token rows in, output words out),
// but what holds it back is the order of the matches: a heavy text shard
// has ~500 of them, and copying them one after another (one warp a
// stream, each match a warp copy and a wait) made its warp the slowest
// of the launch (lanes_parse_trace.py).  So:
//
// - A block takes 8 consecutive streams, a warp each, their 4 KiB
//   histories in shared memory.  It loads 128 token rows of its 8
//   streams at a time, a 4 KiB tile, one 16-byte load a thread that
//   covers whole sectors; the next DEPTH tiles are in flight in
//   registers while a tile is expanded.
// - A warp takes 4 consecutive rows a lane (one 16-byte shared load),
//   finds each record's output offset with one warp prefix sum (none
//   when all 128 rows are literals), places the tile's literals and
//   queues its matches (start, length cut at outlen, dist) in shared
//   memory, which holds a whole tile of them.  A literal may go in
//   before the matches queued ahead of it: they write only bytes before
//   it.
// - A warp copies its queue when it is full and once more after the last
//   tile, with no block barrier, in rounds: f, the first match still to
//   copy, and every match whose source ends at or before f's start read
//   only bytes that are final and write none that another of them reads.
//   Lane l takes entries l, l + 32, ... one a round; a match of up to
//   SHORT bytes is copied by its lane, a longer one by the whole warp.
//   A match reads only bytes before its own start (byte q from q % dist
//   where dist < len), so no copy reads what it writes.
// - Then each warp writes its 1,024 output words, 512 bytes a store.
//
// 44 KB of shared memory and 63 registers a thread: 4 blocks an SM.
// More blocks an SM (fewer registers) and warp copies of short matches
// measured slower.
//
// Inputs kernel A never produces get a fixed meaning: a match record of
// length 0 stands for one 0 byte, and a source before the stream's start
// or a distance of 0 reads as 0.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NSTR = 1024;
constexpr int LANE = 128;
constexpr int SEGB = 4096;
constexpr int TOK_CHUNKS = 35;
constexpr int TOK_ROWS = TOK_CHUNKS * 128;
constexpr int GROUPS = SEGB / 512;
constexpr int WARPS = 8;           // streams a block: one 32-byte sector a row
constexpr int TILE = 128;          // token rows a tile
constexpr int TPAD = TILE + 4;     // a stream's row of the tile, in words
constexpr int DEPTH = 2;           // tiles in flight beyond the one expanded
constexpr int SHORT = 16;          // longest match one lane copies alone
constexpr int QCAP = 128;          // matches a warp holds back
static_assert(QCAP >= TILE, "a tile's matches must fit an empty queue");
constexpr unsigned FULL = 0xFFFFFFFFu;

// This thread's share of the tile of rows k0 .. k0 + 127 (zeros past the
// last row): row k0 + t / 2 of streams r0 + 4 (t % 2) .. + 3.
__device__ __forceinline__ uint4 load_tile(const int32_t* tok, int w, int r0, int k0) {
  const int t = threadIdx.x;
  if (k0 >= TOK_ROWS) return make_uint4(0, 0, 0, 0);
  const int32_t* src = tok + ((size_t)w * TOK_ROWS + k0 + (t >> 1)) * NSTR + r0 + 4 * (t & 1);
  return __ldg(reinterpret_cast<const uint4*>(src));
}

// into the tile, conflict-free
__device__ __forceinline__ void store_tile(uint32_t (*tile)[TPAD], uint4 v) {
  const int t = threadIdx.x;
  const int j = t >> 1, s = 4 * (t & 1);
  tile[s][j] = v.x;
  tile[s + 1][j] = v.y;
  tile[s + 2][j] = v.z;
  tile[s + 3][j] = v.w;
}

// Bytes ms .. ms + m - 1 of the history from dist > 0 bytes back: by
// the whole warp (warp_copy) or by one lane, four bytes a step
// (short_copy).  The source lies before ms; a byte before the stream's
// start reads 0.
__device__ __forceinline__ void warp_copy(uint8_t* hb, int ms, int m, int dist, int lane) {
  const int src = ms - dist;
  if (dist >= m) {
    for (int q = lane; q < m; q += 32) hb[ms + q] = src + q >= 0 ? hb[src + q] : 0;
  } else {
    for (int q = lane; q < m; q += 32) {
      const int s = src + q % dist;
      hb[ms + q] = s >= 0 ? hb[s] : 0;
    }
  }
}

__device__ __forceinline__ void short_copy(uint8_t* hb, int ms, int m, int dist) {
  const int src = ms - dist;
  if (dist >= m) {
    for (int q = 0; q < m; q += 4) {
      uint8_t b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = q + i < m && src + q + i >= 0 ? hb[src + q + i] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (q + i < m) hb[ms + q + i] = b[i];
    }
    return;
  }
  for (int q = 0, r = 0; q < m; ++q) {   // r = q % dist
    hb[ms + q] = src + r >= 0 ? hb[src + r] : 0;
    r = r + 1 == dist ? 0 : r + 1;
  }
}

// A warp's matches still to copy, in stream order: entry k = (start |
// length cut at n << 16, dist).
struct Queue {
  uint2* e;
  int n;
};

// Copies the queue's matches and empties it.  Rounds: f, the first
// match still to copy, and every match whose source ends at or before
// f's start read only bytes that are final (literals, and matches before
// f) and write none that another of them reads.  Lane l takes entries l,
// l + 32, ... in order, one a round; matches of up to SHORT bytes are
// copied by their lane, longer ones by the whole warp.
__device__ __forceinline__ void drain(Queue& q, uint8_t* hb, int lane) {
  __syncwarp();
  for (int i = lane;;) {
    const bool has = i < q.n;
    if (!__ballot_sync(FULL, has)) break;
    const uint2 e = has ? q.e[i] : make_uint2(0, 0);
    const int ms = e.x & 0xFFFF, m = e.x >> 16, dist = e.y;
    const int first = __reduce_min_sync(FULL, has ? i : 0x7FFFFFFF);
    const int sf = q.e[first].x & 0xFFFF;
    const bool ready = has && (i == first || ms - dist + min(m, dist) <= sf);
    if (ready && m <= SHORT) short_copy(hb, ms, m, dist);
    for (unsigned big = __ballot_sync(FULL, ready && m > SHORT); big; big &= big - 1) {
      const int src = __ffs(big) - 1;
      warp_copy(hb, __shfl_sync(FULL, ms, src), __shfl_sync(FULL, m, src),
                __shfl_sync(FULL, dist, src), lane);
    }
    if (ready) i += 32;
    __syncwarp();
  }
  q.n = 0;
}

// Rows k0 + 4 lane .. + 3 of this warp's stream (from its row of the
// tile): literals into its history, matches onto its queue (drained
// first if they would not fit).  Returns the output position after the
// tile.  A literal may go in before the matches queued ahead of it: they
// write only bytes before it.
__device__ __forceinline__ int expand_tile(const uint32_t* trow, uint8_t* hb, Queue& q, int p,
                                           int n, int lane) {
  const uint4 v = *reinterpret_cast<const uint4*>(trow + 4 * lane);
  const int32_t t[4] = {(int32_t)v.x, (int32_t)v.y, (int32_t)v.z, (int32_t)v.w};
  if (__ballot_sync(FULL, t[0] > 0 && t[1] > 0 && t[2] > 0 && t[3] > 0) == FULL) {
    const int base = p + 4 * lane;   // 128 literals
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < n) hb[base + j] = (uint8_t)(t[j] & 255);
    return p + TILE;
  }
  // output offsets and queue places: one scan of len | matches << 16
  int pre[4], own = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int mlen = (t[j] >> 13) & 511;
    pre[j] = own;
    own += t[j] == 0 ? 0 : t[j] < 0 && mlen > 0 ? mlen + (1 << 16) : 1;
  }
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += x;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  if (q.n + (total >> 16) > QCAP) drain(q, hb, lane);
  const int base = p + ((incl - own) & 0xFFFF), k = q.n + ((incl - own) >> 16);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int start = base + (pre[j] & 0xFFFF), mlen = (t[j] >> 13) & 511, dist = t[j] & 8191;
    if (t[j] > 0 && start < n) hb[start] = (uint8_t)(t[j] & 255);
    if (t[j] < 0 && mlen > 0) {        // nothing to copy: length 0 at start 0
      const bool copies = start < n && dist > 0 && start - dist + min(mlen, dist) > 0;
      q.e[k + (pre[j] >> 16)] =
          copies ? make_uint2(start | min(mlen, n - start) << 16, dist) : make_uint2(0, 0);
    }
  }
  q.n += total >> 16;
  return p + (total & 0xFFFF);
}

struct Shared {
  alignas(16) uint32_t hist[WARPS][SEGB / 4];   // the streams' output bytes
  alignas(16) uint32_t tile[WARPS][TPAD];       // tile[s][j]: row k0 + j of stream r0 + s
  uint2 queue[WARPS][QCAP];
};

__global__ void __launch_bounds__(WARPS * 32)
lanes_resolve_kernel(const int32_t* __restrict__ outlen, const int32_t* __restrict__ tok,
                     int32_t* __restrict__ out) {
  __shared__ Shared sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sid = blockIdx.x * WARPS + warp;
  const int w = blockIdx.x * WARPS / NSTR, r0 = blockIdx.x * WARPS % NSTR;
  uint32_t* hw = sh.hist[warp];
  uint8_t* hb = reinterpret_cast<uint8_t*>(hw);
  Queue q{sh.queue[warp], 0};

  uint4 ring[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) ring[d] = load_tile(tok, w, r0, d * TILE);
  for (int i = lane; i < SEGB / 16; i += 32)
    reinterpret_cast<uint4*>(hw)[i] = make_uint4(0, 0, 0, 0);
  int n = outlen[sid];
  n = n < 0 ? 0 : n > SEGB ? SEGB : n;

  int p = 0;
  bool more = true;
  for (int k0 = 0; more; k0 += DEPTH * TILE) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int kt = k0 + d * TILE;
      if (more) {                      // the same in every thread of the block
        store_tile(sh.tile, ring[d]);
        __syncthreads();
        ring[d] = load_tile(tok, w, r0, kt + DEPTH * TILE);
        if (p < n) p = expand_tile(sh.tile[warp], hb, q, p, n, lane);
        more = __syncthreads_or(p < n && kt + TILE < TOK_ROWS);
      }
    }
  }
  drain(q, hb, lane);

  // word i of stream r at out[((w * GROUPS + i / 128) * NSTR + r) * LANE + i % 128]
  int32_t* orow = out + ((size_t)w * GROUPS * NSTR + r0 + warp) * LANE;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g)
    reinterpret_cast<uint4*>(orow + (size_t)g * NSTR * LANE)[lane] =
        reinterpret_cast<const uint4*>(hw)[g * 32 + lane];
}

}  // namespace

// tok step-major (kernel A's layout); every pointer 16-byte aligned.
extern "C" int lanes_resolve_launch(const void* outlen, const void* tok, void* out, int waves,
                                    void* stream) {
  if (waves > 0)
    lanes_resolve_kernel<<<waves * NSTR / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)outlen, (const int32_t*)tok, (int32_t*)out);
  return (int)cudaGetLastError();
}
