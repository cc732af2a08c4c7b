// Stage B of the scalar-path decode: packed token records -> output bytes.
//
// Replaces moonbit_flate_tpu/ops/resolve_pallas.py:resolve_batch_pallas
// (the Pallas kernel _make_kernel).  The TPU kernel is one scalar pass a
// stream over a (stream, 8 KiB output chunk) grid, with a 32 KB circular
// history window and a token slab in SMEM.
//
// What bounds it on the H100: not bytes (some 2.2 MB a stream in and out)
// but the order of the work.  Done as one warp a stream, every 32 tokens
// are a dependent chain of a load, a scan and the round's matches one at
// a time, each match a global byte read of output just written, while
// most of the card idles.  This design gives a stream one block of
// kThreads threads and cuts its output into rounds over a window held in
// shared memory, one cell a byte:
//
//   1. tokens: the block holds a chunk of 4 tokens a thread in registers
//      (16-byte loads; the chunk that holds the next token stays there
//      from round to round and the next chunk is always in flight), scans
//      their lengths and takes those whose output starts before the
//      window's end; a taken token writes a marker at its start cell
//      (start, literal byte or distance).  A round starts where the last
//      one stopped, at a token start p, in a window that begins at p
//      rounded down to 16 bytes (the few bytes before p carried over from
//      the last round), and has kMaxMatch cells of slack, so a match that
//      starts in the window ends in it;
//   2. covering token: a running maximum of the markers (a warp scan a
//      piece, then across warps) gives every byte its token, so work is
//      balanced however long the matches are.  A literal's cell takes its
//      byte; a byte q into a match of distance d at s takes the source
//      s - d + q % d: inside the window a pointer to that cell; before the
//      window a byte of the stream's output in global memory, written by
//      earlier rounds of this block; before the stream's start 0;
//   3. pointer doubling in place: every unresolved cell takes its
//      target's state (a resolved byte or a pointer further back) until a
//      __syncthreads_or says no cell changed.  A state a thread reads
//      while another moves it on is still a cell of the same chain, so no
//      double buffer is needed.  Literal-only windows take no step;
//   4. the finished 16-byte groups go out with 16-byte stores; the last
//      round also writes its part group, zero past the output, and the
//      block then zero-fills the row to no_pad with 16-byte stores.
//
// About 1 MB / kWindow rounds a stream of 1 MB, each a few block barriers
// and a few shared-memory passes over the window.  The window's cells
// take (kWindow + 272) * 4 bytes of dynamic shared memory, above the
// 48 KB of static shared memory a block may have, so the launch raises
// the kernel's limit with cudaFuncSetAttribute.
//
// Tokens past ntok[b] are ignored and output stops at no_pad bytes, so a
// match crossing it is cut.  A source before the stream's start reads as
// 0 (the TPU kernel reads whatever its window held there; the parser
// never emits such a token).
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 16384;              // output bytes in which a round's tokens start
constexpr int kMaxMatch = 258;
constexpr int kCells = kWindow + 272;       // window + slack, rounded up to 16
constexpr int kChunk = 4 * kThreads;        // tokens the block reads at once
// cell states: a resolved byte, or the index of the cell it copies
constexpr uint32_t kDone = 0x80000000u;
// markers, before the running maximum: (start cell + 1) << 16 | kind
constexpr uint32_t kLit = 0x8000u;          // low byte: the literal; else dist - 1

static_assert(kCells >= kWindow - 1 + kMaxMatch, "a match that starts in the window ends in it");
static_assert(kCells % 16 == 0 && kCells < 32768, "cells go out in 16s; starts fit 15 bits");

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

__device__ __forceinline__ int warp_incl_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_incl_max(uint32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = max(v, u);
  }
  return v;
}

// tokens j .. j + 3 of a row (j a multiple of 4), zeros from n on
__device__ __forceinline__ int4 load_tokens(const int32_t* __restrict__ trow, int j, int n) {
  return j < n ? *reinterpret_cast<const int4*>(trow + j) : make_int4(0, 0, 0, 0);
}

// literal: byte value; match: 1<<31 | (len-3)<<15 | (dist-1)
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int32_t* __restrict__ ntok, const int32_t* __restrict__ tokens,
               uint8_t* out, int nt_pad, int no_pad) {
  extern __shared__ __align__(16) uint32_t cell[];
  __shared__ int part[2][3][kWarps];      // a chunk's warp sums, double buffered
  __shared__ uint32_t warp_max[kWarps];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* trow = tokens + (size_t)b * nt_pad;
  uint8_t* ob = out + (size_t)b * no_pad;   // read back too: never __restrict__
  int n = ntok[b];
  n = n < 0 ? 0 : n > nt_pad ? nt_pad : n;
  for (int i = tid; i < kCells; i += kThreads) cell[i] = 0;
  __syncthreads();

  int p = 0, k = 0, carry = 0, par = 0;   // next output byte, next token, cells carried
  // the chunk of tokens that holds k, in registers across rounds, and the
  // next one in flight
  int kb = 0;
  int4 cur = load_tokens(trow, 4 * tid, n), next = load_tokens(trow, kChunk + 4 * tid, n);
  for (;;) {
    const int w0 = p - carry;             // the window's first byte, a multiple of 16
    const int wend = min(w0 + kWindow, no_pad);
    // ---- 1. take the tokens that start before wend, a chunk at a time
    for (;;) {
      const int j0 = kb + 4 * tid;
      const int t[4] = {cur.x, cur.y, cur.z, cur.w};
      int len[4], sum = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = j0 + j >= k && j0 + j < n;
        len[j] = !live ? 0 : t[j] < 0 ? ((t[j] >> 15) & 0xFF) + 3 : 1;
        sum += len[j];
      }
      const int incl = warp_incl_sum(sum, lane);
      if (lane == 31) part[par][0][warp] = incl;
      __syncthreads();
      const int wv = lane < kWarps ? part[par][0][lane] : 0;
      const int before = __shfl_sync(FULL, warp_incl_sum(wv, lane) - wv, warp);
      int start = p + before + incl - sum, cnt = 0, took = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (len[j] && start < wend) {
          const int c = start - w0;
          cell[c] = (uint32_t)(c + 1) << 16
                    | (t[j] < 0 ? (uint32_t)(t[j] & 0x7FFF) : kLit | (uint32_t)(t[j] & 0xFF));
          ++cnt;
          took += len[j];
        }
        start += len[j];
      }
      cnt = warp_sum(cnt);
      took = warp_sum(took);
      if (lane == 0) {
        part[par][1][warp] = cnt;
        part[par][2][warp] = took;
      }
      __syncthreads();
      cnt = warp_sum(lane < kWarps ? part[par][1][lane] : 0);
      took = warp_sum(lane < kWarps ? part[par][2][lane] : 0);
      par ^= 1;
      const bool whole = cnt == min(n, kb + kChunk) - k;
      k += cnt;
      p += took;
      if (!whole || k >= n) break;
      kb += kChunk;
      cur = next;
      next = load_tokens(trow, kb + kChunk + 4 * tid, n);
    }
    const int e = min(p, no_pad) - w0;    // this round's bytes are cells [carry, e)
    const bool last = k >= n || p >= no_pad;

    // ---- 2. each byte's covering token: a running maximum of the markers
    const int piece = (e - carry + kThreads - 1) / kThreads * 32;
    const int lo = carry + warp * piece, hi = min(lo + piece, e);
    uint32_t run = 0;
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const uint32_t v = max(warp_incl_max(i < hi ? cell[i] : 0u, lane), run);
      if (i < hi) cell[i] = v;
      run = __shfl_sync(FULL, v, 31);
    }
    if (lane == 0) warp_max[warp] = run;
    __syncthreads();
    uint32_t prior = lane < warp ? warp_max[lane] : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) prior = max(prior, __shfl_xor_sync(FULL, prior, d));
    bool pointer = false;
    for (int i = lo + lane; i < hi; i += 32) {
      const uint32_t m = max(cell[i], prior);
      uint32_t st;
      if (m & kLit) {
        st = kDone | (m & 0xFF);
      } else {
        const int s = (int)(m >> 16) - 1, dist = (int)(m & 0x7FFF) + 1;
        const int src = s - dist + (i - s) % dist;
        if (src >= 0) {
          st = (uint32_t)src;
          pointer = true;
        } else {
          st = kDone | (w0 + src >= 0 ? ob[w0 + src] : 0u);
        }
      }
      cell[i] = st;
    }

    // ---- 3. pointer doubling in place
    if (__syncthreads_or(pointer)) {
      bool more;
      do {
        more = false;
        for (int i = carry + tid; i < e; i += kThreads) {
          const uint32_t st = cell[i];
          if (!(st & kDone)) {
            const uint32_t nx = cell[st];
            cell[i] = nx;
            more |= !(nx & kDone);
          }
        }
      } while (__syncthreads_or(more));
    }

    // ---- 4. the finished groups of 16 bytes out; the rest carried over
    const int keep = last ? (e + 15) & ~15 : e & ~15;
    for (int v = tid; v < keep / 16; v += kThreads) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 c = reinterpret_cast<const uint4*>(cell)[4 * v + q];
        const int i = 16 * v + 4 * q;
        w[q] = (i < e ? c.x & 0xFF : 0u) | (i + 1 < e ? c.y & 0xFF : 0u) << 8
               | (i + 2 < e ? c.z & 0xFF : 0u) << 16 | (i + 3 < e ? c.w & 0xFF : 0u) << 24;
      }
      reinterpret_cast<uint4*>(ob + w0)[v] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (last) break;
    const int next_carry = e - keep;
    const uint32_t keep_cell = tid < next_carry ? cell[keep + tid] : 0u;
    __syncthreads();
    for (int i = tid; i < e; i += kThreads) cell[i] = i < next_carry ? keep_cell : 0u;
    carry = next_carry;
    __syncthreads();
  }

  // ---- zero past the real output, 16 bytes a store
  uint4* ov = reinterpret_cast<uint4*>(ob);
  for (int v = ((min(p, no_pad) + 15) >> 4) + tid; v < (no_pad >> 4); v += kThreads)
    ov[v] = make_uint4(0, 0, 0, 0);
}

}  // namespace

extern "C" int resolve_launch(const void* ntok, const void* tokens, void* out,
                              int n_streams, int nt_pad, int no_pad, void* stream) {
  const int smem = kCells * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(resolve_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_streams > 0) {
    resolve_kernel<<<n_streams, kThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)ntok, (const int32_t*)tokens, (uint8_t*)out, nt_pad, no_pad);
  }
  return (int)cudaGetLastError();
}
