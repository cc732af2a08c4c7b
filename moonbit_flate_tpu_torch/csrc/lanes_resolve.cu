// Kernel BC of the lane shard decode: token records -> output bytes.
//
// Replaces moonbit_flate_tpu/ops/lanes_resolve.py:resolve_waves (the
// Pallas kernel _make_kernel_bc).  The TPU has no scatter, so its kernel
// advances every stream one output byte a step and resolves copy chains
// by pointer doubling inside 128-byte blocks.  What it computes is plain
// LZ77 expansion: byte p < outlen of a stream is its literal or the byte
// dist before it, overlapping copies (len > dist) byte by byte, and bytes
// past outlen are 0.
//
// On the H100 one warp expands one stream in order, its 4 KiB history in
// shared memory (8 streams a block, 32 KB).  The work is bound by the
// bytes it must move (token rows in, output words out) and by the serial
// order of the matches.  The warp reads 32 token rows at a time (one
// coalesced 128-byte load; rows of a stream are contiguous within a
// 128-row chunk of the lane-major layout), finds each record's output
// offset with a warp prefix sum of the lengths, writes all literals of
// the 32 rows at once, then runs the matches in order: a match of
// length len at position p fills byte p + q from p - dist + q % dist,
// which lies before p, so the whole match is one parallel copy however
// much it overlaps.  Then the warp writes its 1024 output words, 32
// consecutive words a store.
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
constexpr int WARPS = 8;           // streams per block
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(WARPS * 32)
lanes_resolve_kernel(const int32_t* __restrict__ outlen,
                     const int32_t* __restrict__ tok_lm,
                     int32_t* __restrict__ out, int n_streams) {
  __shared__ uint32_t hist[WARPS][SEGB / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sid = blockIdx.x * WARPS + warp;
  if (sid >= n_streams) return;                 // whole warps only
  const int w = sid / NSTR, r = sid % NSTR;
  uint32_t* hw = hist[warp];
  uint8_t* hb = reinterpret_cast<uint8_t*>(hw);
  for (int i = lane; i < SEGB / 4; i += 32) hw[i] = 0;
  __syncwarp();

  int n = outlen[sid];
  n = n < 0 ? 0 : n > SEGB ? SEGB : n;
  // row k of stream r at tok_lm[((w * TOK_CHUNKS + k / 128) * NSTR + r) * LANE + k % 128]
  const int32_t* trow = tok_lm + ((size_t)w * TOK_CHUNKS * NSTR + r) * LANE;
  int p = 0;
  for (int k0 = 0; k0 < TOK_ROWS && p < n; k0 += 32) {
    const int k = k0 + lane;
    const int32_t t = trow[(size_t)(k >> 7) * NSTR * LANE + (k & 127)];
    const int mlen = (t >> 13) & 511;
    const bool copy = t < 0 && mlen > 0;
    const int len = t == 0 ? 0 : copy ? mlen : 1;
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    const int start = p + incl - len;
    if (t > 0 && start < n) hb[start] = (uint8_t)(t & 255);
    __syncwarp();
    unsigned todo = __ballot_sync(FULL, copy && start < n);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int32_t mt = __shfl_sync(FULL, t, src);
      const int ms = __shfl_sync(FULL, start, src);
      const int dist = mt & 8191;
      const int m = min((mt >> 13) & 511, n - ms);
      for (int q = lane; q < m; q += 32) {
        const int s = dist > 0 ? ms - dist + q % dist : -1;
        hb[ms + q] = s >= 0 ? hb[s] : 0;
      }
      __syncwarp();
    }
    p += __shfl_sync(FULL, incl, 31);
  }

  // word i of stream r at out[((w * GROUPS + i / 128) * NSTR + r) * LANE + i % 128]
  int32_t* orow = out + ((size_t)w * GROUPS * NSTR + r) * LANE;
  for (int i = lane; i < SEGB / 4; i += 32)
    orow[(size_t)(i >> 7) * NSTR * LANE + (i & 127)] = (int32_t)hw[i];
}

}  // namespace

extern "C" int lanes_resolve_launch(const void* outlen, const void* tok_lm, void* out,
                                    int n_streams, void* stream) {
  if (n_streams > 0) {
    lanes_resolve_kernel<<<(n_streams + WARPS - 1) / WARPS, WARPS * 32, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)outlen, (const int32_t*)tok_lm, (int32_t*)out, n_streams);
  }
  return (int)cudaGetLastError();
}
