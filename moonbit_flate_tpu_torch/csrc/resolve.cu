// Stage B of the scalar-path decode: packed token records -> output bytes.
//
// Replaces moonbit_flate_tpu/ops/resolve_pallas.py:resolve_batch_pallas
// (the Pallas kernel _make_kernel).  The TPU kernel is one scalar pass a
// stream over a (stream, 8 KiB output chunk) grid, with a 32 KB circular
// history window and a token slab in SMEM.  On the H100 the stream's own
// output in global memory is the history, so there is no window, no slab
// and no chunking: one warp expands one stream in order.  The work is
// bound by the bytes it must move (tokens in, bytes out) and by the
// serial order of the matches.  The warp reads 32 tokens at a time (one
// coalesced 128-byte load), finds each record's output offset with a warp
// prefix sum of the lengths, writes the literals of the 32 records at
// once, then runs the matches in order: a match of length len at offset p
// fills byte p + q from p - dist + q % dist, which lies before p, so the
// whole match is one parallel copy however much it overlaps (len > dist
// repeats).  __syncwarp() orders one match's stores before the next
// one's loads.  Last, the warp zero-fills the row past the real output.
//
// Tokens past ntok[b] are ignored and output stops at no_pad bytes.  A
// source before the stream's start reads as 0 (the TPU kernel reads
// whatever its window held there; the parser never emits such a token).
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

// literal: byte value; match: 1<<31 | (len-3)<<15 | (dist-1)
__global__ void __launch_bounds__(32)
resolve_kernel(const int32_t* __restrict__ ntok, const int32_t* __restrict__ tokens,
               uint8_t* out, int nt_pad, int no_pad) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const int32_t* trow = tokens + (size_t)b * nt_pad;
  uint8_t* ob = out + (size_t)b * no_pad;
  int n = ntok[b];
  n = n < 0 ? 0 : n > nt_pad ? nt_pad : n;
  int p = 0;
  for (int k0 = 0; k0 < n && p < no_pad; k0 += 32) {
    const int k = k0 + lane;
    const bool have = k < n;
    const int32_t t = have ? trow[k] : 0;
    const bool copy = have && t < 0;
    const int len = !have ? 0 : copy ? ((t >> 15) & 0xFF) + 3 : 1;
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    const int start = p + incl - len;
    if (have && !copy && start < no_pad) ob[start] = (uint8_t)(t & 0xFF);
    __syncwarp();
    unsigned todo = __ballot_sync(FULL, copy && start < no_pad);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int32_t mt = __shfl_sync(FULL, t, src);
      const int ms = __shfl_sync(FULL, start, src);
      const int dist = (mt & 0x7FFF) + 1;
      const int m = min(((mt >> 15) & 0xFF) + 3, no_pad - ms);
      for (int q = lane; q < m; q += 32) {
        const int s = ms - dist + q % dist;
        ob[ms + q] = s >= 0 ? ob[s] : (uint8_t)0;
      }
      __syncwarp();
    }
    p += __shfl_sync(FULL, incl, 31);
  }
  p = p < no_pad ? p : no_pad;
  // zero past the real output: bytes up to a word boundary, then words
  const int pw = (p + 3) & ~3;
  if (p + lane < pw) ob[p + lane] = 0;
  int32_t* ow = reinterpret_cast<int32_t*>(ob);
  for (int i = (pw >> 2) + lane; i < (no_pad >> 2); i += 32) ow[i] = 0;
}

}  // namespace

extern "C" int resolve_launch(const void* ntok, const void* tokens, void* out,
                              int n_streams, int nt_pad, int no_pad, void* stream) {
  if (n_streams > 0) {
    resolve_kernel<<<n_streams, 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ntok, (const int32_t*)tokens, (uint8_t*)out, nt_pad, no_pad);
  }
  return (int)cudaGetLastError();
}
