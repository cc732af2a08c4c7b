// Greedy deflateFast parse with lazy match extension, one segment per block.
//
// Replaces moonbit_flate_tpu/ops/walk_pallas.py:walk_batch (the Pallas
// kernel _make_kernel), which walks a segment in 8192-position chunks
// on the TPU's scalar core, carrying the cursor and the next block
// boundary across a sequential grid.  The parse is serial within a
// segment, so on the H100 it is bound by the latency of one thread's
// dependent loads, not by bytes or operations (the bytes alone, about
// 9.1 per position, would take well under a millisecond).  The design
// keeps it simple: block g walks segment g from start to end in one
// loop on thread 0 (B segments run side by side in one launch), after
// all threads of the block have zeroed the segment's output row.  It
// skips literal runs 32 positions per load through the match-presence
// bitmask, and reads data bytes straight from the staged
// uint8[S + 320] buffer, whose zero pad covers every read up to
// q + 258 + 8, so no history window is copied.
//
// Rules kept from the TPU walk: the first block boundary is ctx + 65535;
// lengths clip at n - q, at 258 and at the next boundary; only sort
// candidates (len == 4, dist > 4) are verified (first 4 bytes) and
// extended, 8 bytes per step then a byte-exact tail; exact lengths from
// the lag tables are taken as they are.  Output: (dist << 9 | len) at
// committed match starts and 0 everywhere else.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 65535;     // MAX_STORE_BLOCK_SIZE
constexpr int kMaxMatch = 258;    // MAX_MATCH_LENGTH
constexpr int kSortCap = 4;       // SORT_CAP
constexpr int kZLags = 4;         // Z_LAGS

__device__ __forceinline__ uint64_t load64(const uint8_t* p) {
  uint64_t x = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) x |= (uint64_t)p[k] << (8 * k);
  return x;
}

__device__ __forceinline__ uint32_t load32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

__global__ void walk_kernel(const uint8_t* __restrict__ data,
                            long long data_stride,
                            const int32_t* __restrict__ bits,
                            const int32_t* __restrict__ minfo,
                            int32_t* __restrict__ minfo_out,
                            const int32_t* __restrict__ ctx_arr,
                            const int32_t* __restrict__ n_arr, int s_pad) {
  const int g = blockIdx.x;
  const int nwb = s_pad / 32;
  const uint8_t* seg = data + (long long)g * data_stride;
  const uint32_t* bw = (const uint32_t*)bits + (long long)g * nwb;
  const int32_t* mi = minfo + (long long)g * s_pad;
  int32_t* mo = minfo_out + (long long)g * s_pad;

  for (int i = threadIdx.x; i < s_pad; i += blockDim.x) mo[i] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int ctx = ctx_arr[g];
  const int n = n_arr[g];
  int cur = ctx;
  int nbe = ctx + kBlock;  // next 65535-byte block boundary
  while (cur < s_pad) {
    int wi = cur >> 5;
    uint32_t word = bw[wi] & (0xFFFFFFFFu << (cur & 31));
    while (word == 0 && wi + 1 < nwb) word = bw[++wi];
    if (word == 0) break;
    const int q = wi * 32 + (__ffs(word) - 1);
    const int info = mi[q];
    const int d = info >> 9;
    const int l0 = info & 511;
    while (nbe <= q) nbe += kBlock;
    const int max_l = min(min(kMaxMatch, n - q), nbe - q);
    const uint8_t* a = seg + q;
    const uint8_t* b = seg + q - d;
    const bool is_cand = (d > kZLags) && (l0 == kSortCap);
    if (is_cand && load32(a) != load32(b)) {  // reject: rescan from q + 1
      cur = q + 1;
      continue;
    }
    int len = min(l0, max_l);
    if (is_cand && max_l > kSortCap) {
      int le = kSortCap;
      while (le + 8 <= max_l && load64(a + le) == load64(b + le)) le += 8;
      const uint64_t x = load64(a + le) ^ load64(b + le);
      const int tail = x ? (__ffsll((long long)x) - 1) >> 3 : 8;
      len = le + min(tail, max_l - le);
    }
    mo[q] = (d << 9) | len;
    cur = q + len;
  }
}

}  // namespace

extern "C" int walk_launch(const void* data, long long data_stride,
                           const void* bits, const void* minfo,
                           void* minfo_out, const void* ctx, const void* n,
                           int batch, int s_pad, void* stream) {
  if (batch > 0) {
    walk_kernel<<<batch, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, data_stride, (const int32_t*)bits,
        (const int32_t*)minfo, (int32_t*)minfo_out, (const int32_t*)ctx,
        (const int32_t*)n, s_pad);
  }
  return (int)cudaGetLastError();
}
