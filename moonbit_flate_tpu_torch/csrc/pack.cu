// LSB-first bit packing of (value, width) units into 32-bit words.
//
// pack_batch_launch replaces both Pallas kernels of
// moonbit_flate_tpu/ops/pack.py: pack_units_dense (_place_kernel, which
// ORs [3, 128]-word entities built by a dense XLA merge into the output)
// is its one-row case, pack_units_dense_batch (_make_place_kernel_batch,
// the same merge with a segment axis) its general one.  On the H100 the
// work is bound by memory: each unit is read (value and width) and each
// output word written, with next to no arithmetic.  So the design drops
// the TPU's entity/row merge.  B independent packs, the bit offsets
// computed inside, in int32 (the caller checks that a row's bits fit).
// Two kernels, each on a grid of (tiles of kTileUnits units, rows):
//
//   1. tile_sums_kernel: each tile's total width, and the zeroing of a
//      share of the row's words (the tiles' edge words are OR-ed in);
//   2. pack_batch_kernel: a tile's offset is the sum of the row's
//      earlier tile sums (at most a few hundred ints, read by the whole
//      block); each warp scans the widths of its 256 units with warp
//      shuffles and ORs every unit's bits into the tile's words in shared
//      memory; the words strictly inside the tile's bit range go out with
//      plain coalesced stores, the first and last with atomicOr, since a
//      neighbouring tile may share them.  Units never share bits, so the
//      result does not depend on the order of the atomics.  The last tile
//      writes the row's total bits.
//
// No prefix sum runs before the launch and no offsets are read back: the
// offsets cost a second read of the widths and a few hundred ints a tile.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kTileUnits = 2048;                        // units a tile
constexpr int kPerLane = kTileUnits / kPackThreads;     // units a lane
constexpr int kMaxWidth = 28;
// words a tile's bits can touch: its bits, plus one word for a start
// inside a word
constexpr int kTileWords = (kTileUnits * kMaxWidth + 31) / 32 + 1;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

__global__ void __launch_bounds__(kPackThreads)
tile_sums_kernel(const int32_t* __restrict__ widths, int32_t* __restrict__ sums,
                 uint32_t* __restrict__ words, long long nu, long long n_words, int ntiles) {
  __shared__ int part[kPackWarps];
  const int row = blockIdx.y, t = blockIdx.x, lane = threadIdx.x & 31;
  const int32_t* w = widths + (long long)row * nu;
  const long long u0 = (long long)t * kTileUnits;
  int s = 0;
  for (int i = threadIdx.x; i < kTileUnits; i += kPackThreads)
    if (u0 + i < nu) s += w[u0 + i];
  s = warp_sum(s);
  if (lane == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = warp_sum(lane < kPackWarps ? part[lane] : 0);
    if (lane == 0) sums[(long long)row * ntiles + t] = s;
  }
  const long long share = (n_words + ntiles - 1) / ntiles;
  const long long lo = t * share, hi = min(lo + share, n_words);
  uint32_t* wrow = words + (long long)row * n_words;
  for (long long i = lo + threadIdx.x; i < hi; i += kPackThreads) wrow[i] = 0;
}

__global__ void __launch_bounds__(kPackThreads)
pack_batch_kernel(const int32_t* __restrict__ values, const int32_t* __restrict__ widths,
                   const int32_t* __restrict__ sums, uint32_t* __restrict__ words,
                   int32_t* __restrict__ bits, long long nu, long long n_words, int ntiles) {
  __shared__ uint32_t acc[kTileWords];
  __shared__ int earlier[kPackWarps], mine[kPackWarps];
  const int row = blockIdx.y, t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kTileWords; i += kPackThreads) acc[i] = 0;
  // the row's bits before this tile, a share a warp
  int before = 0;
  for (int j = threadIdx.x; j < t; j += kPackThreads) before += sums[(long long)row * ntiles + j];
  before = warp_sum(before);
  // this warp's 256 units, lane-interleaved: unit u0 + 32 c + lane
  const long long base = (long long)row * nu;
  const long long u0 = (long long)t * kTileUnits + warp * (32 * kPerLane);
  int wd[kPerLane], val[kPerLane], total = 0;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const long long u = u0 + 32 * c + lane;
    wd[c] = u < nu ? widths[base + u] : 0;
    val[c] = u < nu ? values[base + u] : 0;
    total += wd[c];
  }
  total = warp_sum(total);
  if (lane == 0) {
    earlier[warp] = before;
    mine[warp] = total;
  }
  __syncthreads();
  const int e = lane < kPackWarps ? earlier[lane] : 0;
  const int m = lane < kPackWarps ? mine[lane] : 0;
  const int tile_off = warp_sum(e), tile_bits = warp_sum(m);
  int off = tile_off + warp_sum(lane < warp ? m : 0);
  const int first = tile_off >> 5;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    int incl = wd[c];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    const uint32_t w = (uint32_t)wd[c];
    if (w) {
      const int at = off + incl - wd[c];
      const uint32_t v = (uint32_t)val[c] & ((1u << w) - 1u);
      const uint32_t sh = (uint32_t)(at & 31);
      const int wi = (at >> 5) - first;
      const uint32_t lo = v << sh;
      const uint32_t hi = (v >> 1) >> (31 - sh);  // v >> (32 - sh), also for sh == 0
      if (lo) atomicOr(acc + wi, lo);
      if (hi) atomicOr(acc + wi + 1, hi);
    }
    off += __shfl_sync(FULL, incl, 31);
  }
  __syncthreads();
  const int nw = tile_bits ? ((tile_off + tile_bits + 31) >> 5) - first : 0;
  uint32_t* wrow = words + (long long)row * n_words;
  for (int i = threadIdx.x; i < nw && first + i < n_words; i += kPackThreads) {
    const uint32_t x = acc[i];
    if (i > 0 && i < nw - 1) wrow[first + i] = x;
    else if (x) atomicOr(wrow + first + i, x);
  }
  if (t == ntiles - 1 && threadIdx.x == 0) bits[row] = tile_off + tile_bits;
}

}  // namespace

// phases: 1 tile sums and zeroing, 2 scan and place, 3 both (a call);
// tile_sums is int32[rows, ntiles] scratch, ntiles = max(1, ceil(nu / 2048)).
extern "C" int pack_batch_launch(const void* values, const void* widths, void* words,
                                 void* bits, void* tile_sums, long long rows, long long nu,
                                 long long n_words, int phases, void* stream) {
  if (rows > 65535) return (int)cudaErrorInvalidConfiguration;
  if (rows > 0) {
    const int ntiles = nu > 0 ? (int)((nu + kTileUnits - 1) / kTileUnits) : 1;
    const dim3 grid((unsigned)ntiles, (unsigned)rows);
    cudaStream_t st = (cudaStream_t)stream;
    if (phases & 1)
      tile_sums_kernel<<<grid, kPackThreads, 0, st>>>(
          (const int32_t*)widths, (int32_t*)tile_sums, (uint32_t*)words, nu, n_words, ntiles);
    if (phases & 2)
      pack_batch_kernel<<<grid, kPackThreads, 0, st>>>(
          (const int32_t*)values, (const int32_t*)widths, (const int32_t*)tile_sums,
          (uint32_t*)words, (int32_t*)bits, nu, n_words, ntiles);
  }
  return (int)cudaGetLastError();
}
