// LSB-first bit packing of (value, width) units into 32-bit words.
//
// Replaces moonbit_flate_tpu/ops/pack.py:pack_units_dense (the Pallas
// kernel _place_kernel, which ORs [3, 128]-word entities built by a
// dense XLA merge into the output).  On the H100 the work is bound by
// memory: each unit is read once (value, width and its bit offset) and
// each output word written once, with no arithmetic to speak of.  So
// the design drops the TPU's entity/row merge and gives every unit one
// thread: the unit's bits land in at most two words, OR-ed in with
// atomicOr.  Units never share bits, so the result does not depend on
// the order of the atomics.  Offsets come from an exclusive prefix sum
// the caller computes before the launch.
//
// pack_batch_kernel replaces pack_units_dense_batch of that Python
// module (_make_place_kernel_batch, the same merge with a segment axis): the
// same thread per unit on a 2-D grid, one grid row per segment, all
// segments in one launch.
#include <cstdint>
#include <cuda_runtime.h>

// One unit: mask the value to its width and OR its (at most two) words
// into the row of n_words words; words at or past n_words are dropped.
__device__ __forceinline__ void place_unit(int32_t value, int32_t width,
                                           long long off,
                                           uint32_t* __restrict__ words,
                                           long long n_words) {
  uint32_t w = (uint32_t)width;
  if (w == 0) return;
  uint32_t v = (uint32_t)value & ((1u << w) - 1u);
  long long wi = off >> 5;
  uint32_t sh = (uint32_t)(off & 31);
  uint32_t lo = v << sh;
  // v >> (32 - sh) without a shift by 32 when sh == 0
  uint32_t hi = (v >> 1) >> (31 - sh);
  if (wi < n_words && lo) atomicOr(words + wi, lo);
  if (wi + 1 < n_words && hi) atomicOr(words + wi + 1, hi);
}

__global__ void pack_kernel(const int32_t* __restrict__ values,
                            const int32_t* __restrict__ widths,
                            const int64_t* __restrict__ offsets,
                            uint32_t* __restrict__ words,
                            long long nu, long long n_words) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nu) return;
  place_unit(values[i], widths[i], offsets[i], words, n_words);
}

// The batched pack: row blockIdx.y of [rows, nu] units goes into row
// blockIdx.y of [rows, n_words] words, with offsets that restart at 0
// in every row.  Rows never share a word.
__global__ void pack_batch_kernel(const int32_t* __restrict__ values,
                                  const int32_t* __restrict__ widths,
                                  const int64_t* __restrict__ offsets,
                                  uint32_t* __restrict__ words,
                                  long long nu, long long n_words) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nu) return;
  long long u = (long long)blockIdx.y * nu + i;
  place_unit(values[u], widths[u], offsets[u],
             words + (long long)blockIdx.y * n_words, n_words);
}

extern "C" int pack_launch(const void* values, const void* widths,
                           const void* offsets, void* words, long long nu,
                           long long n_words, void* stream) {
  const int threads = 256;
  if (nu > 0) {
    long long blocks = (nu + threads - 1) / threads;
    pack_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)values, (const int32_t*)widths,
        (const int64_t*)offsets, (uint32_t*)words, nu, n_words);
  }
  return (int)cudaGetLastError();
}

extern "C" int pack_batch_launch(const void* values, const void* widths,
                                 const void* offsets, void* words,
                                 long long rows, long long nu,
                                 long long n_words, void* stream) {
  const int threads = 256;
  if (rows > 65535) return (int)cudaErrorInvalidConfiguration;
  if (rows > 0 && nu > 0) {
    dim3 grid((unsigned)((nu + threads - 1) / threads), (unsigned)rows);
    pack_batch_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)values, (const int32_t*)widths,
        (const int64_t*)offsets, (uint32_t*)words, nu, n_words);
  }
  return (int)cudaGetLastError();
}
