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
#include <cstdint>
#include <cuda_runtime.h>

__global__ void pack_kernel(const int32_t* __restrict__ values,
                            const int32_t* __restrict__ widths,
                            const int64_t* __restrict__ offsets,
                            uint32_t* __restrict__ words,
                            long long nu, long long n_words) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nu) return;
  uint32_t w = (uint32_t)widths[i];
  if (w == 0) return;
  uint32_t v = (uint32_t)values[i] & ((1u << w) - 1u);
  long long off = offsets[i];
  long long wi = off >> 5;
  uint32_t sh = (uint32_t)(off & 31);
  uint32_t lo = v << sh;
  // v >> (32 - sh) without a shift by 32 when sh == 0
  uint32_t hi = (v >> 1) >> (31 - sh);
  if (wi < n_words && lo) atomicOr(words + wi, lo);
  if (wi + 1 < n_words && hi) atomicOr(words + wi + 1, hi);
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
