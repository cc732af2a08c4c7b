// The subset of CUDA that the sources of csrc/ use, for a host compiler:
// one OS thread a CUDA thread, the blocks of a launch one after another.
// kernels/emulate.py puts this directory first on the include path, so a
// kernel source's #include <cuda_runtime.h> finds this file, rewrites its
// launch statements into emu_launch calls, and its dynamic shared array
// (extern __shared__ T name[];) into a pointer to emu_dynamic_shared, the
// buffer emu_launch makes for the launch's blocks.  It exists to test a
// kernel's logic on a machine without a card; it says nothing of speed
// and cannot show a race that only real warps would run into.
#pragma once
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) uint2 { uint32_t x, y; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return uint2{a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return uint4{a, b, c, d}; }
inline int4 make_int4(int a, int b, int c, int d) { return int4{a, b, c, d}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidConfiguration = 9;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// every launch gets the dynamic shared memory it asks for
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }

// the read-only path is a plain load here
template <class T>
inline T __ldg(const T* p) { return *p; }

// shared and global words alike: the host's atomic on plain memory
inline unsigned atomicOr(unsigned* a, unsigned v) { return __atomic_fetch_or(a, v, __ATOMIC_RELAXED); }

// A barrier of n threads that spins with yields, then naps: the threads
// of a warp meet here every few steps, and sleeping on a condition
// variable each time costs far more than the work between two meetings;
// a warp that waits for another's long stretch of work should not burn a
// core meanwhile.
struct EmuBarrier {
  int n = 0;
  std::atomic<int> waiting{0};
  std::atomic<unsigned> generation{0};
  void wait() {
    const unsigned g = generation.load(std::memory_order_acquire);
    if (waiting.fetch_add(1, std::memory_order_acq_rel) + 1 == n) {
      waiting.store(0, std::memory_order_relaxed);
      generation.store(g + 1, std::memory_order_release);
      return;
    }
    for (int spins = 0; generation.load(std::memory_order_acquire) == g; ++spins) {
      if (spins < 2000) std::this_thread::yield();
      else std::this_thread::sleep_for(std::chrono::microseconds(100));
    }
  }
};
struct EmuWarp {
  EmuBarrier bar;
  uint64_t slot[32];
};
struct EmuBlock {
  EmuBarrier bar;
  std::atomic<int> all{1};
  std::atomic<int> any{0};
  std::vector<EmuWarp> warps;
};

inline dim3 blockDim, gridDim;
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local EmuBlock* emu_block;
inline thread_local EmuWarp* emu_warp;
inline thread_local int emu_lane;
inline unsigned char* emu_dynamic_shared;

inline void __syncthreads() { emu_block->bar.wait(); }
inline int __syncthreads_and(int pred) {
  if (!pred) emu_block->all.store(0);
  emu_block->bar.wait();
  const int r = emu_block->all.load();
  emu_block->bar.wait();
  if (threadIdx.x == 0) emu_block->all.store(1);
  emu_block->bar.wait();
  return r;
}
inline int __syncthreads_or(int pred) {
  if (pred) emu_block->any.store(1);
  emu_block->bar.wait();
  const int r = emu_block->any.load();
  emu_block->bar.wait();
  if (threadIdx.x == 0) emu_block->any.store(0);
  emu_block->bar.wait();
  return r;
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { emu_warp->bar.wait(); }
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  uint64_t x = 0;
  std::memcpy(&x, &v, sizeof(T));
  emu_warp->slot[emu_lane] = x;
  emu_warp->bar.wait();
  const uint64_t y = emu_warp->slot[src & 31];
  emu_warp->bar.wait();
  T r;
  std::memcpy(&r, &y, sizeof(T));
  return r;
}
// lane i gets the value of lane i - d, or keeps its own below d
template <class T>
inline T __shfl_up_sync(unsigned m, T v, int d) {
  return __shfl_sync(m, v, emu_lane >= d ? emu_lane - d : emu_lane);
}
template <class T>
inline T __shfl_xor_sync(unsigned m, T v, int x) { return __shfl_sync(m, v, emu_lane ^ x); }
inline unsigned __ballot_sync(unsigned, int pred) {
  emu_warp->slot[emu_lane] = pred ? 1 : 0;
  emu_warp->bar.wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)emu_warp->slot[i] << i;
  emu_warp->bar.wait();
  return r;
}
inline unsigned __match_any_sync(unsigned, int v) {
  emu_warp->slot[emu_lane] = (uint64_t)(int64_t)v;
  emu_warp->bar.wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if (emu_warp->slot[i] == (uint64_t)(int64_t)v) r |= 1u << i;
  emu_warp->bar.wait();
  return r;
}
inline int __reduce_min_sync(unsigned, int v) {
  emu_warp->slot[emu_lane] = (uint64_t)(int64_t)v;
  emu_warp->bar.wait();
  int r = v;
  for (int i = 0; i < 32; ++i) r = std::min(r, (int)(int64_t)emu_warp->slot[i]);
  emu_warp->bar.wait();
  return r;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)(((((uint64_t)hi) << 32) | lo) >> (s & 31));
}

// Runs fn once for every thread of every block.  The block's threads are
// made once and take the blocks in order, a barrier between two blocks;
// they share one buffer of `shared` bytes of dynamic shared memory.
// Block sizes are multiples of 32 (every kernel here has such).
inline void emu_launch(dim3 grid, dim3 block, size_t shared, const std::function<void()>& fn) {
  blockDim = block;
  gridDim = grid;
  std::vector<uint4> dynamic_shared((shared + 15) / 16);
  emu_dynamic_shared = reinterpret_cast<unsigned char*>(dynamic_shared.data());
  const int nt = (int)(block.x * block.y * block.z);
  EmuBlock ctx;
  ctx.bar.n = nt;
  ctx.warps = std::vector<EmuWarp>((nt + 31) / 32);
  for (size_t w = 0; w < ctx.warps.size(); ++w) ctx.warps[w].bar.n = std::min(32, nt - (int)w * 32);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t, 0, 0);
      emu_block = &ctx;
      emu_warp = &ctx.warps[t / 32];
      emu_lane = t % 32;
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; ++bx) {
            blockIdx = dim3(bx, by, bz);
            fn();
            ctx.bar.wait();
          }
    });
  for (auto& t : threads) t.join();
}
