// Greedy deflateFast parse with lazy match extension, B segments a call.
//
// Replaces moonbit_flate_tpu/ops/walk_pallas.py:walk_batch (the Pallas
// kernel _make_kernel), which walks a segment in 8192-position chunks
// on the TPU's scalar core, carrying the cursor and the next block
// boundary across a sequential grid.
//
// What bounds it on the H100: done as one walk, a segment is one chain of
// dependent loads on one thread, three to five a step, while the rest of
// the card idles; bytes (about 19 a position with the four output
// arrays) and operations stay far below their limits.  The only state
// the walk carries is the cursor: the next block boundary is a function
// of the position alone, so the outcome at a candidate q (rejected, or
// accepted with a final length) is a pure function of q, the data and
// the matcher's (length, distance) at q, and the committed tokens are
// the positions reached from ctx under next(q) = q + step(q), step = the
// final length at an accepted candidate and 1 anywhere else.  The design
// cuts the chain into four kernels:
//
//   1. extend (one thread a position, the whole grid): verifies and
//      extends every candidate exactly as the walk would on reaching it,
//      8 bytes a step through aligned 32-bit loads and funnel shifts, and
//      writes step[b, q] as uint16.  It reads the matcher's mlen and dist
//      directly: no packed copy and no candidate bitmask are made.
//   2. tile exits (one block a tile of kTile positions): the tile's steps
//      sit in shared memory as jump[p] = p + step[p]; pointer doubling in
//      place (at most 13 rounds, ended early once every jump has left the
//      tile) gives, for each of the 258 offsets at which a walk can enter
//      the tile (a step is at most 258), the offset at which it enters
//      the next tile.  The tile that holds ctx also records the exit of
//      the walk's start.
//   3. stitch (one thread a segment): follows the entry through the
//      tiles' exit tables, one short dependent load a tile.
//   4. mark (one block a tile): pointer doubling again, now double
//      buffered so that round k jumps exactly 2^k steps, spreading a
//      visited mark from the tile's true entry; every thread then writes
//      committed, match_start, the final length and the distance of its
//      positions, so no row is zeroed first and no scan follows.
//
// No step is serial over more than the tiles of a segment.  The work is
// about 13 shared-memory rounds a position in kernels 2 and 4 instead of
// a global-memory chain a token.
//
// Rules kept from the TPU walk: the first block boundary is ctx + 65535;
// lengths clip at n - q, at 258 and at the next boundary; only sort
// candidates (len == 4, dist > 4) are verified (first 4 bytes) and
// extended, 8 bytes per step then a byte-exact tail; exact lengths from
// the lag tables are taken as they are.  A candidate whose clipped
// length is under 3 is no match (a literal), as in the plain twin.  Data
// bytes come straight from the staged uint8[S + 320] buffer, whose zero
// pad covers every read up to q + 258 + 8 + 8.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 65535;     // MAX_STORE_BLOCK_SIZE
constexpr int kMaxMatch = 258;    // MAX_MATCH_LENGTH, the longest step
constexpr int kMinMatch = 3;      // MIN_MATCH_LENGTH
constexpr int kSortCap = 4;       // SORT_CAP
constexpr int kZLags = 4;         // Z_LAGS
constexpr int kTile = 8192;       // positions a tile (ops/walk.py: TILE)
constexpr int kSlots = 260;       // exit table: 258 entries, the start's, a pad
constexpr int kStartSlot = 258;
constexpr int kRounds = 13;       // 2^13 steps cross a tile
constexpr int kThreads = 512;
constexpr unsigned kNoEntry = 0xFFFFu;

static_assert(1 << kRounds >= kTile, "pointer doubling must cross a tile");
static_assert(kTile + kMaxMatch <= 65536, "tile offsets are uint16");

// The 4 bytes at shift / 8 past the aligned word lo, little endian.
__device__ __forceinline__ uint32_t take(uint32_t lo, uint32_t hi, unsigned shift) {
  return __funnelshift_r(lo, hi, shift);
}

// Length of the agreement of seg[q..] with seg[q - d..], clipped at max_l;
// 0 where the first 4 bytes differ (the candidate is rejected).
__device__ int extend(const uint8_t* seg, int q, int d, int max_l) {
  const uintptr_t pa = (uintptr_t)(seg + q), pb = pa - (uintptr_t)d;
  const uint32_t* wa = (const uint32_t*)(pa & ~(uintptr_t)3);
  const uint32_t* wb = (const uint32_t*)(pb & ~(uintptr_t)3);
  const unsigned sa = (unsigned)(pa & 3) * 8, sb = (unsigned)(pb & 3) * 8;
  uint32_t a0 = wa[0], a1 = wa[1], b0 = wb[0], b1 = wb[1];
  if (take(a0, a1, sa) != take(b0, b1, sb)) return 0;
  if (max_l <= kSortCap) return max_l;
  int le = kSortCap, k = 1;       // bytes le.. start in words wa[k], wb[k]
  for (;;) {
    a0 = a1;
    b0 = b1;
    a1 = wa[k + 1];
    b1 = wb[k + 1];
    const uint32_t a2 = wa[k + 2], b2 = wb[k + 2];
    const uint32_t lo = take(a0, a1, sa) ^ take(b0, b1, sb);
    const uint32_t hi = take(a1, a2, sa) ^ take(b1, b2, sb);
    if (le + 8 <= max_l && (lo | hi) == 0) {
      le += 8;
      k += 2;
      a1 = a2;
      b1 = b2;
      continue;
    }
    const int tail = lo ? (__ffs((int)lo) - 1) >> 3 : hi ? 4 + ((__ffs((int)hi) - 1) >> 3) : 8;
    return le + min(tail, max_l - le);
  }
}

__global__ void __launch_bounds__(256)
extend_kernel(const uint8_t* __restrict__ data, long long data_stride,
              const int32_t* __restrict__ mlen, const int32_t* __restrict__ dist,
              uint16_t* __restrict__ step, const int32_t* __restrict__ ctx_arr,
              const int32_t* __restrict__ n_arr, int s) {
  const int g = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= s) return;
  const size_t at = (size_t)g * s + q;
  const int l0 = mlen[at];
  int st = 1;
  if (l0 >= kMinMatch) {
    const int ctx = ctx_arr[g], n = n_arr[g];
    if (q >= ctx) {
      const int d = dist[at];
      const int nbe = ctx + ((q - ctx) / kBlock + 1) * kBlock;  // next block boundary
      const int max_l = min(min(kMaxMatch, n - q), nbe - q);
      int len = min(l0, max_l);
      if (d > kZLags && l0 == kSortCap)
        len = extend(data + (long long)g * data_stride, q, d, max_l);
      if (len >= kMinMatch) st = len;
    }
  }
  step[at] = (uint16_t)st;
}

// jump[p] = p + step[p] for the tile's positions (1 past the segment's
// end), the identity from kTile on.
__device__ __forceinline__ void load_jumps(uint16_t* jump, const uint16_t* __restrict__ step,
                                           int g, int t, int s) {
  for (int p = threadIdx.x; p < kTile + kMaxMatch; p += kThreads) {
    const int q = t * kTile + p;
    jump[p] = (uint16_t)(p < kTile ? p + (q < s ? step[(size_t)g * s + q] : 1) : p);
  }
}

__global__ void __launch_bounds__(kThreads)
exits_kernel(const uint16_t* __restrict__ step, uint16_t* __restrict__ exits,
             const int32_t* __restrict__ ctx_arr, int s, int ntiles) {
  __shared__ uint16_t jump[kTile + kMaxMatch];
  const int g = blockIdx.y, t = blockIdx.x;
  load_jumps(jump, step, g, t, s);
  __syncthreads();
  // in place: a jump read while another thread moves it on is still a
  // position of the same walk, and never less far than a round ago
  for (int r = 0; r < kRounds; ++r) {
    bool out = true;
    for (int p = threadIdx.x; p < kTile; p += kThreads) {
      const uint16_t j = jump[jump[p]];
      jump[p] = j;
      out = out && j >= kTile;
    }
    if (__syncthreads_and(out)) break;
  }
  uint16_t* tab = exits + ((size_t)g * ntiles + t) * kSlots;
  for (int e = threadIdx.x; e < kMaxMatch; e += kThreads) tab[e] = (uint16_t)(jump[e] - kTile);
  const int c = ctx_arr[g] - t * kTile;
  if (threadIdx.x == 0 && c >= 0 && c < kTile) tab[kStartSlot] = (uint16_t)(jump[c] - kTile);
}

__global__ void stitch_kernel(const uint16_t* __restrict__ exits, uint16_t* __restrict__ entry,
                              const int32_t* __restrict__ ctx_arr, int batch, int ntiles) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= batch) return;
  const int ctx = ctx_arr[g];
  const int t0 = min(max(ctx, 0) / kTile, ntiles);
  uint16_t* ent = entry + (size_t)g * ntiles;
  const uint16_t* tab = exits + (size_t)g * ntiles * kSlots;
  for (int t = 0; t < t0; ++t) ent[t] = (uint16_t)kNoEntry;
  if (t0 == ntiles) return;
  ent[t0] = (uint16_t)(ctx - t0 * kTile);
  unsigned e = tab[(size_t)t0 * kSlots + kStartSlot];
  for (int t = t0 + 1; t < ntiles; ++t) {
    ent[t] = (uint16_t)e;
    e = tab[(size_t)t * kSlots + e];
  }
}

__global__ void __launch_bounds__(kThreads)
mark_kernel(const uint16_t* __restrict__ step, const int32_t* __restrict__ dist,
            const uint16_t* __restrict__ entry, const int32_t* __restrict__ ctx_arr,
            const int32_t* __restrict__ n_arr, uint8_t* __restrict__ committed,
            uint8_t* __restrict__ match_start, int32_t* __restrict__ mlen2,
            int32_t* __restrict__ dist2, int s, int ntiles) {
  __shared__ uint16_t jump_a[kTile + kMaxMatch];
  __shared__ uint16_t jump_b[kTile + kMaxMatch];
  __shared__ uint8_t seen[kTile];
  const int g = blockIdx.y, t = blockIdx.x;
  const unsigned e = entry[(size_t)g * ntiles + t];
  const bool entered = e != kNoEntry;       // the same for the whole block
  if (entered) {
    load_jumps(jump_a, step, g, t, s);
    for (int p = threadIdx.x; p < kTile + kMaxMatch; p += kThreads) {
      if (p < kTile) seen[p] = p == (int)e;
      else jump_b[p] = (uint16_t)p;
    }
    __syncthreads();
    // round k: cur jumps exactly 2^k steps, so the marks reach the first
    // 2^(k+1) positions of the walk; a mark set while it is read only
    // marks a later position of the same walk early
    uint16_t* cur = jump_a;
    uint16_t* nxt = jump_b;
    for (int r = 0; r < kRounds; ++r) {
      bool out = true;
      for (int p = threadIdx.x; p < kTile; p += kThreads) {
        const uint16_t j = cur[p];
        if (j < kTile) {
          out = false;
          if (seen[p]) seen[j] = 1;
        }
        nxt[p] = cur[j];
      }
      if (__syncthreads_and(out)) break;
      uint16_t* const swap = cur;
      cur = nxt;
      nxt = swap;
    }
  }
  const int ctx = ctx_arr[g], n = n_arr[g];
  for (int p = threadIdx.x; p < kTile; p += kThreads) {
    const int q = t * kTile + p;
    if (q >= s) break;
    const size_t at = (size_t)g * s + q;
    const bool v = entered && seen[p] && q >= ctx && q < n;
    const int st = v ? step[at] : 0;
    const bool m = st >= kMinMatch;
    committed[at] = v;
    match_start[at] = m;
    mlen2[at] = m ? st : 0;
    dist2[at] = m ? dist[at] : 0;
  }
}

}  // namespace

// phases: 1 extend, 2 tile exits, 4 stitch, 8 mark; a caller passes 15,
// a timing harness one phase at a time on arrays an earlier call filled.
extern "C" int walk_launch(const void* data, long long data_stride, const void* mlen,
                           const void* dist, const void* ctx, const void* n, void* step,
                           void* exits, void* entry, void* committed, void* match_start,
                           void* mlen2, void* dist2, int batch, int s, int phases,
                           void* stream) {
  if (batch > 0 && s > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int ntiles = (s + kTile - 1) / kTile;
    const dim3 tiles(ntiles, batch);
    if (phases & 1) {
      extend_kernel<<<dim3((s + 255) / 256, batch), 256, 0, st>>>(
          (const uint8_t*)data, data_stride, (const int32_t*)mlen, (const int32_t*)dist,
          (uint16_t*)step, (const int32_t*)ctx, (const int32_t*)n, s);
    }
    if (phases & 2) {
      exits_kernel<<<tiles, kThreads, 0, st>>>((const uint16_t*)step, (uint16_t*)exits,
                                               (const int32_t*)ctx, s, ntiles);
    }
    if (phases & 4) {
      stitch_kernel<<<(batch + 63) / 64, 64, 0, st>>>(
          (const uint16_t*)exits, (uint16_t*)entry, (const int32_t*)ctx, batch, ntiles);
    }
    if (phases & 8) {
      mark_kernel<<<tiles, kThreads, 0, st>>>(
          (const uint16_t*)step, (const int32_t*)dist, (const uint16_t*)entry,
          (const int32_t*)ctx, (const int32_t*)n, (uint8_t*)committed,
          (uint8_t*)match_start, (int32_t*)mlen2, (int32_t*)dist2, s, ntiles);
    }
  }
  return (int)cudaGetLastError();
}
