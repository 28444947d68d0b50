// One-pass device-wide inclusive int32 scan by decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016), shared by the compaction prefix count (compact.cu),
// the group boundaries (group_build.cu) and the running segment ids
// (expand.cu). Its memory-order primitives also serve K6's per-bucket
// look-back (radix_rank.cu), K8's arrival counter (decode_attention.cu)
// and K5's (segment_reduce.cu).
//
// The TPU kernels these replace walk their grid in order and carry a
// running total from one tile to the next in SMEM. Hopper blocks run
// concurrently and in no order, so each tile finds its carry itself:
//
//   1. the block's first thread takes the next tile index from a counter
//      (atomicAdd), so every earlier tile has already started and the
//      look-back below cannot wait on a tile that is not resident;
//   2. the block loads its tile once (16-byte loads, warp-striped: lane
//      l of warp w holds 4 consecutive elements of each 128-element
//      stripe of the warp's run), turns the elements into terms where
//      the Op has a prologue, scans the terms in registers with warp
//      shuffles, and publishes the tile's aggregate (flag A);
//   3. one warp reads the 32 nearest predecessors' status words, waits
//      while any is still empty (flag X), sums the aggregates back to
//      the nearest inclusive prefix (flag P), and steps 32 tiles further
//      back if it finds none;
//   4. the block publishes its own inclusive prefix (flag P), adds its
//      exclusive prefix to its registers and stores the tile once.
//
// A status word is 64 bits: the flag in the high half, the int32 value
// in the low half, so one store publishes both. Words are written with
// st.release.gpu and read with ld.acquire.gpu, never with a cached load.
//
// Scratch: (tiles + 1) 64-bit words, word 0 the tile counter and word
// 1 + t tile t's status. launch_lookback zeroes it with one
// cudaMemsetAsync on the launch stream, so a captured CUDA graph resets
// it on every replay; each call owns its scratch, so two calls on two
// streams never share a word.
//
// An Op supplies the operands and the epilogue:
//   const int* in   the elements (read once);
//   int* out        the output (written once);
//   int  emit(v)    the value stored for the inclusive sum v;
//   kPrologue       false where the elements are the terms (K1, K4);
//                   true where prologue<kVec>(v, first, n) turns this
//                   thread's loaded elements into terms in place after
//                   the tile's loads and stores a side output through
//                   the pointer `side` (K3: boundary flags from sorted
//                   keys, the predecessors from the registers of this
//                   and the neighbouring lanes).
//
// Bound: memory, 8 bytes per element (one int32 read, one written; K3
// 12, with its side output).
//
// Tile: 256 threads x 32 items = 8192 elements, eight 16-byte loads in
// flight per thread (32 KB a block; 48 registers, five blocks an SM).
// Chosen on an H100 (NVIDIA H100 80GB HBM3, 700 W) by rebuilding with
// kItems = k: at 2^24 elements k = 8, 16, 32, 48, 64 took 0.0905,
// 0.0675, 0.0622, 0.0647, 0.0648 ms (CUDA-graph replays), so the bytes
// a block keeps in flight decide the time, and past 32 items the lower
// occupancy costs more than they give. What is left above the bound is mostly
// the wait for the predecessors' status words. A wider look-back (128
// or 256 words a step), backoff in the poll, relaxed instead of acquire
// loads, persistent blocks that prefetch their next tile, and a
// separate look-back warp started before the tile's own loads were each
// no faster.
//
// A pointer that is not 16-byte aligned takes the scalar instance of
// the kernel (same layout, 4-byte loads); a length that is not a
// multiple of 4 ends in scalar loads in the last tile. Sums are int32
// and wrap as the plain version's do: callers keep every running total
// below 2^31.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"  // warp_inclusive_scan

namespace repro {
namespace lookback {

constexpr int kThreads = 256;
constexpr int kItems = 32;                    // per thread
constexpr int kRounds = kItems / 4;           // 16-byte loads per thread
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRun = 32 * kItems;         // contiguous elements a warp
constexpr int kTile = kThreads * kItems;
static_assert(kItems % 4 == 0, "items per thread must be a multiple of 4");

// status word flags, in the high 32 bits; X (not ready) is 0
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
// a predecessor that has not published after this many polls has been
// lost (a fault, never a slow tile): trap instead of hanging the card
constexpr long long kMaxPolls = 1ll << 26;

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Relaxed device-scope access to a status word that carries its whole
// payload (flag and value in one 64-bit word): nothing else is
// published with it, so a load needs no acquire (which invalidates the
// SM's L1 after each load) and a store no release fence. K6's look-back
// makes one such access per bucket and thread, 256 per block.
__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// atomic p += v at device scope, returning the old value: a release of
// the caller's earlier writes and an acquire of what the writers of the
// earlier values released (K8's arrival counter)
__device__ __forceinline__ unsigned fetch_add_acq_rel(unsigned* p,
                                                      unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long pack(unsigned long long flag,
                                                  int v) {
  return flag | static_cast<unsigned int>(v);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The exclusive prefix of tile `tile` > 0: the sum of every earlier
// tile's terms. Called by one whole warp; every lane returns it. Lane l
// reads predecessor last - l; the warp waits while any word is X, sums
// back to the nearest inclusive prefix and steps 32 tiles further back
// if there is none.
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         int tile) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int last = tile - 1;; last -= 32) {
    const int t = last - lane;
    unsigned long long w = t >= 0 ? load_acquire(status + t)
                                  : kPrefix;  // before tile 0: prefix 0
    long long polls = 0;
    while (__any_sync(0xffffffffu, w < kAggregate)) {
      if (++polls == kMaxPolls) __trap();
      if (w < kAggregate) w = load_acquire(status + t);
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, w >= kPrefix);
    // the lanes up to the nearest inclusive prefix contribute
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    excl += warp_sum(lane <= stop ? static_cast<int>(
                                        static_cast<unsigned int>(w))
                                  : 0);
    if (prefixes) return excl;
  }
}

template <class Op, bool kVec>
__global__ void __launch_bounds__(kThreads)
lookback_scan_kernel(Op op, int n, unsigned long long* __restrict__ scratch) {
  __shared__ int s_tile;
  __shared__ int s_warp[kWarps];  // warp totals, then warp offsets
  __shared__ int s_prefix;        // the tile's exclusive prefix
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u));
  }
  __syncthreads();
  const int tile = s_tile;
  unsigned long long* status = scratch + 1;
  // lane l of warp w holds elements first + 128 r + k (k < 4) of round r
  const int64_t first = static_cast<int64_t>(tile) * kTile +
                        warp * kWarpRun + lane * 4;

  int v[kItems];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = first + r * 128;
    if (kVec && i + 3 < n) {
      const int4 q = *reinterpret_cast<const int4*>(op.in + i);
      v[4 * r] = q.x;
      v[4 * r + 1] = q.y;
      v[4 * r + 2] = q.z;
      v[4 * r + 3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * r + k] = i + k < n ? op.in[i + k] : 0;
    }
  }
  if constexpr (Op::kPrologue) op.template prologue<kVec>(v, first, n);

  // inclusive scan of the warp's run, one 128-element stripe per round
  int carry = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    v[4 * r + 1] += v[4 * r];
    v[4 * r + 2] += v[4 * r + 1];
    v[4 * r + 3] += v[4 * r + 2];
    const int own = v[4 * r + 3];
    const int incl = warp_inclusive_scan(own);
    const int off = carry + incl - own;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[4 * r + k] += off;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();

  if (warp == 0) {
    const int t = lane < kWarps ? s_warp[lane] : 0;
    const int ti = warp_inclusive_scan(t);
    const int agg = __shfl_sync(0xffffffffu, ti, kWarps - 1);
    if (lane < kWarps) s_warp[lane] = ti - t;
    int prefix = 0;
    if (tile == 0) {
      if (lane == 0) store_release(status, pack(kPrefix, agg));
    } else {
      if (lane == 0) store_release(status + tile, pack(kAggregate, agg));
      prefix = look_back(status, tile);
      if (lane == 0) store_release(status + tile, pack(kPrefix, prefix + agg));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();

  const int off = s_prefix + s_warp[warp];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = first + r * 128;
    if (kVec && i + 3 < n) {
      *reinterpret_cast<int4*>(op.out + i) = make_int4(
          op.emit(off + v[4 * r]), op.emit(off + v[4 * r + 1]),
          op.emit(off + v[4 * r + 2]), op.emit(off + v[4 * r + 3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i + k < n) op.out[i + k] = op.emit(off + v[4 * r + k]);
      }
    }
  }
}

inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }

// Zeroes the scratch ((num_tiles(n) + 1) words) and launches the scan
// on `stream`: the 16-byte instance when every pointer is 16-byte
// aligned, else the scalar one. Returns the first CUDA error code.
template <class Op>
int launch_lookback(Op op, int n, void* scratch, cudaStream_t stream) {
  const int tiles = num_tiles(n);
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0, (tiles + 1) * sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* words = static_cast<unsigned long long*>(scratch);
  uintptr_t bits = reinterpret_cast<uintptr_t>(op.in) |
                  reinterpret_cast<uintptr_t>(op.out);
  if constexpr (Op::kPrologue) bits |= reinterpret_cast<uintptr_t>(op.side);
  const bool aligned = (bits & 15) == 0;
  if (aligned) {
    lookback_scan_kernel<Op, true><<<tiles, kThreads, 0, stream>>>(op, n,
                                                                  words);
  } else {
    lookback_scan_kernel<Op, false><<<tiles, kThreads, 0, stream>>>(op, n,
                                                                   words);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lookback
}  // namespace repro
