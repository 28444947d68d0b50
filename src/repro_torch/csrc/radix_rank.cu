// K6: one stable counting-rank pass of an LSD radix sort, the grouped
// build order of the hash join (kernels/hash_join/ops.py::_radix_order):
//
//   dest[i] = base[d_i] + #{j < i : d_j == d_i}
//
// for digits d in [0, B) and caller-given exclusive bucket offsets base.
// B is a parameter, 1 <= B <= 1024 (256 for the hash join's 8-bit
// digits; the partitioned tier's shard rank is the same function over
// P buckets).
//
// Replaces the TPU kernel
// src/repro/kernels/hash_join/hash_join.py::radix_rank_kernel, which
// walks its grid in order, carries the (256,) per-bucket running counts
// in VMEM from one step to the next and ranks inside a tile through a
// (rows x 256) one-hot cumsum. Hopper blocks run in no order, and the
// one-hot product is 256 times the work, so neither carries over.
//
// Bound: bytes, 8N (the digits read once, dest written once) plus B
// status words per tile.
//
// Design: one pass (Onesweep, Adinets and Merrill 2022, for one digit),
// one launch after one memset. The earlier kernel took three launches
// (tile histograms, a serial per-bucket scan of the (B, tiles) count
// matrix, then the rank), read the digits twice, and in its rank phase
// crossed four block barriers and summed 8 x B shared counters per 256
// rows. Now each block:
//
//   1. takes the next tile of kTile rows from an atomic counter, so every
//      earlier tile has started and a look-back never waits on a tile
//      that is not resident (the rule of scan_lookback.cuh);
//   2. ranks inside the tile as K10 does (shard_rank.cu), with the
//      counter rows widened to B buckets: each warp holds a contiguous
//      run of kWarpRows rows in registers (coalesced 4-byte loads, kRuns
//      in flight per lane), and per 32 rows one ballot per digit bit
//      groups the lanes by digit (__match_any_sync, which K10 uses, slows
//      with the distinct digits in a warp) and each group's lowest lane
//      adds the group's size to its warp's counter of that digit
//      (distinct digits, distinct counters: no atomics, no block barrier
//      in the walk);
//   3. turns the warps' counters into per-warp offsets inside the tile,
//      one thread per bucket, and publishes the tile's count of each
//      bucket as a 64-bit flag-and-value status word (flag A; tile 0
//      publishes its counts as inclusive prefixes, flag P);
//   4. looks back, one thread per bucket: it reads kWindow predecessors'
//      words of its bucket at once, waits while one it needs is empty,
//      sums the counts back to the nearest inclusive prefix and steps
//      kWindow tiles further back if there is none; then it publishes
//      its own inclusive prefix (flag P) and adds base[b] plus the
//      exclusive prefix to the warps' offsets;
//   5. walks each warp's run from registers again, 32 rows at a time,
//      with the peer masks kept from step 2: a row lands at its bucket's
//      counter plus its rank among its group's lanes, and the group's
//      lowest lane advances the counter; dest is written once.
//
// Status words are written with st.relaxed.gpu and read with
// ld.relaxed.gpu (scan_lookback.cuh's primitives): each word carries its
// whole payload, so no release fence and no acquire (an L1 invalidation
// per load) is needed; a predecessor that never publishes traps after
// kMaxPolls polls instead of hanging the card. Scratch: 1 + tiles * B
// 64-bit words, word 0 the tile counter and word 1 + t * B + b tile t's
// status of bucket b. The call zeroes it with one cudaMemsetAsync on its
// stream, so a captured CUDA graph resets it on every replay; each call
// owns its scratch.
//
// Tile 8 warps x 32 lanes x kRuns = 32 rows, look-back windows of 8
// words: on an NVIDIA H100 80GB HBM3 (700 W) with chip_sweep.py (CUDA-
// graph replays, two rounds) at (4,194,304,), B = 256, this kernel took
// 0.04143, 0.04170 ms; 16 rows per lane 0.04755, 0.04825; windows of 16
// words 0.04357, 0.04388; the peers from __match_any_sync 0.05424,
// 0.05440; acquire loads and release stores 0.05566, 0.05555 (the
// earlier three-launch kernel 0.09106, 0.09025).
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_lookback.cuh"

namespace {

namespace lb = repro::lookback;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRuns = 32;                  // rows per lane
constexpr int kWarpRows = 32 * kRuns;      // one warp's contiguous run
constexpr int kTile = kWarps * kWarpRows;  // rows per block
constexpr int kMaxBuckets = 1024;
constexpr int kBucketsPerThread = kMaxBuckets / kThreads;
constexpr int kWindow = 8;  // predecessors a look-back reads at once
constexpr unsigned kFull = 0xffffffffu;

// This lane's rows of the warp's run [lo, lo + kWarpRows): row
// lo + 32 j + lane in d[j], -1 past the end or outside [0, buckets).
__device__ __forceinline__ void load_run(const int* __restrict__ digits,
                                         int64_t lo, int n, int buckets,
                                         int (&d)[kRuns]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    const int64_t i = lo + j * 32 + lane;
    const int v = i < n ? __ldg(digits + i) : -1;
    d[j] = static_cast<unsigned>(v) < static_cast<unsigned>(buckets) ? v
                                                                      : -1;
  }
}

// The lanes whose key equals this lane's (keys < 2^bits), from one
// ballot per key bit. __match_any_sync does the same in one instruction,
// but its time grows with the distinct keys in the warp: at 256 uniform
// buckets nearly every lane holds its own.
__device__ __forceinline__ unsigned peers_of(int key, int bits) {
  unsigned peers = kFull;
#pragma unroll 4
  for (int i = 0; i < bits; ++i) {
    const bool one = (key >> i) & 1;
    const unsigned set = __ballot_sync(kFull, one);
    peers &= one ? set : ~set;
  }
  return peers;
}

// Adds the run's rows to the warp's counters wc[bucket]; keeps each
// step's peer mask (the lanes sharing the row's bucket; rows with no
// bucket take the key `buckets`, which no bucket has) for the rank walk.
__device__ __forceinline__ void count_run(const int (&d)[kRuns], int* wc,
                                          int buckets, int bits,
                                          unsigned (&peers)[kRuns]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    peers[j] = peers_of(d[j] >= 0 ? d[j] : buckets, bits);
    if (d[j] >= 0 && __ffs(peers[j]) - 1 == lane) {
      wc[d[j]] += __popc(peers[j]);
    }
    __syncwarp();
  }
}

// The exclusive prefix of bucket b in tile `tile` > 0: the rows of
// bucket b in every earlier tile. `status` points at tile 0's words.
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         int tile, int buckets, int b) {
  int excl = 0;
  for (int last = tile - 1;; last -= kWindow) {
    unsigned long long w[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      const int t = last - i;
      w[i] = t >= 0 ? lb::load_relaxed(status +
                                       static_cast<int64_t>(t) * buckets + b)
                    : lb::kPrefix;  // before tile 0: prefix 0
    }
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      long long polls = 0;
      while (w[i] < lb::kAggregate) {
        if (++polls == lb::kMaxPolls) __trap();
        w[i] = lb::load_relaxed(
            status + static_cast<int64_t>(last - i) * buckets + b);
      }
      excl += static_cast<int>(static_cast<unsigned>(w[i]));
      if (w[i] >= lb::kPrefix) return excl;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
radix_rank_kernel(const int* __restrict__ digits,
                  const int* __restrict__ base, int n, int buckets,
                  unsigned long long* __restrict__ scratch,
                  int* __restrict__ dest) {
  extern __shared__ int counters[];  // (kWarps, buckets)
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u));
  }
  int* wc = counters + warp * buckets;
  for (int b = lane; b < buckets; b += 32) wc[b] = 0;
  __syncthreads();
  const int tile = s_tile;
  unsigned long long* status = scratch + 1;
  unsigned long long* mine = status + static_cast<int64_t>(tile) * buckets;

  const int64_t lo = static_cast<int64_t>(tile) * kTile + warp * kWarpRows;
  int d[kRuns];
  unsigned peers[kRuns];
  load_run(digits, lo, n, buckets, d);
  count_run(d, wc, buckets, 32 - __clz(buckets), peers);
  __syncthreads();

  // per bucket: the warps' offsets inside the tile, the tile's count,
  // published at once
  int count[kBucketsPerThread];
#pragma unroll
  for (int j = 0; j < kBucketsPerThread; ++j) {
    const int b = threadIdx.x + j * kThreads;
    if (b >= buckets) break;
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = counters[w * buckets + b];
      counters[w * buckets + b] = run;
      run += c;
    }
    count[j] = run;
    lb::store_relaxed(mine + b,
                      lb::pack(tile == 0 ? lb::kPrefix : lb::kAggregate, run));
  }
  // the exclusive prefixes, then each bucket's inclusive one published
#pragma unroll
  for (int j = 0; j < kBucketsPerThread; ++j) {
    const int b = threadIdx.x + j * kThreads;
    if (b >= buckets) break;
    int excl = 0;
    if (tile > 0) {
      excl = look_back(status, tile, buckets, b);
      lb::store_relaxed(mine + b, lb::pack(lb::kPrefix, excl + count[j]));
    }
    const int off = base[b] + excl;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) counters[w * buckets + b] += off;
  }
  __syncthreads();

  // the rank walk: no block barrier
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    if (d[j] >= 0) dest[lo + j * 32 + lane] = wc[d[j]] + __popc(peers[j] & lt);
    __syncwarp();
    if (d[j] >= 0 && __ffs(peers[j]) - 1 == lane) wc[d[j]] += __popc(peers[j]);
    __syncwarp();
  }
}

int num_tiles(int n) {
  return static_cast<int>((static_cast<int64_t>(n) + kTile - 1) / kTile);
}

}  // namespace

extern "C" int repro_radix_rank_tiles(int n) { return num_tiles(n); }

// digits: (n,) int32 in [0, buckets); base: (buckets,) int32 exclusive
// bucket offsets, 1 <= buckets <= 1024; dest: (n,) int32 out; scratch:
// 1 + tiles * buckets 64-bit words, tiles = repro_radix_rank_tiles(n).
// A digit outside [0, buckets) is a caller error: its dest is left
// unwritten. Returns the CUDA error code of the memset and the launch (0
// on success), or cudaErrorInvalidValue for a bucket count outside
// [1, 1024].
extern "C" int repro_radix_rank(const void* digits, const void* base,
                                void* dest, void* scratch, int n,
                                int buckets, void* stream) {
  if (buckets < 1 || buckets > kMaxBuckets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = num_tiles(n);
  const cudaError_t e = cudaMemsetAsync(
      scratch, 0,
      (1 + static_cast<size_t>(tiles) * buckets) * sizeof(unsigned long long),
      st);
  if (e != cudaSuccess) return static_cast<int>(e);
  radix_rank_kernel<<<tiles, kThreads, kWarps * buckets * sizeof(int), st>>>(
      static_cast<const int*>(digits), static_cast<const int*>(base), n,
      buckets, static_cast<unsigned long long*>(scratch),
      static_cast<int*>(dest));
  return static_cast<int>(cudaGetLastError());
}
