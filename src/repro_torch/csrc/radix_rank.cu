// K6: one stable counting-rank pass of an LSD radix sort, the grouped
// build order of the hash join (kernels/hash_join/ops.py::_radix_order):
//
//   dest[i] = base[d_i] + #{j < i : d_j == d_i}
//
// for digits d in [0, B) and caller-given exclusive bucket offsets base.
// B is a parameter (256 for the hash join's 8-bit digits; the
// partitioned tier's shard rank is the same function over P buckets).
//
// Replaces the TPU kernel
// src/repro/kernels/hash_join/hash_join.py::radix_rank_kernel, which
// walks its grid in order, carries the (256,) per-bucket running counts
// in VMEM from one step to the next and ranks inside a tile through a
// (rows x 256) one-hot cumsum. Hopper blocks run in no order, and the
// one-hot product is 256 times the work, so neither carries over. Three
// launches instead, on the caller's stream:
//
//   1. tile_histogram_kernel: each block counts the digits of one tile of
//      kTile rows in shared memory (warp-aggregated with
//      __match_any_sync, so a tile of equal digits costs one atomic per
//      warp) and writes its column of the bucket-major (B, tiles) count
//      matrix;
//   2. bucket_scan_kernel: one block per bucket turns its row of the
//      matrix into exclusive offsets in tile order, starting at base[b];
//   3. tile_rank_kernel: each block walks its tile in order, 256 rows at
//      a time. Inside a warp __match_any_sync gives the lanes with the
//      same digit and __popc(peers & lanemask_lt) the rank among them;
//      per-warp digit counts in shared memory, summed over the earlier
//      warps, give the rank inside the 256 rows, and a per-bucket running
//      count (seeded from phase 2) carries it across the tile.
//
// Bound: memory. 8N bytes per pass (digits read once, dest written once)
// plus the count matrix; phases 1 and 3 both read the digits, so the
// kernel moves 12N.
#include "scan.cuh"

namespace {

using repro::kItems;
using repro::kThreads;
using repro::kTile;
using repro::kWarps;

constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
tile_histogram_kernel(const int* __restrict__ digits, int n, int buckets,
                      int tiles, int* __restrict__ counts) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < buckets; b += kThreads) hist[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
#pragma unroll 4
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    const int raw = i < n ? digits[i] : -1;
    const bool ok = static_cast<unsigned>(raw) < static_cast<unsigned>(buckets);
    const unsigned peers = __match_any_sync(kFull, ok ? raw : -1 - lane);
    if (ok && (__ffs(peers) - 1) == lane) atomicAdd(&hist[raw], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < buckets; b += kThreads) {
    counts[static_cast<int64_t>(b) * tiles + blockIdx.x] = hist[b];
  }
}

__global__ void __launch_bounds__(kThreads)
bucket_scan_kernel(int* __restrict__ counts, const int* __restrict__ base,
                   int tiles) {
  int* row = counts + static_cast<int64_t>(blockIdx.x) * tiles;
  int carry = base[blockIdx.x];
  for (int t0 = 0; t0 < tiles; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const int v = t < tiles ? row[t] : 0;
    int total;
    const int ex = repro::block_exclusive_scan(v, &total);
    if (t < tiles) row[t] = carry + ex;
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
tile_rank_kernel(const int* __restrict__ digits, int n, int buckets,
                 int tiles, const int* __restrict__ offsets,
                 int* __restrict__ dest) {
  extern __shared__ int sm[];
  int* running = sm;                // (buckets,) rows ranked so far + offset
  int* warp_cnt = sm + buckets;     // (kWarps, buckets) this chunk's counts
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int b = threadIdx.x; b < buckets; b += kThreads) {
    running[b] = offsets[static_cast<int64_t>(b) * tiles + blockIdx.x];
  }
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int j = 0; j < kItems; ++j) {
    for (int k = threadIdx.x; k < kWarps * buckets; k += kThreads) {
      warp_cnt[k] = 0;
    }
    __syncthreads();
    const int64_t i = base + j * kThreads + threadIdx.x;
    const int raw = i < n ? digits[i] : -1;
    const bool ok = static_cast<unsigned>(raw) < static_cast<unsigned>(buckets);
    // rows past the end and bad digits get a key no other lane has
    const unsigned peers = __match_any_sync(kFull, ok ? raw : -1 - lane);
    const int rank = __popc(peers & lt);
    if (ok && rank == 0) warp_cnt[warp * buckets + raw] = __popc(peers);
    __syncthreads();
    if (ok) {
      int r = running[raw] + rank;
      for (int w = 0; w < warp; ++w) r += warp_cnt[w * buckets + raw];
      dest[i] = r;
    }
    __syncthreads();
    for (int b = threadIdx.x; b < buckets; b += kThreads) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_cnt[w * buckets + b];
      running[b] += s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int repro_radix_rank_tiles(int n) { return repro::num_tiles(n); }

// digits: (n,) int32 in [0, buckets); base: (buckets,) int32 exclusive
// bucket offsets; dest: (n,) int32 out; counts: (buckets * tiles) int32
// scratch, tiles = repro_radix_rank_tiles(n). A digit outside
// [0, buckets) is a caller error: its dest is left unwritten. Returns the
// CUDA error code of the launches (0 on success).
extern "C" int repro_radix_rank(const void* digits, const void* base,
                                void* dest, void* counts, int n,
                                int buckets, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = repro::num_tiles(n);
  const int* d = static_cast<const int*>(digits);
  int* c = static_cast<int*>(counts);
  tile_histogram_kernel<<<tiles, kThreads, buckets * sizeof(int), st>>>(
      d, n, buckets, tiles, c);
  bucket_scan_kernel<<<buckets, kThreads, 0, st>>>(
      c, static_cast<const int*>(base), tiles);
  tile_rank_kernel<<<tiles, kThreads, (kWarps + 1) * buckets * sizeof(int),
                     st>>>(d, n, buckets, tiles, c, static_cast<int*>(dest));
  return static_cast<int>(cudaGetLastError());
}
