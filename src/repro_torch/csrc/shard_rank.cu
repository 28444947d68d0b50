// K10: the stable shard rank of the partitioned data tier's exchange
// (sharding/data.py, the layout step):
//
//   out[i] = base[d_i] + #{j < i : d_j == d_i}
//
// for shard destinations d in [0, P), P <= 32, and caller-given exclusive
// bucket offsets base (arange(P) * blk for the bucket-major exchange).
//
// Replaces the TPU kernel
// src/repro/kernels/partition/partition.py::shard_rank_kernel, which walks
// its grid in order, carries the (P,) running counts in VMEM from one
// step to the next and ranks inside a tile through a (rows x P) one-hot
// cumsum. Hopper blocks run in no order, so the carry becomes three
// launches on the caller's stream, as for K6 (radix_rank.cu) — but sized
// for P <= 32 buckets, where one warp's row of 32 shared-memory counters
// holds every bucket:
//
//   1. tile_count_kernel: each block takes one tile of kTile rows, each of
//      its warps a contiguous run of kWarpRows rows, which every lane
//      loads into registers (kRuns coalesced loads in flight). Per 32
//      rows, __match_any_sync groups the lanes by bucket and the lowest
//      lane of each group adds the group's size to its warp's counter of
//      that bucket (distinct buckets, distinct counters: no atomics); the
//      warps' counters are summed into the block's column of the
//      bucket-major (P, tiles) count matrix;
//   2. bucket_scan_kernel: one block per bucket turns its row of the
//      matrix into exclusive offsets in tile order, starting at base[p];
//   3. tile_rank_kernel: each warp loads and counts its run again
//      (keeping the peer masks), sets its counters to the tile offset
//      plus the earlier warps' counts, then walks its run from registers
//      32 rows at a time: a row lands at its bucket's counter plus its
//      rank among the group's lanes (__popc(peers & lanemask_lt)), and
//      the group's lowest lane then advances the counter. No block-wide
//      barrier inside the walk.
//
// Bound: memory. 8N bytes (d read once, out written once) plus the
// (P, tiles) count matrix; phases 1 and 3 both read d, so the kernel
// moves 12N from device memory.
#include "scan.cuh"

namespace {

using repro::kThreads;
using repro::kTile;
using repro::kWarps;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBuckets = 32;
constexpr int kWarpRows = kTile / kWarps;  // one warp's contiguous run
constexpr int kRuns = kWarpRows / 32;      // rows per lane

// This lane's rows of the warp's run [lo, lo + kWarpRows): row
// lo + 32 j + lane in d[j], -1 past the end or outside [0, buckets).
__device__ __forceinline__ void load_run(const int* __restrict__ dest,
                                         int64_t lo, int n, int buckets,
                                         int (&d)[kRuns]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    const int64_t i = lo + j * 32 + lane;
    const int v = i < n ? __ldg(dest + i) : -1;
    d[j] = static_cast<unsigned>(v) < static_cast<unsigned>(buckets) ? v
                                                                      : -1;
  }
}

// The lanes sharing row j's bucket (a row with no bucket matches only
// itself).
__device__ __forceinline__ unsigned peers_of(int d) {
  const int lane = threadIdx.x & 31;
  return __match_any_sync(kFull, d >= 0 ? d : -1 - lane);
}

// Adds the run's rows to the warp's counters wc[bucket]; keeps each
// step's peer mask for the rank walk.
__device__ __forceinline__ void count_run(const int (&d)[kRuns], int* wc,
                                          unsigned (&peers)[kRuns]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    peers[j] = peers_of(d[j]);
    if (d[j] >= 0 && __ffs(peers[j]) - 1 == lane) {
      wc[d[j]] += __popc(peers[j]);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
tile_count_kernel(const int* __restrict__ dest, int n, int buckets,
                  int tiles, int* __restrict__ counts) {
  __shared__ int warp_cnt[kWarps][kMaxBuckets];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kTile
                     + warp * kWarpRows;
  int d[kRuns];
  unsigned peers[kRuns];
  load_run(dest, lo, n, buckets, d);
  warp_cnt[warp][lane] = 0;
  __syncwarp();
  count_run(d, warp_cnt[warp], peers);
  __syncthreads();
  if (threadIdx.x < buckets) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_cnt[w][threadIdx.x];
    counts[static_cast<int64_t>(threadIdx.x) * tiles + blockIdx.x] = s;
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
tile_rank_kernel(const int* __restrict__ dest, int n, int buckets,
                 int tiles, const int* __restrict__ offsets,
                 int* __restrict__ out) {
  __shared__ int warp_cnt[kWarps][kMaxBuckets];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kTile
                     + warp * kWarpRows;
  int d[kRuns];
  unsigned peers[kRuns];
  load_run(dest, lo, n, buckets, d);
  int* wc = warp_cnt[warp];
  wc[lane] = 0;
  __syncwarp();
  count_run(d, wc, peers);
  __syncthreads();
  // lane p: where this warp's first row of bucket p goes
  int next = 0;
  if (lane < buckets) {
    next = offsets[static_cast<int64_t>(lane) * tiles + blockIdx.x];
    for (int w = 0; w < warp; ++w) next += warp_cnt[w][lane];
  }
  __syncthreads();  // every warp has read the counts it needs
  wc[lane] = next;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    if (d[j] >= 0) {
      out[lo + j * 32 + lane] = wc[d[j]] + __popc(peers[j] & lt);
    }
    __syncwarp();
    if (d[j] >= 0 && __ffs(peers[j]) - 1 == lane) {
      wc[d[j]] += __popc(peers[j]);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int repro_shard_rank_tiles(int n) { return repro::num_tiles(n); }

// dest: (n,) int32 in [0, buckets); base: (buckets,) int32 exclusive
// offsets, 1 <= buckets <= 32; out: (n,) int32; counts: (buckets * tiles)
// int32 scratch, tiles = repro_shard_rank_tiles(n). A destination outside
// [0, buckets) is a caller error: its out is left unwritten. Returns the
// CUDA error code of the launches (0 on success), or cudaErrorInvalidValue
// for a bucket count outside [1, 32].
extern "C" int repro_shard_rank(const void* dest, const void* base, void* out,
                                void* counts, int n, int buckets,
                                void* stream) {
  if (buckets < 1 || buckets > kMaxBuckets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = repro::num_tiles(n);
  const int* d = static_cast<const int*>(dest);
  int* c = static_cast<int*>(counts);
  tile_count_kernel<<<tiles, kThreads, 0, st>>>(d, n, buckets, tiles, c);
  bucket_scan_kernel<<<buckets, kThreads, 0, st>>>(
      c, static_cast<const int*>(base), tiles);
  tile_rank_kernel<<<tiles, kThreads, 0, st>>>(d, n, buckets, tiles, c,
                                               static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
