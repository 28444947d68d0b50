// K10: the stable shard rank of the partitioned data tier's exchange
// (sharding/data.py, the layout step):
//
//   out[i] = base[d_i] + #{j < i : d_j == d_i}
//
// for shard destinations d in [0, P), 1 <= P <= 32, and caller-given
// exclusive bucket offsets base (arange(P) * blk for the bucket-major
// exchange).
//
// Replaces the TPU kernel
// src/repro/kernels/partition/partition.py::shard_rank_kernel, which walks
// its grid in order, carries the (P,) running counts in VMEM from one
// step to the next and ranks inside a tile through a (rows x P) one-hot
// cumsum. Hopper blocks run in no order, so the carry becomes a decoupled
// look-back over per-bucket status words, as K6's (radix_rank.cu), sized
// for P <= 32 buckets: one warp's lanes hold every bucket.
//
// Bound: bytes, 8N (d read once, out written once) plus P status words
// per tile.
//
// Design: one launch after one memset (the earlier kernel took three
// launches and read d twice). Each block:
//
//   1. takes the next tile of kTile rows from an atomic counter, so every
//      earlier tile has started and a look-back never waits on a tile
//      that is not resident (the rule of scan_lookback.cuh);
//   2. each warp loads its contiguous run of kWarpRows rows into
//      registers once (bucket_rank.cuh's load_run, which K6 shares) and
//      counts it 32 rows a step (count_ranks): for P <= kPerBucketMax one
//      ballot per bucket, lane b keeping bucket b's running count in a
//      register; above it one ballot per bucket bit (peers_of;
//      kMatchAny: __match_any_sync), the group's lowest lane reading and
//      advancing the warp's shared counter of the bucket. Each row's
//      rank among its run's rows of its bucket is packed beside its
//      destination in the same register;
//   3. after one block barrier, warp 0 turns the warps' counts into
//      per-warp offsets inside the tile, lane b for bucket b, and
//      publishes the tile's count of each bucket as a 64-bit
//      flag-and-value status word (flag A; tile 0 its counts as inclusive
//      prefixes, flag P);
//   4. the block looks back (look_back): with the buckets rounded up to
//      span = 2^s, warp w reads row w of a window, lane l bucket l % span
//      of predecessor w * 32 / span + l / span back, so one window of
//      kWindowWarps rows of 32 words covers kWindowWarps * 32 / span
//      predecessors of every bucket (64 at P = 4 with 8 warps, 8 at
//      P = 32); each warp waits while a word it needs is empty and sums
//      each bucket's lanes back to the row's nearest inclusive prefix
//      with xor shuffles that never cross buckets; the rows combine in
//      order through shared memory, and the block steps a window further
//      back while a bucket has found none. Lane b of warp 0 then
//      publishes bucket b's inclusive prefix (flag P);
//   5. lane b of each warp holds base[b] plus the exclusive prefix plus
//      the warp's offset in the tile, and each row lands at its bucket's
//      lane's value (one shuffle) plus its packed rank: out is written
//      once, with no shared memory and no barrier.
//
// Tile 8 warps x 32 lanes x 32 rows, per-bucket ballots up to 4 buckets,
// look-back windows of 8 rows: on an NVIDIA H100 80GB HBM3 (700 W) with
// chip_sweep.py (CUDA-graph replays, two rounds) at (4,194,304,) into
// P = 4 / P = 32 this kernel took 0.01911, 0.01918 / 0.03382, 0.03402 ms;
// per-bucket ballots up to 8 buckets 0.02404, 0.02403 at P = 4 (more
// registers); __match_any_sync above 4 buckets 0.03861, 0.03867 at
// P = 32; windows of one warp's row (one warp looking back) 0.02268,
// 0.02244 / 0.04667, 0.04651, of four rows 0.01903, 0.01904 / 0.04219,
// 0.04206; 16 rows per lane 0.02116, 0.02100 / 0.03634, 0.03654 (the
// earlier three-launch kernel 0.02457, 0.02494 / 0.05647, 0.05654).
//
// Status words are written with st.relaxed.gpu and read with
// ld.relaxed.gpu (scan_lookback.cuh's primitives): each word carries its
// whole payload, so no fence is needed; a predecessor that never
// publishes traps after kMaxPolls polls instead of hanging the card.
// Scratch: 1 + tiles * P 64-bit words, word 0 the tile counter and word
// 1 + t * P + b tile t's status of bucket b. The call zeroes it with one
// cudaMemsetAsync on its stream, so a captured CUDA graph resets it on
// every replay; each call owns its scratch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bucket_rank.cuh"
#include "scan_lookback.cuh"

namespace {

namespace lb = repro::lookback;
namespace rk = repro::rank;
using rk::kFull;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRuns = 32;                  // rows per lane
constexpr int kWarpRows = 32 * kRuns;      // one warp's contiguous run
constexpr int kTile = kWarps * kWarpRows;  // rows per block
constexpr int kMaxBuckets = 32;
// Up to this many buckets a warp groups its lanes with one ballot per
// bucket and keeps each bucket's running count in a register (lane b:
// bucket b); above it with one ballot per bucket bit (or, kMatchAny,
// __match_any_sync) and a row of counters in shared memory.
constexpr int kPerBucketMax = 4;
constexpr bool kMatchAny = false;
// warps that read a row of a look-back window; compile-time, since a
// per-thread select on the word made ptxas spill at P > 4 (PERF.md, PR 22)
constexpr int kWindowWarps = kWarps;

// A row's destination (kNone for none) and, once counted, its rank
// among its warp run's rows of that bucket, in one register: rank << 6
// | destination (a rank is below 32 * kRuns).
constexpr int kNone = 63;
static_assert(32 * kRuns <= (1 << 25), "a rank must fit above 6 bits");

// Counts the run's rows into the warp's counters wc[bucket], 32 rows a
// step, and packs each row's rank among the run's rows of its bucket
// into d[j]: the bucket's count before the row's step plus the row's
// rank among the step's lanes of its bucket.
template <bool kPerBucket>
__device__ __forceinline__ void count_ranks(int (&d)[kRuns], int* wc,
                                            int buckets) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  if constexpr (kPerBucket) {
    int run = 0;  // lane b: the run's rows of bucket b so far
#pragma unroll
    for (int j = 0; j < kRuns; ++j) {
      unsigned in_b = 0;  // lane b: the step's lanes of bucket b
#pragma unroll
      for (int b = 0; b < kPerBucketMax; ++b) {
        if (b < buckets) {
          const unsigned m = __ballot_sync(kFull, d[j] == b);
          if (lane == b) in_b = m;
        }
      }
      const int key = d[j] & 31;  // no bucket: a rank never written
      const int rank = __shfl_sync(kFull, run, key) +
                       __popc(__shfl_sync(kFull, in_b, key) & lt);
      run += __popc(in_b);
      d[j] = rank << 6 | (d[j] & kNone);
    }
    wc[lane] = run;
  } else {
    const int bits = 32 - __clz(buckets);
#pragma unroll
    for (int j = 0; j < kRuns; ++j) {
      const int key = d[j] >= 0 ? d[j] : buckets;  // no bucket: its own key
      const unsigned peers = kMatchAny ? __match_any_sync(kFull, key)
                                       : rk::peers_of(key, bits);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (d[j] >= 0 && leader == lane) {
        before = wc[d[j]];
        wc[d[j]] = before + __popc(peers);
      }
      const int rank = __shfl_sync(kFull, before, leader) +
                       __popc(peers & lt);
      d[j] = rank << 6 | (d[j] & kNone);
      __syncwarp();
    }
  }
}

// The exclusive prefix, in tile `tile` > 0, of this lane's bucket
// b = lane % 2^shift (2^shift >= buckets): its rows in every earlier
// tile. Called by every thread of the block: warp w < kWindowWarps reads
// row w of each window, lane l bucket b of predecessor
// w * 32 / 2^shift + l / 2^shift back; a warp waits while a word it
// needs (up to its bucket's nearest inclusive prefix in the row) is
// empty and sums each bucket's lanes up to there with xor shuffles that
// stay within the bucket; the rows are then combined in order through
// shared memory (part, found). Lanes of one bucket return the same
// value, lanes of no bucket 0.
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         int tile, int buckets, int shift,
                                         int (*part)[32], unsigned* found) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int span = 1 << shift;
  const int b = lane & (span - 1);
  const int ahead = warp * (32 >> shift) + (lane >> shift);
  unsigned group = 1;  // the lanes of bucket 0, then of b
  for (int s = span; s < 32; s <<= 1) group |= group << s;
  group <<= b;
  bool done = b >= buckets;
  int excl = 0;
  for (int last = tile - 1;; last -= kWindowWarps * (32 >> shift)) {
    int t = last - ahead;
    if constexpr (kWindowWarps < kWarps) {
      if (warp >= kWindowWarps) t = -1;  // past the window: read nothing
    }
    const unsigned long long* word =
        status + static_cast<int64_t>(t) * buckets + b;
    unsigned long long w = done || t < 0 ? lb::kPrefix  // before tile 0
                                         : lb::load_relaxed(word);
    unsigned prefixes;
    int stop;
    long long polls = 0;
    while (true) {
      prefixes = __ballot_sync(kFull, w >= lb::kPrefix) & group;
      stop = prefixes ? __ffs(prefixes) - 1 : 31;
      const bool empty = !done && lane <= stop && w < lb::kAggregate;
      if (!__any_sync(kFull, empty)) break;
      if (++polls == lb::kMaxPolls) __trap();
      if (empty) w = lb::load_relaxed(word);
    }
    int v = !done && lane <= stop ? static_cast<int>(static_cast<unsigned>(w))
                                  : 0;
    for (int o = 16; o >= span; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    const unsigned in_row = __ballot_sync(kFull, lane < span && prefixes);
    if (lane < span) part[warp][lane] = v;
    if (lane == 0) found[warp] = in_row;
    __syncthreads();
    if (!done) {
      for (int r = 0; r < kWindowWarps; ++r) {
        excl += part[r][b];
        if ((found[r] >> b) & 1) {
          done = true;
          break;
        }
      }
    }
    if (__syncthreads_and(done)) return excl;
  }
}

template <bool kPerBucket>
__global__ void __launch_bounds__(kThreads)
shard_rank_kernel(const int* __restrict__ dest, const int* __restrict__ base,
                  int n, int buckets, unsigned long long* __restrict__ scratch,
                  int* __restrict__ out) {
  // each warp's counts, then its offsets inside the tile
  __shared__ int counters[kWarps][kMaxBuckets];
  __shared__ int part[kWarps][32];
  __shared__ unsigned found[kWarps];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u));
  }
  int* wc = counters[warp];
  wc[lane] = 0;
  const int my_base = lane < buckets ? __ldg(base + lane) : 0;
  __syncthreads();
  const int tile = s_tile;
  unsigned long long* status = scratch + 1;
  unsigned long long* mine = status + static_cast<int64_t>(tile) * buckets;

  const int64_t lo = static_cast<int64_t>(tile) * kTile + warp * kWarpRows;
  int d[kRuns];
  rk::load_run(dest, lo, n, buckets, d);
  count_ranks<kPerBucket>(d, wc, buckets);
  __syncthreads();

  // warp 0, lane b: the warps' offsets of bucket b inside the tile, the
  // tile's count of it, published at once
  int count = 0;
  if (warp == 0 && lane < buckets) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = counters[w][lane];
      counters[w][lane] = count;
      count += c;
    }
    lb::store_relaxed(mine + lane,
                      lb::pack(tile == 0 ? lb::kPrefix : lb::kAggregate,
                               count));
  }
  int excl = 0;
  if (tile > 0) {
    // its block barriers also hand warp 0's offsets to every warp
    excl = look_back(status, tile, buckets, 32 - __clz(buckets - 1), part,
                     found);
    if (warp == 0 && lane < buckets) {
      lb::store_relaxed(mine + lane, lb::pack(lb::kPrefix, excl + count));
    }
  } else {
    __syncthreads();
  }

  // lane b: where this warp's first row of bucket b lands; each row at
  // its bucket's lane's value plus its rank in the run
  const int first = lane < buckets ? my_base + excl + counters[warp][lane]
                                   : 0;
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    const int b = d[j] & kNone;
    const int at = __shfl_sync(kFull, first, b & 31);
    if (b != kNone) out[lo + j * 32 + lane] = at + (d[j] >> 6);
  }
}

int num_tiles(int n) {
  return static_cast<int>((static_cast<int64_t>(n) + kTile - 1) / kTile);
}

}  // namespace

extern "C" int repro_shard_rank_tiles(int n) { return num_tiles(n); }

// dest: (n,) int32 in [0, buckets); base: (buckets,) int32 exclusive
// offsets, 1 <= buckets <= 32; out: (n,) int32; scratch: 1 + tiles *
// buckets 64-bit words, tiles = repro_shard_rank_tiles(n). A destination
// outside [0, buckets) is a caller error: its out is left unwritten.
// Returns the CUDA error code of the memset and the launch (0 on
// success), or cudaErrorInvalidValue for a bucket count outside [1, 32].
extern "C" int repro_shard_rank(const void* dest, const void* base, void* out,
                                void* scratch, int n, int buckets,
                                void* stream) {
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
  auto* kernel = buckets <= kPerBucketMax ? shard_rank_kernel<true>
                                          : shard_rank_kernel<false>;
  kernel<<<tiles, kThreads, 0, st>>>(
      static_cast<const int*>(dest), static_cast<const int*>(base), n, buckets,
      static_cast<unsigned long long*>(scratch), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
