// What the two stable bucket ranks share, K6 (radix_rank.cu, B <= 1024
// buckets) and K10 (shard_rank.cu, P <= 32):
//
//   rank[i] = base[d_i] + #{j < i : d_j == d_i}
//
// Each warp of a block holds a contiguous run of 32 * kRuns rows in
// registers, lane l holding rows lo + 32 j + l (load_run: kRuns coalesced
// 4-byte loads in flight per lane), and ranks them 32 rows a step, the
// lanes of a step grouped by bucket (peers_of).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace rank {

constexpr unsigned kFull = 0xffffffffu;

// This lane's rows of the warp's run [lo, lo + 32 * kRuns): row
// lo + 32 j + lane in d[j], -1 past the end or outside [0, buckets).
template <int kRuns>
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

}  // namespace rank
}  // namespace repro
