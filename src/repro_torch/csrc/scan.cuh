// Block-level int32 scan building blocks and the tile of the shard
// rank (K10, shard_rank.cu): warp_inclusive_scan, block_exclusive_scan,
// kTile and num_tiles. The one-pass look-back scan of scan_lookback.cuh
// (K1, K3, K4) shares warp_inclusive_scan.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Exclusive scan of one value per thread across the block. Writes the
// block total to *total. Every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  __shared__ int block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_sums[lane] : 0;
    const int wi = warp_inclusive_scan(w);
    if (lane < kWarps) warp_sums[lane] = wi - w;
    if (lane == kWarps - 1) block_total = wi;
  }
  __syncthreads();
  const int out = warp_sums[warp] + incl - v;
  *total = block_total;
  __syncthreads();  // warp_sums and block_total are reused by the caller
  return out;
}

inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }

}  // namespace repro
