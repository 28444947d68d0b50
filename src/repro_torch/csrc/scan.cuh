// Device-wide inclusive int32 scan shared by three kernels of the port:
// the compaction prefix count (compact.cu), the group-boundary scan
// (group_build.cu) and the running segment ids (expand.cu).
//
// The TPU kernels these replace walk their grid in order and carry a
// running total from one tile to the next in SMEM scratch. Hopper blocks
// run concurrently and in no order, so the carry becomes three phases:
//
//   1. tile_reduce_kernel: each block sums one tile of kTile elements;
//   2. scan_tile_sums_kernel: one block turns the tile sums into
//      exclusive tile offsets, looping when there are more tiles than
//      threads;
//   3. tile_scan_kernel: each block rescans its tile in shared memory and
//      adds its offset.
//
// An Op supplies the prologue and the epilogue:
//   int  load(i)       the term of element i (phase 1);
//   int  load_emit(i)  the same term, also writing any side output of
//                      element i (phase 3);
//   void store(i, v)   the epilogue, given the inclusive sum v.
//
// Bound: memory. The input is read twice (phases 1 and 3), the output
// written once; a single-pass decoupled look-back scan would read it
// once and is later work. Sums are int32, as in the reference: callers
// keep N and every running total below 2^31.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

// one pad word every 32 keeps the per-thread strided walk over shared
// memory free of bank conflicts
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

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

template <class Op>
__global__ void __launch_bounds__(kThreads)
tile_reduce_kernel(Op op, int n, int* __restrict__ tile_sums) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int s = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads + threadIdx.x;
    if (i < n) s += op.load(i);
  }
  int total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// static: every kernel source includes this header
static __global__ void __launch_bounds__(kThreads)
scan_tile_sums_kernel(int* __restrict__ tile_sums, int num_tiles) {
  int carry = 0;
  for (int b = 0; b < num_tiles; b += kThreads) {
    const int i = b + threadIdx.x;
    const int v = i < num_tiles ? tile_sums[i] : 0;
    int total;
    const int ex = block_exclusive_scan(v, &total);
    if (i < num_tiles) tile_sums[i] = carry + ex;
    carry += total;
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(Op op, int n, const int* __restrict__ tile_offsets) {
  __shared__ int s[kTile + kTile / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  // coalesced load: neighbouring threads read neighbouring elements
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int64_t g = base + i;
    s[pad(i)] = g < n ? op.load_emit(g) : 0;
  }
  __syncthreads();
  // each thread scans its own kItems consecutive elements
  int local[kItems];
  int run = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run += s[pad(threadIdx.x * kItems + k)];
    local[k] = run;
  }
  int total;
  const int off = tile_offsets[blockIdx.x] + block_exclusive_scan(run, &total);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    s[pad(threadIdx.x * kItems + k)] = off + local[k];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int64_t g = base + i;
    if (g < n) op.store(g, s[pad(i)]);
  }
}

inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }

// Runs the three phases on `stream`. `tile_sums` holds num_tiles(n)
// int32 of scratch. Returns cudaGetLastError() after the last launch.
template <class Op>
int launch_scan(Op op, int n, int* tile_sums, cudaStream_t stream) {
  const int tiles = num_tiles(n);
  tile_reduce_kernel<Op><<<tiles, kThreads, 0, stream>>>(op, n, tile_sums);
  scan_tile_sums_kernel<<<1, kThreads, 0, stream>>>(tile_sums, tiles);
  tile_scan_kernel<Op><<<tiles, kThreads, 0, stream>>>(op, n, tile_sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
