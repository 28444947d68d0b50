// K2: 32-bit FNV-1a row hashes of an (N, C) int32 key matrix, the sort
// key of every group build over C > 1 key columns (semantic operators
// that reference two tables, multi-column group-bys;
// kernels/hash_dedup/ops.py::_hash_bits).
//
// Replaces the TPU kernel
// src/repro/kernels/hash_dedup/hash_dedup.py::hash_rows_kernel. It is a
// pure elementwise pass: one thread per row reads the row's C words and
// mixes their four little-endian bytes in uint32 with natural
// wrap-around (offset 2166136261, prime 16777619), bit-identical to
// hash_rows_np. Bound: memory, 4 * (C + 1) bytes per row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kOffset = 2166136261u;
constexpr uint32_t kPrime = 16777619u;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hash_rows_kernel(const int32_t* __restrict__ keys, uint32_t* __restrict__ out,
                 int64_t n, int c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       r < n; r += stride) {
    const int32_t* row = keys + r * c;
    uint32_t h = kOffset;
    for (int j = 0; j < c; ++j) {
      const uint32_t w = static_cast<uint32_t>(row[j]);
#pragma unroll
      for (int shift = 0; shift < 32; shift += 8) {
        h = (h ^ ((w >> shift) & 0xFFu)) * kPrime;
      }
    }
    out[r] = h;
  }
}

}  // namespace

extern "C" int repro_hash_rows(const void* keys, void* out, long long n,
                               int c, void* stream) {
  const long long want = (n + kThreads - 1) / kThreads;
  // a grid-stride loop: enough blocks to fill every SM many times over
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  hash_rows_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<uint32_t*>(out), n, c);
  return static_cast<int>(cudaGetLastError());
}
