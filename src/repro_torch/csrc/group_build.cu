// K3: group boundaries and group ids over sorted 32-bit keys, the build
// step of every group build (semantic dedup, grouped aggregates and the
// sort-based join build; kernels/hash_dedup/ops.py::_group_build_device).
//
// Replaces the TPU kernel
// src/repro/kernels/hash_dedup/group_build.py::group_boundaries_kernel,
// which carries the previous tile's last key and the running boundary
// count across a sequential grid in SMEM. Here each element reads its
// predecessor key straight from device memory, so the boundary needs no
// carry, and the group id is the device-wide three-phase scan of
// scan.cuh (prologue: bnd = i == 0 || key != predecessor, also written
// out; epilogue: minus one). The port has no pow2 padding, so every row
// is live and the TPU kernel's valid operand is gone. Bound: memory,
// 12 bytes per element (key read, bnd and gid written); the scan reads
// its input twice.
#include "scan.cuh"

namespace {

struct BoundaryOp {
  const int* __restrict__ keys;
  int* __restrict__ bnd;
  int* __restrict__ gid;
  __device__ __forceinline__ int load(int64_t i) const {
    return (i == 0 || keys[i] != keys[i - 1]) ? 1 : 0;
  }
  __device__ __forceinline__ int load_emit(int64_t i) const {
    const int b = load(i);
    bnd[i] = b;
    return b;
  }
  __device__ __forceinline__ void store(int64_t i, int v) const {
    gid[i] = v - 1;
  }
};

}  // namespace

extern "C" int repro_group_boundaries(const void* keys, void* bnd, void* gid,
                                      void* tile_sums, int n, void* stream) {
  BoundaryOp op{static_cast<const int*>(keys), static_cast<int*>(bnd),
                static_cast<int*>(gid)};
  return repro::launch_scan(op, n, static_cast<int*>(tile_sums),
                            static_cast<cudaStream_t>(stream));
}

extern "C" int repro_scan_tiles(int n) { return repro::num_tiles(n); }
