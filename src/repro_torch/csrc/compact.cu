// K1: inclusive running count of int32 flags, the mask side of
// Table.compact (kernels/compact/ops.py::compact_index) and the
// exclusive output offsets of the join probe expansion.
//
// Replaces the TPU kernel
// src/repro/kernels/compact/compact.py::prefix_count_kernel, which
// carries the running count across a sequential grid in SMEM. Here the
// carry is the device-wide three-phase scan of scan.cuh (prologue: the
// flag itself; epilogue: identity). Bound: memory, 8 bytes per element
// (one int32 read, one written); the scan reads its input twice.
#include "scan.cuh"

namespace {

struct CountOp {
  const int* __restrict__ flags;
  int* __restrict__ out;
  __device__ __forceinline__ int load(int64_t i) const { return flags[i]; }
  __device__ __forceinline__ int load_emit(int64_t i) const {
    return flags[i];
  }
  __device__ __forceinline__ void store(int64_t i, int v) const {
    out[i] = v;
  }
};

}  // namespace

extern "C" int repro_prefix_count(const void* flags, void* out,
                                  void* tile_sums, int n, void* stream) {
  CountOp op{static_cast<const int*>(flags), static_cast<int*>(out)};
  return repro::launch_scan(op, n, static_cast<int*>(tile_sums),
                            static_cast<cudaStream_t>(stream));
}

extern "C" int repro_scan_tiles(int n) { return repro::num_tiles(n); }

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
