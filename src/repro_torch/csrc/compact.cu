// K1: inclusive running count of int32 flags, the mask side of
// Table.compact (kernels/compact/ops.py::compact_index) and the
// exclusive output offsets of the join probe expansion.
//
// Replaces the TPU kernel
// src/repro/kernels/compact/compact.py::prefix_count_kernel, which
// carries the running count across a sequential grid in SMEM. Bound:
// memory, 8 bytes per element (one int32 read, one written).
//
// K1 is the one-pass decoupled look-back scan of scan_lookback.cuh
// (no prologue: the flags are the terms; epilogue: identity): one
// memset of the tile status words and one launch, each element read
// once and written once.
#include "scan_lookback.cuh"

namespace {

struct CountOp {
  static constexpr bool kPrologue = false;  // the elements are the terms
  const int* __restrict__ in;
  int* __restrict__ out;
  __device__ __forceinline__ int emit(int v) const { return v; }
};

}  // namespace

extern "C" int repro_prefix_count(const void* flags, void* out,
                                  void* scratch, int n, void* stream) {
  CountOp op{static_cast<const int*>(flags), static_cast<int*>(out)};
  return repro::lookback::launch_lookback(op, n, scratch,
                                          static_cast<cudaStream_t>(stream));
}

// the look-back scan's tile size and its tile count for n elements
extern "C" int repro_lookback_tile() { return repro::lookback::kTile; }

extern "C" int repro_lookback_tiles(int n) {
  return repro::lookback::num_tiles(n);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
