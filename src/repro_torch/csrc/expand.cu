// K4: running segment ids, the probe side of the join and the cross
// join's row enumeration (kernels/expand/ops.py::expand_segments and
// kernels/segmented_reduce/ops.py::_probe_expand_device).
//
// Replaces the TPU kernel
// src/repro/kernels/expand/expand.py::running_segment_ids_kernel, which
// carries the running mark total across a sequential grid in SMEM.
// Bound: memory, 8 bytes per element (one int32 read, one written).
//
// K4 is the one-pass decoupled look-back scan of scan_lookback.cuh
// (no prologue: the terms are the marks, +k where k segments start;
// epilogue: minus one): one memset of the tile status words and one
// launch, each element read once and written once.
#include "scan_lookback.cuh"

namespace {

struct SegmentIdOp {
  static constexpr bool kPrologue = false;  // the elements are the terms
  const int* __restrict__ in;
  int* __restrict__ out;
  __device__ __forceinline__ int emit(int v) const { return v - 1; }
};

}  // namespace

extern "C" int repro_running_segment_ids(const void* marks, void* out,
                                         void* scratch, int n,
                                         void* stream) {
  SegmentIdOp op{static_cast<const int*>(marks), static_cast<int*>(out)};
  return repro::lookback::launch_lookback(op, n, scratch,
                                          static_cast<cudaStream_t>(stream));
}
