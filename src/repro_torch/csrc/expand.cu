// K4: running segment ids, the probe side of the join and the cross
// join's row enumeration (kernels/expand/ops.py::expand_segments and
// kernels/segmented_reduce/ops.py::_probe_expand_device).
//
// Replaces the TPU kernel
// src/repro/kernels/expand/expand.py::running_segment_ids_kernel, which
// carries the running mark total across a sequential grid in SMEM. Here
// the carry is the device-wide three-phase scan of scan.cuh (prologue:
// the mark, +k where k segments start; epilogue: minus one). Bound:
// memory, 8 bytes per element; the scan reads its input twice.
#include "scan.cuh"

namespace {

struct SegmentIdOp {
  const int* __restrict__ marks;
  int* __restrict__ out;
  __device__ __forceinline__ int load(int64_t i) const { return marks[i]; }
  __device__ __forceinline__ int load_emit(int64_t i) const {
    return marks[i];
  }
  __device__ __forceinline__ void store(int64_t i, int v) const {
    out[i] = v - 1;
  }
};

}  // namespace

extern "C" int repro_running_segment_ids(const void* marks, void* out,
                                         void* tile_sums, int n,
                                         void* stream) {
  SegmentIdOp op{static_cast<const int*>(marks), static_cast<int*>(out)};
  return repro::launch_scan(op, n, static_cast<int*>(tile_sums),
                            static_cast<cudaStream_t>(stream));
}
