// K3: group boundaries and group ids over sorted 32-bit keys, the build
// step of every group build (semantic dedup, grouped aggregates and the
// sort-based join build; kernels/hash_dedup/ops.py::_group_build_device).
//
// Replaces the TPU kernel
// src/repro/kernels/hash_dedup/group_build.py::group_boundaries_kernel,
// which carries the previous tile's last key and the running boundary
// count across a sequential grid in SMEM. Here the group id is the
// one-pass decoupled look-back scan of scan_lookback.cuh, whose prologue
// turns the tile's keys into boundary flags (bnd = i == 0 || key !=
// predecessor), stores them with 16-byte stores and scans them; the
// epilogue stores gid = inclusive count - 1. The port has no pow2
// padding, so every row is live and the TPU kernel's valid operand is
// gone.
//
// The predecessor comes from registers: an element's left neighbour in
// the lane's own 4; for the lane's first element of a round, lane l - 1's
// last of the same round (__shfl_up_sync); for lane 0, lane 31's last of
// the previous round. Only each warp run's first element loads
// key[first - 1], issued beside the tile's own loads. Each key is read
// once and bnd and gid are written once: 12 bytes per element, the bound.
// One memset of the status words and one launch per call.
//
// On an H100 (NVIDIA H100 80GB HBM3, 700 W; chip_sweep.py, CUDA-graph
// replays, six samples each over three runs) at 12,584,948 sorted keys
// this kernel took 0.0671-0.0684 ms. The look-back's tile stays at 32 items a thread: at 16 and 48 items K3
// took 0.0728-0.0737 and 0.0659-0.0663 ms, and K1 (which shares the
// tile) 0.0669-0.0673 and 0.0630-0.0634 against 0.0610-0.0614 at 32.
#include "scan_lookback.cuh"

namespace {

namespace lb = repro::lookback;

struct BoundaryOp {
  static constexpr bool kPrologue = true;
  const int* __restrict__ in;  // the sorted keys
  int* __restrict__ out;       // gid
  int* __restrict__ side;      // bnd
  __device__ __forceinline__ int emit(int v) const { return v - 1; }

  // keys -> boundary flags in place, stored to `side`; lane l holds
  // elements first + 128 r + k (k < 4) of round r
  template <bool kVec>
  __device__ __forceinline__ void prologue(int (&v)[lb::kItems],
                                           int64_t first, int n) const {
    const int lane = threadIdx.x & 31;
    const int64_t run = first - 4 * lane;  // the warp run's first element
    // lane 0's predecessor for round 0; element 0 has none
    int carry = lane == 0 && run > 0 && run <= n ? in[run - 1] : 0;
#pragma unroll
    for (int r = 0; r < lb::kRounds; ++r) {
      const int64_t i = first + r * 128;
      const int up = __shfl_up_sync(0xffffffffu, v[4 * r + 3], 1);
      const int last = __shfl_sync(0xffffffffu, v[4 * r + 3], 31);
      const int pred = lane == 0 ? carry : up;
      carry = last;
      int b[4];
      b[0] = i < n && (i == 0 || v[4 * r] != pred);
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        b[j] = i + j < n && v[4 * r + j] != v[4 * r + j - 1];
      }
      if (kVec && i + 3 < n) {
        *reinterpret_cast<int4*>(side + i) = make_int4(b[0], b[1], b[2], b[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (i + j < n) side[i + j] = b[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * r + j] = b[j];
    }
  }
};

}  // namespace

extern "C" int repro_group_boundaries(const void* keys, void* bnd, void* gid,
                                      void* scratch, int n, void* stream) {
  BoundaryOp op{static_cast<const int*>(keys), static_cast<int*>(gid),
                static_cast<int*>(bnd)};
  return lb::launch_lookback(op, n, scratch,
                             static_cast<cudaStream_t>(stream));
}
