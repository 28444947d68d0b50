// Asynchronous copies from device memory into shared memory, shared by K7
// (flash_attention.cu), K8 (decode_attention.cu) and K9 (ssd.cu):
//
//   * cp.async (sm_80+): each thread copies 4 or 16 bytes; a thread's
//     copies are grouped by cp_async_commit and waited for by
//     cp_async_wait<N> (at most N of its groups still in flight); other
//     threads see the data after a barrier;
//   * the TMA unit (sm_90): one thread asks for a box of a tensor
//     described by a tensor map (tensor4), and the copy's completion is counted in bytes on an mbarrier in
//     shared memory; every thread that waits on the barrier's phase sees
//     the data, with no block barrier.
#pragma once

#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// copy ``cols`` floats of each of ``rows`` rows: destination row r (row
// stride ``dst_ld`` floats) from source row ``row_of(r)`` (row stride
// ``src_ld`` floats), with the threads [tid, tid + nthreads, ...);
// 16-byte copies when ``vec`` (cols, src_ld, dst_ld and both bases
// multiples of 4 floats / 16 bytes). One division per thread: the
// (row, column) walk is stepped, not divided
template <class RowOf>
__device__ __forceinline__ void copy_rows_of(float* dst, int dst_ld,
                                             const float* src,
                                             long long src_ld, RowOf row_of,
                                             int rows, int cols, bool vec,
                                             int tid, int nthreads) {
  const int w = vec ? cols >> 2 : cols;  // copies per row
  const int sh = vec ? 2 : 0;
  if (w <= 0) return;
  int r = tid / w;
  int c = tid - r * w;
  const int dr = nthreads / w;
  const int dc = nthreads - dr * w;
  for (; r < rows;) {
    const int col = c << sh;
    const float* from = src + row_of(r) * src_ld + col;
    if (vec)
      cp16(dst + r * dst_ld + col, from);
    else
      cp4(dst + r * dst_ld + col, from);
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

struct SameRow {
  __device__ __forceinline__ long long operator()(int r) const { return r; }
};

// copy_rows_of with destination row r from source row r
__device__ __forceinline__ void copy_rows(float* dst, int dst_ld,
                                          const float* src, long long src_ld,
                                          int rows, int cols, bool vec,
                                          int tid, int nthreads) {
  copy_rows_of(dst, dst_ld, src, src_ld, SameRow{}, rows, cols, vec, tid,
               nthreads);
}

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes the barrier's initialisation visible to the async proxy (the TMA
// unit) and to the other threads (after a block barrier)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once on ``bar`` and add ``bytes`` to the transfers its current
// phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of ``bar`` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// the TMA unit's tiled copy of one box of a 4-D tensor map (coordinates
// innermost first, in elements; rows outside the tensor arrive as zeros)
// into this block's shared memory, counted on ``bar``
__device__ __forceinline__ void tensor4(void* dst, const void* tmap, int c0,
                                        int c1, int c2, int c3,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(tmap)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace async_copy
