// K5: segmented sum/min/max over arbitrary (unsorted) int32 segment ids,
// at the values' dtype (int32 or float32): the device min/max of grouped
// aggregates (kernels/segmented_reduce/ops.py::segmented_aggregate, fed
// SegmentPlan.seg), the device join-build histogram (segment_count) and
// the radix passes' histograms (kernels/hash_join/ops.py::_radix_order).
//
// Replaces the TPU kernel
// src/repro/kernels/segmented_reduce/segmented_reduce.py::
// segment_reduce_kernel, which compares every row of a row tile with
// every segment of a segment tile: O(N*G) dense work that only pays on a
// vector unit. Here each row is touched once and combined into its
// segment with an atomic, so the work is O(N + G).
//
// Semantics, as jnp segment_sum/min/max: an empty segment holds the op's
// identity (0, the int32 extremes, +inf for min and -inf for max); int32
// sums wrap mod 2^32; NaN propagates through float min and max, as the
// canonical quiet NaN; -0.0 orders below +0.0. Rows whose id lies
// outside [0, G) are dropped. float32 sums use float atomicAdd, whose
// order changes from run to run: their tolerance is the float32
// accumulation bound count * 2^-23 * sum|v|.
//
// One memset and one launch per call. Every accumulator is a 32-bit word
// whose identity is the zero word, so the memset fills the output:
//   - sums add int32 (wrapping) or float32 words;
//   - min and max reduce one unsigned word with atomicMax: an int32 key
//     (the int itself, or for a float the order-preserving map: positive
//     floats keep their bits, negative ones flip their low 31 bits, any
//     NaN keyed beyond +-inf so it wins without a flag) biased so that
//     the identity is 0: key ^ 0x80000000 for max, key ^ 0x7fffffff for
//     min (which reverses the order, so min is the largest word).
// Min and max end with a decode: every block arrives on a counter (the
// word after the output, zeroed by the same memset) after its last
// atomic, and the last arrival maps the G words back to values in place
// (0 to the identity, a NaN key to the canonical quiet NaN).
//
// Loads: the TPU kernel's time went into O(N*G) compares; here it is the
// latency of the loads. Each thread loads a batch of kRounds 16-byte
// segment-id loads and kRounds 16-byte value loads (warp-striped: lane l
// holds 4 consecutive rows of each 128-row stripe of its warp's run), all
// issued before any is read, so the value load does not wait on the id
// and a block keeps 32 KB in flight. A pointer that is not 16-byte
// aligned takes the scalar instance (same layout, 4-byte loads).
//
// Contention: a grouped aggregate may send 2^24 rows into ~100 groups.
// When G <= kSharedMaxSegments every block first reduces its rows into a
// private copy of the G accumulators in shared memory, then adds each
// touched one to the output with one global atomic. In both paths a
// stripe whose 128 rows all fall in one segment (a hot segment, or
// sorted ids) reduces in registers with shuffles and issues one atomic,
// and a lane whose 4 rows share a segment issues one.
//
// Grid: at most kBlocksPerSm blocks an SM (the SM count cached once per
// device), each walking batches of kBatch rows block-strided.
//
// Chosen on an H100 (NVIDIA H100 80GB HBM3, 700 W) with chip_sweep.py
// (CUDA-graph replays, six samples each over three runs; four for two
// blocks an SM) at the path's two shapes, (5,768,831,) into 120 float32
// max / (4,194,304,) into 256 int32 sum: kRounds 2, 4, 8 took
// 0.0200-0.0212 / 0.0124-0.0128, 0.0195-0.0216 / 0.0124-0.0127 and
// 0.0259-0.0273 / 0.0144-0.0150 ms; kBlocksPerSm 2 and 8 took
// 0.0225-0.0232 / 0.0117-0.0119 and 0.0266-0.0276 / 0.0213-0.0223 (more
// blocks, more flush atomics).
//
// Combine: the other design, per-block partials written to a scratch and
// combined by the last arrival, took 0.0592-0.0604 / 0.0950-0.0966 ms in
// the same runs: its one block reads grid x G words, where the atomic
// design's flushes spread over the blocks' ends.
//
// The large-G path (G > kSharedMaxSegments, global atomics) takes the
// same loads; its min/max decode of G words runs in the last block alone.
//
// Bound: memory. 8N + 4G bytes (values and ids read once, the output
// written once).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

#include "scan_lookback.cuh"  // fetch_add_acq_rel

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 4;  // 16-byte id loads (and value loads) a batch
constexpr int kWarpRun = 128 * kRounds;         // rows a warp per batch
constexpr int kBatch = kThreads * 4 * kRounds;  // rows a block per batch
constexpr int kBlocksPerSm = 4;
constexpr int kSharedMaxSegments = 12288;  // 48 KB of 4-byte accumulators
constexpr unsigned kFull = 0xffffffffu;

enum { kSum = 0, kMin = 1, kMax = 2 };

// the accumulator word: float for float sums, else unsigned
template <int OP, bool kFloat>
struct Word { using T = unsigned; };
template <>
struct Word<kSum, true> { using T = float; };

// the bias that makes a min/max identity the zero word
template <int OP>
__device__ __forceinline__ unsigned bias() {
  return OP == kMin ? 0x7fffffffu : 0x80000000u;
}
constexpr int kNanBits = 0x7fc00000;

// the order-preserving int32 key of a float; NaN beyond +-inf
template <int OP>
__device__ __forceinline__ int float_key(int bits) {
  if (isnan(__int_as_float(bits))) return OP == kMin ? INT_MIN : INT_MAX;
  return bits >= 0 ? bits : (bits ^ 0x7fffffff);
}

// a row's value (its raw 32 bits) as an accumulator word
template <int OP, bool kFloat>
__device__ __forceinline__ typename Word<OP, kFloat>::T encode(int bits) {
  if constexpr (OP == kSum) {
    if constexpr (kFloat) {
      return __int_as_float(bits);
    } else {
      return static_cast<unsigned>(bits);
    }
  } else {
    const int key = kFloat ? float_key<OP>(bits) : bits;
    return static_cast<unsigned>(key) ^ bias<OP>();
  }
}

// an accumulator word as the output's bits
template <int OP, bool kFloat>
__device__ __forceinline__ int decode(typename Word<OP, kFloat>::T w) {
  if constexpr (OP == kSum) {
    if constexpr (kFloat) {
      return __float_as_int(w);
    } else {
      return static_cast<int>(w);
    }
  } else {
    const int key = static_cast<int>(w ^ bias<OP>());
    if (!kFloat) return key;
    if (w == 0) return OP == kMin ? 0x7f800000 : static_cast<int>(0xff800000u);
    if (key == (OP == kMin ? INT_MIN : INT_MAX)) return kNanBits;
    return key >= 0 ? key : (key ^ 0x7fffffff);
  }
}

template <int OP, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (OP == kSum) {
    return a + b;  // unsigned words wrap
  } else {
    return max(a, b);
  }
}

template <int OP, typename T>
__device__ __forceinline__ void atomic_combine(T* p, T v) {
  if constexpr (OP == kSum) {
    atomicAdd(p, v);
  } else {
    atomicMax(p, v);
  }
}

// Combine one stripe, 4 rows a lane (ids s, raw values x), into acc.
// Called by whole warps.
template <int OP, bool kFloat, typename T>
__device__ __forceinline__ void accumulate_stripe(const int (&s)[4],
                                                  const int (&x)[4], int g,
                                                  T* acc) {
  const int s0 = __shfl_sync(kFull, s[0], 0);
  bool ok[4];
  bool run = true;  // the lane's 4 rows live and in one segment
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ok[k] = static_cast<unsigned>(s[k]) < static_cast<unsigned>(g);
    run = run && ok[k] && s[k] == s[0];
  }
  if (__all_sync(kFull, run && s[0] == s0)) {
    T v = encode<OP, kFloat>(x[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) v = combine<OP>(v, encode<OP, kFloat>(x[k]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v = combine<OP>(v, __shfl_xor_sync(kFull, v, o));
    }
    if ((threadIdx.x & 31) == 0) atomic_combine<OP>(&acc[s0], v);
  } else if (run) {
    T v = encode<OP, kFloat>(x[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) v = combine<OP>(v, encode<OP, kFloat>(x[k]));
    atomic_combine<OP>(&acc[s[0]], v);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (ok[k]) atomic_combine<OP>(&acc[s[k]], encode<OP, kFloat>(x[k]));
    }
  }
}

// out: the G output words, then the arrival counter (all zeroed by the
// call's memset)
template <int OP, bool kFloat, bool kVec, bool kShared>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
segment_reduce_kernel(const int* __restrict__ vals,
                      const int* __restrict__ seg, int n, int g,
                      typename Word<OP, kFloat>::T* __restrict__ out) {
  using T = typename Word<OP, kFloat>::T;
  // the G accumulators (kShared); after the flush, the arrival flag
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = kShared ? reinterpret_cast<T*>(smem) : out;
  unsigned* s_last = reinterpret_cast<unsigned*>(smem);
  if constexpr (kShared) {
    for (int k = threadIdx.x; k < g; k += kThreads) acc[k] = T(0);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the loop bound is block-uniform: every warp takes every batch
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kBatch; base < n;
       base += static_cast<int64_t>(gridDim.x) * kBatch) {
    const int64_t first = base + warp * kWarpRun + lane * 4;
    int s[kRounds][4], x[kRounds][4];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int64_t i = first + r * 128;
      if (kVec && i + 3 < n) {
        const int4 q = *reinterpret_cast<const int4*>(seg + i);
        const int4 w = *reinterpret_cast<const int4*>(vals + i);
        s[r][0] = q.x, s[r][1] = q.y, s[r][2] = q.z, s[r][3] = q.w;
        x[r][0] = w.x, x[r][1] = w.y, x[r][2] = w.z, x[r][3] = w.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s[r][k] = i + k < n ? seg[i + k] : -1;
          x[r][k] = i + k < n ? vals[i + k] : 0;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      accumulate_stripe<OP, kFloat>(s[r], x[r], g, acc);
    }
  }

  if constexpr (kShared) {
    __syncthreads();
    for (int k = threadIdx.x; k < g; k += kThreads) {
      const T v = acc[k];
      if (v != T(0)) atomic_combine<OP>(&out[k], v);
    }
  }
  if constexpr (OP == kSum) return;  // sums need no decode

  // arrive; the barrier orders the block's atomics and stores before
  // thread 0's release (cumulative, as in a cooperative grid sync)
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned old = repro::lookback::fetch_add_acq_rel(
        reinterpret_cast<unsigned*>(out + g), 1u);
    *s_last = old == gridDim.x - 1;
  }
  __syncthreads();
  if (!*s_last) return;

  // decode the G words in place, eight loads in flight a thread
  for (int k0 = threadIdx.x; k0 < g; k0 += kThreads * 8) {
    T w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j * kThreads;
      w[j] = k < g ? __ldcg(out + k) : T(0);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j * kThreads;
      if (k < g) reinterpret_cast<int*>(out)[k] = decode<OP, kFloat>(w[j]);
    }
  }
}

constexpr int kMaxDevices = 64;

// the card's SM count, queried once per device
int sm_count() {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  std::atomic<int>& c = cached[dev % kMaxDevices];
  int sms = c.load(std::memory_order_relaxed);
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    c.store(sms, std::memory_order_relaxed);
  }
  return sms;
}

int grid_size(int n) {
  const int64_t batches = (static_cast<int64_t>(n) + kBatch - 1) / kBatch;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  return static_cast<int>(batches < 1 ? 1 : batches < cap ? batches : cap);
}

template <int OP, bool kFloat>
int launch(const int* vals, const int* seg, int n, int g, void* buf,
           cudaStream_t stream) {
  using T = typename Word<OP, kFloat>::T;
  const cudaError_t e = cudaMemsetAsync(
      buf, 0, (static_cast<size_t>(g) + 1) * sizeof(T), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  T* out = static_cast<T*>(buf);
  const int blocks = grid_size(n);
  const bool vec = ((reinterpret_cast<uintptr_t>(vals) |
                     reinterpret_cast<uintptr_t>(seg)) & 15) == 0;
  if (g <= kSharedMaxSegments) {
    const size_t bytes = static_cast<size_t>(g) * sizeof(T);
    if (vec) {
      segment_reduce_kernel<OP, kFloat, true, true>
          <<<blocks, kThreads, bytes, stream>>>(vals, seg, n, g, out);
    } else {
      segment_reduce_kernel<OP, kFloat, false, true>
          <<<blocks, kThreads, bytes, stream>>>(vals, seg, n, g, out);
    }
  } else if (vec) {
    segment_reduce_kernel<OP, kFloat, true, false>
        <<<blocks, kThreads, sizeof(unsigned), stream>>>(vals, seg, n, g,
                                                         out);
  } else {
    segment_reduce_kernel<OP, kFloat, false, false>
        <<<blocks, kThreads, sizeof(unsigned), stream>>>(vals, seg, n, g,
                                                         out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows a block loads at once, and the most segments accumulated in
// shared memory
extern "C" int repro_segment_reduce_batch() { return kBatch; }

extern "C" int repro_segment_reduce_shared_max() {
  return kSharedMaxSegments;
}

// values: (n,) int32 (is_float == 0) or float32; segment_ids: (n,) int32;
// out: num_segments + 1 32-bit words, the first num_segments of which
// receive the result at the values' dtype (the last is the arrival
// counter);
// op: 0 sum, 1 min, 2 max. Returns the CUDA error code of the memset and
// the launch (0 on success).
extern "C" int repro_segment_reduce(const void* values,
                                    const void* segment_ids, void* out,
                                    int n, int num_segments, int op,
                                    int is_float, void* stream) {
  if (num_segments <= 0) return 0;
  const int* v = static_cast<const int*>(values);
  const int* seg = static_cast<const int*>(segment_ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = num_segments;
  if (is_float) {
    if (op == kSum) return launch<kSum, true>(v, seg, n, g, out, st);
    if (op == kMin) return launch<kMin, true>(v, seg, n, g, out, st);
    return launch<kMax, true>(v, seg, n, g, out, st);
  }
  if (op == kSum) return launch<kSum, false>(v, seg, n, g, out, st);
  if (op == kMin) return launch<kMin, false>(v, seg, n, g, out, st);
  return launch<kMax, false>(v, seg, n, g, out, st);
}
