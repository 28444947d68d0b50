// K5: segmented sum/min/max over arbitrary (unsorted) int32 segment ids,
// at the values' dtype (int32 or float32): the device min/max of grouped
// aggregates (kernels/segmented_reduce/ops.py::segmented_aggregate, fed
// SegmentPlan.seg) and the device join-build histogram (segment_count).
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
// sums wrap mod 2^32; NaN propagates through float min and max. Rows
// whose id lies outside [0, G) are dropped.
//
// float min/max run on int32 keys: an order-preserving map sends every
// float to an int (positive floats keep their bits, negative ones flip
// their low 31 bits), so the int atomics order them as floats. A NaN of
// any payload becomes INT_MIN for min and INT_MAX for max, beyond every
// real key (-inf maps to 0x807fffff, +inf to 0x7f800000), so the NaN
// wins its segment without a flag; an epilogue maps keys back to floats
// in place, NaN as the canonical quiet NaN. -0.0 orders below +0.0.
// float32 sums use float atomicAdd, whose order changes from run to run:
// their tolerance is the float32 accumulation bound count * 2^-23 * sum|v|.
//
// Contention: a grouped aggregate may send 2^24 rows into ~100 groups.
// When G <= kSharedMaxSegments every block first reduces its rows into a
// private copy of the G accumulators in shared memory, then adds each
// touched one to the output with one global atomic. In both paths a warp
// whose 32 rows all fall in one segment (a hot segment, or sorted ids)
// reduces in registers with shuffles and issues one atomic.
//
// Bound: memory. 8N + 4G bytes (values and ids read once, the output
// written once).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedMaxSegments = 12288;  // 48 KB of 4-byte accumulators
constexpr unsigned kFull = 0xffffffffu;

enum { kSum = 0, kMin = 1, kMax = 2 };

constexpr int kMinFloatIdentity = 0x7f800000;               // key(+inf)
constexpr int kMaxFloatIdentity = static_cast<int>(0x807fffffu);  // key(-inf)

template <int OP>
__device__ __forceinline__ int float_key(float f) {
  if (isnan(f)) return OP == kMin ? INT_MIN : INT_MAX;
  const int i = __float_as_int(f);
  return i >= 0 ? i : (i ^ 0x7fffffff);
}

__device__ __forceinline__ float key_float(int k, int op) {
  if (k == (op == kMin ? INT_MIN : INT_MAX)) return __int_as_float(0x7fc00000);
  return __int_as_float(k >= 0 ? k : (k ^ 0x7fffffff));
}

template <int OP>
__device__ __forceinline__ int combine(int a, int b) {
  if (OP == kSum) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));  // wraps
  }
  return OP == kMin ? min(a, b) : max(a, b);
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  return a + b;  // float accumulators only ever sum
}

template <int OP>
__device__ __forceinline__ void atomic_combine(int* p, int v) {
  if (OP == kSum) {
    atomicAdd(p, v);
  } else if (OP == kMin) {
    atomicMin(p, v);
  } else {
    atomicMax(p, v);
  }
}

template <int OP>
__device__ __forceinline__ void atomic_combine(float* p, float v) {
  atomicAdd(p, v);
}

struct IntLoad {
  const int* __restrict__ v;
  __device__ __forceinline__ int operator()(int64_t i) const { return v[i]; }
};

struct FloatLoad {
  const float* __restrict__ v;
  __device__ __forceinline__ float operator()(int64_t i) const {
    return v[i];
  }
};

template <int OP>
struct FloatKeyLoad {
  const float* __restrict__ v;
  __device__ __forceinline__ int operator()(int64_t i) const {
    return float_key<OP>(v[i]);
  }
};

// Combine rows [0, n) into acc, block-strided from `start` by `stride`
// (both multiples of the block size, so every warp runs the same number
// of iterations and full-mask warp intrinsics are safe).
template <int OP, typename T, class Load>
__device__ __forceinline__ void accumulate_rows(Load load,
                                                const int* __restrict__ seg,
                                                int64_t n, int g, T* acc,
                                                int64_t start,
                                                int64_t stride) {
  const int lane = threadIdx.x & 31;
  for (int64_t b = start; b < n; b += stride) {
    const int64_t i = b + threadIdx.x;
    const bool live = i < n;
    const int s = live ? seg[i] : -1;
    const bool ok = live && static_cast<unsigned>(s) < static_cast<unsigned>(g);
    const int s0 = __shfl_sync(kFull, s, 0);
    if (__all_sync(kFull, ok && s == s0)) {
      T v = load(i);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        v = combine<OP>(v, __shfl_xor_sync(kFull, v, o));
      }
      if (lane == 0) atomic_combine<OP>(&acc[s0], v);
    } else if (ok) {
      atomic_combine<OP>(&acc[s], load(i));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fill_kernel(T* __restrict__ out, int g, T v) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < g) out[i] = v;
}

template <int OP, typename T, class Load>
__global__ void __launch_bounds__(kThreads)
reduce_shared_kernel(Load load, const int* __restrict__ seg, int n, int g,
                     T ident, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = reinterpret_cast<T*>(smem);
  for (int k = threadIdx.x; k < g; k += kThreads) acc[k] = ident;
  __syncthreads();
  accumulate_rows<OP>(load, seg, n, g, acc,
                      static_cast<int64_t>(blockIdx.x) * kThreads,
                      static_cast<int64_t>(gridDim.x) * kThreads);
  __syncthreads();
  for (int k = threadIdx.x; k < g; k += kThreads) {
    const T v = acc[k];
    if (v != ident) atomic_combine<OP>(&out[k], v);
  }
}

template <int OP, typename T, class Load>
__global__ void __launch_bounds__(kThreads)
reduce_global_kernel(Load load, const int* __restrict__ seg, int n, int g,
                     T* __restrict__ out) {
  accumulate_rows<OP>(load, seg, n, g, out,
                      static_cast<int64_t>(blockIdx.x) * kThreads,
                      static_cast<int64_t>(gridDim.x) * kThreads);
}

__global__ void __launch_bounds__(kThreads)
decode_float_keys_kernel(int* __restrict__ out, int g, int op) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < g) out[i] = __float_as_int(key_float(out[i], op));
}

template <int OP, typename T, class Load>
int launch(Load load, const int* seg, int n, int g, T ident, T* out,
           cudaStream_t stream) {
  const int g_blocks = (g + kThreads - 1) / kThreads;
  fill_kernel<T><<<g_blocks, kThreads, 0, stream>>>(out, g, ident);
  if (n > 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t row_blocks = (static_cast<int64_t>(n) + kThreads - 1) /
                               kThreads;
    if (g <= kSharedMaxSegments) {
      const size_t bytes = static_cast<size_t>(g) * sizeof(T);
      const int per_sm = bytes <= 12 * 1024 ? 8 : 4;
      const int blocks = static_cast<int>(
          row_blocks < static_cast<int64_t>(sms) * per_sm
              ? row_blocks : static_cast<int64_t>(sms) * per_sm);
      reduce_shared_kernel<OP, T, Load><<<blocks, kThreads, bytes, stream>>>(
          load, seg, n, g, ident, out);
    } else {
      const int blocks = static_cast<int>(
          row_blocks < static_cast<int64_t>(sms) * 8
              ? row_blocks : static_cast<int64_t>(sms) * 8);
      reduce_global_kernel<OP, T, Load><<<blocks, kThreads, 0, stream>>>(
          load, seg, n, g, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values: (n,) int32 (is_float == 0) or float32; segment_ids: (n,) int32;
// out: (num_segments,) of the values' dtype; op: 0 sum, 1 min, 2 max.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int repro_segment_reduce(const void* values,
                                    const void* segment_ids, void* out,
                                    int n, int num_segments, int op,
                                    int is_float, void* stream) {
  if (num_segments <= 0) return 0;
  const int* seg = static_cast<const int*>(segment_ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = num_segments;
  if (!is_float) {
    const IntLoad load{static_cast<const int*>(values)};
    int* o = static_cast<int*>(out);
    if (op == kSum) return launch<kSum, int>(load, seg, n, g, 0, o, st);
    if (op == kMin) return launch<kMin, int>(load, seg, n, g, INT_MAX, o, st);
    return launch<kMax, int>(load, seg, n, g, INT_MIN, o, st);
  }
  const float* v = static_cast<const float*>(values);
  if (op == kSum) {
    return launch<kSum, float>(FloatLoad{v}, seg, n, g, 0.0f,
                               static_cast<float*>(out), st);
  }
  int* keys = static_cast<int*>(out);  // the float output, as int32 keys
  const int rc = op == kMin
      ? launch<kMin, int>(FloatKeyLoad<kMin>{v}, seg, n, g,
                          kMinFloatIdentity, keys, st)
      : launch<kMax, int>(FloatKeyLoad<kMax>{v}, seg, n, g,
                          kMaxFloatIdentity, keys, st);
  if (rc != 0) return rc;
  decode_float_keys_kernel<<<(g + kThreads - 1) / kThreads, kThreads, 0,
                             st>>>(keys, g, op);
  return static_cast<int>(cudaGetLastError());
}
