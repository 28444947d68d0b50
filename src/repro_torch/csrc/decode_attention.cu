// K8: one-token grouped-query attention over a KV cache in float32, the
// decode attention of the dense LM (models/layers.py::attention_decode):
//
//   o[b,h] = sum_{t < len[b]} softmax_t(q[b,h] . k[b,h/G,t] * scale)
//            v[b,h/G,t]
//
// with G = H / K query heads per KV head, over one of two masks:
//
//   * per-row cache lengths (the dense LM, whose slot t holds position
//     t): positions t < len[b] are live;
//   * the reference's slot mask (the hybrid LM's ring cache, whose slot
//     t holds position slot_pos[b, t], written at pos % window): slot t
//     is live iff 0 <= slot_pos[b,t] <= pos[b] and, with a window,
//     pos[b] - slot_pos[b,t] < window (models/layers.py::
//     attention_decode). A ring breaks slot_pos[t] == t, so no length
//     can stand for this mask.
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py::
// decode_attention_kernel, whose grid walks the cache blocks of one
// (row, KV head) in order with the online-softmax state of its G query
// heads in VMEM scratch. Here that walk is a loop inside one block:
//
//   * one block per (batch row, KV head), one warp per query head of the
//     group, so the group's G heads share every K/V tile the block
//     stages in shared memory (the cache is read once, not G times);
//   * tiles of kBT = 32 cache positions, one position per lane for the
//     scores, the K tile padded to d + 1 words a row so the lanes' dot
//     products hit distinct banks;
//   * m and l are warp-uniform registers and each lane keeps d/32 output
//     columns in float32; probabilities reach the P.V loop by shuffle;
//   * under lengths only the row's first len[b] positions are read;
//     under the slot mask all T are read and masked one by one, and a
//     tile whose slots are all masked leaves the row's state as it was;
//     the cache is read through its (b, kv, t) strides, so the model's
//     (B, T, K, d) cache goes in as a permuted view.
//
// A row with nothing live (a length <= 0, or no live slot) follows the
// plain version (kernels/decode_attention/ref.py), which softmaxes T
// equal masked scores: the mean of V over all T positions. The serving
// path never passes one (lengths = pos + 1; a row's current slot is
// always live).
//
// Bound: memory, the cache prefix each row reads. At this slice's
// widths T <= 131, so no split over T (flash-decoding's combine) is
// needed; that is speed work for later.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBT = 32;      // cache positions per tile: one per lane
constexpr int kMaxDpl = 4;   // head_dim <= 32 * kMaxDpl = 128
constexpr int kMaxGroup = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

size_t smem_bytes(int group, int d) {
  return sizeof(float) * (static_cast<size_t>(group) * d +
                          static_cast<size_t>(kBT) * (d + 1) +
                          static_cast<size_t>(kBT) * d);
}

// DPL: output columns per lane, d <= 32 * DPL
template <int DPL>
__global__ void decode_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int* __restrict__ lengths,
                              const int* __restrict__ slot_pos,
                              const int* __restrict__ pos, int window,
                              float* __restrict__ o, int K, int group, int T,
                              int d, long long q_sb, long long q_sh,
                              Strides ks, Strides vs, long long o_sb,
                              long long o_sh, float scale) {
  extern __shared__ float smem[];
  const int dk = d + 1;
  float* Qs = smem;              // group x d
  float* Ks = Qs + group * d;    // kBT x dk
  float* Vs = Ks + kBT * dk;     // kBT x d

  const int b = blockIdx.x / K;
  const int kh = blockIdx.x - b * K;
  const int warp = threadIdx.x >> 5;  // query head kh * group + warp
  const int lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;

  for (int i = threadIdx.x; i < group * d; i += nthreads) {
    const int g = i / d;
    const int col = i - g * d;
    Qs[i] = q[b * q_sb + (kh * group + g) * q_sh + col];
  }
  const bool slots = slot_pos != nullptr;
  const int* sp = slots ? slot_pos + static_cast<long long>(b) * T : nullptr;
  const int p = slots ? pos[b] : 0;
  bool uniform;
  int n;
  if (slots) {
    int any = 0;
    for (int t = threadIdx.x; t < T; t += nthreads) {
      const int v = sp[t];
      any |= v >= 0 && v <= p && (window <= 0 || p - v < window);
    }
    uniform = !__syncthreads_or(any);
    n = T;
  } else {
    const int len = lengths[b];
    uniform = len <= 0;
    n = uniform ? T : min(len, T);
  }
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < n; t0 += kBT) {
    __syncthreads();  // Qs written; the last tile's reads are done
    for (int i = threadIdx.x; i < kBT * d; i += nthreads) {
      const int tt = i / d;
      const int col = i - tt * d;
      const int t = t0 + tt;
      float kv = 0.f, vv = 0.f;
      if (t < n) {
        kv = kb[t * ks.t + col];
        vv = vb[t * vs.t + col];
      }
      Ks[tt * dk + col] = kv;
      Vs[tt * d + col] = vv;
    }
    __syncthreads();

    const float* qrow = Qs + warp * d;
    float s = 0.f;
    for (int kk = 0; kk < d; ++kk) s = fmaf(qrow[kk], Ks[lane * dk + kk], s);
    const int t = t0 + lane;
    bool ok = t < n;
    if (ok && slots && !uniform) {
      const int v = sp[t];
      ok = v >= 0 && v <= p && (window <= 0 || p - v < window);
    }
    s = ok ? (uniform ? 0.f : s * scale) : -INFINITY;
    // a tile with nothing live leaves m = -inf, l = 0 and acc = 0
    const float m_new = fmaxf(m, warp_max(s));
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    const float pr = expf(s - m_use);
    l = l * alpha + warp_sum(pr);
    m = m_new;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= alpha;
    const int t_end = min(kBT, n - t0);
    for (int tt = 0; tt < t_end; ++tt) {
      const float pt = __shfl_sync(kFull, pr, tt);
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int col = lane + 32 * j;
        if (col < d) acc[j] = fmaf(pt, Vs[tt * d + col], acc[j]);
      }
    }
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* ob = o + b * o_sb + (kh * group + warp) * o_sh;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int col = lane + 32 * j;
    if (col < d) ob[col] = acc[j] * inv;
  }
}

template <int DPL>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lengths, const int* slot_pos, const int* pos,
                   int window, float* o, int B, int K, int group,
                   int T, int d, long long q_sb, long long q_sh, Strides ks,
                   Strides vs, long long o_sb, long long o_sh, float scale,
                   cudaStream_t st) {
  // raise the dynamic shared memory limit once per instantiation, to
  // what the largest group at its widest head_dim needs, so a call
  // inside a CUDA graph capture makes no attribute change
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxGroup, 32 * DPL)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const size_t bytes = smem_bytes(group, d);
  decode_kernel<DPL><<<B * K, 32 * group, bytes, st>>>(
      q, k, v, lengths, slot_pos, pos, window, o, K, group, T, d, q_sb, q_sh,
      ks, vs, o_sb, o_sh, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, H, d) with (b, h) strides; k/v: (B, K, T, d) with (b, kv, t)
// strides; either lengths: (B,) int32 (slot_pos and pos null) or
// slot_pos: (B, T) and pos: (B,) int32 with window >= 0 (lengths null),
// contiguous; o: (B, H, d) with (b, h) strides; float32, unit stride on
// d; H % K == 0, H / K <= 32, 1 <= d <= 128. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* slot_pos, const void* pos, int window, void* o, int B, int H, int K, int T, int d, long long q_sb,
    long long q_sh, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, float scale, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kMaxGroup || d <= 0 ||
      d > 32 * kMaxDpl || T <= 0 ||
      (lengths == nullptr) == (slot_pos == nullptr) ||
      (slot_pos != nullptr && pos == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* lf = static_cast<const int*>(lengths);
  const int* spf = static_cast<const int*>(slot_pos);
  const int* pf = static_cast<const int*>(pos);
  float* of = static_cast<float*>(o);
  const Strides ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st};
  const int group = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((d + 31) / 32) {
#define REPRO_DECODE_CASE(N)                                                \
  case N:                                                                   \
    err = launch<N>(qf, kf, vf, lf, spf, pf, window, of, B, K, group, T, d, \
                    q_sb, q_sh, ks, vs, o_sb, o_sh, scale, st);             \
    break;
    REPRO_DECODE_CASE(1)
    REPRO_DECODE_CASE(2)
    REPRO_DECODE_CASE(3)
    REPRO_DECODE_CASE(4)
#undef REPRO_DECODE_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
