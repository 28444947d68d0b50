// K7: causal grouped-query attention forward in float32, the prefill
// attention of the dense LM (models/layers.py::attention_block):
//
//   o[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,h/G,j] * scale) v[b,h/G,j]
//
// over keys j <= i when causal, and only over i - j < window when a
// sliding window is given (window > 0; the hybrid family's attention),
// with G = H / K query heads per KV head.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_kernel, whose grid walks the key blocks of one query
// block in order and carries the online-softmax state (m, l, acc) in
// VMEM scratch from one grid step to the next. Hopper blocks run in no
// order, so the key loop moves inside the block instead:
//
//   * one block per (batch row, query head, tile of kBQ = 64 queries),
//     256 threads as 16 row groups of 16 lanes; a row group owns 4 query
//     rows, a lane 2 score columns of each key tile and d/16 output
//     columns;
//   * the query tile stays in shared memory; key tiles of kBK = 32 rows
//     are staged there (K transposed, so lanes read neighbouring words),
//     scores go through shared memory to the P.V product;
//   * m, l and acc stay in registers in float32; row maxima and sums
//     reduce over the 16 lanes of a row group with shuffles;
//   * under causal, key tiles wholly after the query tile are never
//     loaded, and under a window, key tiles wholly before the first
//     query's window; the ragged ends of queries and keys are masked,
//     not padded; a row whose keys of a tile are all masked keeps its
//     state (every row sees at least its own key);
//   * the KV head is h / G, so K and V are never repeated H-wide;
//   * q, k, v and o are read and written through their (b, h, s) strides
//     (unit stride on d), so the model's (B, S, H, d) projections go in
//     as transposed views without a copy.
//
// Arithmetic is CUDA-core FMAs in float32 (no TF32: the reference runs
// in float32). Bound: operations at the model's widths, 4 d flops per
// visible (query, key) pair against the float32 rate; the inputs are
// read once per query tile.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;
constexpr int kMaxDpt = 8;     // head_dim <= 16 * kMaxDpt = 128
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off, 16));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off, 16);
  return x;
}

size_t smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (d + 1) +
                          static_cast<size_t>(d) * (kBK + 1) +
                          static_cast<size_t>(kBK) * d +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

// DPT: output columns per lane, d <= 16 * DPT
template <int DPT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int group, int Sq, int Sk, int d, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale, int causal,
                 int window) {
  extern __shared__ float smem[];
  const int dq = d + 1;                // padded row stride of the Q tile
  float* Qs = smem;                    // kBQ x dq
  float* Kt = Qs + kBQ * dq;           // d x (kBK + 1), K transposed
  float* Vs = Kt + d * (kBK + 1);      // kBK x d
  float* Ps = Vs + kBK * d;            // kBQ x (kBK + 1)

  const int tid = threadIdx.x;
  const int r = tid >> 4;  // row group: tile rows kRows*r .. +kRows-1
  const int c = tid & 15;  // lane within the row group
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kh = h / group;
  const int q0 = blockIdx.y * kBQ;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int row = i / d;
    const int col = i - row * d;
    const int qi = q0 + row;
    Qs[row * dq + col] = qi < Sq ? qb[qi * qs.s + col] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // causal: keys past the tile's last query are never visible; window:
  // keys before the first query's window are never visible
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's Vs/Ps reads are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int t = i / d;
      const int col = i - t * d;
      const int kj = k0 + t;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk) {
        kv = kb[kj * ks.s + col];
        vv = vb[kj * vs.s + col];
      }
      Kt[col * (kBK + 1) + t] = kv;
      Vs[t * d + col] = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      float kv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Kt[kk * (kBK + 1) + c + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qv = Qs[(kRows * r + i) * dq + kk];
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + kRows * r + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + c + 16 * j;
        const bool ok = kj < Sk && (!causal || kj <= qi) &&
                        (window <= 0 || qi - kj < window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_use);
        Ps[(kRows * r + i) * (kBK + 1) + c + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int t_end = min(kBK, k_end - k0);
    for (int t = 0; t < t_end; ++t) {
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int col = c + 16 * j;
        vv[j] = col < d ? Vs[t * d + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = Ps[(kRows * r + i) * (kBK + 1) + t];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + kRows * r + i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int col = c + 16 * j;
      if (col < d) ob[qi * os.s + col] = acc[i][j] * inv;
    }
  }
}

template <int DPT>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int H, int group, int Sq, int Sk, int d,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, int window, cudaStream_t st) {
  // raise the dynamic shared memory limit once per instantiation, to
  // what its widest head_dim needs, so a call inside a CUDA graph
  // capture makes no attribute change
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(16 * DPT)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const size_t bytes = smem_bytes(d);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<DPT><<<grid, kThreads, bytes, st>>>(
      q, k, v, o, H, group, Sq, Sk, d, qs, ks, vs, os, scale, causal,
      window);
  return cudaGetLastError();
}

}  // namespace

// q: (B, H, Sq, d), k/v: (B, K, Sk, d), o: (B, H, Sq, d), all float32
// with unit stride on d and the given (b, h, s) strides in elements;
// H % K == 0, 1 <= d <= 128, B * H < 2^31, Sq < 2^16 * 64; window 0 is
// none. Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int K, int Sq, int Sk, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int window,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K != 0 || d <= 0 || d > 16 * kMaxDpt)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const int group = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((d + 15) / 16) {
#define REPRO_FLASH_CASE(N)                                                 \
  case N:                                                                   \
    err = launch<N>(qf, kf, vf, of, B, H, group, Sq, Sk, d, qs, ks, vs, os, \
                    scale, causal, window, st);                             \
    break;
    REPRO_FLASH_CASE(1)
    REPRO_FLASH_CASE(2)
    REPRO_FLASH_CASE(3)
    REPRO_FLASH_CASE(4)
    REPRO_FLASH_CASE(5)
    REPRO_FLASH_CASE(6)
    REPRO_FLASH_CASE(7)
    REPRO_FLASH_CASE(8)
#undef REPRO_FLASH_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
