// K8: one-token grouped-query attention over a KV cache in float32, the
// decode attention of the dense LM (models/layers.py::attention_decode):
//
//   o[b,h] = sum_{t live} softmax_t(q[b,h] . k[b,h/G,t] * scale)
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
// heads in VMEM scratch.
//
// Bound: bytes, the live cache rows (2 K d floats each) and the masks.
// Per byte of cache the kernel does G/4 operations (3 at starcoder2's
// group of 12), far below the float32 CUDA-core ridge of 67 TFLOP/s /
// 3.35 TB/s = 20, so the products run on CUDA cores in float32.
//
// Design (flash-decoding, in one launch). The earlier kernel gave one
// block to each (row, KV head) and walked its cache tile after tile:
// 32 blocks at starcoder2's serve shape, 5 at long_prefill's decode,
// each tile's load latency exposed in turn. Now:
//
//   * one block of 384 threads per (row, KV head, chunk of kChunk cache
//     positions): at (16, 2) rows x KV heads over a 131-slot cache 96
//     blocks, at long_prefill's 2048-slot ring of (1, 5) 160;
//   * the group's queries are copied first; then the chunk's live
//     positions are listed (under lengths the first len - t0, and a
//     chunk at or past len[b] exits before reading anything; under the
//     slot mask its slot_pos entries are read and compacted by ballot),
//     and only live rows of K and V are copied into shared memory:
//     16-byte cp.async copies through the (b, kv, t) strides (the model
//     passes permuted views), 4-byte ones where d or a stride is not a
//     multiple of 4 floats, no division in the copy loop; V in a second
//     group that lands while the scores are computed;
//   * the scores: one (head, position) per thread, the dot product as
//     four independent float4 sums (K rows padded to an odd number of
//     float4s: no bank conflicts; q broadcast); a softmax per head by
//     warp reductions; P.V with one (head, float4 of columns) per
//     thread;
//   * a row of one chunk writes o at once. Otherwise the block writes
//     its partial state (m, l, unnormalised acc[G, d]) to a scratch and
//     arrives on its (row, KV head) counter: a block barrier, then one
//     thread's acq_rel atomic add (scan_lookback.cuh), whose release is
//     cumulative over what the barrier ordered before it, as in a
//     cooperative grid sync. The last of the ceil(len / kChunk) chunks
//     (every chunk, under the slot mask) to arrive combines: it stages
//     the partials into shared memory in batches (a batch's copies all
//     in flight), keeps a running (m, l, acc) per head rescaled batch by
//     batch, sums in chunk order, so the output does not depend on which
//     block came last, and writes o. A chunk with nothing live arrives
//     with l = 0 and weighs 0.
//
// The counters are zeroed by one cudaMemsetAsync inside each call, on
// the launch stream, so a captured CUDA graph resets them on every
// replay; each call owns its scratch (allocated by the wrapper).
//
// A row with nothing live (a length <= 0, or no live slot) follows the
// plain version (kernels/decode_attention/ref.py), which softmaxes T
// equal masked scores: the mean of V over all T positions. The serving
// path never passes one (lengths = pos + 1; a row's current slot is
// always live).
//
// kChunk = 64 and 384 threads, chosen on an NVIDIA H100 80GB HBM3
// (700 W) with chip_sweep.py (CUDA-graph replays, two rounds, ms) at
// (16,24,2,131,128) with lengths / (16,25,5,131,64) with the slot mask /
// (1,25,5,2048,64) over a full ring: kChunk 64 0.01372, 0.01373 /
// 0.01150, 0.01145 / 0.01260, 0.01272; kChunk 32 0.01420, 0.01419 /
// 0.01126, 0.01127 / 0.01517, 0.01527; kChunk 16 0.01666, 0.01652 /
// 0.01455, 0.01470 / 0.02630, 0.02650; 256 threads 0.01546, 0.01511 /
// 0.01274, 0.01141 / 0.01282, 0.01283 (the earlier kernel: 0.02662,
// 0.02648 / 0.02353, 0.02331 / 0.28004, 0.27856). Of the 0.0137 ms at
// the lengths shape, the call's floor (every block returning at once:
// the memset and the launch) took 0.0072-0.0097 and the combine
// (the last arrival returning at once instead) 0.0019. The combine
// first read the partials with dependent loads, one chunk after another:
// at the full ring that took longer than the rest of the kernel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "async_copy.cuh"
#include "scan_lookback.cuh"

namespace {

namespace ac = async_copy;

constexpr int kChunk = 64;  // cache positions per block
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 32;
constexpr int kMaxD = 128;
// (head, float4 of columns) pairs a thread keeps in the combine
constexpr int kPairs = (kMaxGroup * (kMaxD / 4) + kThreads - 1) / kThreads;
// the combine's staging room, where the main phase's region is smaller
constexpr size_t kStageBytes = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }
constexpr int kChunkShift = log2i(kChunk);
static_assert(kChunk >= 16 && kChunk <= 128 && (1 << kChunkShift) == kChunk,
              "kChunk is a power of two in [16, 128]");

struct Strides {
  long long b, h, t;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* lengths;   // (B,) or null
  const int* slot_pos;  // (B, T) or null
  const int* pos;       // (B,) with slot_pos
  int window;
  float* o;
  int K, group, T, d, chunks;
  int stage;  // chunks the combine stages at once
  long long q_sb, q_sh;
  Strides ks, vs;
  long long o_sb, o_sh;
  float scale;
  unsigned* counters;  // (B * K,) zeroed per call
  float2* part_ml;     // (B * K, chunks, group) (m, l)
  float4* part_acc;    // (B * K, chunks, group, dp / 4)
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

__host__ __device__ __forceinline__ int padded_d(int d) {
  return (d + 3) & ~3;
}

// K/V row stride in floats: an odd number of float4s, so 8 consecutive
// rows read at one column hit 8 distinct 16-byte bank groups
__host__ __device__ __forceinline__ int row_ld(int d) {
  return ((padded_d(d) >> 2) | 1) << 2;
}

// floats of one chunk's staged partial state in the combine: acc
// (group x dp), (m, l) per head, and the head's weight
__host__ __device__ __forceinline__ int stage_floats(int group, int d) {
  return group * (padded_d(d) + 3);
}

// the small arrays at the front of shared memory, in 4-byte words:
// running (m, l) and the rescale of each head, the chunk's live rows,
// two flags (rounded to 16 bytes)
constexpr int kSmallWords = (3 * kMaxGroup + kChunk + 2 + 3) & ~3;

// floats of the main phase's region: Q, the K and V rows, the scores
size_t main_floats(int group, int d) {
  return static_cast<size_t>(group) * padded_d(d) +
         2 * static_cast<size_t>(kChunk) * row_ld(d) +
         static_cast<size_t>(group) * (kChunk + 1);
}

// chunks the combine stages at once: as many as the main region, or
// kStageBytes where that is more, holds
int stage_chunks(int group, int d, int chunks) {
  const size_t room = std::max(main_floats(group, d) * sizeof(float),
                               kStageBytes);
  const int fit = static_cast<int>(room /
                                   (sizeof(float) * stage_floats(group, d)));
  return std::max(1, std::min(fit, chunks));
}

size_t smem_bytes(int group, int d, int chunks) {
  const size_t stage = static_cast<size_t>(stage_chunks(group, d, chunks)) *
                       stage_floats(group, d);
  return sizeof(float) * (kSmallWords +
                          std::max(main_floats(group, d), stage));
}

// the most any call asks for
size_t max_smem_bytes() {
  return sizeof(float) * kSmallWords +
         std::max(main_floats(kMaxGroup, kMaxD) * sizeof(float),
                  kStageBytes);
}

__device__ __forceinline__ bool slot_live(int sp, int p, int window) {
  return sp >= 0 && sp <= p && (window <= 0 || p - sp < window);
}

struct LiveRow {
  const int* idx;
  __device__ __forceinline__ long long operator()(int r) const {
    return idx[r];
  }
};

// o[b, kh * group + g, :] = the mean of V over all T positions, for every
// head of the group: the plain version's answer for a row with nothing
// live
__device__ void mean_of_v(const Args& a, int b, int kh) {
  const float* vb = a.v + b * a.vs.b + kh * a.vs.h;
  for (int col = threadIdx.x; col < a.d; col += kThreads) {
    float s = 0.f;
#pragma unroll 8
    for (int t = 0; t < a.T; ++t) s += vb[t * a.vs.t + col];
    const float mean = s / a.T;
    for (int g = 0; g < a.group; ++g)
      a.o[b * a.o_sb + (kh * a.group + g) * a.o_sh + col] = mean;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int group = a.group, d = a.d;
  const int dp = padded_d(d), d4 = dp >> 2, ld = row_ld(d), ld4 = ld >> 2;
  float* small = reinterpret_cast<float*>(smem4);
  float* s_m = small;                  // group: (running) max
  float* s_l = s_m + kMaxGroup;        // group: (running) sum
  float* s_scale = s_l + kMaxGroup;    // group: rescale of the running acc
  int* idx = reinterpret_cast<int*>(s_scale + kMaxGroup);  // live rows
  int* s_flag = idx + kChunk;          // live count, last arrival
  float* Qs = small + kSmallWords;     // group x dp
  float* Ks = Qs + group * dp;         // kChunk x ld
  float* Vs = Ks + kChunk * ld;        // kChunk x ld
  float* Ps = Vs + kChunk * ld;        // group x (kChunk + 1)
  const float4* Q4 = reinterpret_cast<const float4*>(Qs);
  const float4* K4 = reinterpret_cast<const float4*>(Ks);
  const float4* V4 = reinterpret_cast<const float4*>(Vs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x;
  const int bk = blockIdx.y;
  const int b = bk / a.K;
  const int kh = bk - b * a.K;
  const int t0 = c * kChunk;
  const int pairs = group * d4;  // (head, float4 of columns)
  float* ob = a.o + b * a.o_sb + kh * group * a.o_sh;

  // the group's queries, in flight while the mask is read
  ac::copy_rows_of(Qs, dp, a.q + b * a.q_sb + kh * group * a.q_sh, a.q_sh,
                   ac::SameRow{}, group, d, kVec, tid, kThreads);
  ac::commit();

  // the chunk's live positions, and how many chunks of this (row, KV
  // head) arrive
  int n_arrive, nlive;
  if (a.lengths != nullptr) {
    const int len = a.lengths[b];
    const int n = len <= 0 ? 0 : min(len, a.T);
    n_arrive = max((n + kChunk - 1) / kChunk, 1);
    if (c >= n_arrive) {
      ac::wait<0>();
      return;
    }
    nlive = max(min(kChunk, n - t0), 0);
    for (int i = tid; i < nlive; i += kThreads) idx[i] = t0 + i;
  } else {
    n_arrive = a.chunks;
    if (warp == 0) {
      const int* sp = a.slot_pos + static_cast<long long>(b) * a.T;
      const int p = a.pos[b];
      int count = 0;
#pragma unroll
      for (int i0 = 0; i0 < kChunk; i0 += 32) {
        const int t = t0 + i0 + lane;
        const bool live = i0 + lane < kChunk && t < a.T &&
                          slot_live(sp[t], p, a.window);
        const unsigned ballot = __ballot_sync(kFull, live);
        if (live) idx[count + __popc(ballot & ((1u << lane) - 1u))] = t;
        count += __popc(ballot);
      }
      if (lane == 0) s_flag[0] = count;
    }
    __syncthreads();
    nlive = s_flag[0];
  }

  const long long cell = static_cast<long long>(bk) * a.chunks;
  if (nlive > 0) {
    __syncthreads();  // idx written
    const LiveRow rows{idx};
    ac::copy_rows_of(Ks, ld, a.k + b * a.ks.b + kh * a.ks.h, a.ks.t, rows,
                     nlive, d, kVec, tid, kThreads);
    ac::commit();
    ac::copy_rows_of(Vs, ld, a.v + b * a.vs.b + kh * a.vs.h, a.vs.t, rows,
                     nlive, d, kVec, tid, kThreads);
    ac::commit();  // V lands while the scores are computed
    if (!kVec && dp != d) {  // zero the pad columns the float4 loops read
      for (int col = d + tid; col < dp; col += kThreads) {
        for (int g = 0; g < group; ++g) Qs[g * dp + col] = 0.f;
        for (int r = 0; r < nlive; ++r) {
          Ks[r * ld + col] = 0.f;
          Vs[r * ld + col] = 0.f;
        }
      }
    }
    ac::wait<1>();  // Q and K
    __syncthreads();

    // scores: one (head, position) per thread and pass, the dot product
    // as four independent sums
    for (int p = tid; p < group * kChunk; p += kThreads) {
      const int g = p >> kChunkShift;
      const int t = p & (kChunk - 1);
      float s = -INFINITY;
      if (t < nlive) {
        const float4* kr = K4 + t * ld4;
        const float4* qr = Q4 + g * d4;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int j = 0; j < d4; ++j) {
          const float4 kv = kr[j], qv = qr[j];
          acc.x = fmaf(qv.x, kv.x, acc.x);
          acc.y = fmaf(qv.y, kv.y, acc.y);
          acc.z = fmaf(qv.z, kv.z, acc.z);
          acc.w = fmaf(qv.w, kv.w, acc.w);
        }
        s = ((acc.x + acc.y) + (acc.z + acc.w)) * a.scale;
      }
      Ps[g * (kChunk + 1) + t] = s;
    }
    __syncthreads();

    // softmax over the chunk, one warp per head
    for (int g = warp; g < group; g += kWarps) {
      float* pg = Ps + g * (kChunk + 1);
      float m = -INFINITY;
#pragma unroll
      for (int i = lane; i < kChunk; i += 32) m = fmaxf(m, pg[i]);
      m = warp_max(m);  // finite: the chunk has a live position
      float l = 0.f;
#pragma unroll
      for (int i = lane; i < kChunk; i += 32) {
        const float e = expf(pg[i] - m);
        pg[i] = e;
        l += e;
      }
      l = warp_sum(l);
      if (lane == 0) {
        s_m[g] = m;
        s_l[g] = l;
      }
    }
    ac::wait<0>();  // V
    __syncthreads();

    // P.V: one (head, float4 of columns) per thread and pass; a row of
    // one chunk writes o, any other its partial acc
    for (int p = tid; p < pairs; p += kThreads) {
      const int g = p / d4;
      const int c4 = p - g * d4;
      const float* pr = Ps + g * (kChunk + 1);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int t = 0; t < nlive; ++t) {
        const float w = pr[t];
        const float4 vv = V4[t * ld4 + c4];
        acc.x = fmaf(w, vv.x, acc.x);
        acc.y = fmaf(w, vv.y, acc.y);
        acc.z = fmaf(w, vv.z, acc.z);
        acc.w = fmaf(w, vv.w, acc.w);
      }
      if (n_arrive == 1) {
        const float inv = 1.f / s_l[g];
        float* og = ob + g * a.o_sh + 4 * c4;
        const float r[4] = {acc.x * inv, acc.y * inv, acc.z * inv,
                            acc.w * inv};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * c4 + j < d) og[j] = r[j];
      } else {
        a.part_acc[(cell + c) * pairs + p] = acc;
      }
    }
    if (n_arrive == 1) return;
  } else {
    ac::wait<0>();
    if (n_arrive == 1) {  // nothing live in the row
      mean_of_v(a, b, kh);
      return;
    }
    for (int g = tid; g < group; g += kThreads) {
      s_m[g] = -INFINITY;
      s_l[g] = 0.f;
    }
    __syncthreads();
  }

  // publish the partial state, arrive; the last arrival combines
  for (int g = tid; g < group; g += kThreads)
    a.part_ml[(cell + c) * group + g] = make_float2(s_m[g], s_l[g]);
  // the barrier orders the block's stores before thread 0's release
  // (cumulative, as in a cooperative grid sync)
  __syncthreads();
  if (tid == 0) {
    const unsigned old =
        repro::lookback::fetch_add_acq_rel(a.counters + bk, 1u);
    s_flag[1] = old == static_cast<unsigned>(n_arrive - 1);
  }
  __syncthreads();
  if (!s_flag[1]) return;

  // the combine: the partials staged into shared memory in batches of
  // chunks, a batch's copies all in flight at once; a running (m, l,
  // acc) per head, rescaled batch by batch, every sum in chunk order
  for (int g = tid; g < group; g += kThreads) {
    s_m[g] = -INFINITY;
    s_l[g] = 0.f;
  }
  float4 run[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) run[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* st_acc = Qs;  // (nb, group, dp)
  const float4* X4 = reinterpret_cast<const float4*>(st_acc);
  for (int c0 = 0; c0 < n_arrive; c0 += a.stage) {
    const int nb = min(a.stage, n_arrive - c0);
    float* st_ml = st_acc + nb * group * dp;  // (nb, group) (m, l)
    float* st_w = st_ml + 2 * nb * group;     // (group, nb) weights
    ac::copy_rows_of(
        st_acc, 0,
        reinterpret_cast<const float*>(a.part_acc + (cell + c0) * pairs), 0,
        ac::SameRow{}, 1, nb * group * dp, true, tid, kThreads);
    ac::copy_rows_of(
        st_ml, 0,
        reinterpret_cast<const float*>(a.part_ml + (cell + c0) * group), 0,
        ac::SameRow{}, 1, 2 * nb * group, false, tid, kThreads);
    ac::commit();
    ac::wait<0>();
    __syncthreads();
    for (int g = warp; g < group; g += kWarps) {
      float mb = -INFINITY;
      for (int i = lane; i < nb; i += 32) {
        const float* ml = st_ml + 2 * (i * group + g);
        if (ml[1] > 0.f) mb = fmaxf(mb, ml[0]);
      }
      const float m_old = s_m[g], l_old = s_l[g];
      const float m_new = fmaxf(m_old, warp_max(mb));
      float lb = 0.f;
      for (int i = lane; i < nb; i += 32) {
        const float* ml = st_ml + 2 * (i * group + g);
        // an empty chunk (l = 0) weighs 0: its acc was never written
        const float w = ml[1] > 0.f ? expf(ml[0] - m_new) : 0.f;
        st_w[g * nb + i] = w;
        lb += ml[1] * w;
      }
      lb = warp_sum(lb);
      if (lane == 0) {
        const float scale = l_old > 0.f ? expf(m_old - m_new) : 0.f;
        s_scale[g] = scale;
        s_m[g] = m_new;
        s_l[g] = l_old * scale + lb;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int p = tid + q * kThreads;
      if (p >= pairs) break;
      const int g = p / d4;
      const float scale = s_scale[g];
      const float* wg = st_w + g * nb;
      float4 sum = make_float4(run[q].x * scale, run[q].y * scale,
                               run[q].z * scale, run[q].w * scale);
#pragma unroll 4
      for (int i = 0; i < nb; ++i) {
        const float w = wg[i];
        const float4 x = X4[i * pairs + p];
        // select, not multiply: an unwritten acc may hold a NaN
        sum.x += w > 0.f ? w * x.x : 0.f;
        sum.y += w > 0.f ? w * x.y : 0.f;
        sum.z += w > 0.f ? w * x.z : 0.f;
        sum.w += w > 0.f ? w * x.w : 0.f;
      }
      run[q] = sum;
    }
    __syncthreads();  // the stage is read before the next batch
  }

  if (s_l[0] == 0.f) {  // nothing live in the row (every head alike)
    mean_of_v(a, b, kh);
    return;
  }
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int p = tid + q * kThreads;
    if (p >= pairs) break;
    const int g = p / d4;
    const int c4 = p - g * d4;
    const float inv = 1.f / s_l[g];
    float* og = ob + g * a.o_sh + 4 * c4;
    const float r[4] = {run[q].x * inv, run[q].y * inv, run[q].z * inv,
                        run[q].w * inv};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * c4 + j < d) og[j] = r[j];
  }
}

struct ScratchLayout {
  size_t ml, acc, bytes;
};

ScratchLayout scratch_layout(int B, int K, int group, int chunks, int d) {
  const size_t cells = static_cast<size_t>(B) * K;
  const size_t parts = cells * chunks * group;
  ScratchLayout s;
  s.ml = (cells * sizeof(unsigned) + 15) & ~size_t{15};
  s.acc = (s.ml + parts * sizeof(float2) + 15) & ~size_t{15};
  s.bytes = s.acc + parts * padded_d(d) * sizeof(float);
  return s;
}

template <bool kVec>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  // allow the most dynamic shared memory a call can ask for, once per
  // instance, so a call inside a CUDA graph capture makes no attribute
  // change
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(max_smem_bytes()));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(a.chunks, B * a.K);
  decode_kernel<kVec><<<grid, kThreads, smem_bytes(a.group, a.d, a.chunks),
                        st>>>(a);
  return cudaGetLastError();
}

bool valid(int B, int H, int K, int T, int d) {
  return B >= 0 && H > 0 && K > 0 && H % K == 0 && H / K <= kMaxGroup &&
         d > 0 && d <= kMaxD && T > 0 &&
         static_cast<long long>(B) * K <= 65535;
}

}  // namespace

// cache positions per block (attention_cases.DECODE_CHUNK)
extern "C" int repro_decode_chunk() { return kChunk; }

// bytes of scratch repro_decode_attention needs at these sizes (0 for
// sizes it refuses)
extern "C" long long repro_decode_scratch_bytes(int B, int H, int K, int T,
                                                int d) {
  if (!valid(B, H, K, T, d)) return 0;
  const int chunks = (T + kChunk - 1) / kChunk;
  return static_cast<long long>(
      scratch_layout(B, K, H / K, chunks, d).bytes);
}

// q: (B, H, d) with (b, h) strides; k/v: (B, K, T, d) with (b, kv, t)
// strides; either lengths: (B,) int32 (slot_pos and pos null) or
// slot_pos: (B, T) and pos: (B,) int32 with window >= 0 (lengths null),
// contiguous; o: (B, H, d) with (b, h) strides; float32, unit stride on
// d; H % K == 0, H / K <= 32, 1 <= d <= 128, B * K <= 65535; scratch:
// repro_decode_scratch_bytes(B, H, K, T, d) bytes, 16-byte aligned.
// Returns the CUDA error code of the memset and the launch (0 on
// success).
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* slot_pos, const void* pos, int window, void* o, int B,
    int H, int K, int T, int d, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long o_sb, long long o_sh,
    float scale, void* scratch, void* stream) {
  if (!valid(B, H, K, T, d) || (lengths == nullptr) == (slot_pos == nullptr) ||
      (slot_pos != nullptr && pos == nullptr) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.lengths = static_cast<const int*>(lengths);
  a.slot_pos = static_cast<const int*>(slot_pos);
  a.pos = static_cast<const int*>(pos);
  a.window = window;
  a.o = static_cast<float*>(o);
  a.K = K;
  a.group = H / K;
  a.T = T;
  a.d = d;
  a.chunks = (T + kChunk - 1) / kChunk;
  a.stage = stage_chunks(a.group, d, a.chunks);
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.ks = Strides{k_sb, k_sh, k_st};
  a.vs = Strides{v_sb, v_sh, v_st};
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.scale = scale;
  const ScratchLayout lay = scratch_layout(B, K, a.group, a.chunks, d);
  char* base = static_cast<char*>(scratch);
  a.counters = reinterpret_cast<unsigned*>(base);
  a.part_ml = reinterpret_cast<float2*>(base + lay.ml);
  a.part_acc = reinterpret_cast<float4*>(base + lay.acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(B) * K * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies: every row start a multiple of 4 floats from a
  // 16-byte aligned base
  const bool vec =
      d % 4 == 0 && q_sb % 4 == 0 && q_sh % 4 == 0 && k_sb % 4 == 0 &&
      k_sh % 4 == 0 && k_st % 4 == 0 && v_sb % 4 == 0 && v_sh % 4 == 0 &&
      v_st % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  err = vec ? launch<true>(a, B, st) : launch<false>(a, B, st);
  return static_cast<int>(err);
}
