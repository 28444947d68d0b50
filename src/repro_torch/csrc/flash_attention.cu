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
// order, so the key loop moves inside the block:
//
//   * one block per (batch row, query head, tile of kBQ = 64 queries),
//     four warps of 16 query rows each; the heaviest (last) query tiles
//     are scheduled first. The KV head is h / G: K and V are never
//     repeated H-wide, and the G blocks of one KV head read its tiles
//     from L2 (packing the G heads into one block's rows was not taken);
//   * key tiles of kBK = 32 rows go through a two-stage ring in shared
//     memory beside the query tile: 96 KB at d = 128, so two blocks share
//     an SM and one block's copies overlap the other's products (two
//     64-key stages would take 160 KB, one block per SM, and leave every
//     block's first tile exposed; at d = 256, paligemma-3b's head, the
//     query tile and the ring take 194 KB, one block per SM, and a warp's
//     16 x 256 output is 128 registers a thread). Where q, k and v start
//     on 16 bytes and their strides are multiples of 16 bytes (the
//     model's views), the
//     TMA unit copies each 32-column box of a tile from a tensor map
//     (one thread issues them), filling rows and columns outside the
//     tensor with zeros and counting the bytes on the stage's mbarrier,
//     which the warps wait on; otherwise every thread copies 4-byte
//     words with cp.async into the same layout. Tile t + 2 is requested
//     as soon as tile t is consumed, behind one block barrier per tile;
//   * the tiles are stored as the TMA unit's 128-byte swizzle lays them
//     out (each 32-column box row-major, 16-byte unit u of row r at u ^
//     (r % 8)), so every fragment load hits 32 banks; head_dim is
//     zero-padded to the 32-column boxes (d = 36, 80 ...);
//   * S = Q.K^T and O += P.V run on the tensor cores in error-compensated
//     TF32 (mma_tf32x3.cuh: each float32 operand split into two TF32
//     parts, three mma.sync.m16n8k8 products; the scores keep the small
//     terms in an accumulator of their own, so that fewer products wait
//     on each other): a warp's 16 x 32 scores and its 16 x d output stay
//     in registers, the online softmax runs in float32 and base 2 on the
//     accumulator fragments (row max and sum over the four lanes of a row
//     by shuffles), and the score fragments are P.V's A operand as they
//     stand (the key order inside an 8-key step is permuted to match);
//   * under causal, key tiles wholly after the query tile are never
//     loaded, and under a window, key tiles wholly before the first
//     query's window, and a warp skips a tile that none of its 16 rows
//     sees (inside a tile every product is issued, branch-free, so that
//     the independent products overlap); ragged ends are masked
//     (selected to -inf), not padded; a row whose keys in a tile are all
//     masked keeps its state;
//   * q, k, v and o are read and written through their (b, h, s) strides
//     (unit stride on d), so the model's (B, S, H, d) projections go in
//     as transposed views without a copy.
//
// Bound: at the model's widths the bytes (q, k, v read once, o written
// once: 54.5 MB at starcoder2-3b's admission, 0.0163 ms at 3.35 TB/s)
// outweigh the operations, 4 d flops per visible (query, key) pair
// (1.62 GFLOP there: 0.0098 ms at the 165 TFLOP/s that three TF32
// products leave of the 495 TFLOP/s dense TF32 rate; 0.024 ms at the
// 67 TFLOP/s float32 CUDA-core rate).
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "mma_tf32x3.cuh"

namespace {

namespace ac = async_copy;

constexpr int kBQ = 64;  // query rows per block: 4 warps x 16
constexpr int kBK = 32;  // keys per ring stage
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kMaxD16 = 16;   // head_dim <= 16 * kMaxD16 = 256
constexpr int kBox = 32;      // columns per TMA box (128 bytes)
constexpr int kAlign = 1024;  // the 128-byte swizzle repeats every 1 KB
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;
};

// where a tensor's (row, head, batch) coordinates go among the tensor
// map's dimensions 1..3 (the map orders them by stride)
struct MapOrder {
  int row, head, batch;
};

// float offset of (r, col) in a tile of R rows stored as 32-column boxes
// with the 128-byte swizzle: 16-byte unit u of row r sits at u ^ (r % 8)
__device__ __forceinline__ int sw(int r, int col, int R) {
  return (col >> 5) * R * kBox + r * kBox +
         ((((col >> 2) & 7) ^ (r & 7)) << 2) + (col & 3);
}

// floats of the query tile and of one key (or value) tile
__host__ __device__ constexpr int q_floats(int d16) {
  return kBQ * kBox * ((16 * d16 + kBox - 1) / kBox);
}
__host__ __device__ constexpr int kv_floats(int d16) {
  return kBK * kBox * ((16 * d16 + kBox - 1) / kBox);
}

// padding to 1 KB, the mbarriers' kilobyte, then the query tile and
// kStages K and V tiles (every tile a multiple of 1 KB)
size_t smem_bytes(int d16) {
  return 2 * kAlign + sizeof(float) * (static_cast<size_t>(q_floats(d16)) +
                                       2 * kStages * kv_floats(d16));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// the TMA copy of the box at column ``col`` of rows [row, row + box rows)
// of (head, batch)
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap& map,
                                        MapOrder o, int col, int row,
                                        int head, int batch, uint64_t* bar) {
  const int c1 = o.row == 0 ? row : o.head == 0 ? head : batch;
  const int c2 = o.row == 1 ? row : o.head == 1 ? head : batch;
  const int c3 = o.row == 2 ? row : o.head == 2 ? head : batch;
  ac::tensor4(dst, &map, col, c1, c2, c3, bar);
}

// D16: head_dim <= 16 * D16; TMA: the tiles arrive by tensor-map copies
// (else cp.async words)
template <int D16, bool TMA>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, MapOrder qo,
                 MapOrder ko, MapOrder vo, const float* __restrict__ q,
                 const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, int H, int group, int Sq, int Sk,
                 int d, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal, int window) {
  constexpr int DP = 16 * D16;  // head_dim padded to the output tiles
  constexpr int NB = (DP + kBox - 1) / kBox;  // 32-column boxes
  constexpr int DC = NB * kBox;               // columns stored
  constexpr int QT = q_floats(D16);
  constexpr int KT = kv_floats(D16);
  constexpr int ND = DP / 8;  // 8-column output tiles
  // the score product's 8-column steps unrolled: all of them at d = 128
  // (measured faster), 4 at a time at d <= 64 (fewer registers, faster),
  // 8 at a time above 128, where the 16 x d output alone takes d / 2
  // registers a thread
  constexpr int kQkUnroll = DP <= 64 ? 4 : DP <= 128 ? DP / 8 : 8;
  // softmax in base 2: exp(x) = 2^(x log2 e), log2 e folded into the
  // scale (exp2f takes fewer instructions than expf, on every score)
  const float scale2 = scale * 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of the address: align the tiles to 1 KB
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~static_cast<uintptr_t>(kAlign - 1));
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);
  float* Qs = reinterpret_cast<float*>(base + kAlign);
  float* Ks = Qs + QT;            // kStages tiles
  float* Vs = Ks + kStages * KT;  // kStages tiles

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and B column)
  const int t = lane & 3;   // fragment column pair
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  // causal: keys past the tile's last query are never visible; window:
  // keys before the first query's window are never visible
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK
                                     : 0;
  const int qrows = min(kBQ, Sq - q0);

  if (TMA) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) ac::mbar_init(&bars[s], 1);
      ac::fence_mbar_init();
    }
  } else {
    // the TMA unit fills what lies outside the tensors with zeros; the
    // word copies leave it to this: columns [d, DC) of every tile, the
    // query rows past Sq, and the rows past k_end of the stage that takes
    // the last key tile (a stage never written holds no finite values,
    // and V is multiplied by P = 0 there)
    for (int r = tid; r < kBQ + 2 * kStages * kBK; r += kThreads) {
      float* tile = r < kBQ ? Qs : Ks + ((r - kBQ) / kBK) * KT;
      const int rr = r < kBQ ? r : (r - kBQ) % kBK;
      const int R = r < kBQ ? kBQ : kBK;
      for (int c = d; c < DC; ++c) tile[sw(rr, c, R)] = 0.f;
    }
    for (int r = qrows + warp; r < kBQ; r += kWarps)
      for (int c = lane; c < d; c += 32) Qs[sw(r, c, kBQ)] = 0.f;
    if (ntiles > 0) {
      const int last = ntiles - 1;
      const int tail = k_end - (k_begin + last * kBK);
      float* kt = Ks + (last % kStages) * KT;
      float* vt = Vs + (last % kStages) * KT;
      for (int r = tail + warp; r < kBK; r += kWarps)
        for (int c = lane; c < d; c += 32) {
          kt[sw(r, c, kBK)] = 0.f;
          vt[sw(r, c, kBK)] = 0.f;
        }
    }
  }
  __syncthreads();

  // request key tile ``it`` (and, with tile 0, the query tile) into
  // stage it % kStages; with cp.async every call commits one group
  auto request = [&](int it) {
    const bool live = it < ntiles;
    const int k0 = k_begin + it * kBK;
    float* kt = Ks + (it % kStages) * KT;
    float* vt = Vs + (it % kStages) * KT;
    if (TMA) {
      if (!live || tid != 0) return;
      uint64_t* bar = &bars[it % kStages];
      ac::mbar_expect_tx(bar, 4u * (2 * KT + (it == 0 ? QT : 0)));
      for (int c = 0; c < NB; ++c) {
        tma_box(kt + c * kBK * kBox, kmap, ko, c * kBox, k0, kh, b, bar);
        tma_box(vt + c * kBK * kBox, vmap, vo, c * kBox, k0, kh, b, bar);
        if (it == 0)
          tma_box(Qs + c * kBQ * kBox, qmap, qo, c * kBox, q0, h, b, bar);
      }
    } else {
      if (live) {
        const int rows = min(kBK, k_end - k0);
        for (int e = tid; e < rows * d; e += kThreads) {
          const int r = e / d;
          const int c = e - r * d;
          ac::cp4(kt + sw(r, c, kBK), kb + (k0 + r) * ks.s + c);
          ac::cp4(vt + sw(r, c, kBK), vb + (k0 + r) * vs.s + c);
        }
        if (it == 0)
          for (int e = tid; e < qrows * d; e += kThreads) {
            const int r = e / d;
            const int c = e - r * d;
            ac::cp4(Qs + sw(r, c, kBQ), qb + (q0 + r) * qs.s + c);
          }
      }
      ac::commit();
    }
  };

  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int qa = q0 + 16 * warp;  // the warp's first query row
  const int row[2] = {qa + g, qa + g + 8};

  for (int it = 0; it < kStages; ++it) request(it);
  for (int it = 0; it < ntiles; ++it) {
    if (TMA) {
      ac::mbar_wait(&bars[it % kStages], (it / kStages) & 1);
    } else {
      ac::wait<kStages - 1>();
      __syncthreads();
    }
    const int k0 = k_begin + it * kBK;
    const float* Kt = Ks + (it % kStages) * KT;
    const float* Vt = Vs + (it % kStages) * KT;
    // a warp none of whose rows sees a key of the tile skips it (a
    // branch per 8-key step would serialise the products)
    const bool live = qa < Sq && (!causal || k0 <= qa + 15) &&
                      (window <= 0 || k0 + kBK - 1 > qa - window);
    if (live) {
      // S = Q.K^T, 16 x 32 per warp; the small terms of the split product
      // in an accumulator of their own
      float s[kBK / 8][4], s_lo[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s_lo[j][e] = 0.f;
#pragma unroll kQkUnroll
      for (int kk = 0; kk < DP; kk += 8) {
        // columns kk + t and kk + t + 4 are 16-byte units u and u + 1 of
        // a box row; rows 16 warp + g (+ 8) and 8 j + g are g mod 8
        const int u = (kk >> 2) & 7;
        const int ua = ((u ^ g) << 2) + t;
        const int ub = (((u + 1) ^ g) << 2) + t;
        const float* qr = Qs + (kk >> 5) * kBQ * kBox + (16 * warp + g) * kBox;
        const float af[4] = {qr[ua], qr[8 * kBox + ua], qr[ub],
                             qr[8 * kBox + ub]};
        uint32_t ah[4], al[4];
        tf32x3::split(af, ah, al);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float* kr = Kt + (kk >> 5) * kBK * kBox + (8 * j + g) * kBox;
          const float bf[2] = {kr[ua], kr[ub]};
          uint32_t bh[2], bl[2];
          tf32x3::split(bf, bh, bl);
          tf32x3::mma(s_lo[j], al, bh);
          tf32x3::mma(s_lo[j], ah, bl);
          tf32x3::mma(s[j], ah, bh);
        }
      }

      // online softmax in float32 on the fragments (scores in log2 units):
      // element e of step j is row row[e / 2], key k0 + 8 j + 2 t + e % 2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = row[e >> 1];
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = kj < k_end && (!causal || kj <= qi) &&
                          (window <= 0 || qi - kj < window);
          s[j][e] = ok ? (s_lo[j][e] + s[j][e]) * scale2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - m_use[r]);
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m_use[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // O += P.V: the score fragment of step j is the A operand of keys
      // k0 + 8 j + 2 t (k = t) and + 1 (k = t + 4); V's rows 8 j + 2 t
      // and + 1 are 2 t and 2 t + 1 mod 8, column 8 c + g is unit
      // 2 (c % 4) + g / 4 of box c / 4
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float pf[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t ph[4], pl[4];
        tf32x3::split(pf, ph, pl);
        const float* vr = Vt + (8 * j + 2 * t) * kBox + (g & 3);
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          const int u = 2 * (c & 3) + (g >> 2);
          const float* vb0 = vr + (c >> 2) * kBK * kBox;
          const float bf[2] = {vb0[(u ^ (2 * t)) << 2],
                               vb0[kBox + ((u ^ (2 * t + 1)) << 2)]};
          uint32_t bh[2], bl[2];
          tf32x3::split(bf, bh, bl);
          tf32x3::mma3(acc[c], ph, pl, bh, bl);
        }
      }
    }

    __syncthreads();  // every warp is done with this stage
    request(it + kStages);
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row[r];
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* orow = ob + qi * os.s;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < d) orow[col] = acc[c][2 * r] * inv;
      if (col + 1 < d) orow[col + 1] = acc[c][2 * r + 1] * inv;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (no link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tensor map over ``ptr`` (B, heads, S, d) float32 with the given
// element strides: boxes of 32 columns x ``rows`` rows, the 128-byte
// swizzle, the three outer dimensions ordered by stride (``order`` says
// where each went)
bool make_map(CUtensorMap* map, MapOrder* order, const void* ptr, int B,
              int heads, int S, int d, Strides st, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  // (extent, byte stride) of row, head, batch; a dimension of extent 1
  // takes any valid stride
  const long long ext[3] = {S, heads, B};
  long long str[3] = {st.s * 4, st.h * 4, st.b * 4};
  long long big = 16;
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1 && str[i] > big) big = str[i];
  for (int i = 0; i < 3; ++i)
    if (ext[i] == 1) str[i] = big;
  int idx[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (str[idx[j]] < str[idx[i]]) {
        const int x = idx[i];
        idx[i] = idx[j];
        idx[j] = x;
      }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 1, 1, 1};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {kBox, 1, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(ext[idx[i]]);
    strides[i] = static_cast<cuuint64_t>(str[idx[i]]);
    pos[idx[i]] = i;
    if (idx[i] == 0) box[i + 1] = static_cast<cuuint32_t>(rows);
  }
  *order = MapOrder{pos[0], pos[1], pos[2]};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D16, bool TMA>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, MapOrder qo, MapOrder ko,
                   MapOrder vo, const float* q, const float* k,
                   const float* v, float* o, int B, int H, int group, int Sq,
                   int Sk, int d, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale, int causal, int window,
                   cudaStream_t st) {
  // raise the dynamic shared memory limit once per instantiation (its
  // size does not depend on the call), so a call inside a CUDA graph
  // capture makes no attribute change
  static bool configured = false;
  const size_t bytes = smem_bytes(D16);
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D16, TMA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D16, TMA><<<grid, kThreads, bytes, st>>>(
      qm, km, vm, qo, ko, vo, q, k, v, o, H, group, Sq, Sk, d, qs, ks, vs,
      os, scale, causal, window);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// q: (B, H, Sq, d), k/v: (B, K, Sk, d), o: (B, H, Sq, d), all float32
// with unit stride on d and the given (b, h, s) strides in elements;
// H % K == 0, 1 <= d <= 256, B * H < 2^31, Sq < 2^16 * 64; window 0 is
// none. Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int K, int Sq, int Sk, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int window,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (K <= 0 || H % K != 0 || d <= 0 || d > 16 * kMaxD16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  // the tensor maps need 16-byte aligned bases and strides
  const bool tma = aligned16(q) && aligned16(k) && aligned16(v) &&
                   (q_sb | q_sh | q_ss | k_sb | k_sh | k_ss | v_sb | v_sh |
                    v_ss) % 4 == 0;
  CUtensorMap qm{}, km{}, vm{};
  MapOrder qo{0, 1, 2}, ko{0, 1, 2}, vo{0, 1, 2};
  if (tma && !(make_map(&qm, &qo, q, B, H, Sq, d, qs, kBQ) &&
               make_map(&km, &ko, k, B, K, Sk, d, ks, kBK) &&
               make_map(&vm, &vo, v, B, K, Sk, d, vs, kBK)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = H / K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // heads up to 128 take the instance of their 16-column count; wider
  // ones (paligemma-3b's 256) the 256-column instance, columns past d
  // zero as at d = 36
  switch (d <= 128 ? (d + 15) / 16 : kMaxD16) {
#define REPRO_FLASH_CASE(N)                                                 \
  case N:                                                                   \
    err = tma ? launch<N, true>(qm, km, vm, qo, ko, vo, qf, kf, vf, of, B,  \
                                H, group, Sq, Sk, d, qs, ks, vs, os, scale, \
                                causal, window, st)                         \
              : launch<N, false>(qm, km, vm, qo, ko, vo, qf, kf, vf, of, B, \
                                 H, group, Sq, Sk, d, qs, ks, vs, os,       \
                                 scale, causal, window, st);                \
    break;
    REPRO_FLASH_CASE(1)
    REPRO_FLASH_CASE(2)
    REPRO_FLASH_CASE(3)
    REPRO_FLASH_CASE(4)
    REPRO_FLASH_CASE(5)
    REPRO_FLASH_CASE(6)
    REPRO_FLASH_CASE(7)
    REPRO_FLASH_CASE(8)
    REPRO_FLASH_CASE(kMaxD16)
#undef REPRO_FLASH_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
