// K9: the Mamba-2 SSD intra-chunk step in float32, the chunk-local half
// of the SSM prefill (models/layers.py::ssm_block through
// kernels/ssd/ops.py::ssd). For each row b, chunk c of l steps and head
// h, with dA = dt * A[h] and cum its in-chunk prefix sum:
//
//   y_diag[i] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   states    = sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j   (p x n)
//   decay     = exp(cum_last)
//
// and cum itself. The recurrence across chunks stays in torch, as the
// reference keeps it outside its kernel.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd.py::ssd_chunk_kernel,
// whose grid takes one (row, chunk) cell per sequential step with every
// head inside, so that the l x l product C.B^T and the l x l decay
// matrix of all heads fill the 128 x 128 MXU. At serving sizes that is
// 16-32 cells, too few for 132 SMs, so the heads are split into groups:
// one launch, one block of 8 warps per (row, chunk, group of heads), no
// scratch in device memory:
//
//   * C and B arrive by cp.async (16-byte copies where the rows are
//     aligned) in slabs of up to 128 state columns; C.B^T, shared by
//     every head, is computed once per block into shared memory (64 KB
//     at l = n = 128) over the 16 x 32 tiles that reach the diagonal or
//     below it (nothing reads the others), on seven warps; B stays
//     resident for the states when n <= 128;
//   * meanwhile the eighth warp takes the in-chunk prefix sums of dt * A
//     of the group's heads (one head per lane), sequentially with no
//     fused multiply-add (__fmul_rn, __fadd_rn), in the order of
//     torch.cumsum over a non-inner axis, so that cum and the decays
//     agree bit for bit with the plain version where both run that
//     order;
//   * the groups are as many as still run in one wave (repro_ssd_groups:
//     fewer groups repeat C.B^T less, a second wave leaves SMs idle);
//     at mamba2-370m's admission that is 8 groups of 4 heads, 128 blocks
//     of one per SM (a thread block cluster sharing C.B^T through
//     distributed shared memory was not taken). Timed through
//     repro_ssd_chunk at other counts (CUDA-graph replays, NVIDIA H100
//     80GB HBM3, 700 W), the choice was the fastest at both admission
//     shapes: at (b, s, h, p, n, l) = (16, 128, 32, 64, 128, 128), 4 /
//     8 / 10 / 13 / 16 / 25 / 32 groups took 0.112-0.114 / 0.065-0.066 /
//     0.111-0.112 / 0.099-0.101 / 0.082 / 0.118-0.119 / 0.110-0.111 ms;
//     at hymba-1.5b's (16, 128, 50, 64, 16, 64), 4 / 8 / 10 / 13 / 16 /
//     25 / 32 / 50 took 0.060-0.061 / 0.051-0.052 / 0.061-0.062 / 0.059
//     / 0.057 / 0.063-0.064 / 0.066-0.068 / 0.080-0.082 ms (8 groups:
//     256 blocks, two per SM);
//   * then per head: x arrives by cp.async, the next head's x in flight
//     during this head's products where shared memory holds two, read
//     through its strides (the model passes a slice of its conv output)
//     and scaled by dt as fragments are loaded (__fmul_rn: the plain
//     version's x * dt exactly); four warps take y and four the states,
//     at once:
//   * y = M.(x dt) with M[i][j] = C.B^T[i][j] exp(cum_i - cum_j) built
//     in registers as the A fragments are loaded, SELECTED to 0 above
//     the diagonal, never multiplied by a mask: there exp(cum_i - cum_j)
//     overflows to inf once dt * A is large (A in [-16, -1] at the
//     model's init), and inf * 0 would be NaN. The 8-step columns above
//     the diagonal are skipped, and each warp takes a pair of 16-row
//     tiles (r, last - r), so every warp does the same work of the
//     triangle, over all of p at mamba2's widths (each M element built
//     once);
//   * states = (exp(cum_last - cum) x dt)^T . B over 32 x 32 (or 16 x 32)
//     output tiles;
//   * every product runs on the tensor cores in error-compensated TF32
//     (mma_tf32x3.cuh), every 16 terms summed from zero and added to the
//     float32 sums with rounding to nearest (the tensor cores' own
//     accumulation truncates); shared rows are padded so fragment loads
//     hit 32 banks, and l, p and n are zero-padded to the tiles;
//   * the registers are sized for two blocks per SM where shared memory
//     lets two share one (hymba-1.5b's widths), else for one.
//
// Bound: at mamba2-370m's admission shape (b, s, h, p, n, l) = (16, 128,
// 32, 64, 128, 128) the bytes (x, dt, B, C in; y, states, decay, cum
// out: 53 MB, 0.0158 ms at 3.35 TB/s) outweigh the operations, 2 l^2 n
// per cell for C.B^T, 2 p per visible (i >= j) pair and head for y, 2 l
// h p n per cell for the states (1.68 GFLOP: 0.0102 ms at the 165
// TFLOP/s that three TF32 products leave of the 495 TFLOP/s dense TF32
// rate; 0.025 ms at the 67 TFLOP/s float32 CUDA-core rate).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "mma_tf32x3.cuh"

namespace {

namespace ac = async_copy;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kYW = kWarps / 2;  // warps on y (the rest on the states)
constexpr int kMaxChunk = 128;
constexpr int kMaxP = 128;
constexpr int kSlab = 128;  // state columns per staged C/B slab

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// row strides (floats) of the shared tiles: 8 mod 32 where a fragment
// walks 4 rows x 8 columns (x, B as the states' and y's k x n operand)
// or 8 rows x 4 column pairs (C and B in C.B^T, read as float2); 4 mod 32
// where it walks 8 rows x 4 columns (C.B^T read as y's A operand)
__host__ __device__ constexpr int ld8(int w) {
  return w + (8 - w % 32 + 32) % 32;
}
__host__ __device__ constexpr int ld4(int w) {
  return w + (4 - w % 32 + 32) % 32;
}

// Shared-memory layout in floats, the same on host and device: B slab,
// C.B^T, a region that holds the C slab and later the x buffers, then
// dt, cum and exp(cum_last - cum) per head of the group
struct Layout {
  int LP, PP, NS, ldS, ldCB, ldX, xbufs, hg;
  int b_off, cb_off, u_off, dt_off, cum_off, dec_off, total;
};

__host__ __device__ inline Layout make_layout(int l, int p, int n, int hg,
                                              int xbufs) {
  Layout L;
  L.LP = round_up(l, 16);
  L.PP = round_up(p, 16);
  L.NS = round_up(n < kSlab ? n : kSlab, 16);
  L.ldS = ld8(L.NS);
  L.ldCB = ld4(L.LP);
  L.ldX = ld8(L.PP);
  L.xbufs = xbufs;
  L.hg = hg;
  const int slab = L.LP * L.ldS;
  const int xs = xbufs * L.LP * L.ldX;
  L.b_off = 0;
  L.cb_off = L.b_off + slab;
  L.u_off = L.cb_off + L.LP * L.ldCB;
  L.dt_off = L.u_off + (slab > xs ? slab : xs);
  L.cum_off = L.dt_off + hg * L.LP;
  L.dec_off = L.cum_off + hg * L.LP;
  L.total = L.dec_off + hg * L.LP;
  return L;
}

struct YArgs {
  float* y;
  const float *CB, *X, *ck, *dk;
  int ldCB, ldX, r, ny0, l, p, h, hh;
  long long row0;
  int g, t;
};

// y rows [16 r, 16 r + 16) x columns [8 ny0, 8 (ny0 + NY)) of one head:
// sum over j < 16 (r + 1) of M[i][j] (x dt)[j], M built in registers;
// each 16 j are summed from zero on the tensor cores and added with
// rounding to nearest
template <int NY>
__device__ __forceinline__ void y_rows(const YArgs& a) {
  const int ia = 16 * a.r + a.g;
  const float cia = a.ck[ia], cib = a.ck[ia + 8];
  float acc[NY][4];
#pragma unroll
  for (int j = 0; j < NY; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float* cbr = a.CB + ia * a.ldCB + a.t;
  const float* xa = a.X + a.t * a.ldX + 8 * a.ny0 + a.g;
  for (int k16 = 0; k16 < 16 * (a.r + 1); k16 += 16) {
    float part[NY][4];
#pragma unroll
    for (int j = 0; j < NY; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kk = k16; kk < k16 + 16; kk += 8) {
      const int j0 = kk + a.t;
      const int j1 = j0 + 4;
      const float cj0 = a.ck[j0], cj1 = a.ck[j1];
      // M, computed everywhere (no branch per element) and then selected
      // to 0 above the diagonal and past l, where exp may overflow
      const float m[4] = {cbr[kk] * expf(__fsub_rn(cia, cj0)),
                          cbr[8 * a.ldCB + kk] * expf(__fsub_rn(cib, cj0)),
                          cbr[kk + 4] * expf(__fsub_rn(cia, cj1)),
                          cbr[8 * a.ldCB + kk + 4] *
                              expf(__fsub_rn(cib, cj1))};
      const float af[4] = {j0 <= ia && ia < a.l ? m[0] : 0.f,
                           j0 <= ia + 8 && ia + 8 < a.l ? m[1] : 0.f,
                           j1 <= ia && ia < a.l ? m[2] : 0.f,
                           j1 <= ia + 8 && ia + 8 < a.l ? m[3] : 0.f};
      uint32_t ah[4], al[4];
      tf32x3::split(af, ah, al);
      const float d0 = a.dk[j0], d1 = a.dk[j1];
      const float* xr = xa + kk * a.ldX;
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        const float bf[2] = {__fmul_rn(xr[8 * j], d0),
                             __fmul_rn(xr[4 * a.ldX + 8 * j], d1)};
        uint32_t bh[2], bl[2];
        tf32x3::split(bf, bh, bl);
        tf32x3::mma3(part[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < NY; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
  }
#pragma unroll
  for (int j = 0; j < NY; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = ia + 8 * (e >> 1);
      const int col = 8 * (a.ny0 + j) + 2 * a.t + (e & 1);
      if (i < a.l && col < a.p)
        a.y[((a.row0 + i) * a.h + a.hh) * a.p + col] = acc[j][e];
    }
}

// y over ``ny`` 8-column tiles from a.ny0, at most 8 (4 where the
// registers are sized for two blocks per SM) per pass over the rows
template <int MINB>
__device__ __forceinline__ void y_cols(YArgs a, int ny) {
  constexpr int kMax = MINB == 2 ? 4 : 8;
  while (ny > 0) {
    const int nn = ny < kMax ? ny : kMax;
    switch (nn) {  // a compile-time tile count: no branch per product
      case 1: y_rows<1>(a); break;
      case 2: y_rows<2>(a); break;
      case 3: y_rows<3>(a); break;
      case 4: y_rows<4>(a); break;
      case 5: if constexpr (kMax >= 5) y_rows<5>(a); break;
      case 6: if constexpr (kMax >= 6) y_rows<6>(a); break;
      case 7: if constexpr (kMax >= 7) y_rows<7>(a); break;
      default: if constexpr (kMax >= 8) y_rows<8>(a); break;
    }
    a.ny0 += nn;
    ny -= nn;
  }
}

struct SArgs {
  float* stc;
  const float *X, *Bs, *dk, *ek;
  int ldX, ldS, LP, mt, nt0, n0, p, n, g, t;
};

// states rows [16 mt, 16 (mt + MW)) of p x state columns n0 + [8 nt0,
// 8 (nt0 + NT)) of one head: sum over j of exp(cum_last - cum_j)
// (x dt)[j][pp] B[j][col], each 16 j summed from zero on the tensor
// cores and added with rounding to nearest
template <int MW, int NT>
__device__ __forceinline__ void state_tiles(const SArgs& a) {
  float acc[MW][NT][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  const float* xa = a.X + a.t * a.ldX + 16 * a.mt + a.g;
  const float* ba = a.Bs + a.t * a.ldS + 8 * a.nt0 + a.g;
  for (int k16 = 0; k16 < a.LP; k16 += 16) {
    float part[MW][NT][4];
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
#pragma unroll
    for (int kk = k16; kk < k16 + 16; kk += 8) {
      const int j0 = kk + a.t;
      const int j1 = j0 + 4;
      const float d0 = a.dk[j0], d1 = a.dk[j1];
      const float e0 = a.ek[j0], e1 = a.ek[j1];
      const float* xr = xa + kk * a.ldX;
      uint32_t ah[MW][4], al[MW][4];
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        // exp(cum_last - cum_j) * (x_j * dt_j), as the plain version
        const float* xm = xr + 16 * m;
        const float af[4] = {__fmul_rn(e0, __fmul_rn(xm[0], d0)),
                             __fmul_rn(e0, __fmul_rn(xm[8], d0)),
                             __fmul_rn(e1, __fmul_rn(xm[4 * a.ldX], d1)),
                             __fmul_rn(e1, __fmul_rn(xm[4 * a.ldX + 8], d1))};
        tf32x3::split(af, ah[m], al[m]);
      }
      const float* br = ba + kk * a.ldS;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float bf[2] = {br[8 * j], br[4 * a.ldS + 8 * j]};
        uint32_t bh[2], bl[2];
        tf32x3::split(bf, bh, bl);
#pragma unroll
        for (int m = 0; m < MW; ++m)
          tf32x3::mma3(part[m][j], ah[m], al[m], bh, bl);
      }
    }
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[m][j][e] = __fadd_rn(acc[m][j][e], part[m][j][e]);
  }
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = 16 * (a.mt + m) + a.g + 8 * (e >> 1);
        const int col = a.n0 + 8 * (a.nt0 + j) + 2 * a.t + (e & 1);
        if (pp < a.p && col < a.n)
          a.stc[static_cast<long long>(pp) * a.n + col] = acc[m][j][e];
      }
}

// MINB: blocks per SM the registers are sized for (2 where shared memory
// lets two blocks share an SM: hymba's widths; 1 at mamba2's)
template <int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ C, float* __restrict__ y,
                 float* __restrict__ st, float* __restrict__ dec,
                 float* __restrict__ cum_out, int s, int h, int p, int n,
                 int nc, int l, int groups, int hg, int xbufs,
                 long long x_sb, long long x_ss, long long x_sh,
                 long long b_sb, long long b_ss, long long c_sb,
                 long long c_ss, int vec_x, int vec_b, int vec_c) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(l, p, n, hg, xbufs);
  const int LP = L.LP, PP = L.PP, ldS = L.ldS, ldCB = L.ldCB, ldX = L.ldX;
  float* Bs = smem + L.b_off;
  float* CB = smem + L.cb_off;
  float* Cs = smem + L.u_off;  // the C slab, until C.B^T is done
  float* dts = smem + L.dt_off;
  float* cums = smem + L.cum_off;
  float* decs = smem + L.dec_off;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int grp = blockIdx.x % groups;
  const int cell = blockIdx.x / groups;  // bi * nc + c
  const int bi = cell / nc;
  const int c = cell - bi * nc;
  const int hk0 = grp * h / groups;
  const int hn = (grp + 1) * h / groups - hk0;  // heads of this group
  const long long t0 = static_cast<long long>(c) * l;  // first step
  const long long row0 = bi * static_cast<long long>(s) + t0;
  const int nslabs = (n + kSlab - 1) / kSlab;
  const int RT = LP / 16;  // 16-row tiles of the chunk

  // dt of the group's heads, zero past l
  for (int kk = warp; kk < hn; kk += kWarps)
    for (int j = lane; j < LP; j += 32)
      dts[kk * LP + j] = j < l ? dt[(row0 + j) * h + hk0 + kk] : 0.f;

  // stage state columns [n0, n0 + w) of C (when ``with_c``) and B: rows
  // past l and columns [w, w rounded to 16) are zero
  auto stage_slab = [&](int si, bool with_c) {
    const int n0 = si * kSlab;
    const int w = min(kSlab, n - n0);
    const int w16 = round_up(w, 16);
    ac::copy_rows(Bs, ldS, B + bi * b_sb + t0 * b_ss + n0, b_ss, l, w,
                  vec_b, tid, kThreads);
    if (with_c)
      ac::copy_rows(Cs, ldS, C + bi * c_sb + t0 * c_ss + n0, c_ss, l, w,
                    vec_c, tid, kThreads);
    ac::commit();
    for (int j = warp; j < LP; j += kWarps)
      for (int col = (j < l ? w : 0) + lane; col < w16; col += 32) {
        Bs[j * ldS + col] = 0.f;
        if (with_c) Cs[j * ldS + col] = 0.f;
      }
  };

  // C.B^T over the 16 x 32 tiles that reach the diagonal or below it,
  // on every warp but the last (which takes the prefix sums); the slab's
  // state columns are the sum index, read as float2 column pairs (k = t
  // -> 2t, t + 4 -> 2t + 1)
  auto cb_slab = [&](int si) {
    const int w16 = round_up(min(kSlab, n - si * kSlab), 16);
    int tiles = 0;
    for (int ri = 0; ri < RT; ++ri) tiles += ri / 2 + 1;
    for (int u = warp; u < tiles; u += kWarps - 1) {
      int ri = 0, first = 0;
      while (first + ri / 2 + 1 <= u) first += ri++ / 2 + 1;
      const int c0 = 32 * (u - first);  // first column of the tile
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * ri + g + 8 * (e >> 1);
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          acc[j][e] = si > 0 && col < LP ? CB[i * ldCB + col] : 0.f;
        }
      const float* ca = Cs + (16 * ri + g) * ldS + 2 * t;
      const float* ba[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)  // rows past the chunk: any finite row
        ba[j] = Bs + min(c0 + 8 * j + g, LP - 1) * ldS + 2 * t;
#pragma unroll 2
      for (int k16 = 0; k16 < w16; k16 += 16) {
        float part[4][4] = {};
#pragma unroll
        for (int kk = k16; kk < k16 + 16; kk += 8) {
          const float2 c0v = *reinterpret_cast<const float2*>(ca + kk);
          const float2 c1v =
              *reinterpret_cast<const float2*>(ca + 8 * ldS + kk);
          const float af[4] = {c0v.x, c1v.x, c0v.y, c1v.y};
          uint32_t ah[4], al[4];
          tf32x3::split(af, ah, al);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 bv = *reinterpret_cast<const float2*>(ba[j] + kk);
            const float bf[2] = {bv.x, bv.y};
            uint32_t bh[2], bl[2];
            tf32x3::split(bf, bh, bl);
            tf32x3::mma3(part[j], ah, al, bh, bl);
          }
        }
        // 16 state columns summed from zero, added with rounding
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * ri + g + 8 * (e >> 1);
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          if (col < LP) CB[i * ldCB + col] = acc[j][e];
        }
    }
  };

  stage_slab(0, true);
  ac::wait<0>();
  __syncthreads();
  if (warp == kWarps - 1) {
    // the prefix sums of dt * A, one head per lane, then the decays and
    // cum's output by the whole warp
    for (int kk = lane; kk < hn; kk += 32) {
      const float a = A[hk0 + kk];
      const float* d_ = dts + kk * LP;
      float* cu = cums + kk * LP;
      float run = 0.f;
#pragma unroll 8
      for (int j = 0; j < l; ++j) {
        run = __fadd_rn(run, __fmul_rn(d_[j], a));
        cu[j] = run;
      }
      for (int j = l; j < LP; ++j) cu[j] = run;
      dec[static_cast<long long>(cell) * h + hk0 + kk] = expf(run);
    }
    __syncwarp();
    for (int kk = 0; kk < hn; ++kk) {
      const float* cu = cums + kk * LP;
      const float last = cu[LP - 1];
      for (int j = lane; j < LP; j += 32) {
        decs[kk * LP + j] = j < l ? expf(__fsub_rn(last, cu[j])) : 0.f;
        if (j < l) cum_out[(row0 + j) * h + hk0 + kk] = cu[j];
      }
    }
  } else {
    cb_slab(0);
  }
  for (int si = 1; si < nslabs; ++si) {
    __syncthreads();  // the last slab's reads are done
    stage_slab(si, true);
    ac::wait<0>();
    __syncthreads();
    if (warp < kWarps - 1) cb_slab(si);
  }
  __syncthreads();  // C.B^T, cum and the decays are complete; Cs is free

  // the x buffers take the C slab's place: zero their rows past l and
  // columns past p, which no copy writes
  float* Xb = smem + L.u_off;
  for (int bf = 0; bf < xbufs; ++bf)
    for (int j = warp; j < LP; j += kWarps)
      for (int col = (j < l ? p : 0) + lane; col < PP; col += 32)
        Xb[(bf * LP + j) * ldX + col] = 0.f;
  auto stage_x = [&](int kk) {
    ac::copy_rows(Xb + (kk % xbufs) * LP * ldX, ldX,
                  x + bi * x_sb + t0 * x_ss + (hk0 + kk) * x_sh, x_ss, l, p,
                  vec_x, tid, kThreads);
    ac::commit();
  };
  if (xbufs > 1) stage_x(0);

  // per head, at once: warps [0, kYW) take y, each a row-tile pair (r,
  // RT - 1 - r) over a share of the 8-column tiles of p (all of them at
  // mamba2's widths, so each M element is built once), and warps [kYW,
  // kWarps) take the states
  const int P2 = (RT + 1) / 2;  // <= kYW
  const int CG = kYW / P2;
  const int NTy = PP / 8;
  const int MT = PP / 16;
  for (int kk = 0; kk < hn; ++kk) {
    const int hh = hk0 + kk;
    if (xbufs == 1) {
      stage_x(kk);
      ac::wait<0>();
    } else if (kk + 1 < hn) {
      stage_x(kk + 1);
      ac::wait<1>();
    } else {
      ac::wait<0>();
    }
    __syncthreads();  // x of head kk (and, at kk = 0, the zeros) is here
    const float* X = Xb + (kk % xbufs) * LP * ldX;
    const float* dk = dts + kk * LP;
    const float* ck = cums + kk * LP;
    const float* ek = decs + kk * LP;

    if (warp < kYW) {
      const int pq = warp / CG;
      const int cg = warp - pq * CG;
      const int ny0 = cg * NTy / CG;
      const int ny = pq < P2 ? (cg + 1) * NTy / CG - ny0 : 0;
      for (int side = 0; side < 2 && ny > 0; ++side) {
        const int r = side == 0 ? pq : RT - 1 - pq;
        if (side == 1 && r == pq) break;
        y_cols<MINB>(YArgs{y, CB, X, ck, dk, ldCB, ldX, r, ny0, l, p, h, hh,
                           row0, g, t},
                     ny);
      }
    }

    // states over (16 or 32 rows of p) x (up to 4 8-column tiles of the
    // slab); B is staged again per head only when n > 128
    float* stc = st + (static_cast<long long>(cell) * h + hh) * p * n;
    for (int si = 0; si < nslabs; ++si) {
      if (nslabs > 1) {
        __syncthreads();  // the last slab's reads are done
        stage_slab(si, false);
        ac::wait<0>();
        __syncthreads();
      }
      if (warp < kYW) continue;
      const int n0 = si * kSlab;
      const int NTs = round_up(min(kSlab, n - n0), 8) / 8;
      const int NG = (NTs + 3) / 4;
      // 32-row tiles where they still give every warp one, else 16-row
      const int MW =
          MINB == 1 && MT % 2 == 0 && (MT / 2) * NG >= kWarps - kYW ? 2 : 1;
      for (int u = warp - kYW; u < (MT / MW) * NG; u += kWarps - kYW) {
        const int mt = MW * (u / NG);
        const int nt0 = 4 * (u % NG);
        const SArgs a{stc, X, Bs, dk, ek, ldX, ldS, LP, mt, nt0, n0, p, n,
                      g, t};
        const int nt = min(4, NTs - nt0);
        if (MINB == 1 && MW == 2) {
          switch (nt) {
            case 1: state_tiles<2, 1>(a); break;
            case 2: state_tiles<2, 2>(a); break;
            case 3: state_tiles<2, 3>(a); break;
            default: state_tiles<2, 4>(a); break;
          }
        } else {
          switch (nt) {
            case 1: state_tiles<1, 1>(a); break;
            case 2: state_tiles<1, 2>(a); break;
            case 3: state_tiles<1, 3>(a); break;
            default: state_tiles<1, 4>(a); break;
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this head's x buffer
  }
}

int max_smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      bytes = 48 * 1024;
  }
  return bytes;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the launch of ``hg`` heads per block at (l, p, n): its layout (two x
// buffers where they fit), shared memory bytes, the instantiation and how
// many of its blocks share an SM; false if none fits
struct Plan {
  Layout L;
  size_t bytes;
  int minb, per_sm;
};

constexpr size_t kOccupancySlots = 2048;  // 256 KB in 128-byte steps

bool plan(int l, int p, int n, int hg, Plan* out) {
  const int cap = max_smem_optin();
  Layout L = make_layout(l, p, n, hg, 2);
  if (static_cast<long long>(L.total) * 4 > cap)
    L = make_layout(l, p, n, hg, 1);
  const size_t bytes = static_cast<size_t>(L.total) * 4;
  if (bytes > static_cast<size_t>(cap)) return false;
  // the limit is raised once per instantiation, to the card's, so a call
  // inside a CUDA graph capture makes no attribute change
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(ssd_chunk_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             cap) != cudaSuccess ||
        cudaFuncSetAttribute(ssd_chunk_kernel<2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             cap) != cudaSuccess)
      return false;
    configured = true;
  }
  // blocks per SM by shared-memory size, asked once per size (in 128-byte
  // steps; racing callers store the same value)
  static int occupancy[kOccupancySlots] = {};  // blocks per SM + 1
  const size_t slot = bytes / 128;
  int per_sm = slot < kOccupancySlots ? occupancy[slot] - 1 : -1;
  if (per_sm < 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ssd_chunk_kernel<2>, kThreads, bytes) != cudaSuccess)
      return false;
    if (slot < kOccupancySlots) occupancy[slot] = per_sm + 1;
  }
  *out = Plan{L, bytes, per_sm >= 2 ? 2 : 1, per_sm >= 2 ? per_sm : 1};
  return true;
}

}  // namespace

// Head groups for a call at (b, s / l chunks, h, l, p, n): the most that
// still run in one wave (cells x groups blocks on the card's SMs, as many
// per SM as fit), at least one, and no fewer than shared memory allows;
// 0 if no group fits. One block per group computes C.B^T once for its
// heads, so fewer groups repeat it less, while a second wave of blocks
// would leave SMs idle behind it (at mamba2-370m's admission, 8 groups of
// 4 heads in 128 blocks beat 16 groups of 2 in 256 blocks).
extern "C" int repro_ssd_groups(int b, int nc, int h, int l, int p, int n) {
  if (b <= 0 || nc <= 0 || h <= 0 || l <= 0 || l > kMaxChunk || p <= 0 ||
      p > kMaxP || n <= 0)
    return 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const long long cells = static_cast<long long>(b) * nc;
  int best = 0;
  for (int groups = h; groups >= 1; --groups) {
    Plan pl;
    if (!plan(l, p, n, (h + groups - 1) / groups, &pl)) break;
    best = groups;
    if (cells * groups <= static_cast<long long>(sms) * pl.per_sm) break;
  }
  return best;
}

// x: (b, s, h, p) with (b, s, h) strides; dt: (b, s, h) contiguous;
// A: (h,); B, C: (b, s, n) with (b, s) strides; all float32 with unit
// stride on the last axis. Outputs, contiguous: y (b, s, h, p), st
// (b, nc, h, p, n), dec (b, nc, h), cum (b, s, h). One block per (row,
// chunk, group of heads), ``groups`` groups of h / groups heads (rounded
// down or up). s % l == 0, 1 <= l <= 128, 1 <= p <= 128, n >= 1,
// 1 <= groups <= h. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int repro_ssd_chunk(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* st, void* dec, void* cum, int b, int s,
                               int h, int p, int n, int l, int groups,
                               long long x_sb, long long x_ss,
                               long long x_sh, long long b_sb,
                               long long b_ss, long long c_sb,
                               long long c_ss, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (l <= 0 || l > kMaxChunk || s % l != 0 || p <= 0 || p > kMaxP ||
      n <= 0 || groups <= 0 || groups > h)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = s / l;
  const int hg = (h + groups - 1) / groups;
  Plan pl;
  if (!plan(l, p, n, hg, &pl)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vx = p % 4 == 0 && aligned16(x) && (x_sb | x_ss | x_sh) % 4 == 0;
  const bool vb = aligned16(B) && (b_sb | b_ss) % 4 == 0 && n % 4 == 0;
  const bool vc = aligned16(C) && (c_sb | c_ss) % 4 == 0 && n % 4 == 0;
  const unsigned blocks =
      static_cast<unsigned>(static_cast<long long>(b) * nc * groups);
  auto kernel = pl.minb == 2 ? ssd_chunk_kernel<2> : ssd_chunk_kernel<1>;
  kernel<<<blocks, kThreads, pl.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(st), static_cast<float*>(dec),
      static_cast<float*>(cum), s, h, p, n, nc, l, groups, hg, pl.L.xbufs,
      x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, vx, vb, vc);
  return static_cast<int>(cudaGetLastError());
}
