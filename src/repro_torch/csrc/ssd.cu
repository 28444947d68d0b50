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
// 16-32 cells, too few for 132 SMs, so the work is split differently:
//
//   * launch 1, C.B^T: one block per (row, chunk, 32 x 32 tile) computes
//     the l x l product shared by every head into a global scratch
//     (64 KB per cell at l = 128, read back from L2 by the h blocks of
//     launch 2); tiles wholly above the diagonal are never computed,
//     since nothing reads them. Computing it inside launch 2 instead
//     would repeat it once per head (32x at mamba2-370m's widths);
//   * launch 2, one block per (row, chunk, head), 256 threads:
//     - dt is staged in shared memory and one thread takes the prefix
//       sum of dt * A sequentially (l <= 128 adds, with no fused
//       multiply-add), in the order of torch.cumsum over a non-inner
//       axis, so that cum and the decays agree bit for bit with the
//       plain version where both run that order;
//     - x * dt is staged in shared memory (l x p, 32 KB at l = 128,
//       p = 64), x read through its strides: the model passes a slice
//       of its conv output, so no copy is made;
//     - M[i][j] = C.B^T[i][j] * exp(cum_i - cum_j) is built in shared
//       memory for j <= i and SELECTED to 0 above the diagonal, never
//       multiplied by a mask: there exp(cum_i - cum_j) overflows to inf
//       once dt * A is large (A in [-16, -1] at the model's init), and
//       inf * 0 would be NaN;
//     - y = M . (x dt) as a register-tiled product, each thread owning a
//       contiguous block of rows and looping only up to its last row, so
//       the work above the diagonal is skipped;
//     - states = (x dt)^T . (B * exp(cum_last - cum)) with B streamed
//       through shared memory in tiles of 64 state columns (B is 64 KB
//       per chunk at n = 128), reusing M's space;
//     - above 48 KB of shared memory the launch uses dynamic shared
//       memory, its limit raised once with cudaFuncSetAttribute.
//
// Arithmetic is CUDA-core float32 (no tensor cores: TF32 would change
// the numbers; bf16 needs a path of its own). Bound: at mamba2-370m's
// admission shape (b, s, h, p, n, l) = (16, 128, 32, 64, 128, 128) the
// operations, 2 l^2 n per cell for C.B^T, 2 p per visible (i >= j)
// pair and head for y, 2 l h p n per cell for the states (1.68 GFLOP,
// 0.025 ms at 67 TFLOP/s), outweigh the bytes (x, dt, B, C in; y,
// states, decay, cum out: 53 MB, 0.016 ms at 3.35 TB/s).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;       // C.B^T tile edge
constexpr int kMaxChunk = 128;  // l <= 16 rows per thread group x 8
constexpr int kMaxCpt = 8;      // p <= 16 * kMaxCpt = 128
constexpr int kNT = 64;         // state columns per staged B tile

// launch 1: cb[cell][i][j] = sum_k C[b, c l + i, k] B[b, c l + j, k]
// for the tiles on or below the diagonal
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const float* __restrict__ B, const float* __restrict__ C,
              float* __restrict__ cb, int nc, int l, int n, long long b_sb,
              long long b_ss, long long c_sb, long long c_ss) {
  const int ti = blockIdx.y, tj = blockIdx.z;
  if (tj > ti) return;  // wholly above the diagonal: never read
  __shared__ float Cs[kTile][kTile + 1];
  __shared__ float Bs[kTile][kTile + 1];
  const int cell = blockIdx.x;
  const int bi = cell / nc;
  const int c = cell - bi * nc;
  const float* Cb = C + bi * c_sb + static_cast<long long>(c) * l * c_ss;
  const float* Bb = B + bi * b_sb + static_cast<long long>(c) * l * b_ss;
  const int tid = threadIdx.x;
  const int r = tid >> 3;  // tile row
  const int cg = tid & 7;  // tile columns cg + 8 q
  const int i0 = ti * kTile, j0 = tj * kTile;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < n; n0 += kTile) {
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int rr = e / kTile;
      const int kk = e - rr * kTile;
      const int nn = n0 + kk;
      const int ii = i0 + rr, jj = j0 + rr;
      Cs[rr][kk] = (ii < l && nn < n) ? Cb[ii * c_ss + nn] : 0.f;
      Bs[rr][kk] = (jj < l && nn < n) ? Bb[jj * b_ss + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float a = Cs[r][kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(a, Bs[cg + 8 * q][kk], acc[q]);
    }
    __syncthreads();
  }
  const int i = i0 + r;
  if (i >= l) return;
  float* out = cb + static_cast<long long>(cell) * l * l +
               static_cast<long long>(i) * l;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + cg + 8 * q;
    if (j < l) out[j] = acc[q];
  }
}

size_t chunk_smem_bytes(int l, int p) {
  const size_t region = static_cast<size_t>(l) *
                        (l + 1 > kNT ? l + 1 : kNT);
  return sizeof(float) *
         (3 * static_cast<size_t>(l) + static_cast<size_t>(l) * p + region);
}

// launch 2, one block per (row, chunk, head). CPT: y columns per thread,
// p <= 16 * CPT
template <int CPT>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ cb, float* __restrict__ y,
                 float* __restrict__ st, float* __restrict__ dec,
                 float* __restrict__ cum_out, int s, int h, int p, int n,
                 int nc, int l, long long x_sb, long long x_ss,
                 long long x_sh, long long b_sb, long long b_ss) {
  extern __shared__ float smem[];
  float* dts = smem;            // l: dt of the chunk
  float* cums = dts + l;        // l: prefix sum of dt * A
  float* decs = cums + l;       // l: exp(cum_last - cum_j)
  float* xdt = decs + l;        // l x p: x * dt
  float* region = xdt + l * p;  // M (l x (l + 1)), then B tiles (l x kNT)

  const int tid = threadIdx.x;
  const int hh = blockIdx.x % h;
  const int cell = blockIdx.x / h;  // bi * nc + c
  const int bi = cell / nc;
  const int c = cell - bi * nc;
  const long long t0 = static_cast<long long>(c) * l;  // first step
  const float a = A[hh];

  for (int j = tid; j < l; j += kThreads)
    dts[j] = dt[(bi * static_cast<long long>(s) + t0 + j) * h + hh];
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int j = 0; j < l; ++j) {
      run = __fadd_rn(run, __fmul_rn(dts[j], a));
      cums[j] = run;
    }
  }
  const float* xb = x + bi * x_sb + t0 * x_ss + hh * x_sh;
  for (int e = tid; e < l * p; e += kThreads) {
    const int j = e / p;
    const int col = e - j * p;
    xdt[e] = __fmul_rn(xb[j * x_ss + col], dts[j]);
  }
  __syncthreads();

  const float clast = cums[l - 1];
  for (int j = tid; j < l; j += kThreads) {
    decs[j] = expf(__fsub_rn(clast, cums[j]));
    cum_out[(bi * static_cast<long long>(s) + t0 + j) * h + hh] = cums[j];
  }
  if (tid == 0) dec[static_cast<long long>(cell) * h + hh] = expf(clast);

  // M[i][j] = C.B^T[i][j] exp(cum_i - cum_j), selected to 0 for j > i
  const int lm = l + 1;
  float* M = region;
  const float* cbc = cb + static_cast<long long>(cell) * l * l;
  for (int e = tid; e < l * l; e += kThreads) {
    const int i = e / l;
    const int j = e - i * l;
    M[i * lm + j] =
        j <= i ? cbc[e] * expf(__fsub_rn(cums[i], cums[j])) : 0.f;
  }
  __syncthreads();

  // y rows [i0, i0 + rpt) x columns tx + 16 q, j only up to the last row
  const int tx = tid & 15;
  const int ty = tid >> 4;
  {
    const int rpt = (l + 15) / 16;
    const int i0 = ty * rpt;
    const int i_end = i0 < l ? min(i0 + rpt, l) : 0;
    float acc[8][CPT];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < CPT; ++q) acc[r][q] = 0.f;
    for (int j = 0; j < i_end; ++j) {
      float xv[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = tx + 16 * q;
        xv[q] = col < p ? xdt[j * p + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (i0 + r < i_end) {
          const float m = M[(i0 + r) * lm + j];
#pragma unroll
          for (int q = 0; q < CPT; ++q) acc[r][q] = fmaf(m, xv[q], acc[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + r;
      if (i >= i_end) continue;
      float* yrow = y + ((bi * static_cast<long long>(s) + t0 + i) * h + hh) *
                            p;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = tx + 16 * q;
        if (col < p) yrow[col] = acc[r][q];
      }
    }
  }

  // states[pp][nn] = sum_j xdt[j][pp] B[j][nn] exp(cum_last - cum_j), B
  // staged kNT columns at a time in M's space
  float* Bd = region;
  const float* bb = B + bi * b_sb + t0 * b_ss;
  float* stc = st + (static_cast<long long>(cell) * h + hh) * p * n;
  for (int n0 = 0; n0 < n; n0 += kNT) {
    __syncthreads();  // M's (or the last tile's) reads are done
    for (int e = tid; e < l * kNT; e += kThreads) {
      const int j = e / kNT;
      const int q = e - j * kNT;
      const int nn = n0 + q;
      Bd[e] = nn < n ? bb[j * b_ss + nn] * decs[j] : 0.f;
    }
    __syncthreads();
    float acc[CPT][4];
#pragma unroll
    for (int r = 0; r < CPT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    for (int j = 0; j < l; ++j) {
      float bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Bd[j * kNT + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < CPT; ++r) {
        const int pp = ty + 16 * r;
        const float xv = pp < p ? xdt[j * p + pp] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(xv, bv[q], acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < CPT; ++r) {
      const int pp = ty + 16 * r;
      if (pp >= p) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int nn = n0 + tx + 16 * q;
        if (nn < n) stc[static_cast<long long>(pp) * n + nn] = acc[r][q];
      }
    }
  }
}

template <int CPT>
cudaError_t launch_chunk(const float* x, const float* dt, const float* A,
                         const float* B, const float* cb, float* y, float* st,
                         float* dec, float* cum, int b, int s, int h, int p,
                         int n, int nc, int l, long long x_sb, long long x_ss,
                         long long x_sh, long long b_sb, long long b_ss,
                         cudaStream_t stream) {
  // raise the dynamic shared memory limit once per instantiation, to
  // what the longest chunk at its widest head_dim needs, so a call
  // inside a CUDA graph capture makes no attribute change
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(chunk_smem_bytes(kMaxChunk, 16 * CPT)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long blocks = static_cast<long long>(b) * nc * h;
  ssd_chunk_kernel<CPT><<<static_cast<unsigned>(blocks), kThreads,
                          chunk_smem_bytes(l, p), stream>>>(
      x, dt, A, B, cb, y, st, dec, cum, s, h, p, n, nc, l, x_sb, x_ss, x_sh,
      b_sb, b_ss);
  return cudaGetLastError();
}

}  // namespace

// x: (b, s, h, p) with (b, s, h) strides; dt: (b, s, h) contiguous;
// A: (h,); B, C: (b, s, n) with (b, s) strides; all float32 with unit
// stride on the last axis. Outputs, contiguous: y (b, s, h, p), st
// (b, nc, h, p, n), dec (b, nc, h), cum (b, s, h); cb is a (b, nc, l, l)
// scratch. s % l == 0, 1 <= l <= 128, 1 <= p <= 128, n >= 1. Returns the
// CUDA error code of the launches (0 on success).
extern "C" int repro_ssd_chunk(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* st, void* dec, void* cum, void* cb,
                               int b, int s, int h, int p, int n, int l,
                               long long x_sb, long long x_ss,
                               long long x_sh, long long b_sb,
                               long long b_ss, long long c_sb,
                               long long c_ss, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (l <= 0 || l > kMaxChunk || s % l != 0 || p <= 0 ||
      p > 16 * kMaxCpt || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = s / l;
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  const float* Bf = static_cast<const float*>(B);
  float* cbf = static_cast<float*>(cb);
  const int tiles = (l + kTile - 1) / kTile;
  ssd_cb_kernel<<<dim3(b * nc, tiles, tiles), kThreads, 0, stream_>>>(
      Bf, static_cast<const float*>(C), cbf, nc, l, n, b_sb, b_ss, c_sb,
      c_ss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* stf = static_cast<float*>(st);
  float* decf = static_cast<float*>(dec);
  float* cumf = static_cast<float*>(cum);
  switch ((p + 15) / 16) {
#define REPRO_SSD_CASE(N)                                                    \
  case N:                                                                    \
    err = launch_chunk<N>(xf, dtf, Af, Bf, cbf, yf, stf, decf, cumf, b, s, h, \
                          p, n, nc, l, x_sb, x_ss, x_sh, b_sb, b_ss,         \
                          stream_);                                          \
    break;
    REPRO_SSD_CASE(1)
    REPRO_SSD_CASE(2)
    REPRO_SSD_CASE(3)
    REPRO_SSD_CASE(4)
    REPRO_SSD_CASE(5)
    REPRO_SSD_CASE(6)
    REPRO_SSD_CASE(7)
    REPRO_SSD_CASE(8)
#undef REPRO_SSD_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
