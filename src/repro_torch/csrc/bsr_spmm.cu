// Block-sparse (flat BSR) x dense semiring product for Hopper (sm_90a): one
// synchronous (Jacobi) round.
//
// Replaces the TPU kernel `bsr_spmm_pallas` of src/repro/kernels/bsr_spmm.py.
// For every row-block i of the ragged flat BSR:
//
//     y[i] = REDUCE_t tiles[t] (x) x[tilecols[t]],  t in [rowptr[i], rowptr[i+1])
//
// for plus_times (sum of products), min_plus, max_min and max_times.
// Row-blocks with no tiles get the reduce identity (the reference writes it
// after its grid; here the accumulator simply starts there), which also
// covers the empty-graph pack (rowptr all zero).
//
// Design: row-blocks are independent, so one CTA owns one (row-block, column
// chunk) and walks that row's tiles in tile order; the TPU kernel ran one
// grid step per tile and kept the output block in VMEM, here it lives in
// registers. Two paths, chosen per launch:
//   * bs % 64 == 0, d % 64 == 0, 16-byte aligned (the main path's shape):
//     a CTA owns a 64 x 64 output block as 4 x 4 register blocks per thread,
//     stages 64 x 64 slices of the tile and of the gathered source block
//     whole with float4 loads, and feeds 64 FMAs from 8 shared loads;
//   * anything else: a thread owns one column and up to 64 rows of it, and
//     each tile is staged in slices of 32 tile columns, so any bs and d fit.
// In both, every output element is one sequential chain over (tile, k) in
// order: plus_times is an f32 FFMA chain (never TF32), the lattice pairs use
// the exact ops of gs_sweep.cu (__fadd_rn / __fmul_rn, min, max). No
// atomics, so the output is deterministic and the same on either path and
// for any column chunk.
//
// Bound on this card: the tiles are read once (nnz * bs * bs * 4 bytes) and
// the product does 2 * nnz * bs * bs * d operations; at d = 64 the
// operations dominate (67 TFLOP/s f32 counting an FMA as two; the lattice
// pairs issue two non-FMA instructions per element). Neither path overlaps
// the staging of the next slice with the arithmetic of this one, so both
// stay above that bound (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#define SP_THREADS 256
#define SP_KC 32                 // tile columns staged per slice
#define SP_TS (SP_KC + 1)        // padded row stride of the staged tile slice
#define SP_ROWS 256              // tile rows staged per pass
#define SP_COLS 64               // columns per CTA
#define SP_Q 64                  // rows per thread per pass (SP_ROWS / 4)

enum { SR_PLUS_TIMES = 0, SR_MIN_PLUS = 1, SR_MAX_MIN = 2, SR_MAX_TIMES = 3 };

template <int SR> struct Semiring;

template <> struct Semiring<SR_PLUS_TIMES> {
  static __device__ __forceinline__ float ident() { return 0.0f; }
  static __device__ __forceinline__ float tile(float acc, float a, float b) { return fmaf(a, b, acc); }
};

template <> struct Semiring<SR_MIN_PLUS> {
  static __device__ __forceinline__ float ident() { return 3.0e38f; }
  static __device__ __forceinline__ float tile(float acc, float a, float b) { return fminf(acc, __fadd_rn(a, b)); }
};

template <> struct Semiring<SR_MAX_MIN> {
  static __device__ __forceinline__ float ident() { return -3.0e38f; }
  static __device__ __forceinline__ float tile(float acc, float a, float b) { return fmaxf(acc, fminf(a, b)); }
};

template <> struct Semiring<SR_MAX_TIMES> {
  static __device__ __forceinline__ float ident() { return -3.0e38f; }
  static __device__ __forceinline__ float tile(float acc, float a, float b) { return fmaxf(acc, __fmul_rn(a, b)); }
};

template <int SR>
__global__ void __launch_bounds__(SP_THREADS)
bsr_spmm_kernel(const int* __restrict__ rowptr, const int* __restrict__ tilecols,
                const float* __restrict__ tiles, const float* __restrict__ x,
                float* __restrict__ y, int bs, int d, int dj) {
  typedef Semiring<SR> S;
  __shared__ float Ts[SP_ROWS * SP_TS];  // tile slice [row][k], padded stride
  __shared__ float Xs[SP_KC * SP_COLS];  // source slice [k][col]
  const int i = blockIdx.x;
  const int c0 = blockIdx.y * dj;
  const int tc = min(dj, d - c0);        // columns of this chunk, <= SP_COLS
  const int trows = SP_THREADS / tc;
  const int tid = threadIdx.x;
  const bool act = tid < trows * tc;
  const int col = tid % tc;
  const int r0 = tid / tc;
  const int lo = rowptr[i], hi = rowptr[i + 1];
  for (int rb = 0; rb < bs; rb += SP_ROWS) {
    const int prow = min(SP_ROWS, bs - rb);
    const int nq = act && r0 < prow ? (prow - r0 + trows - 1) / trows : 0;
    float acc[SP_Q];
#pragma unroll
    for (int q = 0; q < SP_Q; ++q) acc[q] = S::ident();
    for (int t = lo; t < hi; ++t) {
      const float* T = tiles + (size_t)t * bs * bs + (size_t)rb * bs;
      const float* X = x + (size_t)tilecols[t] * bs * d + c0;
      for (int k0 = 0; k0 < bs; k0 += SP_KC) {
        const int kc = min(SP_KC, bs - k0);
        __syncthreads();  // the previous slice is consumed
        for (int e = tid; e < prow * SP_KC; e += SP_THREADS) {
          const int rr = e / SP_KC, kk = e % SP_KC;
          Ts[rr * SP_TS + kk] = kk < kc ? T[(size_t)rr * bs + k0 + kk] : 0.0f;
        }
        for (int e = tid; e < kc * tc; e += SP_THREADS) {
          const int kk = e / tc, cc = e % tc;
          Xs[kk * SP_COLS + cc] = X[(size_t)(k0 + kk) * d + cc];
        }
        __syncthreads();
        for (int kk = 0; kk < kc; ++kk) {
          const float xv = Xs[kk * SP_COLS + col];
#pragma unroll
          for (int q = 0; q < SP_Q; ++q) {
            if (q >= nq) break;
            acc[q] = S::tile(acc[q], Ts[(r0 + trows * q) * SP_TS + kk], xv);
          }
        }
      }
    }
    float* Y = y + ((size_t)i * bs + rb) * d + c0 + col;
#pragma unroll
    for (int q = 0; q < SP_Q; ++q) {
      if (q >= nq) break;
      Y[(size_t)(r0 + trows * q) * d] = acc[q];
    }
  }
}

// The main path's shape: see the design note at the top.
#define SP_B 64
#define SP_BT (SP_B + 4)  // padded row stride of the staged tile slice

template <int SR>
__global__ void __launch_bounds__(SP_THREADS)
bsr_spmm_kernel_b64(const int* __restrict__ rowptr, const int* __restrict__ tilecols,
                    const float* __restrict__ tiles, const float* __restrict__ x,
                    float* __restrict__ y, int bs, int d) {
  typedef Semiring<SR> S;
  __shared__ __align__(16) float Ts[SP_B * SP_BT];  // [row][k]
  __shared__ __align__(16) float Xs[SP_B * SP_B];   // [k][col]
  const int i = blockIdx.x;
  const int c0 = blockIdx.y * SP_B;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // columns 4tx.., rows 4ty..
  const int lo = rowptr[i], hi = rowptr[i + 1];
  for (int rb = 0; rb < bs; rb += SP_B) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = S::ident();
    for (int t = lo; t < hi; ++t) {
      const float* T = tiles + (size_t)t * bs * bs + (size_t)rb * bs;
      const float* X = x + (size_t)tilecols[t] * bs * d + c0;
      for (int k0 = 0; k0 < bs; k0 += SP_B) {
        __syncthreads();  // the previous slice is consumed
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = tid + j * SP_THREADS;  // float4 index in a 64 x 64 slice
          const int r = e / 16, c4 = (e % 16) * 4;
          *reinterpret_cast<float4*>(&Ts[r * SP_BT + c4]) =
              *reinterpret_cast<const float4*>(T + (size_t)r * bs + k0 + c4);
          *reinterpret_cast<float4*>(&Xs[r * SP_B + c4]) =
              *reinterpret_cast<const float4*>(X + (size_t)(k0 + r) * d + c4);
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < SP_B; k += 4) {
          float ar[4][4], br[4][4];  // ar[row][kk] = tile, br[kk][col] = source
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 a = *reinterpret_cast<const float4*>(&Ts[(4 * ty + q) * SP_BT + k]);
            const float4 b = *reinterpret_cast<const float4*>(&Xs[(k + q) * SP_B + 4 * tx]);
            ar[q][0] = a.x; ar[q][1] = a.y; ar[q][2] = a.z; ar[q][3] = a.w;
            br[q][0] = b.x; br[q][1] = b.y; br[q][2] = b.z; br[q][3] = b.w;
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = S::tile(acc[r][c], ar[r][kk], br[kk][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(y + ((size_t)i * bs + rb + 4 * ty + r) * d + c0 + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

extern "C" {

// One launch on `stream`; returns cudaGetLastError() after it. `dj` is the
// column chunk per CTA (capped at 64); it chooses tiling only.
int bsr_spmm_launch(int semiring, const void* rowptr, const void* tilecols,
                    const void* tiles, const void* x, void* y, int nb, int bs,
                    int d, int dj, void* stream) {
  if (nb < 1 || bs < 1 || d < 1 || dj < 1) return (int)cudaErrorInvalidValue;
  if (dj > SP_COLS) dj = SP_COLS;
  cudaStream_t st = (cudaStream_t)stream;
  const int* rp = (const int*)rowptr;
  const int* tcs = (const int*)tilecols;
  const float* tl = (const float*)tiles;
  const float* xx = (const float*)x;
  float* yy = (float*)y;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)tiles % 16 == 0) &&
                       ((uintptr_t)y % 16 == 0);
  if (aligned && bs % SP_B == 0 && d % SP_B == 0) {
    const dim3 grid(nb, d / SP_B), block(SP_THREADS);
    switch (semiring) {
      case SR_PLUS_TIMES:
        bsr_spmm_kernel_b64<SR_PLUS_TIMES><<<grid, block, 0, st>>>(rp, tcs, tl, xx, yy, bs, d);
        break;
      case SR_MIN_PLUS:
        bsr_spmm_kernel_b64<SR_MIN_PLUS><<<grid, block, 0, st>>>(rp, tcs, tl, xx, yy, bs, d);
        break;
      case SR_MAX_MIN:
        bsr_spmm_kernel_b64<SR_MAX_MIN><<<grid, block, 0, st>>>(rp, tcs, tl, xx, yy, bs, d);
        break;
      case SR_MAX_TIMES:
        bsr_spmm_kernel_b64<SR_MAX_TIMES><<<grid, block, 0, st>>>(rp, tcs, tl, xx, yy, bs, d);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  const dim3 grid(nb, (d + dj - 1) / dj), block(SP_THREADS);
  switch (semiring) {
    case SR_PLUS_TIMES:
      bsr_spmm_kernel<SR_PLUS_TIMES><<<grid, block, 0, st>>>(rp, tcs, tl, xx, yy, bs, d, dj);
      break;
    case SR_MIN_PLUS:
      bsr_spmm_kernel<SR_MIN_PLUS><<<grid, block, 0, st>>>(rp, tcs, tl, xx, yy, bs, d, dj);
      break;
    case SR_MAX_MIN:
      bsr_spmm_kernel<SR_MAX_MIN><<<grid, block, 0, st>>>(rp, tcs, tl, xx, yy, bs, d, dj);
      break;
    case SR_MAX_TIMES:
      bsr_spmm_kernel<SR_MAX_TIMES><<<grid, block, 0, st>>>(rp, tcs, tl, xx, yy, bs, d, dj);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
