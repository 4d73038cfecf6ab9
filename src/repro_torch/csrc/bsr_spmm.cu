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
// Three paths, chosen per launch:
//
//   * plus_times with bs % 64 == 0, d % 64 == 0, 16-byte aligned (the main
//     path's shape): `bsr_spmm_tc_kernel`, the tensor-core product below;
//   * the lattice pairs at that shape: `bsr_spmm_kernel_b64`, one CTA per
//     (row-block, 64 columns), 4 x 4 register blocks per thread, each tile
//     staged whole through shared memory (the lattice ops have no tensor
//     core form);
//   * anything else: `bsr_spmm_kernel`, a thread owns one column and up to
//     64 rows of it, and each tile is staged in slices of 32 tile columns,
//     so any bs and d fit.
//
// The tensor-core product (plus_times). What bounds it on this card: the
// tiles are read once (nnz * bs * bs * 4 bytes, 7.39 GB on the main path)
// and the source blocks they gather (25.6 MB in all) stay in the 50 MB L2,
// so the floor is the tile stream at 3.35 TB/s. An f32 FFMA product needs
// 2 * nnz * bs * bs * d operations at 67 TFLOP/s, above that floor, so the
// product runs on the tensor cores in 3xTF32: each operand is split into a
// TF32 high part and a TF32 remainder, and lo*hi + hi*lo + hi*hi is summed
// in f32 (the lo*lo term is below f32 rounding), three times the operations
// at 495 TFLOP/s, which stays below the byte floor. The design:
//   * persistent CTAs (two per SM) claim work units through an atomic
//     counter; a unit is (row-block, 64 rows of it, 64 columns) and the
//     wrapper lists row-blocks heaviest first (a device-side sort of the row
//     lengths), so the longest rows start first and the tail is short;
//   * one producer warp keeps a ring of 3 stages in flight. A stage holds
//     one 64 x 64 slice of a tile and the 64 x 64 source slice it
//     multiplies, as four TMA boxes of 64 rows x 128 bytes with the 128B
//     swizzle (the tile with an evict-first L2 policy, the source
//     evict-last); each stage has a full and an empty mbarrier (copying row
//     by row with `cp.async.bulk` into padded rows was much slower: the copy
//     engine's cost is per request);
//   * one consumer warpgroup computes y^T = x^T . T^T with `wgmma` m64n64k8
//     in TF32. The source slice, split into its two parts, is the register
//     operand (TF32 `wgmma` reads a shared operand only K-major, which the
//     tile is as T^T and the source slice is not); the tile is split in
//     shared memory, its high part in place and its remainder into the
//     source slice's boxes once those are in registers. Fragment rows are
//     mapped to output columns by a permutation that keeps every swizzled
//     load free of bank conflicts.
// Each stage's product is summed in its own registers and then added to the
// unit's running sum with an f32 round-to-nearest add: the tensor cores
// truncate as they accumulate, and over a row of ~900 tiles that error grew
// past the tolerance. Every output element is summed in one fixed order
// (tile, then the 64-wide slices of k, then k in steps of 8, then lo*hi,
// hi*lo, hi*hi), whatever the unit's CTA, the column chunk asked for or the
// run; there are no atomics in the sum, so the result repeats bit for bit.
// The split keeps about f32 accuracy for finite operands below 2^127
// (PERF.md has the error at full size).
//
// In the lattice paths every output element is one sequential chain over
// (tile, k) in order, with the exact ops of gs_sweep.cu (__fadd_rn /
// __fmul_rn, min, max); neither overlaps the staging of the next slice with
// the arithmetic of this one, so they stay above their bound (PERF.md).

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// The tensor-core product of plus_times (see the design note at the top).
// ---------------------------------------------------------------------------

#define TC_B 64                       // rows, columns and depth of one stage
#define TC_STAGES 3
#define TC_CONSUMERS 4                // one warpgroup
#define TC_THREADS (32 * (TC_CONSUMERS + 1))
#define TC_BOX 8192                   // one 64-row x 32-float box, 128B-swizzled
#define TC_STAGE (4 * TC_BOX)         // tile k 0..31, tile k 32..63, source cols 0..31, 32..63
#define TC_HEADER 128                 // barriers and stage records
#define TC_SMEM (TC_HEADER + 1024 + TC_STAGES * TC_STAGE)  // + room to align the stages
#define TC_STAGE_BYTES (2 * TC_B * TC_B * 4)

// what a stage holds, in its record's flags
#define TC_FIRST 1  // the unit's first stage: start the sum
#define TC_LAST 2   // the unit's last stage: write the sum
#define TC_EMPTY 4  // no copy (a row-block without tiles)
#define TC_STOP 8   // no unit is left

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64 x 32 box of a 2-D tensor map at (column c0, row c1) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

// v = hi + lo with hi = tf32(v) rounded to nearest and lo = tf32(v - hi).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  const float rest = __fsub_rn(v, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// Byte offset of element (row, c), c in 0..31, in a 128B-swizzled box: the
// 16-byte chunk index is XORed with the row's position in its group of 8.
__device__ __forceinline__ uint32_t swz(int row, int c) {
  return row * 128 + (((c >> 2) ^ (row & 7)) << 4) + ((c & 3) << 2);
}

// Shared-memory descriptor of a K-major operand in 128B-swizzled boxes:
// start address, leading offset 16 (unused when swizzled), 1024 bytes
// between groups of 8 rows, swizzle mode 128B.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3fff) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[64 x 64] += a[64 x 8] (registers) * b[8 x 64] (shared memory), TF32
// operands, f32 sums; issued by the whole warpgroup.
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

// Work unit u: row-block order[u / per], 64-row slice (u % per) / nchunks,
// 64-column chunk u % nchunks, with per = (bs / 64) * nchunks. A unit walks
// its row's tiles in order, and each tile's bs / 64 slices of k. The
// warpgroup computes y^T = x^T . T^T per stage: x^T is the register operand
// (TF32 wgmma takes a shared-memory operand only K-major, and the tile is
// K-major as T^T, the source block is not), the tile the shared one.
__global__ void __launch_bounds__(TC_THREADS, 2)
bsr_spmm_tc_kernel(const __grid_constant__ CUtensorMap tmap_tiles,
                   const __grid_constant__ CUtensorMap tmap_x,
                   const int* __restrict__ rowptr, const int* __restrict__ tilecols,
                   const int* __restrict__ order, int* __restrict__ counter,
                   float* __restrict__ y, int nunits, int bs, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + TC_STAGES;
  int4* rec = reinterpret_cast<int4*>(smem + 16 * TC_STAGES);
  const uint32_t s0 = smem_addr(smem);
  const uint32_t base = (s0 + TC_HEADER + 1023) & ~1023u;  // swizzled boxes need 1024
  unsigned char* stages = smem + (base - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kbs = bs / TC_B, nchunks = d / TC_B, per = kbs * nchunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(empty + s), TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == TC_CONSUMERS) {
    // producer: claim units heaviest first and keep the ring full
    uint64_t stream_pol, keep_pol;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(stream_pol));
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep_pol));
    int s = 0;
    uint32_t ph = 0;
    for (;;) {
      int u = 0;
      if (lane == 0) u = atomicAdd(counter, 1);
      u = __shfl_sync(0xffffffffu, u, 0);
      const bool stop = u >= nunits;
      int i = 0, rb = 0, c = 0, lo = 0, hi = 0;
      if (!stop) {
        i = order[u / per];
        rb = (u % per) / nchunks;
        c = u % nchunks;
        lo = rowptr[i];
        hi = rowptr[i + 1];
      }
      const int nst = hi > lo ? (hi - lo) * kbs : 1;
      int cols = 0;  // tilecols[lo + 32 * (tile / 32) + lane]
      for (int q = 0; q < nst; ++q) {
        const int tt = q / kbs, kb = q % kbs;
        if (hi > lo && kb == 0 && tt % 32 == 0)
          cols = lo + tt + lane < hi ? tilecols[lo + tt + lane] : 0;
        const int col = __shfl_sync(0xffffffffu, cols, tt % 32);
        mbar_wait(smem_addr(empty + s), ph ^ 1);
        if (lane == 0) {
          const uint32_t fb = smem_addr(full + s);
          rec[s] = make_int4(i, rb, c, (q == 0 ? TC_FIRST : 0) | (q == nst - 1 ? TC_LAST : 0) |
                                           (hi > lo ? 0 : TC_EMPTY) | (stop ? TC_STOP : 0));
          if (hi > lo) {
            mbar_arrive_tx(fb, TC_STAGE_BYTES);
            const uint32_t st = base + s * TC_STAGE;
            const int trow = (lo + tt) * bs + rb * TC_B, xrow = col * bs + kb * TC_B;
            tma_load(st, &tmap_tiles, kb * TC_B, trow, fb, stream_pol);
            tma_load(st + TC_BOX, &tmap_tiles, kb * TC_B + 32, trow, fb, stream_pol);
            tma_load(st + 2 * TC_BOX, &tmap_x, c * TC_B, xrow, fb, keep_pol);
            tma_load(st + 3 * TC_BOX, &tmap_x, c * TC_B + 32, xrow, fb, keep_pol);
          } else {
            mbar_arrive(fb);
          }
        }
        __syncwarp();
        if (++s == TC_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      if (stop) break;
    }
    return;
  }

  // consumers, one warpgroup. Fragment row m of warp w (16 w + g, + 8 for
  // the second half) stands for output column colp[half]: a permutation of
  // the 64 columns under which every load of the source box is free of bank
  // conflicts.
  const int tid = threadIdx.x, g = lane / 4, t4 = lane % 4;
  int colp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    colp[r] = 32 * (warp >> 1) + 4 * (4 * (g >> 2) + 2 * (warp & 1) + r) + (g & 3);
  float acc[32];
  int s = 0;
  uint32_t ph = 0;
  for (;;) {
    mbar_wait(smem_addr(full + s), ph);
    const int4 m = rec[s];
    if (m.w & TC_STOP) break;
    if (m.w & TC_FIRST) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
    }
    if (!(m.w & TC_EMPTY)) {
      unsigned char* T = stages + s * TC_STAGE;
      unsigned char* X = T + 2 * TC_BOX;
      // the source block's fragments for all 8 steps of k, split, in registers
      uint32_t ah[8][4], al[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 8 * j + t4 + 4 * (q >> 1), cp = colp[q & 1];
          split_tf32(*reinterpret_cast<const float*>(X + (cp >> 5) * TC_BOX + swz(k, cp & 31)),
                     ah[j][q], al[j][q]);
        }
      asm volatile("bar.sync 1, 128;" ::: "memory");  // the source boxes are free
      // the tile: its high part in place, its remainder into the source
      // boxes (element-wise, so the swizzled layout holds)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int o = (tid + 128 * e) * 16;
        const float4 v = *reinterpret_cast<const float4*>(T + o);
        uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
        split_tf32(v.x, h0, l0);
        split_tf32(v.y, h1, l1);
        split_tf32(v.z, h2, l2);
        split_tf32(v.w, h3, l3);
        *reinterpret_cast<uint4*>(T + o) = make_uint4(h0, h1, h2, h3);
        *reinterpret_cast<uint4*>(X + o) = make_uint4(l0, l1, l2, l3);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
      asm volatile("bar.sync 1, 128;" ::: "memory");
      // the stage's product is summed apart and added to the running sum in
      // f32 round-to-nearest: the tensor cores' own accumulation truncates,
      // and over a long row its error would grow with the row's length
      float part[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) part[e] = 0.0f;
      const uint32_t hi_t = smem_addr(T), lo_t = smem_addr(X);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t off = (j >> 2) * TC_BOX + (j & 3) * 32;  // k = 8 j .. 8 j + 7
        wgmma_tf32(part, al[j], desc_sw128(hi_t + off));
        wgmma_tf32(part, ah[j], desc_sw128(lo_t + off));
        wgmma_tf32(part, ah[j], desc_sw128(hi_t + off));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      // the sums and the register operands are read or kept only from here on
#pragma unroll
      for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(part[e])::"memory");
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(ah[j][q]), "+r"(al[j][q])::"memory");
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
    }
    if (m.w & TC_LAST) {
      // accumulator e holds output row 8 (e / 4) + 2 t + e % 2, column
      // colp[(e / 2) % 2] of the unit
      float* Y = y + ((size_t)m.x * bs + m.y * TC_B) * d + m.z * TC_B;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        Y[(size_t)(8 * (e >> 2) + 2 * t4 + (e & 1)) * d + colp[(e >> 1) & 1]] = acc[e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(empty + s));
    if (++s == TC_STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A row-major f32 matrix [rows][cols] as a tensor map of 64 x 32 boxes with
// 128B swizzle. The encoder lives in libcuda and is looked up through the
// runtime's entry-point query, so the library links against the runtime only.
static int make_tensor_map(CUtensorMap* map, const void* base, unsigned long long cols,
                           unsigned long long rows) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode = (EncodeTiledFn)fn;
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 4};
  const cuuint32_t box[2] = {32, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

extern "C" {

// One launch on `stream`; returns cudaGetLastError() after it. `dj` is the
// column chunk per CTA (capped at 64); it chooses tiling only. `ntiles` is
// the first dimension of `tiles`. The tensor-core path needs `order`
// (row-blocks heaviest first, i32[nb]) and `counter` (one i32 set to 0); the
// other paths ignore both.
int bsr_spmm_launch(int semiring, const void* rowptr, const void* tilecols,
                    const void* tiles, const void* x, void* y, const void* order,
                    void* counter, int nb, int ntiles, int bs, int d, int dj, void* stream) {
  if (nb < 1 || ntiles < 1 || bs < 1 || d < 1 || dj < 1) return (int)cudaErrorInvalidValue;
  if (dj > SP_COLS) dj = SP_COLS;
  cudaStream_t st = (cudaStream_t)stream;
  const int* rp = (const int*)rowptr;
  const int* tcs = (const int*)tilecols;
  const float* tl = (const float*)tiles;
  const float* xx = (const float*)x;
  float* yy = (float*)y;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)tiles % 16 == 0) &&
                       ((uintptr_t)y % 16 == 0);
  if (aligned && bs % SP_B == 0 && d % SP_B == 0 && semiring == SR_PLUS_TIMES) {
    if (order == nullptr || counter == nullptr) return (int)cudaErrorInvalidValue;
    const long long units = (long long)nb * (bs / TC_B) * (d / TC_B);
    if (units > 0x7fffffffLL || (long long)ntiles * bs > 0x7fffffffLL ||
        (long long)nb * bs > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;  // TMA coordinates are 32-bit
    CUtensorMap map_tiles, map_x;
    int rc = make_tensor_map(&map_tiles, tiles, bs, (unsigned long long)ntiles * bs);
    if (rc) return rc;
    if ((rc = make_tensor_map(&map_x, x, d, (unsigned long long)nb * bs))) return rc;
    cudaError_t err = cudaFuncSetAttribute(
        bsr_spmm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bsr_spmm_tc_kernel,
                                                             TC_THREADS, TC_SMEM)) != cudaSuccess)
      return (int)err;
    const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const int grid = (int)(units < slots ? units : slots);
    bsr_spmm_tc_kernel<<<grid, TC_THREADS, TC_SMEM, st>>>(
        map_tiles, map_x, rp, tcs, (const int*)order, (int*)counter, yy, (int)units, bs, d);
    return (int)cudaGetLastError();
  }
  if (aligned && bs % SP_B == 0 && d % SP_B == 0) {
    const dim3 grid(nb, d / SP_B), block(SP_THREADS);
    switch (semiring) {
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
