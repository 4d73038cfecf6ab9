// Frontier-gated multi-sweep block Gauss–Seidel kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `gs_multisweep_pallas` of
// src/repro/kernels/gs_sweep.py (and its one-sweep wrapper
// `gs_sweep_pallas`). It computes, for up to `sweeps` sweeps over the
// destination blocks i = 0..nb-1 of a ragged flat BSR, in that order:
//
//     agg  = REDUCE_t tiles[t] (x) x[tilecols[t]],  t in [rowptr[i], rowptr[i+1])
//     new  = combine(c[i], agg, old);  new = fixed ? x0 : new;  x[i] <- new
//
// with the per-sweep per-column delta (linf / l1 / changed), the count of
// updated blocks, the dirty-block frontier (a block whose state changed
// bitwise re-marks its dependents through revptr/revrows, visible to later
// blocks of the same sweep) and a sticky early-out once every column's
// delta is <= eps. The state x is updated in place; it must not alias x0.
//
// Block order is the algorithm: block i must see blocks < i at their new
// values. The TPU ran its grid in sequence; here one persistent cooperative
// launch walks the blocks in order, and every CTA works on the same block:
//
//   1. the block's tile list is split into contiguous chunks, one per CTA;
//      each CTA reduces its chunk into a partial (bs, d) accumulator in
//      global scratch;                                   -- grid barrier A
//   2. the block's rows are split across CTAs; each reduces the partials of
//      its rows in fixed CTA order (no float atomics: plus_times is
//      deterministic from run to run), combines, writes the new rows and a
//      per-column delta and a changed flag;               -- grid barrier B
//      (nobody writes block i before barrier A, so a diagonal tile reads the
//      old state of its own block, as on the TPU)
//   3. every CTA folds the changed flags and re-marks dependents in its own
//      copy of the dirty bitmap (shared memory; all copies take the same
//      steps, so they agree without communication); CTA 0 folds the deltas.
//
// A clean block is skipped by every CTA without a barrier. At a sweep's end
// CTA 0 writes the sweep's deltas and active count, decides `done`, and one
// more barrier publishes it. The flag alternates between two slots by sweep
// parity: a sweep with no dirty block has no barrier before its end, so CTA 0
// may write the next sweep's decision while a slower CTA still reads this one.
//
// Bound on this card: per full sweep the kernel must read every tile once
// (nnz * bs * bs * 4 bytes) and do 2 * nnz * bs * bs * d operations; at d = 64
// the operations dominate (f32 FMA, no tensor cores: plus_times is an f32
// product and must not round through TF32). A block's ~300 tiles spread over
// 132 CTAs leave each CTA two or three tiles, so step 1 is bound by load
// latency, not by bandwidth: where the whole (bs, bs) tiles and their source
// blocks fit in shared memory (bs <= 64 at d <= 64) a CTA issues every copy
// of its chunk at once (cp.async, L2 only) and waits once, and (d % 4 == 0)
// each thread accumulates a 4 x 4 register block from vector loads;
// otherwise it stages 16-column slices. Accumulation is plain FFMA. The two
// grid barriers per updated block and the serial walk over blocks keep it
// well above the bound (see PERF.md). No fast-math: BIG + BIG must overflow
// to +inf exactly as in numpy.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define GS_BLOCK 256   // threads per CTA
#define GS_EPT 16      // output elements per thread per pass
#define GS_KC 16       // tile columns staged per slice (sliced path)
#define GS_STAGE_MAX (160 * 1024)  // bytes of whole tiles staged at once

enum { SR_PLUS_TIMES = 0, SR_MIN_PLUS = 1, SR_MAX_MIN = 2, SR_MAX_TIMES = 3 };
enum { RK_LINF = 0, RK_L1 = 1, RK_CHANGED = 2 };

template <int SR> struct Semiring;

template <> struct Semiring<SR_PLUS_TIMES> {
  static __device__ __forceinline__ float ident() { return 0.0f; }
  static __device__ __forceinline__ float tile(float acc, float a, float b) { return fmaf(a, b, acc); }
  static __device__ __forceinline__ float reduce(float acc, float v) { return acc + v; }
  static __device__ __forceinline__ float combine(float c, float agg, float old) { return c + agg; }
};

template <> struct Semiring<SR_MIN_PLUS> {
  static __device__ __forceinline__ float ident() { return 3.0e38f; }
  static __device__ __forceinline__ float tile(float acc, float a, float b) { return fminf(acc, __fadd_rn(a, b)); }
  static __device__ __forceinline__ float reduce(float acc, float v) { return fminf(acc, v); }
  static __device__ __forceinline__ float combine(float c, float agg, float old) { return fminf(old, fminf(c, agg)); }
};

template <> struct Semiring<SR_MAX_MIN> {
  static __device__ __forceinline__ float ident() { return -3.0e38f; }
  static __device__ __forceinline__ float tile(float acc, float a, float b) { return fmaxf(acc, fminf(a, b)); }
  static __device__ __forceinline__ float reduce(float acc, float v) { return fmaxf(acc, v); }
  static __device__ __forceinline__ float combine(float c, float agg, float old) { return fmaxf(old, fmaxf(c, agg)); }
};

template <> struct Semiring<SR_MAX_TIMES> {
  static __device__ __forceinline__ float ident() { return -3.0e38f; }
  static __device__ __forceinline__ float tile(float acc, float a, float b) { return fmaxf(acc, __fmul_rn(a, b)); }
  static __device__ __forceinline__ float reduce(float acc, float v) { return fmaxf(acc, v); }
  static __device__ __forceinline__ float combine(float c, float agg, float old) { return fmaxf(old, fmaxf(c, agg)); }
};

template <int RK> struct Delta;
template <> struct Delta<RK_LINF> {
  static __device__ __forceinline__ float add(float acc, float nw, float od) { return fmaxf(acc, fabsf(__fsub_rn(nw, od))); }
  static __device__ __forceinline__ float fold(float acc, float v) { return fmaxf(acc, v); }
};
template <> struct Delta<RK_L1> {
  static __device__ __forceinline__ float add(float acc, float nw, float od) { return acc + fabsf(__fsub_rn(nw, od)); }
  static __device__ __forceinline__ float fold(float acc, float v) { return acc + v; }
};
template <> struct Delta<RK_CHANGED> {
  static __device__ __forceinline__ float add(float acc, float nw, float od) { return acc + (nw != od ? 1.0f : 0.0f); }
  static __device__ __forceinline__ float fold(float acc, float v) { return acc + v; }
};

struct Args {
  const int* rowptr;    // [nb + 1]
  const int* tilecols;  // [nnz]
  const int* revptr;    // [nb + 1]
  const int* revrows;   // [nnz]
  const int* dirty_in;  // [nb]
  const float* tiles;   // [nnz, bs, bs]
  const float* c;       // [nb * bs, d]
  const float* x0;      // [nb * bs, d]
  const float* fixed;   // [nb * bs, d]
  float* x;             // [nb * bs, d], in place
  float* deltas;        // [sweeps, d]
  float* active;        // [sweeps]
  int* dirty_out;       // [nb]
  float* partial;       // scratch [grid, bs, d]
  float* dscratch;      // scratch [Q, d]
  int* chg;             // scratch [Q]
  float* dacc;          // scratch [d]      (CTA 0 only)
  int* done_flag;       // scratch [2], by sweep parity
  int nb, bs, d, sweeps;
  float eps;
  int stage_tiles;      // whole tiles staged per group; 0 = sliced path
};

// floats of one whole staged tile (rows padded by 4 against bank
// conflicts, 16-byte aligned) plus its (bs, d) source block
static __host__ __device__ int staged_tile_floats(int bs, int d) {
  return bs * (bs + 4) + bs * d;
}

// Whole-tile staging needs 16-byte rows and one register pass over the
// block's (bs, d) elements; returns how many tiles fit at once (0 = use
// the sliced path).
static int stage_tiles_for(int bs, int d, int nb, int smem_max, bool aligned) {
  if (!aligned || bs % 4 != 0 || bs * d > GS_BLOCK * GS_EPT) return 0;
  long long avail = (long long)smem_max - GS_BLOCK * 4 - ((nb + 15) / 16) * 16 - 1024;
  if (avail > GS_STAGE_MAX) avail = GS_STAGE_MAX;
  long long tb = avail / (4LL * staged_tile_floats(bs, d));
  return tb > 64 ? 64 : (int)tb;
}

// bytes of dynamic shared memory one CTA needs
static size_t smem_bytes(int bs, int d, int nb, int stage_tiles) {
  size_t region = (size_t)bs * GS_KC + (size_t)GS_KC * d;
  size_t staged = (size_t)stage_tiles * staged_tile_floats(bs, d);
  if (staged > region) region = staged;
  region = (region + 3) / 4 * 4;
  return (region + GS_BLOCK) * sizeof(float) + (size_t)((nb + 15) / 16) * 16;
}

// 16-byte asynchronous copy global -> shared, cached in L2 only (the state
// is written by other CTAs; L1 would not see their writes)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int SR, int RK>
__global__ void __launch_bounds__(GS_BLOCK)
gs_multisweep_kernel(Args a) {
  using S = Semiring<SR>;
  using D = Delta<RK>;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int bs = a.bs, d = a.d, nb = a.nb;
  int region = bs * GS_KC + GS_KC * d;
  if (a.stage_tiles * staged_tile_floats(bs, d) > region)
    region = a.stage_tiles * staged_tile_floats(bs, d);
  region = (region + 3) / 4 * 4;
  float* tile_s = smem;                       // sliced: [bs, GS_KC]
  float* xs_s = tile_s + bs * GS_KC;          // sliced: [GS_KC, d]
  float* red_s = smem + region;               // [GS_BLOCK]
  unsigned char* dirty_s = reinterpret_cast<unsigned char*>(red_s + GS_BLOCK);  // [nb]
  __shared__ int cnt_s;

  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int g = blockIdx.x;
  const int Q = G < bs ? G : bs;   // CTAs that own rows in the combine step
  const int ne = bs * d;           // elements of one block

  for (int i = tid; i < nb; i += GS_BLOCK) dirty_s[i] = a.dirty_in[i] != 0;
  __syncthreads();
  int done = 0;

  for (int s = 0; s < a.sweeps; ++s) {
    if (done) {  // early-outed sweep: reports 0 movement, 0 blocks
      if (g == 0) {
        for (int j = tid; j < d; j += GS_BLOCK) a.deltas[(size_t)s * d + j] = 0.0f;
        if (tid == 0) a.active[s] = 0.0f;
      }
      continue;
    }
    if (g == 0) {
      for (int j = tid; j < d; j += GS_BLOCK) a.dacc[j] = 0.0f;
      if (tid == 0) cnt_s = 0;
    }
    for (int i = 0; i < nb; ++i) {
      if (!dirty_s[i]) continue;  // uniform: every CTA holds the same bitmap
      __syncthreads();            // every thread has read dirty_s[i]
      if (tid == 0) dirty_s[i] = 0;  // cleared before dependents are re-marked
      const int lo = a.rowptr[i], hi = a.rowptr[i + 1];
      const int nt = hi - lo;
      const int P = nt < G ? nt : G;  // partial chunks, each nonempty

      // ---- 1. this CTA's chunk of tiles -> partial[g] ----------------------
      if (g < P && a.stage_tiles > 0) {
        // whole tiles and their source blocks, a group at a time, every copy
        // in flight before one wait; one register pass over the elements
        const int t0 = lo + (int)(((long long)g * nt) / P);
        const int t1 = lo + (int)(((long long)(g + 1) * nt) / P);
        const int TS = bs + 4;
        const int per_tile = staged_tile_floats(bs, d);
        // d % 4 == 0: each thread owns a 4 x 4 block of (row, column)
        // elements, 8 vector loads from shared memory per 64 FMAs;
        // otherwise element m of a thread is tid + m * GS_BLOCK
        const bool micro = d % 4 == 0;
        const int d4 = d / 4;
        const bool mact = micro && tid < (bs / 4) * d4;
        const int rt = mact ? tid / d4 : 0, ct = mact ? tid % d4 : 0;
        float acc[GS_EPT];
        int rr[GS_EPT], jj[GS_EPT];
#pragma unroll
        for (int m = 0; m < GS_EPT; ++m) {
          acc[m] = S::ident();
          int e = tid + m * GS_BLOCK;
          if (e >= ne) e = ne - 1;  // duplicate work, never stored
          rr[m] = e / d;
          jj[m] = e - rr[m] * d;
        }
        for (int tg = t0; tg < t1; tg += a.stage_tiles) {
          const int ng = t1 - tg < a.stage_tiles ? t1 - tg : a.stage_tiles;
          __syncthreads();  // the previous group is consumed
          for (int tt = 0; tt < ng; ++tt) {
            float* ts = smem + tt * per_tile;
            float* xd = ts + bs * TS;
            const float* T = a.tiles + (size_t)(tg + tt) * bs * bs;
            const float* X = a.x + (size_t)a.tilecols[tg + tt] * bs * d;
            for (int c = tid; c < bs * bs / 4; c += GS_BLOCK) {
              const int r = (4 * c) / bs;
              cp_async16(ts + r * TS + (4 * c - r * bs), T + 4 * c);
            }
            for (int c = tid; c < bs * d / 4; c += GS_BLOCK) cp_async16(xd + 4 * c, X + 4 * c);
          }
          cp_async_wait_all();
          __syncthreads();
          for (int tt = 0; tt < ng; ++tt) {
            const float* ts = smem + tt * per_tile;
            const float* xd = ts + bs * TS;
            if (micro) {
              if (mact)
                for (int k = 0; k < bs; k += 4) {
                  float4 av[4];
#pragma unroll
                  for (int i = 0; i < 4; ++i)
                    av[i] = *reinterpret_cast<const float4*>(ts + (4 * rt + i) * TS + k);
#pragma unroll
                  for (int kk = 0; kk < 4; ++kk) {
                    const float4 b = *reinterpret_cast<const float4*>(xd + (k + kk) * d + 4 * ct);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                      const float av_k = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
                      acc[4 * i + 0] = S::tile(acc[4 * i + 0], av_k, b.x);
                      acc[4 * i + 1] = S::tile(acc[4 * i + 1], av_k, b.y);
                      acc[4 * i + 2] = S::tile(acc[4 * i + 2], av_k, b.z);
                      acc[4 * i + 3] = S::tile(acc[4 * i + 3], av_k, b.w);
                    }
                  }
                }
            } else {
              for (int k = 0; k < bs; ++k) {
#pragma unroll
                for (int m = 0; m < GS_EPT; ++m)
                  acc[m] = S::tile(acc[m], ts[rr[m] * TS + k], xd[k * d + jj[m]]);
              }
            }
          }
        }
        float* part = a.partial + (size_t)g * ne;
        if (micro) {
          if (mact)
#pragma unroll
            for (int m = 0; m < GS_EPT; ++m)
              __stcg(part + (size_t)(4 * rt + m / 4) * d + 4 * ct + m % 4, acc[m]);
        } else {
#pragma unroll
          for (int m = 0; m < GS_EPT; ++m) {
            const int e = tid + m * GS_BLOCK;
            if (e < ne) __stcg(part + e, acc[m]);
          }
        }
      } else if (g < P) {
        // sliced: GS_KC tile columns and source rows at a time (any bs, d)
        const int t0 = lo + (int)(((long long)g * nt) / P);
        const int t1 = lo + (int)(((long long)(g + 1) * nt) / P);
        float* part = a.partial + (size_t)g * ne;
        for (int base = 0; base < ne; base += GS_BLOCK * GS_EPT) {
          float acc[GS_EPT];
          int rr[GS_EPT], jj[GS_EPT];
#pragma unroll
          for (int m = 0; m < GS_EPT; ++m) {
            acc[m] = S::ident();
            int e = base + tid + m * GS_BLOCK;
            if (e >= ne) e = ne - 1;  // duplicate work, never stored
            rr[m] = e / d;
            jj[m] = e - rr[m] * d;
          }
          for (int t = t0; t < t1; ++t) {
            const float* T = a.tiles + (size_t)t * bs * bs;
            const float* X = a.x + (size_t)a.tilecols[t] * bs * d;
            for (int k0 = 0; k0 < bs; k0 += GS_KC) {
              const int kc = bs - k0 < GS_KC ? bs - k0 : GS_KC;
              __syncthreads();  // previous slice consumed
              for (int idx = tid; idx < bs * kc; idx += GS_BLOCK) {
                const int r = idx / kc, kk = idx - r * kc;
                tile_s[r * GS_KC + kk] = __ldg(T + (size_t)r * bs + k0 + kk);
              }
              for (int idx = tid; idx < kc * d; idx += GS_BLOCK)
                xs_s[idx] = __ldcg(X + (size_t)k0 * d + idx);
              __syncthreads();
              for (int kk = 0; kk < kc; ++kk) {
#pragma unroll
                for (int m = 0; m < GS_EPT; ++m)
                  acc[m] = S::tile(acc[m], tile_s[rr[m] * GS_KC + kk], xs_s[kk * d + jj[m]]);
              }
            }
          }
#pragma unroll
          for (int m = 0; m < GS_EPT; ++m) {
            const int e = base + tid + m * GS_BLOCK;
            if (e < ne) __stcg(part + e, acc[m]);
          }
        }
      }
      grid.sync();  // A: partials written, every read of the old state done

      // ---- 2. rows of this CTA: fold partials, combine, write back --------
      if (g < Q) {
        const int r0 = (g * bs) / Q, r1 = ((g + 1) * bs) / Q;
        const int JW = d < GS_BLOCK ? d : GS_BLOCK;
        const int SP = GS_BLOCK / JW;  // thread groups splitting the partials
        int changed = 0;
        for (int jb = 0; jb < d; jb += JW) {
          const int jl = tid % JW, sg = tid / JW, j = jb + jl;
          const bool act = sg < SP && j < d;
          const int p0 = (sg * P) / SP, p1 = ((sg + 1) * P) / SP;
          float dl = 0.0f;
          for (int r = r0; r < r1; ++r) {
            float v = S::ident();
            if (act)
#pragma unroll 4
              for (int p = p0; p < p1; ++p)
                v = S::reduce(v, __ldcg(a.partial + (size_t)p * ne + (size_t)r * d + j));
            red_s[tid] = v;
            __syncthreads();
            if (act && sg == 0) {
              float agg = S::ident();
              for (int q = 0; q < SP; ++q) agg = S::reduce(agg, red_s[q * JW + jl]);
              const size_t off = ((size_t)i * bs + r) * d + j;
              const float old = __ldcg(a.x + off);
              float nw = S::combine(__ldg(a.c + off), agg, old);
              if (__ldg(a.fixed + off) != 0.0f) nw = __ldg(a.x0 + off);
              __stcg(a.x + off, nw);
              dl = D::add(dl, nw, old);
              changed |= (nw != old);
            }
            __syncthreads();
          }
          if (act && sg == 0) __stcg(a.dscratch + (size_t)g * d + j, dl);
        }
        changed = __syncthreads_or(changed);
        if (tid == 0) __stcg(a.chg + g, changed);
      }
      grid.sync();  // B: block i's new rows, deltas and flags are visible

      // ---- 3. frontier bookkeeping (every CTA), delta fold (CTA 0) ---------
      int any = 0;
      for (int q = tid; q < Q; q += GS_BLOCK) any |= __ldcg(a.chg + q);
      any = __syncthreads_or(any);
      if (any)
        for (int t = a.revptr[i] + tid; t < a.revptr[i + 1]; t += GS_BLOCK)
          dirty_s[a.revrows[t]] = 1;
      if (g == 0) {
        for (int j = tid; j < d; j += GS_BLOCK) {
          float v = 0.0f;
#pragma unroll 8
          for (int q = 0; q < Q; ++q) v = D::fold(v, __ldcg(a.dscratch + (size_t)q * d + j));
          a.dacc[j] = D::fold(a.dacc[j], v);
        }
        if (tid == 0) cnt_s += 1;
      }
      __syncthreads();
    }
    // ---- sweep end: export deltas/active, decide the early-out -------------
    int below = 1;
    if (g == 0) {
      for (int j = tid; j < d; j += GS_BLOCK) {
        const float v = a.dacc[j];
        a.deltas[(size_t)s * d + j] = v;
        below &= (v <= a.eps);
      }
      below = __syncthreads_and(below);
      if (tid == 0) {
        a.active[s] = (float)cnt_s;
        a.done_flag[s & 1] = below;
      }
    }
    grid.sync();
    done = __ldcg(a.done_flag + (s & 1));
  }
  if (g == 0)
    for (int i = tid; i < nb; i += GS_BLOCK) a.dirty_out[i] = dirty_s[i];
}

typedef void (*KernelFn)(Args);

static KernelFn pick(int semiring, int res_kind) {
#define GS_CASE(SR, RK) \
  if (semiring == SR && res_kind == RK) return gs_multisweep_kernel<SR, RK>;
#define GS_SR(SR) GS_CASE(SR, RK_LINF) GS_CASE(SR, RK_L1) GS_CASE(SR, RK_CHANGED)
  GS_SR(SR_PLUS_TIMES)
  GS_SR(SR_MIN_PLUS)
  GS_SR(SR_MAX_MIN)
  GS_SR(SR_MAX_TIMES)
#undef GS_SR
#undef GS_CASE
  return nullptr;
}

static int prepare(KernelFn fn, int bs, int d, int nb, bool aligned, int* grid,
                   size_t* smem, int* stage_tiles) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0, smem_max = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))) return err;
  if (!coop) return cudaErrorNotSupported;
  *stage_tiles = stage_tiles_for(bs, d, nb, smem_max, aligned);
  *smem = smem_bytes(bs, d, nb, *stage_tiles);
  if (*smem > (size_t)smem_max) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)*smem)))
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)fn, GS_BLOCK, *smem)))
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = sms;  // one CTA per SM: co-resident, and the cheapest grid barrier
  return cudaSuccess;
}

extern "C" {

// Grid size and float32 scratch length the launch below needs.
int gs_multisweep_plan(int semiring, int res_kind, int bs, int d, int nb,
                       int* grid, long long* scratch_floats) {
  KernelFn fn = pick(semiring, res_kind);
  if (!fn) return cudaErrorInvalidValue;
  size_t smem = 0;
  int stage = 0;
  int err = prepare(fn, bs, d, nb, true, grid, &smem, &stage);
  if (err) return err;
  const long long Q = *grid < bs ? *grid : bs;
  *scratch_floats = (long long)(*grid) * bs * d + Q * d + Q + d + 2;
  return cudaSuccess;
}

// One cooperative launch on `stream`; returns cudaGetLastError() after it.
int gs_multisweep_launch(int semiring, int res_kind,
                         const void* rowptr, const void* tilecols,
                         const void* revptr, const void* revrows,
                         const void* dirty_in, const void* tiles,
                         const void* c, const void* x0, const void* fixed,
                         void* x, void* deltas, void* active, void* dirty_out,
                         void* scratch, int nb, int bs, int d, int sweeps,
                         float eps, int grid, void* stream) {
  KernelFn fn = pick(semiring, res_kind);
  if (!fn) return cudaErrorInvalidValue;
  int planned = 0, stage = 0;
  size_t smem = 0;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)tiles % 16 == 0);
  int err = prepare(fn, bs, d, nb, aligned, &planned, &smem, &stage);
  if (err) return err;
  if (grid != planned) return cudaErrorInvalidValue;
  const int Q = grid < bs ? grid : bs;
  Args a;
  a.rowptr = (const int*)rowptr;
  a.tilecols = (const int*)tilecols;
  a.revptr = (const int*)revptr;
  a.revrows = (const int*)revrows;
  a.dirty_in = (const int*)dirty_in;
  a.tiles = (const float*)tiles;
  a.c = (const float*)c;
  a.x0 = (const float*)x0;
  a.fixed = (const float*)fixed;
  a.x = (float*)x;
  a.deltas = (float*)deltas;
  a.active = (float*)active;
  a.dirty_out = (int*)dirty_out;
  float* sc = (float*)scratch;
  a.partial = sc;
  sc += (size_t)grid * bs * d;
  a.dscratch = sc;
  sc += (size_t)Q * d;
  a.chg = (int*)sc;
  sc += Q;
  a.dacc = sc;
  sc += d;
  a.done_flag = (int*)sc;
  a.nb = nb;
  a.bs = bs;
  a.d = d;
  a.sweeps = sweeps;
  a.eps = eps;
  a.stage_tiles = stage;
  void* params[] = {&a};
  cudaLaunchCooperativeKernel((const void*)fn, dim3(grid), dim3(GS_BLOCK), params, smem,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
