// Bucketed residual-push scatter kernel for Hopper (sm_90a): conflict-free
// waves.
//
// Replaces the TPU kernel `push_scatter_pallas` of
// src/repro/kernels/push_scatter.py. One launch is one push round over a
// slot list the host has bucketed (best priority first). Per slot k in flat
// b * cap + j order with u = vid[k] >= 0, on p, r f32[n, d] in place:
//
//     sum (plus_times):   push = r[u];  p[u] = p[u] + push
//     lattice (min/max):  push = combine(p[u], r[u]);  p[u] = push
//     then                r[u] = ACC_IDENTITY
//     then, for each out-edge (v, w) in nbrs/ew[seg_start[k] : +seg_len[k]]:
//                         r[v] = reduce(r[v], edge_op(push, w))
//
// Every slot sees all earlier slots' writes. (pushed / edges per bucket are
// counted by the wrapper from vid and seg_len.)
//
// Design. A slot reads and writes only the rows of its closed out-set
// {u} + N_out(u). Consecutive slots whose closed sets are pairwise disjoint
// share no address, so running them at once gives the sequential bits in
// every semiring. The wrapper (kernels/push_scatter.py, push_schedule) finds
// for each live slot k, with torch ops on the device, prev[k]: the last
// earlier live slot whose closed set meets k's. (A round of at most 64
// slots skips that search, whose torch ops cost ~1 ms whatever the round:
// its slots come as waves of one, each walking its edges in order.) This
// file holds two kernels:
//
//  * push_waves_kernel, one warp: cuts the slot list into waves, maximal runs
//    of consecutive slots in which no live slot has prev >= the run's start,
//    also cut at PS_WMAX slots (a wave's settled values live in shared
//    memory). Dead slots (vid < 0) never open or close a wave. One window of
//    32 slots per step, one ballot per cut: ~S/32 + waves warp steps.
//  * push_scatter_kernel: the columns are independent, so each CTA owns G
//    consecutive columns (G = min(8, pow2 >= d)) and runs every wave in
//    order; no grid barrier, no atomics. Its threads form groups of G lanes,
//    lane = column, so a row access is one coalesced G-float segment. Per
//    wave:
//      1. each group settles slots of the wave (u's two rows), keeps the
//         pushed value in shared memory and empties r[u]; a slot whose
//         segment repeats a destination (a parallel edge: flagged by the
//         schedule) also walks its own edges in order, as the oracle does;
//                                                   -- __syncthreads
//      2. the wave's other edges, flattened in slot-and-edge order by the
//         schedule, are spread over the groups, four per group at a time with
//         their row loads issued before any store: within a wave no two of
//         them share a destination. A self-loop lands on the emptied row.
//                                                   -- __syncthreads
//    The state-independent arrays of the next wave (its slots, and its
//    edges' destination, weight and slot) are staged into shared memory with
//    cp.async, double-buffered, while this wave runs, so a wave's dependent
//    chain is only the state rows: load u's rows, then the destinations'.
//
// Why G = min(8, pow2 >= d): at d = 64 eight CTAs of 512 threads run on
// eight SMs, each with 64 groups, which covers a typical wave (~34 slots,
// ~240 edges on the PPR graph) in one pass of each phase; a 32-byte row
// segment is one memory sector. At d = 1 one CTA of 512 single-lane groups
// takes up to 2,048 edges of a wave per pass. The waves, not the columns,
// carry the parallelism: the round's time is ~waves x two dependent
// global-memory latencies.
//
// Exactness: the oracle rounds every product before the add, so the sum is
// __fmul_rn then __fadd_rn (no FFMA contraction), and min_plus adds with
// __fadd_rn. No fast-math: BIG + w may overflow to +inf exactly as in numpy.
// The state is read and written through L2 (ld/st.cg); every access to a
// column lies in the CTA that owns it, and __syncthreads orders the waves.
//
// Bound on this card: per slot u's two rows are read and written
// (4 * d * 4 bytes), per edge the edge is read (8 bytes) and one residual
// row read and written (2 * d * 4 bytes). PERF.md holds the measured time
// beside that bound.

#include <cuda_runtime.h>
#include <stdint.h>

#define PS_THREADS 512
#define PS_GMAX 8        // columns per CTA (lanes per group) at most
#define PS_WMAX 256      // slots per wave at most
#define PS_EST 1024      // edges of a wave staged in shared memory
#define PS_UNROLL 4      // edges per group per step of phase 2

enum { SR_PLUS_TIMES = 0, SR_MIN_PLUS = 1, SR_MAX_MIN = 2, SR_MAX_TIMES = 3 };

template <int SR> struct Push;

template <> struct Push<SR_PLUS_TIMES> {
  static __device__ __forceinline__ float ident() { return 0.0f; }
  // returns the pushed value; *p becomes the settled state
  static __device__ __forceinline__ float settle(float* p, float r) {
    const float push = r;
    *p = __fadd_rn(*p, push);
    return push;
  }
  static __device__ __forceinline__ float edge(float rv, float push, float w) {
    return __fadd_rn(rv, __fmul_rn(w, push));
  }
};

template <> struct Push<SR_MIN_PLUS> {
  static __device__ __forceinline__ float ident() { return 3.0e38f; }
  static __device__ __forceinline__ float settle(float* p, float r) {
    *p = fminf(*p, r);
    return *p;
  }
  static __device__ __forceinline__ float edge(float rv, float push, float w) {
    return fminf(rv, __fadd_rn(push, w));
  }
};

template <> struct Push<SR_MAX_MIN> {
  static __device__ __forceinline__ float ident() { return -3.0e38f; }
  static __device__ __forceinline__ float settle(float* p, float r) {
    *p = fmaxf(*p, r);
    return *p;
  }
  static __device__ __forceinline__ float edge(float rv, float push, float w) {
    return fmaxf(rv, fminf(push, w));
  }
};

template <> struct Push<SR_MAX_TIMES> {
  static __device__ __forceinline__ float ident() { return -3.0e38f; }
  static __device__ __forceinline__ float settle(float* p, float r) {
    *p = fmaxf(*p, r);
    return *p;
  }
  static __device__ __forceinline__ float edge(float rv, float push, float w) {
    return fmaxf(rv, __fmul_rn(push, w));
  }
};

// ---------------------------------------------------------------------------
// the wave cut
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
push_waves_kernel(const int* __restrict__ vid, const int* __restrict__ prev, int S,
                  int wmax, int* wstart, int* wend, int* nw) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x;
  int ws = -1, last = -1, w = 0;
  int nv = lane < S ? __ldg(vid + lane) : -1;
  int np = lane < S ? __ldg(prev + lane) : -1;
  for (int base = 0; base < S; base += 32) {
    const int k = base + lane;
    const int v = nv, pv = np;
    const int kn = k + 32;  // the next window's loads, issued before this one's steps
    nv = kn < S ? __ldg(vid + kn) : -1;
    np = kn < S ? __ldg(prev + kn) : -1;
    unsigned pending = __ballot_sync(FULL, k < S && v >= 0);
    while (pending) {
      const bool mine = (pending >> lane) & 1u;
      const unsigned need =
          __ballot_sync(FULL, mine && (ws < 0 || pv >= ws || k - ws >= wmax));
      if (!need) {
        last = base + 31 - __clz(pending);
        break;
      }
      const int f = __ffs(need) - 1;
      const unsigned before = pending & ((1u << f) - 1u);
      if (before) last = base + 31 - __clz(before);
      if (ws >= 0) {
        if (lane == 0) {
          wstart[w] = ws;
          wend[w] = last + 1;
        }
        ++w;
      }
      ws = base + f;
      last = ws;
      pending &= ~((2u << f) - 1u);  // f = 31: 2u << 31 == 0, clears all
    }
  }
  if (ws >= 0) {
    if (lane == 0) {
      wstart[w] = ws;
      wend[w] = last + 1;
    }
    ++w;
  }
  if (lane == 0) *nw = w;
}

// ---------------------------------------------------------------------------
// the round
// ---------------------------------------------------------------------------

struct Args {
  const int* seg_start;  // [S]
  const int* seg_len;    // [S]
  const int* nbrs;       // [E]
  const float* ew;       // [E]
  const int* sv;         // [S] schedule: -1 dead, u, or -(u + 2) for a slot walked in order
  const int* e_v;        // [cap_e] flattened edges: destination,
  const float* e_w;      //                          weight,
  const int* e_k;        //                          slot
  const int4* wb;        // [nw] waves: slot range, flattened-edge range
  const int* nw;         // [1] number of waves
  float* p;              // [n, d] in place
  float* r;              // [n, d] in place
  int d, G;
};

struct Stage {
  int sv[PS_WMAX];
  int ev[PS_EST];
  float ew[PS_EST];
  int ek[PS_EST];
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// all but the most recent group of this thread are in
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// start, without waiting, the copies of one wave's slots and of its first
// PS_EST flattened edges into `st`
__device__ __forceinline__ void stage_wave(Stage& st, const Args& a, int ws, int we,
                                           int eb, int ee) {
  for (int i = threadIdx.x; i < we - ws; i += PS_THREADS) cp_async4(&st.sv[i], a.sv + ws + i);
  const int ne = ee - eb < PS_EST ? ee - eb : PS_EST;
  for (int q = threadIdx.x; q < ne; q += PS_THREADS) {
    cp_async4(&st.ev[q], a.e_v + eb + q);
    cp_async4(&st.ew[q], a.e_w + eb + q);
    cp_async4(&st.ek[q], a.e_k + eb + q);
  }
}

// a slot whose segment repeats a destination: its edges in order, four at a
// time when their destinations are distinct
template <int SR>
__device__ void walk_in_order(const Args& a, int k, int j, float push) {
  typedef Push<SR> S;
  const int d = a.d;
  int t = __ldg(a.seg_start + k);
  const int hi = t + __ldg(a.seg_len + k);
  for (; t + 4 <= hi; t += 4) {
    const int v0 = __ldg(a.nbrs + t), v1 = __ldg(a.nbrs + t + 1);
    const int v2 = __ldg(a.nbrs + t + 2), v3 = __ldg(a.nbrs + t + 3);
    const float w0 = __ldg(a.ew + t), w1 = __ldg(a.ew + t + 1);
    const float w2 = __ldg(a.ew + t + 2), w3 = __ldg(a.ew + t + 3);
    float* r0 = a.r + (size_t)v0 * d + j;
    float* r1 = a.r + (size_t)v1 * d + j;
    float* r2 = a.r + (size_t)v2 * d + j;
    float* r3 = a.r + (size_t)v3 * d + j;
    if (v0 != v1 && v0 != v2 && v0 != v3 && v1 != v2 && v1 != v3 && v2 != v3) {
      const float x0 = __ldcg(r0), x1 = __ldcg(r1), x2 = __ldcg(r2), x3 = __ldcg(r3);
      __stcg(r0, S::edge(x0, push, w0));
      __stcg(r1, S::edge(x1, push, w1));
      __stcg(r2, S::edge(x2, push, w2));
      __stcg(r3, S::edge(x3, push, w3));
    } else {
      __stcg(r0, S::edge(__ldcg(r0), push, w0));
      __stcg(r1, S::edge(__ldcg(r1), push, w1));
      __stcg(r2, S::edge(__ldcg(r2), push, w2));
      __stcg(r3, S::edge(__ldcg(r3), push, w3));
    }
  }
  for (; t < hi; ++t) {
    float* rv = a.r + (size_t)__ldg(a.nbrs + t) * d + j;
    __stcg(rv, S::edge(__ldcg(rv), push, __ldg(a.ew + t)));
  }
}

template <int SR>
__global__ void __launch_bounds__(PS_THREADS)
push_scatter_kernel(Args a) {
  typedef Push<SR> S;
  __shared__ Stage stage[3];
  __shared__ float push_s[PS_WMAX * PS_GMAX];
  const int G = a.G, d = a.d;
  const int NG = PS_THREADS / G;
  const int grp = threadIdx.x / G, lane = threadIdx.x - grp * G;
  const int j = blockIdx.x * G + lane;
  const bool col = j < d;
  const int nw = *a.nw;
  if (nw == 0) return;

  // each wave's (slot start, slot end, edge start, edge end) is loaded
  // three waves ahead; the next two waves' arrays are staged while this
  // one runs, and the next wave's state rows are prefetched into L2
  const int4 none = make_int4(0, 0, 0, 0);
  int4 b0 = a.wb[0];
  int4 b1 = nw > 1 ? a.wb[1] : none;
  int4 b2 = nw > 2 ? a.wb[2] : none;
  stage_wave(stage[0], a, b0.x, b0.y, b0.z, b0.w);
  cp_async_commit();
  stage_wave(stage[1], a, b1.x, b1.y, b1.z, b1.w);
  cp_async_commit();

  for (int w = 0; w < nw; ++w) {
    Stage& st = stage[w % 3];
    const int ws = b0.x, we = b0.y, eb = b0.z, ee = b0.w;
    if (w + 2 < nw) stage_wave(stage[(w + 2) % 3], a, b2.x, b2.y, b2.z, b2.w);
    const int4 b3 = w + 3 < nw ? a.wb[w + 3] : none;
    cp_async_commit();
    cp_async_wait_prev();  // this wave's and the next one's copies are in
    __syncthreads();
    if (w + 1 < nw) {  // the next wave's rows, into L2
      const Stage& nx = stage[(w + 1) % 3];
      const size_t c0 = (size_t)blockIdx.x * G;
      for (int i = threadIdx.x; i < b1.y - b1.x; i += PS_THREADS) {
        const int sv = nx.sv[i];
        if (sv != -1) {
          const size_t u = (size_t)(sv >= 0 ? sv : -sv - 2) * d + c0;
          asm volatile("prefetch.global.L2 [%0];" ::"l"(a.p + u));
          asm volatile("prefetch.global.L2 [%0];" ::"l"(a.r + u));
        }
      }
      const int ne1 = b1.w - b1.z < PS_EST ? b1.w - b1.z : PS_EST;
      for (int q = threadIdx.x; q < ne1; q += PS_THREADS)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(a.r + (size_t)nx.ev[q] * d + c0));
    }

    // ---- 1. settle the wave's slots --------------------------------------
    for (int i = grp; i < we - ws; i += NG) {
      const int sv = st.sv[i];
      if (sv == -1 || !col) continue;
      const int u = sv >= 0 ? sv : -sv - 2;
      float* pu = a.p + (size_t)u * d + j;
      float* ru = a.r + (size_t)u * d + j;
      float pv = __ldcg(pu);
      const float push = S::settle(&pv, __ldcg(ru));
      __stcg(pu, pv);
      __stcg(ru, S::ident());  // before the scatter: a self-loop lands on the empty row
      if (sv >= 0)
        push_s[i * G + lane] = push;
      else
        walk_in_order<SR>(a, ws + i, j, push);
    }
    __syncthreads();

    // ---- 2. the wave's other edges, spread over the groups ---------------
    const int ne = ee - eb;
    for (int q0 = grp; q0 < ne; q0 += NG * PS_UNROLL) {
      float* addr[PS_UNROLL];
      float pushv[PS_UNROLL], wv[PS_UNROLL], rv[PS_UNROLL];
      bool on[PS_UNROLL];
#pragma unroll
      for (int m = 0; m < PS_UNROLL; ++m) {
        const int q = q0 + m * NG;
        on[m] = false;
        addr[m] = a.r;
        pushv[m] = 0.0f;
        wv[m] = 0.0f;
        if (q < ne && col) {
          int v, k;
          float wt;
          if (q < PS_EST) {
            v = st.ev[q];
            wt = st.ew[q];
            k = st.ek[q];
          } else {
            v = __ldg(a.e_v + eb + q);
            wt = __ldg(a.e_w + eb + q);
            k = __ldg(a.e_k + eb + q);
          }
          const int i = k - ws;
          if (st.sv[i] >= 0) {  // walked in order in phase 1 otherwise
            on[m] = true;
            addr[m] = a.r + (size_t)v * d + j;
            pushv[m] = push_s[i * G + lane];
            wv[m] = wt;
          }
        }
      }
#pragma unroll
      for (int m = 0; m < PS_UNROLL; ++m) rv[m] = on[m] ? __ldcg(addr[m]) : 0.0f;
#pragma unroll
      for (int m = 0; m < PS_UNROLL; ++m)
        if (on[m]) __stcg(addr[m], S::edge(rv[m], pushv[m], wv[m]));
    }
    __syncthreads();  // the wave's writes are visible; its buffers are free

    b0 = b1;
    b1 = b2;
    b2 = b3;
  }
  cp_async_wait_all();
}

static int columns_per_cta(int d) {
  int g = 1;
  while (g < d && g < PS_GMAX) g *= 2;
  return g;
}

extern "C" {

int push_scatter_wmax(void) { return PS_WMAX; }

// The wave cut: one warp on `stream`; returns cudaGetLastError() after it.
int push_waves_launch(const void* vid, const void* prev, int S, void* wstart,
                      void* wend, void* nw, void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  push_waves_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int*)vid, (const int*)prev, S, PS_WMAX, (int*)wstart, (int*)wend, (int*)nw);
  return (int)cudaGetLastError();
}

// One round over the waves on `stream`; returns cudaGetLastError() after it.
int push_scatter_launch(int semiring, const void* seg_start,
                        const void* seg_len, const void* nbrs, const void* ew,
                        const void* sv, const void* e_v, const void* e_w,
                        const void* e_k, const void* wb, const void* nw, void* p, void* r,
                        int d, void* stream) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.seg_start = (const int*)seg_start;
  a.seg_len = (const int*)seg_len;
  a.nbrs = (const int*)nbrs;
  a.ew = (const float*)ew;
  a.sv = (const int*)sv;
  a.e_v = (const int*)e_v;
  a.e_w = (const float*)e_w;
  a.e_k = (const int*)e_k;
  a.wb = (const int4*)wb;
  a.nw = (const int*)nw;
  a.p = (float*)p;
  a.r = (float*)r;
  a.d = d;
  a.G = columns_per_cta(d);
  const dim3 grid((d + a.G - 1) / a.G), block(PS_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  switch (semiring) {
    case SR_PLUS_TIMES: push_scatter_kernel<SR_PLUS_TIMES><<<grid, block, 0, st>>>(a); break;
    case SR_MIN_PLUS: push_scatter_kernel<SR_MIN_PLUS><<<grid, block, 0, st>>>(a); break;
    case SR_MAX_MIN: push_scatter_kernel<SR_MAX_MIN><<<grid, block, 0, st>>>(a); break;
    case SR_MAX_TIMES: push_scatter_kernel<SR_MAX_TIMES><<<grid, block, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
