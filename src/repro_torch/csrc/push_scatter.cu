// Bucketed residual-push scatter kernel for Hopper (sm_90a).
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
// Every slot sees all earlier slots' writes. pushed[b] / edges[b] count the
// settled vertices and scattered edges of bucket b.
//
// Design: the d columns are independent -- each runs the same slot sequence
// and no value of column j is ever read by another column -- so one thread
// owns one column and walks every slot and every edge in order. That is
// exactly the sequential semantics of the oracle (kernels/ref.py,
// ref_push_round), with no atomics, no grid barrier and no race, and the
// result is bitwise repeatable. A warp covers 32 consecutive columns, so
// each row access is one coalesced segment; one CTA of 32 threads per warp
// of columns spreads the warps over SMs. The TPU kernel staged neighbour ids
// in chunks of `ecap` through SMEM; here they are read straight from global
// memory (the same address for every lane: one broadcast load), so the
// arrays need no tail padding.
//
// Within one slot the edges are taken four at a time: when the four
// destinations are distinct their four row loads are issued together before
// any store, which is the sequential result because no edge of the four
// reads another's write; when two coincide (a parallel edge) the four run
// one by one.
//
// Exactness: the oracle rounds every product before the add, so the sum is
// __fmul_rn then __fadd_rn (no FFMA contraction), and min_plus adds with
// __fadd_rn. No fast-math: BIG + w may overflow to +inf exactly as in numpy.
//
// Bound on this card: per slot u's two rows are read and written
// (4 * d * 4 bytes), per edge the edge is read (8 bytes) and one residual
// row read and written (2 * d * 4 bytes). At d = 64 only two warps run, so
// the kernel is bound by the latency of its dependent loads (neighbour id,
// then row), not by bandwidth; PERF.md holds its time beside that bound.

#include <cuda_runtime.h>
#include <stdint.h>

#define PS_WARP 32

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

template <int SR>
__global__ void __launch_bounds__(PS_WARP)
push_scatter_kernel(const int* __restrict__ vid, const int* __restrict__ seg_start,
                    const int* __restrict__ seg_len, const int* __restrict__ nbrs,
                    const float* __restrict__ ew, float* p, float* r,
                    float* pushed, float* edges, int buckets, int cap, int d) {
  typedef Push<SR> S;
  const int j = blockIdx.x * PS_WARP + threadIdx.x;  // this thread's column
  const bool live = j < d;
  const bool counter = blockIdx.x == 0 && threadIdx.x == 0;
  for (int b = 0; b < buckets; ++b) {
    float cnt = 0.0f, ecnt = 0.0f;
    for (int s = 0; s < cap; ++s) {
      const int k = b * cap + s;
      const int u = __ldg(vid + k);
      if (u < 0) continue;
      const int lo = __ldg(seg_start + k);
      const int deg = __ldg(seg_len + k);
      cnt += 1.0f;
      ecnt += (float)deg;
      if (!live) continue;
      const size_t ui = (size_t)u * d + j;
      float pu = p[ui];
      const float push = S::settle(&pu, r[ui]);
      p[ui] = pu;
      r[ui] = S::ident();  // before the scatter: a self-loop lands on the empty row
      int t = lo;
      const int hi = lo + deg;
      for (; t + 4 <= hi; t += 4) {
        const int v0 = __ldg(nbrs + t), v1 = __ldg(nbrs + t + 1);
        const int v2 = __ldg(nbrs + t + 2), v3 = __ldg(nbrs + t + 3);
        const float w0 = __ldg(ew + t), w1 = __ldg(ew + t + 1);
        const float w2 = __ldg(ew + t + 2), w3 = __ldg(ew + t + 3);
        const size_t a0 = (size_t)v0 * d + j, a1 = (size_t)v1 * d + j;
        const size_t a2 = (size_t)v2 * d + j, a3 = (size_t)v3 * d + j;
        if (v0 != v1 && v0 != v2 && v0 != v3 && v1 != v2 && v1 != v3 && v2 != v3) {
          const float r0 = r[a0], r1 = r[a1], r2 = r[a2], r3 = r[a3];
          r[a0] = S::edge(r0, push, w0);
          r[a1] = S::edge(r1, push, w1);
          r[a2] = S::edge(r2, push, w2);
          r[a3] = S::edge(r3, push, w3);
        } else {
          r[a0] = S::edge(r[a0], push, w0);
          r[a1] = S::edge(r[a1], push, w1);
          r[a2] = S::edge(r[a2], push, w2);
          r[a3] = S::edge(r[a3], push, w3);
        }
      }
      for (; t < hi; ++t) {
        const size_t a = (size_t)__ldg(nbrs + t) * d + j;
        r[a] = S::edge(r[a], push, __ldg(ew + t));
      }
    }
    if (counter) {
      pushed[b] = cnt;
      edges[b] = ecnt;
    }
  }
}

extern "C" {

// One launch on `stream`; returns cudaGetLastError() after it.
int push_scatter_launch(int semiring, const void* vid, const void* seg_start,
                        const void* seg_len, const void* nbrs, const void* ew,
                        void* p, void* r, void* pushed, void* edges,
                        int buckets, int cap, int n, int d, void* stream) {
  (void)n;
  if (d < 1 || buckets < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((d + PS_WARP - 1) / PS_WARP), block(PS_WARP);
  cudaStream_t st = (cudaStream_t)stream;
  const int* vi = (const int*)vid;
  const int* ss = (const int*)seg_start;
  const int* sl = (const int*)seg_len;
  const int* nb = (const int*)nbrs;
  const float* w = (const float*)ew;
  float* pp = (float*)p;
  float* rr = (float*)r;
  float* pc = (float*)pushed;
  float* ec = (float*)edges;
  switch (semiring) {
    case SR_PLUS_TIMES:
      push_scatter_kernel<SR_PLUS_TIMES><<<grid, block, 0, st>>>(vi, ss, sl, nb, w, pp, rr, pc, ec, buckets, cap, d);
      break;
    case SR_MIN_PLUS:
      push_scatter_kernel<SR_MIN_PLUS><<<grid, block, 0, st>>>(vi, ss, sl, nb, w, pp, rr, pc, ec, buckets, cap, d);
      break;
    case SR_MAX_MIN:
      push_scatter_kernel<SR_MAX_MIN><<<grid, block, 0, st>>>(vi, ss, sl, nb, w, pp, rr, pc, ec, buckets, cap, d);
      break;
    case SR_MAX_TIMES:
      push_scatter_kernel<SR_MAX_TIMES><<<grid, block, 0, st>>>(vi, ss, sl, nb, w, pp, rr, pc, ec, buckets, cap, d);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
