// Frontier-gated multi-sweep block Gauss–Seidel kernel for Hopper (sm_90a):
// blocks in flight, each waiting only on the blocks it reads.
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
// re-marks the blocks that read it, and later blocks see the mark in the
// same sweep) and a sticky early-out once every column's delta is <= eps.
// The state x is updated in place; it must not alias x0.
//
// Block order is the algorithm: block i reads blocks j < i at this sweep's
// values and blocks j >= i (its own included) at the last sweep's. Nothing
// else orders the blocks, so the kernel keeps many in flight:
//
// * Work. One persistent cooperative launch, one CTA per SM. A sweep is a
//   list of units: each block's tiles, in the fixed order below, cut into
//   parts of at most GS_TMAX tiles (the wrapper lists them, block by block).
//   A CTA claims (sweep, unit) pairs from an atomic ticket in ascending
//   order and runs a unit to its end. All but a block's last part leave a
//   partial sum; the last part folds them in part order, then combines and
//   publishes the block. Splitting keeps a heavy block (up to 918 tiles on
//   the PPR graph) from holding one CTA while the blocks after it wait.
// * Deadlock. A unit waits only on units with smaller tickets: the earlier
//   parts of its block, the last parts of this sweep's blocks j < i, and the
//   previous sweep's end. Those were all claimed earlier by CTAs that are
//   running (a cooperative launch keeps every CTA resident) and that
//   themselves wait only on smaller tickets, so the smallest unfinished
//   unit never waits and the launch cannot deadlock.
// * Publication. A unit publishes its block with a release store of
//   the word pub[i] = (s + 1, updated, changed, buffer of its rows), after
//   its rows, its per-column delta and chg / locs[s & 1][i]. A reader waits
//   (acquire) for pub[j] to reach sweep s before it reads a block j < i.
// * Read-after-write is that wait. Write-after-read: block j of sweep s
//   may finish while an earlier block i < j of the same sweep still has to
//   read j's old rows. The state is ping-ponged between the caller's x and
//   a second buffer: a block writes its new rows into the buffer its old
//   rows are not in, and readers of old rows take locs[(s - 1) & 1][j]. The
//   rows that write overwrites are two versions old, and the wait at each
//   sweep's end guarantees nobody reads them any more. Chosen over "read"
//   signals from the readers because those would make every block wait on
//   every earlier block that reads it, which puts the tiles that read later
//   blocks (45% on the PPR graph) on the critical path; ping-pong leaves
//   only the read-after-write chain (897 of 1,563 blocks there). Blocks whose
//   last rows sit in the second buffer are copied back at the end.
// * Frontier. Block i is dirty in sweep s iff a block it reads changed since
//   its last turn: a source j < i changed in sweep s, or a source j >= i in
//   sweep s - 1 (sweep 0: the caller's bitmap). The second is settled at the
//   start; the first is settled once the in-sweep sources have published,
//   the dependency the block has anyway. A clean block publishes at once,
//   without work. So the frontier is read off the tiles: revptr / revrows
//   must describe the same structure (they do, from pack_algorithm).
// * Tile order. A dirty block reduces its tiles in a fixed order, whatever
//   the timing: first the tiles that read blocks j >= i (old rows, ready
//   at the start), ascending, then the in-sweep sources j < i, ascending.
//   Tiles are sorted by column within a block, so this order is the tile
//   list rotated at the first column >= i: indexed, no tile moves. Each
//   output element is a sequential chain over each part, and the parts'
//   sums are folded in part order: plus_times is bit-for-bit repeatable.
// * Sweep end. The sweep's last unit waits until all nb blocks have
//   published, counts the updated ones, folds the per-block deltas in block
//   order (fixed, so l1 is repeatable), writes deltas and the active count,
//   decides the early-out and releases the next sweep. One wait per sweep.
//
// Tile work: whole tiles and their source blocks are staged into a ring of
// shared-memory slots with cp.async (L2 only: other CTAs write the state),
// a tile or more ahead of the one being reduced, the next tiles prefetched
// into L2; a block's tile columns and source buffers are read once into
// shared memory, so issuing a tile needs no dependent global load. With
// d % 4 == 0 each thread accumulates a 4 x 4 register block (8 vector
// shared loads per 64 FFMA); a small (bs, d) block (d = 1) gives each
// element several threads, each a slice of the k range, folded in slice
// order. Shapes whose block or tile does not fit take a sliced path: 16
// tile columns at a time through shared memory. Accumulation is plain FFMA
// (no TF32); no fast-math: BIG + BIG must overflow to +inf exactly as in
// numpy.
//
// Bound on this card: per full sweep every tile is read once
// (nnz * bs * bs * 4 bytes) and 2 * nnz * bs * bs * d operations are done;
// at d = 64 the operations dominate (3.53 ms for plus_times on the PPR
// graph). The in-sweep chain of blocks, a few microseconds per link, is the
// other floor. PERF.md holds the measured times.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define GS_BLOCK 256   // threads per CTA
#define GS_EPT 16      // output elements per thread per chunk
#define GS_KC 16       // tile columns staged per slice (sliced path)
#define GS_RING_MAX 4  // staged tiles in flight
#define GS_META 1024   // tiles of a block whose column and source buffer are kept in shared memory
#define GS_TMAX 128    // tiles per unit: a block with more is split into parts
#define GS_NE (GS_BLOCK * GS_EPT)  // output elements of a CTA per chunk

enum { SR_PLUS_TIMES = 0, SR_MIN_PLUS = 1, SR_MAX_MIN = 2, SR_MAX_TIMES = 3 };
enum { RK_LINF = 0, RK_L1 = 1, RK_CHANGED = 2 };

template <int SR> struct Semiring;

template <> struct Semiring<SR_PLUS_TIMES> {
  static __device__ __forceinline__ float ident() { return 0.0f; }
  static __device__ __forceinline__ float tile(float acc, float a, float b) { return fmaf(a, b, acc); }
  static __device__ __forceinline__ float reduce(float acc, float v) { return __fadd_rn(acc, v); }
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
  static __device__ __forceinline__ float elem(float nw, float od) { return fabsf(__fsub_rn(nw, od)); }
  static __device__ __forceinline__ float fold(float acc, float v) { return fmaxf(acc, v); }
};
template <> struct Delta<RK_L1> {
  static __device__ __forceinline__ float elem(float nw, float od) { return fabsf(__fsub_rn(nw, od)); }
  static __device__ __forceinline__ float fold(float acc, float v) { return __fadd_rn(acc, v); }
};
template <> struct Delta<RK_CHANGED> {
  static __device__ __forceinline__ float elem(float nw, float od) { return nw != od ? 1.0f : 0.0f; }
  static __device__ __forceinline__ float fold(float acc, float v) { return __fadd_rn(acc, v); }
};

// control words (int32, zeroed by the wrapper)
enum { C_TICKET = 0, C_CLOSED = 1, C_DONE = 2, C_SLAST = 3, C_HEAD = 4 };

// a publication word: the sweep (plus one) and, for its readers in that
// sweep, whether the block was updated, whether it changed, and the buffer
// its rows are in
__host__ __device__ __forceinline__ int pub_word(int s, int dirty, int changed, int loc) {
  return ((s + 1) << 3) | (dirty << 2) | (changed << 1) | loc;
}
__device__ __forceinline__ bool pub_done(int w, int s) { return (w >> 3) > s; }

struct Args {
  const int* rowptr;    // [nb + 1]
  const int* tilecols;  // [nnz]
  const int* dirty_in;  // [nb]
  const float* tiles;   // [nnz, bs, bs]
  const float* c;       // [nb * bs, d]
  const float* x0;      // [nb * bs, d]
  const float* fixed;   // [nb * bs, d]
  float* x;             // [nb * bs, d], in place (buffer 0)
  float* xb;            // [nb * bs, d], scratch (buffer 1)
  float* deltas;        // [sweeps, d]
  float* active;        // [sweeps]
  int* dirty_out;       // [nb]
  int* ctrl;            // [C_HEAD + 5 * nb + units]: words, pub[nb], chg[2][nb],
                        // locs[2][nb], partpub[units]
  float* dblk;          // [nb, d] per-block per-column delta of the current sweep
  float* part;          // [units, bs, d] partial sums of the parts but a block's last
  const int* unit_block;  // [units] block of each unit of a sweep, ascending
  const int* unit_part;   // [units] its part of the block's tiles
  const int* nunits;      // [1] units of a sweep
  int tmax;             // tiles per part (0: one part a block)
  int nb, bs, d, sweeps;
  float eps;
  int ring;             // staged tiles in flight; 0 = sliced path
};

// floats of one staged tile (rows padded by 4 against bank conflicts,
// 16-byte aligned) plus its (bs, d) source block
static __host__ __device__ int staged_tile_floats(int bs, int d) {
  return bs * (bs + 4) + bs * d;
}

// dynamic shared memory besides the tile region: element deltas and a
// reduction buffer
static size_t fixed_smem_bytes() { return (size_t)(GS_NE + GS_BLOCK) * 4; }
// static shared memory: the block's tile metadata and a reduction buffer
static const size_t kStaticSmem = (size_t)(2 * GS_META + GS_BLOCK + 2) * 4;

// tiles the ring holds within `budget` bytes (0: the sliced path)
static int ring_for(int bs, int d, long long budget, bool aligned) {
  if (!aligned || bs % 4 != 0 || bs * d > GS_NE) return 0;
  const long long r = (budget - (long long)fixed_smem_bytes()) / (4LL * staged_tile_floats(bs, d));
  if (r < 2) return 0;
  return r > GS_RING_MAX ? GS_RING_MAX : (int)r;
}

static __host__ __device__ size_t region_floats(int bs, int d, int ring) {
  size_t region = (size_t)bs * GS_KC + (size_t)GS_KC * d;
  const size_t staged = (size_t)ring * staged_tile_floats(bs, d);
  if (staged > region) region = staged;
  return (region + 3) / 4 * 4;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most n of this thread's groups are pending (n < GS_RING_MAX)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void spin_until_at_least(const int* p, int v) {
  while (ld_acquire(p) < v) {
  }
}

// the unit a CTA runs and its block's tile metadata; uniform across threads
struct Unit {
  int s, i, lo, npre, nsuf;
  int ready;  // in-sweep sources [0, ready) of the block known published
};

// the block's tile columns and the buffer of each tile's source rows (once
// known), by offset from lo; a reduction buffer
__shared__ int cols_s[GS_META];
__shared__ int locs_s[GS_META];
__shared__ int red_i[GS_BLOCK];
__shared__ int sh[2];

__device__ __forceinline__ int tile_col(const Args& a, const Unit& u, int off) {
  return off < GS_META ? cols_s[off] : __ldg(a.tilecols + u.lo + off);
}

// Advance u.ready past the in-sweep sources that have published, waiting
// for the first one that has not (if it is < limit). Threads acquire the
// flags they read; whoever saw a source published records its rows'
// buffer. With `chg_any`, returns whether a source passed changed.
__device__ __forceinline__ void advance_ready(const Args& a, Unit& u, int limit, int* chg_any) {
  const int nb = a.nb;
  const int* pub = a.ctrl + C_HEAD;
  int any = 0;
  int first = u.npre;
  for (int base = u.ready; base < u.npre; base += GS_BLOCK) {
    if (threadIdx.x == 0) red_i[0] = u.npre;
    __syncthreads();
    const int q = base + threadIdx.x;
    int w = 0;
    if (q < u.npre) {
      w = ld_acquire(pub + tile_col(a, u, q));
      if (!pub_done(w, u.s)) atomicMin(red_i, q);
    }
    __syncthreads();
    first = red_i[0];
    if (q < first) {
      any |= (w >> 1) & 1;
      if (q < GS_META) locs_s[q] = w & 1;
    }
    __syncthreads();
    if (first < u.npre) break;
  }
  u.ready = first;
  any = chg_any ? __syncthreads_or(any) : 0;
  if (u.ready < u.npre && u.ready < limit && !any) {
    if (threadIdx.x == 0) {
      const int* pw = pub + tile_col(a, u, u.ready);
      int w;
      while (!pub_done(w = ld_acquire(pw), u.s)) {
      }
      if (u.ready < GS_META) locs_s[u.ready] = w & 1;
      red_i[1] = (w >> 1) & 1;
    }
    __syncthreads();
    if (chg_any) any = red_i[1];
    u.ready += 1;
  }
  if (chg_any) *chg_any = any;
}

// wait until in-sweep source q (< npre) has published
__device__ __forceinline__ void ensure_ready(const Args& a, Unit& u, int q) {
  while (u.ready <= q) advance_ready(a, u, q + 1, nullptr);
}

// tile index of position p of the fixed order, and its source rows
__device__ __forceinline__ int tile_off(const Unit& u, int p) {
  return p < u.nsuf ? u.npre + p : p - u.nsuf;
}
__device__ __forceinline__ const float* source_rows(const Args& a, const Unit& u, int p, int off,
                                                    int col) {
  int loc;
  if (off < GS_META) {
    loc = locs_s[off];
  } else {
    const int sw = p < u.nsuf ? u.s - 1 : u.s;  // old rows, or this sweep's
    loc = __ldcg(a.ctrl + C_HEAD + 3 * a.nb + (sw & 1) * a.nb + col);
  }
  return (loc ? a.xb : a.x) + (size_t)col * a.bs * a.d;
}

template <int SR, int RK>
__global__ void __launch_bounds__(GS_BLOCK)
gs_multisweep_kernel(Args a) {
  using S = Semiring<SR>;
  using D = Delta<RK>;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int bs = a.bs, d = a.d, nb = a.nb;
  const int region = (int)region_floats(bs, d, a.ring);
  float* tile_s = smem;                         // sliced: [bs, GS_KC]
  float* xs_s = tile_s + bs * GS_KC;            // sliced: [GS_KC, d]
  float* dsm = smem + region;                   // [GS_NE] element deltas
  float* red = dsm + GS_NE;                     // [GS_BLOCK]

  int* ctrl = a.ctrl;
  int* pub = ctrl + C_HEAD;
  int* chg = pub + nb;       // [2][nb]
  int* locs = chg + 2 * nb;  // [2][nb]
  const int tid = threadIdx.x;
  const int ne = bs * d;
  const int U = *a.nunits;
  const long long total = (long long)a.sweeps * U;
  int* partpub = ctrl + C_HEAD + 5 * nb;
  const int per_tile = staged_tile_floats(bs, d);
  const int TS = bs + 4;
  const bool micro = a.ring > 0 && d % 4 == 0;
  const int d4 = d / 4;
  const bool mact = micro && tid < (bs / 4) * d4;
  const int rt = mact ? tid / d4 : 0, ct = mact ? tid % d4 : 0;
  // small blocks (non-micro, ne <= GS_BLOCK / 2): one element a thread and
  // one of nks slices of the k range, folded in slice order at the end
  const int nks = (!micro && a.ring > 0 && 2 * ne <= GS_BLOCK) ? GS_BLOCK / ne : 1;

  for (;;) {
    // ---- claim the next unit; wait for the previous sweep's end ----------
    if (tid == 0) {
      const int t = atomicAdd(ctrl + C_TICKET, 1);
      sh[0] = t;
      if (t < total) {
        spin_until_at_least(ctrl + C_CLOSED, t / U);
        sh[1] = ld_acquire(ctrl + C_DONE);
      }
    }
    __syncthreads();
    const int t = sh[0];
    if (t >= total || sh[1]) break;
    Unit u;
    u.s = t / U;
    const int k = t - u.s * U;
    u.i = a.unit_block[k];
    const int prt = a.unit_part[k];
    u.lo = a.rowptr[u.i];
    const int hi = a.rowptr[u.i + 1];
    const int nt = hi - u.lo;
    u.ready = 0;
    // this unit's part of the fixed tile order: positions [pos0, pos1)
    const int parts = a.tmax > 0 && nt > a.tmax ? (nt + a.tmax - 1) / a.tmax : 1;
    const bool last = prt == parts - 1;
    const int pos0 = a.tmax > 0 ? prt * a.tmax : 0;
    const int pos1 = last ? nt : pos0 + a.tmax;
    const int sp = u.s & 1, sq = (u.s - 1) & 1;

    // ---- the tiles' columns, the split, the marks from blocks j >= i ------
    int npre = 0, marked = 0;
    for (int base = 0; base < nt; base += GS_BLOCK) {
      const int off = base + tid;
      const int col = off < nt ? __ldg(a.tilecols + u.lo + off) : -1;
      const bool old_src = col >= u.i;
      if (off < GS_META && col >= 0) {
        cols_s[off] = col;
        if (old_src) locs_s[off] = __ldcg(locs + sq * nb + col);  // s = 0: zeroed, x
      }
      npre += __syncthreads_count(col >= 0 && !old_src);
      marked |= __syncthreads_or(u.s > 0 && old_src && __ldcg(chg + sq * nb + col) != 0);
    }
    u.npre = npre;
    u.nsuf = nt - npre;
    int dirty = u.s == 0 ? a.dirty_in[u.i] != 0 : marked;
    while (!dirty && u.ready < u.npre) {  // settled by the in-sweep sources
      int any = 0;
      advance_ready(a, u, u.npre, &any);
      dirty = any;
    }

    if (pos0 - u.nsuf > u.ready) u.ready = pos0 - u.nsuf;  // sources of earlier parts: not ours

    const int oldloc = __ldcg(locs + sq * nb + u.i);
    int changed = 0;
    if (dirty) {
      // the combine's operands, into L2 while the tiles run
      for (int e = tid * 32; last && e < ne; e += GS_BLOCK * 32) {
        const size_t off = (size_t)u.i * ne + e;
        asm volatile("prefetch.global.L2 [%0];" ::"l"(a.c + off));
        asm volatile("prefetch.global.L2 [%0];" ::"l"(a.x0 + off));
        asm volatile("prefetch.global.L2 [%0];" ::"l"(a.fixed + off));
        asm volatile("prefetch.global.L2 [%0];" ::"l"((oldloc ? a.xb : a.x) + off));
      }
      for (int base = 0; base < ne; base += GS_NE) {
        const int own = micro ? (mact ? GS_EPT : 0)
                      : nks > 1 ? (tid < ne ? 1 : 0)
                      : min(GS_EPT, (ne - base - tid + GS_BLOCK - 1) / GS_BLOCK);
        float acc[GS_EPT];
#pragma unroll
        for (int m = 0; m < GS_EPT; ++m) acc[m] = S::ident();
        if (a.ring > 0) {
          // ---- staged ring: tile p in slot p % ring -----------------------
          int issued = pos0;
          for (int p = pos0; p < pos1; ++p) {
            while (issued < pos1 &&
                   (issued <= p ||
                    (issued < p + a.ring && (issued < u.nsuf || issued - u.nsuf < u.ready)))) {
              if (issued >= u.nsuf) ensure_ready(a, u, issued - u.nsuf);
              const int off = tile_off(u, issued);
              const int col = tile_col(a, u, off);
              float* ts = smem + (issued % a.ring) * per_tile;
              float* xd = ts + bs * TS;
              const float* T = a.tiles + (size_t)(u.lo + off) * bs * bs;
              const float* X = source_rows(a, u, issued, off, col);
              for (int c = tid; c < bs * bs / 4; c += GS_BLOCK) {
                const int r = (4 * c) / bs;
                cp_async16(ts + r * TS + (4 * c - r * bs), T + 4 * c);
              }
              for (int c = tid; c < ne / 4; c += GS_BLOCK) cp_async16(xd + 4 * c, X + 4 * c);
              cp_async_commit();
              if (issued + a.ring < pos1) {  // a tile further on, into L2
                const float* T2 = a.tiles + (size_t)(u.lo + tile_off(u, issued + a.ring)) * bs * bs;
                for (int l = tid * 32; l < bs * bs; l += GS_BLOCK * 32)
                  asm volatile("prefetch.global.L2 [%0];" ::"l"(T2 + l));
              }
              ++issued;
            }
            cp_async_wait(issued - p - 1);
            __syncthreads();
            const float* ts = smem + (p % a.ring) * per_tile;
            const float* xd = ts + bs * TS;
            if (micro) {
              if (mact)
#pragma unroll 4
                for (int k = 0; k < bs; k += 4) {
                  float4 av[4];
#pragma unroll
                  for (int ii = 0; ii < 4; ++ii)
                    av[ii] = *reinterpret_cast<const float4*>(ts + (4 * rt + ii) * TS + k);
#pragma unroll
                  for (int kk = 0; kk < 4; ++kk) {
                    const float4 b = *reinterpret_cast<const float4*>(xd + (k + kk) * d + 4 * ct);
#pragma unroll
                    for (int ii = 0; ii < 4; ++ii) {
                      const float av_k = kk == 0 ? av[ii].x : kk == 1 ? av[ii].y : kk == 2 ? av[ii].z : av[ii].w;
                      acc[4 * ii + 0] = S::tile(acc[4 * ii + 0], av_k, b.x);
                      acc[4 * ii + 1] = S::tile(acc[4 * ii + 1], av_k, b.y);
                      acc[4 * ii + 2] = S::tile(acc[4 * ii + 2], av_k, b.z);
                      acc[4 * ii + 3] = S::tile(acc[4 * ii + 3], av_k, b.w);
                    }
                  }
                }
            } else if (nks > 1) {
              if (tid < ne * nks) {
                const int e = tid % ne, ks = tid / ne;
                const float* tr = ts + (e / d) * TS;
                const float* xc = xd + e % d;
                for (int k = (ks * bs) / nks; k < ((ks + 1) * bs) / nks; ++k)
                  acc[0] = S::tile(acc[0], tr[k], xc[k * d]);
              }
            } else {
              for (int k = 0; k < bs; ++k) {
#pragma unroll
                for (int m = 0; m < GS_EPT; ++m)
                  if (m < own) {
                    const int e = tid + m * GS_BLOCK;
                    acc[m] = S::tile(acc[m], ts[(e / d) * TS + k], xd[k * d + e % d]);
                  }
              }
            }
            __syncthreads();  // slot p % ring is free
          }
          if (nks > 1) {  // fold the k slices of each element, in slice order
            if (tid < ne * nks) red[tid] = acc[0];
            __syncthreads();
            if (tid < ne) {
              float v = red[tid];
              for (int q = 1; q < nks; ++q) v = S::reduce(v, red[q * ne + tid]);
              acc[0] = v;
            }
            __syncthreads();
          }
          // ---- parts: all but the last leave a partial sum; the last folds
          // them in part order and goes on to the combine
          float* mypart = a.part + (size_t)k * ne;
          if (!last) {
#pragma unroll
            for (int m = 0; m < GS_EPT; ++m) {
              if (m >= own) break;
              const int e = micro ? (4 * rt + m / 4) * d + 4 * ct + m % 4
                                  : nks > 1 ? tid : tid + m * GS_BLOCK;
              __stcg(mypart + e, acc[m]);
            }
          } else if (prt > 0) {
            if (tid == 0)
              for (int q = k - prt; q < k; ++q) spin_until_at_least(partpub + q, u.s + 1);
            __syncthreads();
#pragma unroll
            for (int m = 0; m < GS_EPT; ++m) {
              if (m >= own) break;
              const int e = micro ? (4 * rt + m / 4) * d + 4 * ct + m % 4
                                  : nks > 1 ? tid : tid + m * GS_BLOCK;
              float v = __ldcg(a.part + (size_t)(k - prt) * ne + e);
              for (int q = k - prt + 1; q < k; ++q) v = S::reduce(v, __ldcg(a.part + (size_t)q * ne + e));
              acc[m] = S::reduce(v, acc[m]);
            }
          }
        } else {
          // ---- sliced: GS_KC tile columns and source rows at a time -------
          for (int p = 0; p < nt; ++p) {
            if (p >= u.nsuf) ensure_ready(a, u, p - u.nsuf);
            const int off = tile_off(u, p);
            const int col = tile_col(a, u, off);
            const float* T = a.tiles + (size_t)(u.lo + off) * bs * bs;
            const float* X = source_rows(a, u, p, off, col);
            for (int k0s = 0; k0s < bs; k0s += GS_KC) {
              const int kc = bs - k0s < GS_KC ? bs - k0s : GS_KC;
              __syncthreads();  // previous slice consumed
              for (int idx = tid; idx < bs * kc; idx += GS_BLOCK) {
                const int r = idx / kc, kk = idx - r * kc;
                tile_s[r * GS_KC + kk] = __ldg(T + (size_t)r * bs + k0s + kk);
              }
              for (int idx = tid; idx < kc * d; idx += GS_BLOCK)
                xs_s[idx] = __ldcg(X + (size_t)k0s * d + idx);
              __syncthreads();
              for (int kk = 0; kk < kc; ++kk) {
#pragma unroll
                for (int m = 0; m < GS_EPT; ++m)
                  if (m < own) {
                    const int e = base + tid + m * GS_BLOCK;
                    acc[m] = S::tile(acc[m], tile_s[(e / d) * GS_KC + kk], xs_s[kk * d + e % d]);
                  }
              }
            }
          }
        }

        if (!last) break;  // a partial is all this unit leaves
        const float* xold = (oldloc ? a.xb : a.x) + (size_t)u.i * ne;
        float* xnew = (oldloc ? a.x : a.xb) + (size_t)u.i * ne;
        const float* cb = a.c + (size_t)u.i * ne;
        const float* x0b = a.x0 + (size_t)u.i * ne;
        const float* fb = a.fixed + (size_t)u.i * ne;
        // ---- combine this chunk's elements; element deltas to dsm ---------
        if (micro) {
          if (mact) {  // four rows of four columns; each column's four
                       // element deltas folded in row order into dsm
            float4 o[4], cv[4], fv[4], zv[4];  // every load before any store
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              const int e = (4 * rt + ii) * d + 4 * ct;
              o[ii] = __ldcg(reinterpret_cast<const float4*>(xold + e));
              cv[ii] = __ldg(reinterpret_cast<const float4*>(cb + e));
              fv[ii] = __ldg(reinterpret_cast<const float4*>(fb + e));
              zv[ii] = __ldg(reinterpret_cast<const float4*>(x0b + e));
            }
            float pv[4];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              const int e = (4 * rt + ii) * d + 4 * ct;
              const float ov[4] = {o[ii].x, o[ii].y, o[ii].z, o[ii].w};
              const float cc[4] = {cv[ii].x, cv[ii].y, cv[ii].z, cv[ii].w};
              const float ff[4] = {fv[ii].x, fv[ii].y, fv[ii].z, fv[ii].w};
              const float zz[4] = {zv[ii].x, zv[ii].y, zv[ii].z, zv[ii].w};
              float nw[4];
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                nw[jj] = S::combine(cc[jj], acc[4 * ii + jj], ov[jj]);
                if (ff[jj] != 0.0f) nw[jj] = zz[jj];
                const float el = D::elem(nw[jj], ov[jj]);
                pv[jj] = ii == 0 ? el : D::fold(pv[jj], el);
                changed |= (nw[jj] != ov[jj]);
              }
              __stcg(reinterpret_cast<float4*>(xnew + e), make_float4(nw[0], nw[1], nw[2], nw[3]));
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) dsm[rt * d + 4 * ct + jj] = pv[jj];
          }
        } else {
#pragma unroll
          for (int m = 0; m < GS_EPT; ++m) {
            if (m >= own) break;
            const int e = nks > 1 ? tid : base + tid + m * GS_BLOCK;
            const float old = __ldcg(xold + e);
            float nw = S::combine(__ldg(cb + e), acc[m], old);
            if (__ldg(fb + e) != 0.0f) nw = __ldg(x0b + e);
            __stcg(xnew + e, nw);
            dsm[e - base] = D::elem(nw, old);
            changed |= (nw != old);
          }
        }
        __syncthreads();
        // fold each column over this chunk's rows, in row order: P threads
        // per column take contiguous row ranges, then thread 0 of the
        // column folds the P partials in order onto the running value
        // (micro: dsm holds one row per group of four rows)
        const int nchunk = micro ? ne / 4 : (ne - base < GS_NE ? ne - base : GS_NE);
        const int JW = d < GS_BLOCK ? d : GS_BLOCK;
        const int P = GS_BLOCK / JW;
        for (int jb = 0; jb < d; jb += JW) {
          const int jl = tid % JW, pg = tid / JW, j = jb + jl;
          const bool act = pg < P && j < d;
          // elements of column j in this chunk: e = e0 + r * d
          const int e0 = ((j - base) % d + d) % d;
          const int nr = e0 < nchunk ? (nchunk - 1 - e0) / d + 1 : 0;
          const int r0 = (pg * nr) / P, r1 = ((pg + 1) * nr) / P;
          float v = 0.0f;
          if (act)
            for (int r = r0; r < r1; ++r) v = D::fold(v, dsm[e0 + r * d]);
          red[tid] = v;
          __syncthreads();
          if (act && pg == 0) {
            float w = base == 0 ? 0.0f : __ldcg(a.dblk + (size_t)u.i * d + j);
            for (int q = 0; q < P; ++q) w = D::fold(w, red[q * JW + jl]);
            __stcg(a.dblk + (size_t)u.i * d + j, w);
          }
          __syncthreads();
        }
      }
    } else {
      for (int j = tid; last && j < d; j += GS_BLOCK) __stcg(a.dblk + (size_t)u.i * d + j, 0.0f);
    }

    // ---- publish ---------------------------------------------------------
    changed = __syncthreads_or(changed);
    if (!last) {
      if (tid == 0) st_release(partpub + k, u.s + 1);
      continue;
    }
    if (tid == 0) {
      const int newloc = dirty ? 1 - oldloc : oldloc;
      __stcg(chg + sp * nb + u.i, changed);
      __stcg(locs + sp * nb + u.i, newloc);
      st_release(pub + u.i, pub_word(u.s, dirty, changed, newloc));
    }

    // ---- sweep end (the unit of the last block) ---------------------------
    if (u.i == nb - 1) {
      int updated = 0;
      for (int b = tid; b < nb; b += GS_BLOCK) {
        int w;
        while (!pub_done(w = ld_acquire(pub + b), u.s)) {
        }
        updated += (w >> 2) & 1;
      }
      if (tid == 0) red_i[0] = 0;
      __syncthreads();
      atomicAdd(red_i, updated);
      __syncthreads();
      updated = red_i[0];
      const int JW = d < GS_BLOCK ? d : GS_BLOCK;
      const int P = GS_BLOCK / JW;
      int below = 1;
      for (int jb = 0; jb < d; jb += JW) {
        const int jl = tid % JW, pg = tid / JW, j = jb + jl;
        const bool act = pg < P && j < d;
        const int b0 = (pg * nb) / P, b1 = ((pg + 1) * nb) / P;
        float v = 0.0f;
        if (act)
#pragma unroll 8
          for (int b = b0; b < b1; ++b) v = D::fold(v, __ldcg(a.dblk + (size_t)b * d + j));
        red[tid] = v;
        __syncthreads();
        if (act && pg == 0) {
          float w = 0.0f;
          for (int q = 0; q < P; ++q) w = D::fold(w, red[q * JW + jl]);
          a.deltas[(size_t)u.s * d + j] = w;
          below &= (w <= a.eps);
        }
        __syncthreads();
      }
      below = __syncthreads_and(below);
      if (below)
        for (size_t k = (size_t)(u.s + 1) * d + tid; k < (size_t)a.sweeps * d; k += GS_BLOCK)
          a.deltas[k] = 0.0f;
      if (tid == 0) {
        a.active[u.s] = (float)updated;
        if (below)
          for (int s2 = u.s + 1; s2 < a.sweeps; ++s2) a.active[s2] = 0.0f;
        if (below || u.s == a.sweeps - 1) ctrl[C_SLAST] = u.s;
        if (below) ctrl[C_DONE] = 1;
        __threadfence();
        st_release(ctrl + C_CLOSED, below ? a.sweeps : u.s + 1);
      }
    }
  }

  // ---- the end: rows back into x, the frontier left over ------------------
  grid.sync();
  const int sl = __ldcg(ctrl + C_SLAST) & 1;
  for (int i = blockIdx.x; i < nb; i += gridDim.x) {
    if (__ldcg(locs + sl * nb + i)) {
      const float* src = a.xb + (size_t)i * ne;
      float* dst = a.x + (size_t)i * ne;
      for (int e = tid; e < ne; e += GS_BLOCK) __stcg(dst + e, __ldcg(src + e));
    }
    const int lo = a.rowptr[i], hi = a.rowptr[i + 1];
    int mark = 0;
    for (int t = lo + tid; t < hi; t += GS_BLOCK) {
      const int col = __ldg(a.tilecols + t);
      mark |= col >= i && __ldcg(chg + sl * nb + col) != 0;
    }
    mark = __syncthreads_or(mark);
    if (tid == 0) a.dirty_out[i] = mark;
  }
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

static int prepare(KernelFn fn, int bs, int d, bool aligned, int* grid, size_t* smem, int* ring) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0, smem_max = 0, smem_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))) return err;
  if ((err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev))) return err;
  if (!coop) return cudaErrorNotSupported;
  long long budget = (smem_sm - 1024 < smem_max ? smem_sm - 1024 : smem_max) - (long long)kStaticSmem;
  *ring = ring_for(bs, d, budget, aligned);
  *smem = region_floats(bs, d, *ring) * sizeof(float) + fixed_smem_bytes();
  if (*smem + kStaticSmem > (size_t)smem_max) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)*smem)))
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)fn, GS_BLOCK, *smem)))
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = sms;  // one CTA per SM, all resident
  return cudaSuccess;
}

// float32 scratch: per-block deltas, the second state buffer at a 256-byte
// boundary, then the parts' partial sums
static long long dblk_floats(int nb, int d) { return ((long long)nb * d + 63) / 64 * 64; }
// units of a sweep at most: one a block, one more per GS_TMAX tiles
static long long max_units(int nb, long long nnz, int tmax) { return nb + (tmax ? nnz / tmax : 0); }

extern "C" {

// For a launch on operands that are 16-byte aligned (`aligned`) or not:
// the grid, the int32 control words (to be zeroed), the float32 scratch,
// and the tiles per unit (0: no block is split). The caller lists the units
// of a sweep for that tmax: block by block, ceil(tiles / tmax) parts each.
int gs_multisweep_plan(int semiring, int res_kind, int bs, int d, int nb, long long nnz,
                       int aligned, int* grid, long long* ctrl_ints,
                       long long* scratch_floats, int* tmax) {
  KernelFn fn = pick(semiring, res_kind);
  if (!fn) return cudaErrorInvalidValue;
  size_t smem = 0;
  int ring = 0;
  int err = prepare(fn, bs, d, aligned != 0, grid, &smem, &ring);
  if (err) return err;
  *tmax = ring > 0 ? GS_TMAX : 0;
  const long long units = max_units(nb, nnz, *tmax);
  *ctrl_ints = C_HEAD + 5LL * nb + units;
  *scratch_floats = dblk_floats(nb, d) + (long long)nb * bs * d + (*tmax ? units * bs * d : 0);
  return cudaSuccess;
}

// One cooperative launch on `stream`; returns cudaGetLastError() after it.
int gs_multisweep_launch(int semiring, int res_kind,
                         const void* rowptr, const void* tilecols,
                         const void* dirty_in, const void* tiles,
                         const void* c, const void* x0, const void* fixed,
                         void* x, void* deltas, void* active, void* dirty_out,
                         void* ctrl, void* scratch, const void* unit_block,
                         const void* unit_part, const void* nunits, int nb, int bs, int d,
                         int sweeps, float eps, int tmax, int grid, void* stream) {
  KernelFn fn = pick(semiring, res_kind);
  if (!fn) return cudaErrorInvalidValue;
  int planned = 0, ring = 0;
  size_t smem = 0;
  float* xb = (float*)scratch + dblk_floats(nb, d);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)tiles % 16 == 0) &&
                       ((uintptr_t)c % 16 == 0) && ((uintptr_t)x0 % 16 == 0) &&
                       ((uintptr_t)fixed % 16 == 0);
  int err = prepare(fn, bs, d, aligned, &planned, &smem, &ring);
  if (err) return err;
  if (grid != planned || tmax != (ring > 0 ? GS_TMAX : 0)) return cudaErrorInvalidValue;
  Args a;
  a.rowptr = (const int*)rowptr;
  a.tilecols = (const int*)tilecols;
  a.dirty_in = (const int*)dirty_in;
  a.tiles = (const float*)tiles;
  a.c = (const float*)c;
  a.x0 = (const float*)x0;
  a.fixed = (const float*)fixed;
  a.x = (float*)x;
  a.xb = xb;
  a.deltas = (float*)deltas;
  a.active = (float*)active;
  a.dirty_out = (int*)dirty_out;
  a.ctrl = (int*)ctrl;
  a.dblk = (float*)scratch;
  a.part = xb + (size_t)nb * bs * d;
  a.unit_block = (const int*)unit_block;
  a.unit_part = (const int*)unit_part;
  a.nunits = (const int*)nunits;
  a.tmax = tmax;
  a.nb = nb;
  a.bs = bs;
  a.d = d;
  a.sweeps = sweeps;
  a.eps = eps;
  a.ring = ring;
  void* params[] = {&a};
  cudaLaunchCooperativeKernel((const void*)fn, dim3(grid), dim3(GS_BLOCK), params, smem,
                              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
