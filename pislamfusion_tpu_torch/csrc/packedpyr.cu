// K7: the packed serial ORB pyramid, the whole buffer in one launch.
//
// Replaces pislamfusion_tpu/ops/features/pyramid_pallas.py
// build_packed_pyramid (pallas_call at :279).
//
// Level l's block of the packed [total_rows, wpl] f32 buffer, rows
// [base, base + blk_rows): for t < lh + 2r and u < lw + 2r
//   t1[t, c] = fma(row_w[t,1], src[row_start[t]+1, c],
//                  fma(row_w[t,0], src[row_start[t], c], 0))
//   out[t, u] = fma(col_w[u,1], t1[t, col_start[u]+1],
//                   fma(col_w[u,0], t1[t, col_start[u]], 0))
// over each pad-clamp matrix row's nonzero span (host tables; a one-tap
// span takes its one tap), src being level l-1's raw pixels (the image for
// l = 1, else level l-1's block interior in the same buffer); 0 elsewhere
// in the block. Level 0's block is the image edge-padded by r, and the
// rows after the last block are 0. Each sum is a chain of fused
// multiply-adds over the taps in order from 0 (__fmaf_rn, rounded once
// each), as the reference's dense products contract; the plain PyTorch
// version computes each step exactly in float64, so the two are equal.
//
// Bound on the H100: bytes. 1080p / 8 levels / r = 21 reads an 8.3 MB
// image and writes a 48.2 MB buffer, 42 % of it the zeros around the
// blocks; each output takes at most 2x2 taps. Level l reads level l-1, so
// the work is a chain of seven levels; one launch runs all of it:
// - A persistent grid (resident blocks an SM x SMs) claims host-planned
//   items (ops/features/packedpyr.py kernel_plan, five int4 each) in the
//   plan's order with one atomic ticket counter: a level tile (a band of
//   output rows by a run of columns), a band of level 0's edge pad, or a
//   rectangle of zeros (16-byte stores). A block claims its next ticket
//   as it publishes its last tile, and loads that item's record while its
//   fence waits.
// - A tile of depth 1 reads level l-1's raw pixels. One of depth 2 (the
//   deepest levels) computes the window of level l-1 it reads in shared
//   memory from level l-2's pixels, with the same arithmetic (so the same
//   bits) as level l-1's own tiles: the chain from level 1 to the last
//   level takes fewer dependent steps.
// - A tile waits until the tiles whose pixels it reads are done (a counter
//   a tile) and no longer, so a level starts on its first tiles while the
//   one before still writes its last. The plan puts every item after
//   everything it waits on, so a waiting block waits on tickets that
//   running blocks hold: no deadlock, whatever the grid's size. Pad and
//   zero items wait on nothing and fill the chain's gaps.
// - A tile stages its source window and the span tables of its rows and
//   columns (cp.async.cg, 16 bytes where the rows align: through L2, which
//   is coherent with the other blocks' stores), computes each t1[t, c]
//   once into shared memory, then the column chains from there (a lane a
//   column, conflict-free).
// - Producer: every thread's stores, a barrier, then one thread's
//   __threadfence and atomicAdd on its counter (tiles of levels that no
//   tile reads skip both). Consumer: relaxed polls of the counters, a
//   __threadfence, then a barrier.
// - The counters (ticket, blocks done, tiles) are one device buffer a
//   shape; the last block to finish sets them back to 0, so the next call
//   (or a CUDA graph's next replay) starts from 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS = 6;     // resident blocks an SM (registers allow)
constexpr int RS = 5;         // int4 a record
constexpr int MAXL = 16;
constexpr int KIND_ZERO = 0, KIND_PAD = 1, KIND_TILE = 2;
constexpr int C_TICKET = 0, C_DONE = 1;   // then one counter a tile

struct Level {      // level l >= 1
  int base;         // first packed row of its block
  int lh2, lw2;     // its live rows and columns, lh + 2r and lw + 2r
  int rt, ct;       // its first row in rtab, first column in ctab
  int src_row;      // packed row of level l-1's raw row 0 (l >= 2)
  int src_col;      // column of level l-1's raw column 0 (l >= 2)
  int unused;
};

struct Params {
  Level lv[MAXL];
  const float* img;
  float* out;
  int h, w, wpl, r;
  int vec1;         // the image's rows align to 16 bytes (level 1's source)
  int tr;           // output rows of a depth-1 tile
  int pitch;        // floats a row of its t1 and staged window
  int pitch_f;      // floats a row of a depth-2 tile's buffers
  int rows_a;       // rows of its first buffer
  int tab_off;      // float offset of the staged span tables
  int tab_rows;     // their row entries (the column entries follow)
  int lgcg, lgcg_f, lgcg_v;   // log2 of 128-column groups: depth 1, depth
                              // 2, depth 2's step in between
  int n_items, n_ctr;
  // rtab / ctab: a row's / column's span (start, length, w0 and w1 bits);
  // records: per item RS int4 (see kernel_plan)
  const int4* rtab;
  const int4* ctab;
  const int4* records;
  unsigned* ctr;
};

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + n) x columns [col0, col0 + 4 * n4) of zeros
__device__ void zero_rect(const Params& p, int row0, int n, int col0,
                          int n4) {
  const int lane = threadIdx.x & 31;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int rr = threadIdx.x >> 5; rr < n; rr += WARPS) {
    float4* d = reinterpret_cast<float4*>(
        p.out + (long long)(row0 + rr) * p.wpl + col0);
    for (int q = lane; q < n4; q += 32) d[q] = z;
  }
}

// level 0's rows [row0, row0 + n): the image edge-padded by r over columns
// [0, 4 * n4), 0 past w + 2r; a lane's 16 reads of a batch in flight
__device__ void pad_rect(const Params& p, int row0, int n, int n4) {
  const int lane = threadIdx.x & 31;
  const int w2 = p.w + 2 * p.r;
  for (int rr = threadIdx.x >> 5; rr < n; rr += WARPS) {
    const int y = min(max(row0 + rr - p.r, 0), p.h - 1);
    const float* s = p.img + (long long)y * p.w;
    float4* d = reinterpret_cast<float4*>(p.out + (long long)(row0 + rr) *
                                                      p.wpl);
    for (int q0 = lane; q0 < n4; q0 += 128) {
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int u = 4 * (q0 + 32 * (k >> 2)) + (k & 3);
        v[k] = u < w2 ? __ldg(s + min(max(u - p.r, 0), p.w - 1)) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q0 + 32 * j < n4)
          d[q0 + 32 * j] =
              make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  }
}

// warp 0 (lane 0's ticket t): the ticket and, where it is an item, its
// record into shared memory, for the block's next item
__device__ __forceinline__ void next_item(const Params& p, unsigned t,
                                          unsigned* s_tk, int4* s_rec) {
  const int lane = threadIdx.x & 31;
  t = __shfl_sync(0xffffffffu, t, 0);
  if (lane == 0) *s_tk = t;
  if (lane < RS && t < (unsigned)p.n_items)
    s_rec[lane] = __ldg(p.records + RS * t + lane);
}

// Stage the raw pixels [sr0, sr0 + sr) x [sc0, sc0 + sc) that level lvl
// reads (level lvl-1's: the image for lvl = 1, else the buffer) into S
// (rows of `pitch` floats), from a 16-byte boundary where the rows align:
// starts the copies and returns how many floats before sc0 they begin.
__device__ int stage_window(const Params& p, int lvl, int sr0, int sr,
                            int sc0, int sc, float* S, int pitch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Level& L = p.lv[lvl];
  const bool first = lvl == 1;
  const float* src = first ? p.img : p.out;
  const int ld = first ? p.w : p.wpl;
  const long long row0 = (first ? 0 : L.src_row) + sr0;
  const int col = (first ? 0 : L.src_col) + sc0;
  const int lead = !first || p.vec1 ? (col & 3) : -1;
  if (lead >= 0) {
    const int n4 = (lead + sc + 3) >> 2;
    for (int rr = warp; rr < sr; rr += WARPS) {
      const float* g = src + (row0 + rr) * ld + (col - lead);
      for (int q = lane; q < n4; q += 32)
        cp_async16(S + rr * pitch + 4 * q, g + 4 * q);
    }
    return lead;
  }
  for (int rr = warp; rr < sr; rr += WARPS) {
    const float* g = src + (row0 + rr) * ld + col;
    for (int q = lane; q < sc; q += 32) cp_async4(S + rr * pitch + q, g + q);
  }
  return 0;
}

// Row pass of nr rows with spans `rows` (shared): T[t][c] for c < sc from
// the source rows in S (S's row 0 is raw row sr0, its column 0 raw column
// sc0), each value once.
__device__ void row_pass(const int4* rows, int nr, int sr0,
                         const float* __restrict__ S, int sp, int sc,
                         float* __restrict__ T, int tp) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < nr; t += WARPS) {
    const int4 rw = rows[t];
    const float* __restrict__ s0 = S + (rw.x - sr0) * sp;
    const float* __restrict__ s1 = s0 + (rw.y > 1 ? sp : 0);
    const float w0 = __int_as_float(rw.z), w1 = __int_as_float(rw.w);
    float* __restrict__ o = T + t * tp;
#pragma unroll 4
    for (int q = lane; q < sc; q += 32)
      o[q] = __fmaf_rn(w1, s1[q], __fmaf_rn(w0, s0[q], 0.f));
  }
}

// Column pass of nu columns, the first `live` with spans `cols` (shared),
// the rest 0, for nr rows of T (its column 0 is raw column sc0) into D
// (rows of dp floats, global or shared): a warp one 128-column group, a
// lane columns lane + 32i of it, rows strided by the warps of a group.
__device__ void col_pass(const int4* cols, int live_n, int nu, int sc0,
                         int nr, const float* __restrict__ T, int tp,
                         float* __restrict__ D, long long dp, int lgcg) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cg = warp & ((1 << lgcg) - 1);
  int off0[4], off1[4];
  float cw0[4], cw1[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = 128 * cg + lane + 32 * i;
    live[i] = u < nu;
    off0[i] = off1[i] = 0;
    cw0[i] = cw1[i] = 0.f;        // columns past lw + 2r come out 0
    if (u < live_n) {
      const int4 cr = cols[u];
      off0[i] = cr.x - sc0;
      off1[i] = off0[i] + (cr.y > 1 ? 1 : 0);
      cw0[i] = __int_as_float(cr.z);
      cw1[i] = __int_as_float(cr.w);
    }
  }
  float* __restrict__ db = D + 128 * cg + lane;
#pragma unroll 2
  for (int t = warp >> lgcg; t < nr; t += WARPS >> lgcg) {
    const float* __restrict__ s = T + t * tp;
    float* __restrict__ o = db + t * dp;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (live[i])
        o[32 * i] = __fmaf_rn(cw1[i], s[off1[i]],
                              __fmaf_rn(cw0[i], s[off0[i]], 0.f));
  }
}

// a level tile: output rows [t0, t0 + nr) x columns [u0, u0 + nu) of level
// a.y's block from level l-1's raw pixels (depth 1) or, computed on the
// way in shared memory, from level l-2's (depth 2); its last step claims
// the block's next ticket, beside the fence before the tile's count
__device__ void level_tile(const Params& p, const int4* rec, float* smem,
                           unsigned* s_tk, int4* s_rec) {
  const int tid = threadIdx.x;
  const int4 a = rec[0], b = rec[1], c = rec[2], d = rec[3];
  const int lvl = a.y, t0 = a.z, nr = a.w;
  const int u0 = b.x, nu = b.y, sc0 = b.z, sc = b.w;
  const int sr0 = c.x, sr = c.y, own = c.z;
  const Level& L = p.lv[lvl];
  // wait for the tiles whose pixels this tile reads: d.y bands of d.z runs
  // from counter d.x, d.w counters a band, each until its tile is done
  // (relaxed polls, then one fence; seconds of waiting mean a broken plan
  // or stale counters: trap rather than hang)
  if (tid < d.y * d.z) {
    const int bb = tid / d.z;
    const volatile unsigned* f = p.ctr + d.x + bb * d.w + (tid - bb * d.z);
    unsigned spins = 0;
    while (*f == 0u) {
      __nanosleep(100);
      if (++spins == (1u << 26)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
  float* out = p.out + (long long)(L.base + t0) * p.wpl + u0;
  // the span tables of the tile's rows and live columns (and, at depth 2,
  // of the level-(l-1) window's), staged beside the source window
  int4* RT = reinterpret_cast<int4*>(smem + p.tab_off);
  int4* CT = RT + p.tab_rows;
  const int ncl = min(nu, L.lw2 - u0);
  for (int i = tid; i < nr; i += THREADS)
    cp_async16(RT + i, p.rtab + L.rt + t0 + i);
  for (int i = tid; i < ncl; i += THREADS)
    cp_async16(CT + i, p.ctab + L.ct + u0 + i);
  if (c.w == 1) {
    // t1 [tr][pitch], then the staged window [stage rows][pitch]
    float* T = smem;
    float* S = smem + p.tr * p.pitch;
    const int lead = stage_window(p, lvl, sr0, sr, sc0, sc, S, p.pitch);
    cp_commit_wait_all();
    __syncthreads();
    row_pass(RT, nr, sr0, S + lead, p.pitch, sc, T, p.pitch);
    __syncthreads();
    col_pass(CT, ncl, nu, sc0, nr, T, p.pitch, out, p.wpl, p.lgcg);
  } else {
    // A holds level l-2's window, then level l-1's rows [sr0, sr0 + sr) x
    // columns [sc0, sc0 + sc) (its block's rows and columns + r); T the
    // row pass of each step
    const int4 e = rec[4];
    const int pf = p.pitch_f;
    float* A = smem;
    float* T = smem + p.rows_a * pf;
    const Level& M = p.lv[lvl - 1];
    for (int i = tid; i < sr; i += THREADS)
      cp_async16(RT + nr + i, p.rtab + M.rt + sr0 + p.r + i);
    for (int i = tid; i < sc; i += THREADS)
      cp_async16(CT + ncl + i, p.ctab + M.ct + sc0 + p.r + i);
    const int lead = stage_window(p, lvl - 1, e.x, e.y, e.z, e.w, A, pf);
    cp_commit_wait_all();
    __syncthreads();
    row_pass(RT + nr, sr, e.x, A + lead, pf, e.w, T, pf);
    __syncthreads();
    col_pass(CT + ncl, sc, sc, e.z, sr, T, pf, A, pf, p.lgcg_v);
    __syncthreads();
    row_pass(RT, nr, sr0, A, pf, sc, T, pf);
    __syncthreads();
    col_pass(CT, ncl, nu, sc0, nr, T, pf, out, p.wpl, p.lgcg_f);
  }
  // publish: every thread's stores, then the tile's count (own 0: no tile
  // waits on its level); the next ticket's round trip and its record's
  // load overlap the fence
  __syncthreads();
  if (tid < 32) {
    const unsigned t = __shfl_sync(
        0xffffffffu, tid == 0 ? atomicAdd(p.ctr + C_TICKET, 1u) : 0u, 0);
    int4 r4 = make_int4(0, 0, 0, 0);
    if (tid < RS && t < (unsigned)p.n_items)
      r4 = __ldg(p.records + RS * t + tid);
    if (tid == 0 && own) {
      __threadfence();
      atomicAdd(p.ctr + own, 1u);
    }
    if (tid == 0) *s_tk = t;
    if (tid < RS) s_rec[tid] = r4;
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS)
    packedpyr_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  // the ticket and record of the block's next item, two slots by the
  // parity of its item count: written while the item before is read
  __shared__ unsigned s_tk[2];
  __shared__ int4 s_rec[2][RS];
  __shared__ int s_last;
  float* smem = reinterpret_cast<float*>(smem4);
  if (threadIdx.x < 32)
    next_item(p, threadIdx.x == 0 ? atomicAdd(p.ctr + C_TICKET, 1u) : 0u,
              s_tk, s_rec[0]);
  __syncthreads();
  for (int k = 0;; ++k) {
    const unsigned i = s_tk[k & 1];
    if (i >= (unsigned)p.n_items) break;
    const int4* rec = s_rec[k & 1];
    unsigned* tk = s_tk + ((k + 1) & 1);
    int4* nrec = s_rec[(k + 1) & 1];
    const int4 a = rec[0], b = rec[1];
    if (a.x == KIND_TILE) {
      level_tile(p, rec, smem, tk, nrec);
    } else {
      if (a.x == KIND_ZERO)
        zero_rect(p, a.z, a.w, b.x, b.y >> 2);
      else
        pad_rect(p, a.z, a.w, b.y >> 2);
      if (threadIdx.x < 32)
        next_item(p, threadIdx.x == 0 ? atomicAdd(p.ctr + C_TICKET, 1u) : 0u,
                  tk, nrec);
    }
    __syncthreads();
  }
  // the last block out sets every counter back to 0 for the next call
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(p.ctr + C_DONE, 1u) == gridDim.x - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (s_last)
    for (int k = threadIdx.x; k < p.n_ctr; k += THREADS) p.ctr[k] = 0u;
}

}  // namespace

// Resident blocks of the kernel on one SM with `smem` bytes of dynamic
// shared memory each (registers included), or -1 on an error.
extern "C" int packedpyr_occupancy(int smem) {
  if (cudaFuncSetAttribute(packedpyr_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, packedpyr_kernel, THREADS, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// img: [h, w] f32; out: the packed [rows, wpl] f32 buffer; levels (host):
// [MAXL][8] ints per level (Level; level 0 unused); geo (host): tr,
// pitch, pitch_f, rows_a, lgcg, lgcg_f, lgcg_v, tab_off, tab_rows
// (Params); rtab, ctab,
// records: the plan's tables on the device; ctr: n_ctr zeroed counters on
// the device, zeroed again by the kernel; grid blocks, smem bytes each.
extern "C" int packedpyr_launch(const float* img, int h, int w, int vec1,
                                float* out, int wpl, int r,
                                const int* levels, const int* geo,
                                const int* rtab, const int* ctab,
                                const int* records, int n_items,
                                unsigned* ctr, int n_ctr, int grid, int smem,
                                void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      packedpyr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  Params p;
  for (int l = 0; l < MAXL; ++l) {
    const int* v = levels + 8 * l;
    p.lv[l] = Level{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
  }
  p.img = img;
  p.out = out;
  p.h = h;
  p.w = w;
  p.wpl = wpl;
  p.r = r;
  p.vec1 = vec1;
  p.tr = geo[0];
  p.pitch = geo[1];
  p.pitch_f = geo[2];
  p.rows_a = geo[3];
  p.lgcg = geo[4];
  p.lgcg_f = geo[5];
  p.lgcg_v = geo[6];
  p.tab_off = geo[7];
  p.tab_rows = geo[8];
  p.n_items = n_items;
  p.n_ctr = n_ctr;
  p.rtab = reinterpret_cast<const int4*>(rtab);
  p.ctab = reinterpret_cast<const int4*>(ctab);
  p.records = reinterpret_cast<const int4*>(records);
  p.ctr = ctr;
  packedpyr_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
