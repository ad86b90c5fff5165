// K5: P banded sandwiches of one image, out[p] = mhs[p] @ x @ mws[p]^T.
//
// Replaces pislamfusion_tpu/ops/stencil_pallas.py banded_stack_pallas
// (pallas_call in _stack_call at :338): SIFT's Gaussian octave stack.
//
// With the nonzero span of each operator row from host tables
// (ops/stencil.py):
//   t1[p, y, c]  = sum_k row_w[p, y, k] * x[row_start[p, y] + k, c]  (rows)
//   out[p, y, x] = sum_k col_w[p, x, k] * t1[p, y, col_start[p, x] + k]
// all in f32 multiply-adds (the TPU kernel ran at Precision.HIGHEST; no
// TF32, no tensor cores).
//
// Bound on the H100: operations. Octave 0 at 1080p is ~1.43 GFLOP of f32
// multiply-adds against ~50 MB of traffic. The design feeds the FMA pipe:
// - A work item is one scale and one tile (th = 16 or 32 output rows by
//   tw[s] output columns), not a tile of all scales, so the small octaves
//   still have hundreds of items. A persistent grid walks the items
//   blockIdx.x, + gridDim.x, ..., the widest scale's first.
// - The row pass computes t1 for the tile's rows over cw[s] columns (the
//   tile's and a halo of r each side, rounded up to 32) into shared memory:
//   a thread one column of 16 rows (a row group), from the x column's
//   16 + 2r inputs read once each from global memory (L2), a warp 32
//   adjacent columns (coalesced). The column pass gives a thread 8 outputs
//   of one row (a column group) from the row's 8 + 2r t1 values, lanes 8
//   rows x 4 groups: with the t1 pitch 1 mod 32 the shared reads are free
//   of bank conflicts, and a warp's two float4 stores cover 8 rows x 128
//   bytes.
// - Register blocking: each loaded value feeds all the group's outputs it
//   reaches (up to 16 or 8 independent accumulators), so one load feeds
//   7-13 multiply-adds. The half-width is a template parameter (4, 9, 15,
//   23 and 33: SIFT's default chain; the host raises on others), the tap
//   loops unroll fully, and away from the reflect folds (an interior
//   group) the weights are the scale's one vector, passed in the kernel's
//   parameters: every FFMA reads its weight from the constant bank, with
//   no load at all.
// - A group that holds an output within r of an edge (an edge group) takes
//   a dense block of weights over its window ([16 + 2r, 16] or [8 + 2r,
//   8], zeros outside each output's span), staged in shared memory with
//   cp.async when the item starts: 3 loads feed 16 or 8 multiply-adds.
//   The item's group tables (window starts, edge blocks) land in shared
//   memory first, one load a thread, in a single round trip to L2.
// - No division in an index loop: the tasks of both passes are walked by
//   subtraction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXP = 5;
constexpr int RR = 16;   // output rows of a row group (stencil.K5_ROWS)
constexpr int RC = 8;    // output columns of a column group
constexpr int NW = 173;  // interior weights of the five half-widths
constexpr int MAXG = 32;     // column groups of a tile (tw <= 256)
constexpr int MAXSLOT = 32;  // column block slots of a tile

template <int RH>
struct Off;   // offset of a half-width's interior vector in wr / wc
template <> struct Off<4> { static constexpr int v = 0; };
template <> struct Off<9> { static constexpr int v = 9; };
template <> struct Off<15> { static constexpr int v = 28; };
template <> struct Off<23> { static constexpr int v = 59; };
template <> struct Off<33> { static constexpr int v = 106; };

struct Params {
  float wr[NW];       // interior row vectors at Off<r>
  float wc[NW];       // interior column vectors
  int h, w, n_items, th, pitch, nslot, rslot, cslot, vec;
  // per slot (items of one scale), widest first; item0[MAXP] = n_items
  int p_out[MAXP], rh[MAXP], tw[MAXP], cw[MAXP], ntx[MAXP];
  int item0[MAXP + 1], rg0[MAXP], cg0[MAXP], tx0[MAXP];
  const int* rg_ws;     // window start row of each row group
  const int* rg_e;      // offset of its block in d_row, -1 interior
  const int* cg_ws;     // window start column of each column group
  const int* cg_slot;   // its slot in its tile column, -1 interior
  const int* tx_t0;     // first t1 column of each tile column
  const int* tx_slots;  // [tile columns, nslot] d_col offset of each slot
  const float* d_row;   // edge row blocks [16 + 2r][16]
  const float* d_col;   // edge column blocks [8 + 2r][8]
};

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One row group of an interior tile: t1[i][c] for i < 16 from x[ws + j][c],
// j < 16 + 2r, the scale's vector from the parameters.
template <int RH>
__device__ __forceinline__ void row_interior(const float* __restrict__ src,
                                             int w, const Params& p,
                                             float* dst, int pitch) {
  constexpr int L = RR + 2 * RH;
  constexpr int O = Off<RH>::v;
  float acc[RR];
#pragma unroll
  for (int i = 0; i < RR; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float v = __ldg(src + j * w);
#pragma unroll
    for (int i = 0; i < RR; ++i)
      if (j - i >= 0 && j - i <= 2 * RH)
        acc[i] = fmaf(p.wr[O + j - i], v, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < RR; ++i) dst[i * pitch] = acc[i];
}

// A row group with an edge row: the staged [L][16] block d.
__device__ __forceinline__ void row_edge(const float* __restrict__ src, int w,
                                         int L, const float* d, float* dst,
                                         int pitch) {
  float acc[RR];
#pragma unroll
  for (int i = 0; i < RR; ++i) acc[i] = 0.f;
  const float4* d4 = reinterpret_cast<const float4*>(d);
#pragma unroll 2
  for (int j = 0; j < L; ++j) {
    const float v = __ldg(src + j * w);
#pragma unroll
    for (int q = 0; q < RR / 4; ++q) {
      const float4 c = d4[j * (RR / 4) + q];
      acc[4 * q] = fmaf(c.x, v, acc[4 * q]);
      acc[4 * q + 1] = fmaf(c.y, v, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(c.z, v, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(c.w, v, acc[4 * q + 3]);
    }
  }
#pragma unroll
  for (int i = 0; i < RR; ++i) dst[i * pitch] = acc[i];
}

// One interior column group: out[x0 + i] for i < 8 from t1 row values
// src[j], j < 8 + 2r.
template <int RH>
__device__ __forceinline__ void col_interior(const float* src,
                                             const Params& p,
                                             float (&acc)[RC]) {
  constexpr int L = RC + 2 * RH;
  constexpr int O = Off<RH>::v;
#pragma unroll
  for (int i = 0; i < RC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float v = src[j];
#pragma unroll
    for (int i = 0; i < RC; ++i)
      if (j - i >= 0 && j - i <= 2 * RH)
        acc[i] = fmaf(p.wc[O + j - i], v, acc[i]);
  }
}

__device__ __forceinline__ void col_edge(const float* src, int L,
                                         const float* d, float (&acc)[RC]) {
#pragma unroll
  for (int i = 0; i < RC; ++i) acc[i] = 0.f;
  const float4* d4 = reinterpret_cast<const float4*>(d);
#pragma unroll 2
  for (int j = 0; j < L; ++j) {
    const float v = src[j];
    const float4 a = d4[2 * j];
    const float4 b = d4[2 * j + 1];
    acc[0] = fmaf(a.x, v, acc[0]);
    acc[1] = fmaf(a.y, v, acc[1]);
    acc[2] = fmaf(a.z, v, acc[2]);
    acc[3] = fmaf(a.w, v, acc[3]);
    acc[4] = fmaf(b.x, v, acc[4]);
    acc[5] = fmaf(b.y, v, acc[5]);
    acc[6] = fmaf(b.z, v, acc[6]);
    acc[7] = fmaf(b.w, v, acc[7]);
  }
}

__global__ void __launch_bounds__(THREADS, 4)
    bandedstack_kernel(const float* __restrict__ x, float* __restrict__ out,
                       const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* t1 = reinterpret_cast<float*>(smem4);      // [th][pitch]
  float* drow = t1 + p.th * p.pitch;                // [th / 16][rslot]
  float* dcol = drow + (p.th / RR) * p.rslot;       // [nslot][cslot]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nrg = p.th / RR;
  // the current item's group tables
  __shared__ int s_rws[32 / RR], s_re[32 / RR], s_cws[MAXG], s_cslot[MAXG],
      s_slot[MAXSLOT], s_t0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    int s = 0;
    while (item >= p.item0[s + 1]) ++s;
    const int rest = item - p.item0[s];
    const int ty = rest / p.ntx[s];            // once an item
    const int tx = rest - ty * p.ntx[s];
    const int r = p.rh[s], tw = p.tw[s];
    const int tile = p.tx0[s] + tx;
    const int lr = RR + 2 * r, lc = RC + 2 * r;
    const int ngr = tw / RC;                    // column groups of the tile
    // the item's group tables, one load a thread (a single round trip)
    {
      const int t = threadIdx.x;
      if (t < nrg) {
        const int g = ty * nrg + t;
        const bool in = g * RR < p.h;
        s_rws[t] = in ? __ldg(p.rg_ws + p.rg0[s] + g) : 0;
        s_re[t] = in ? __ldg(p.rg_e + p.rg0[s] + g) : -1;
      } else if (t >= 32 && t < 32 + ngr) {
        const int gl = t - 32;
        const bool in = tx * tw + gl * RC < p.w;
        const int g = p.cg0[s] + tx * ngr + gl;
        s_cws[gl] = in ? __ldg(p.cg_ws + g) : 0;
        s_cslot[gl] = in ? __ldg(p.cg_slot + g) : -1;
      } else if (t >= 64 && t < 64 + p.nslot) {
        s_slot[t - 64] = __ldg(p.tx_slots + tile * p.nslot + t - 64);
      } else if (t == 96) {
        s_t0 = __ldg(p.tx_t0 + tile);
      }
    }
    __syncthreads();
    const int t0 = s_t0;
    // stage the edge blocks of this item's groups
    for (int k = 0; k < nrg; ++k) {
      const int e = s_re[k];
      if (e >= 0)
        for (int i = threadIdx.x; i < lr * (RR / 4); i += THREADS)
          cp_async16(drow + k * p.rslot + 4 * i, p.d_row + e + 4 * i);
    }
    for (int sl = 0; sl < p.nslot; ++sl) {
      const int e = s_slot[sl];
      if (e >= 0)
        for (int i = threadIdx.x; i < lc * (RC / 4); i += THREADS)
          cp_async16(dcol + sl * p.cslot + 4 * i, p.d_col + e + 4 * i);
    }
    cp_commit_wait_all();
    __syncthreads();

    // row pass: task (row group k, lane block lb), cw / 32 lane blocks
    const int nlb = p.cw[s] >> 5;
    for (int task = warp; task < nrg * nlb; task += WARPS) {
      int k = 0, lb = task;
      while (lb >= nlb) {
        lb -= nlb;
        ++k;
      }
      if ((ty * nrg + k) * RR >= p.h) continue;
      const int ws = s_rws[k];
      const int e = s_re[k];
      const int col = min(t0 + lb * 32 + lane, p.w - 1);
      const float* src = x + (long long)ws * p.w + col;
      float* dst = t1 + k * RR * p.pitch + lb * 32 + lane;
      if (e >= 0) {
        row_edge(src, p.w, lr, drow + k * p.rslot, dst, p.pitch);
      } else {
        switch (r) {
          case 4: row_interior<4>(src, p.w, p, dst, p.pitch); break;
          case 9: row_interior<9>(src, p.w, p, dst, p.pitch); break;
          case 15: row_interior<15>(src, p.w, p, dst, p.pitch); break;
          case 23: row_interior<23>(src, p.w, p, dst, p.pitch); break;
          default: row_interior<33>(src, p.w, p, dst, p.pitch); break;
        }
      }
    }
    __syncthreads();

    // column pass: task (8-row block rb, 32-column block cb); lanes 8 rows
    // x 4 column groups
    const int ncb = tw >> 5;
    const int rr = lane & 7;
    const int gq = lane >> 3;
    float* plane = out + (long long)p.p_out[s] * p.h * p.w;
    int rb = 0;
    for (int cb = warp;; cb += WARPS) {
      while (cb >= ncb) { cb -= ncb; ++rb; }
      if (rb >= (p.th >> 3)) break;
      const int yl = rb * 8 + rr;
      const int gl = cb * 4 + gq;
      const int y = ty * p.th + yl;
      const int xo = tx * tw + gl * RC;
      if (y >= p.h || xo >= p.w) continue;
      const float* src = t1 + yl * p.pitch + (s_cws[gl] - t0);
      const int sl = s_cslot[gl];
      float acc[RC];
      if (sl >= 0) {
        col_edge(src, lc, dcol + sl * p.cslot, acc);
      } else {
        switch (r) {
          case 4: col_interior<4>(src, p, acc); break;
          case 9: col_interior<9>(src, p, acc); break;
          case 15: col_interior<15>(src, p, acc); break;
          case 23: col_interior<23>(src, p, acc); break;
          default: col_interior<33>(src, p, acc); break;
        }
      }
      float* o = plane + (long long)y * p.w + xo;
      if (p.vec && xo + RC <= p.w) {
        reinterpret_cast<float4*>(o)[0] =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        reinterpret_cast<float4*>(o)[1] =
            make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
#pragma unroll
        for (int i = 0; i < RC; ++i)
          if (xo + i < p.w) o[i] = acc[i];
      }
    }
    __syncthreads();   // the next item overwrites t1 and the blocks
  }
}

}  // namespace

// Resident blocks of the kernel on one SM with `smem` bytes of dynamic
// shared memory each (registers included), or -1 on an error.
extern "C" int bandedstack_occupancy(int smem) {
  if (cudaFuncSetAttribute(bandedstack_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bandedstack_kernel, THREADS, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// x: [h, w] f32, out: [P, h, w] f32, both contiguous on the device. desc
// (host): n_items, th, pitch, nslot, rslot, cslot, the slot count, then
// per slot (five) p_out, rh, tw, cw, ntx, item0, rg0, cg0, tx0 (ops/
// stencil.py _stack_desc); wr, wc (host): the interior vectors; the
// tables on the device (stencil.stack_plan); `grid` persistent blocks.
extern "C" int bandedstack_launch(
    const float* x, float* out, int h, int w, const int* desc,
    const float* wr, const float* wc, const int* rg_ws, const int* rg_e,
    const int* cg_ws, const int* cg_slot, const int* tx_t0,
    const int* tx_slots, const float* d_row, const float* d_col, int smem,
    int grid, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      bandedstack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  Params p;
  for (int i = 0; i < NW; ++i) {
    p.wr[i] = wr[i];
    p.wc[i] = wc[i];
  }
  p.h = h;
  p.w = w;
  p.n_items = desc[0];
  p.th = desc[1];
  p.pitch = desc[2];
  p.nslot = desc[3];
  p.rslot = desc[4];
  p.cslot = desc[5];
  p.vec = (w % 4 == 0) && ((uintptr_t)out % 16 == 0);
  const int* d = desc + 7;
  for (int s = 0; s < MAXP; ++s, d += 9) {
    p.p_out[s] = d[0];
    p.rh[s] = d[1];
    p.tw[s] = d[2];
    p.cw[s] = d[3];
    p.ntx[s] = d[4];
    p.item0[s] = d[5];
    p.rg0[s] = d[6];
    p.cg0[s] = d[7];
    p.tx0[s] = d[8];
  }
  p.item0[MAXP] = desc[0];
  p.rg_ws = rg_ws;
  p.rg_e = rg_e;
  p.cg_ws = cg_ws;
  p.cg_slot = cg_slot;
  p.tx_t0 = tx_t0;
  p.tx_slots = tx_slots;
  p.d_row = d_row;
  p.d_col = d_col;
  bandedstack_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(x, out,
                                                                     p);
  return (int)cudaGetLastError();
}
