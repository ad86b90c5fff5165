// K4: FAST-16 score, threshold and border masks, 3x3 NMS and the per-cell
// winner, for every pyramid level in one launch.
//
// Replaces pislamfusion_tpu/ops/features/fastselect.py fast_cell_winners
// (pallas_call in _winners_kernel_call at :191).
//
// Per level (pixel (x, y) at packed[(oy + y) * ld + ox + x], lh x lw, cells
// of `cell` px): s = FAST score where border <= y < lh - border and
// border <= x < lw - border and score > thr, else 0; nms = s where s >= its
// 8 neighbours, else 0; per cell the maximum of nms and the first row-major
// index y * ncx * cell + x among the pixels that reach it.
//
// Bound on the H100: operations. The full score is ~180 f32 subtractions,
// minima and maxima a pixel, but on survey imagery only ~9 % of pixels
// score above the threshold. So each pixel first takes an exact pretest:
// a score > thr needs a run of 9 consecutive circle pixels all brighter
// than c + thr (or all darker than c - thr), and any 9 consecutive indices
// of 16 hold two cyclically adjacent members of A = {0, 4, 8, 12} and two
// of B = {2, 6, 10, 14}. Two adjacent members of A are above thr exactly
// when (d0 > thr or d8 > thr) and (d4 > thr or d12 > thr), so
//   brighter possible  <=>  min(max(v0, v8), max(v4, v12),
//                               max(v2, v10), max(v6, v14)) - c > thr
// and the darker test is the same with min and max swapped against -thr
// (v - c is monotone in v under rounding, so it commutes with min and max
// and these equal the tests on the rounded differences). A pixel that
// fails has a score <= thr, which the mask makes 0: the output stays equal
// to the plain version's for any thr.
//
// One block of 8 warps takes `run` cells of one cell row (4 at cell 32):
//   stage   the slab (the cells, a 1-px NMS halo and FAST's 3-px radius)
//           into shared memory with coalesced asynchronous copies, all in
//           flight at once (16 bytes each where the rows lie inside the
//           level and align), while the score tile is zero-filled;
//   pass 1  every pixel of the score tile (cells + halo) takes the
//           pretest: a warp slides down a 32-column chunk, a lane a
//           column, its 9 taps in registers (5 shared reads a pixel); the
//           pixels that pass are appended to a shared list of (row << 8 |
//           column) with one warp ballot and one shared atomicAdd a warp;
//   pass 2  the warps walk the list densely and score each candidate;
//   pass 3  the list once more: each candidate of the cells (not the
//           halo) with a score > 0 that is >= its 8 neighbours updates its
//           thread's (max, first index) of its cell, held in registers;
//           then a shuffle reduction a warp and one across the warps.
// The list's order does not matter: a score depends only on its position,
// and (max, first index) is the same in any order. Only subtractions, min
// and max are used, so the result equals the plain version's bit for bit.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXRUN = 4;           // cells a block at most
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FR = 3;               // FAST circle radius

// FAST-16 score of the slab pixel at p (row pitch `pitch`): the max over
// both polarities of the 9-pixel arc minimum of the circle differences.
__device__ __forceinline__ float fast16(const float* p, int pitch) {
  const float c = p[0];
  float d[16];
  d[0] = p[-3 * pitch] - c;          // (0, -3)
  d[1] = p[-3 * pitch + 1] - c;      // (1, -3)
  d[2] = p[-2 * pitch + 2] - c;      // (2, -2)
  d[3] = p[-pitch + 3] - c;          // (3, -1)
  d[4] = p[3] - c;                   // (3, 0)
  d[5] = p[pitch + 3] - c;           // (3, 1)
  d[6] = p[2 * pitch + 2] - c;       // (2, 2)
  d[7] = p[3 * pitch + 1] - c;       // (1, 3)
  d[8] = p[3 * pitch] - c;           // (0, 3)
  d[9] = p[3 * pitch - 1] - c;       // (-1, 3)
  d[10] = p[2 * pitch - 2] - c;      // (-2, 2)
  d[11] = p[pitch - 3] - c;          // (-3, 1)
  d[12] = p[-3] - c;                 // (-3, 0)
  d[13] = p[-pitch - 3] - c;         // (-3, -1)
  d[14] = p[-2 * pitch - 2] - c;     // (-2, -2)
  d[15] = p[-3 * pitch - 1] - c;     // (-1, -3)
  float mn3[16], mx3[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float a = d[i], b = d[(i + 1) & 15], e = d[(i + 2) & 15];
    mn3[i] = fminf(fminf(a, b), e);
    mx3[i] = fmaxf(fmaxf(a, b), e);
  }
  // brighter arcs: max_i min d[i..i+8]; darker: max_i min -d[i..i+8],
  // which is -(min_i max d[i..i+8]) exactly
  float pos = -INFINITY, neg = INFINITY;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    pos = fmaxf(pos, fminf(fminf(mn3[i], mn3[(i + 3) & 15]),
                           mn3[(i + 6) & 15]));
    neg = fminf(neg, fmaxf(fmaxf(mx3[i], mx3[(i + 3) & 15]),
                           mx3[(i + 6) & 15]));
  }
  return fmaxf(pos, -neg);
}

// The exact pretest of the header: false only where the score is <= thr.
__device__ __forceinline__ bool may_pass(const float* p, int pitch,
                                         float thr) {
  const float c = p[0];
  const float v0 = p[-3 * pitch], v4 = p[3], v8 = p[3 * pitch], v12 = p[-3];
  const float v2 = p[-2 * pitch + 2], v6 = p[2 * pitch + 2];
  const float v10 = p[2 * pitch - 2], v14 = p[-2 * pitch - 2];
  const float hi = fminf(fminf(fmaxf(v0, v8), fmaxf(v4, v12)),
                         fminf(fmaxf(v2, v10), fmaxf(v6, v14)));
  const float lo = fmaxf(fmaxf(fminf(v0, v8), fminf(v4, v12)),
                         fmaxf(fminf(v2, v10), fminf(v6, v14)));
  return (hi - c > thr) || (lo - c < -thr);
}

__device__ __forceinline__ void take(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// Append `e` to the shared list where `cand` is set: one ballot a warp, one
// shared atomicAdd a warp that has any (called by every lane of the warp).
__device__ __forceinline__ void append(unsigned short* list, int* n,
                                       bool cand, int e, int lane) {
  const unsigned m = __ballot_sync(0xffffffffu, cand);
  if (m) {
    int at = 0;
    if (lane == 0) at = atomicAdd(n, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0) + __popc(m & ((1u << lane) - 1u));
    if (cand) list[at] = (unsigned short)e;
  }
}

// Copy 4 bytes from global to shared memory asynchronously, or write 0
// where `ok` is false (cp.async's zero fill; src then points anywhere
// valid).
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// Copy 16 bytes (both addresses 16-byte aligned) asynchronously.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// levels: [L, 6] (oy, ox, lh, lw, ncx, first output cell); blocks:
// [n_blocks, 3] (level, cell row, first cell of the run). CELL_T and
// RUN_T fix the cell and the run at compile time (0: read cell_ and run_).
template <int CELL_T, int RUN_T>
__global__ void __launch_bounds__(THREADS)
    fastselect_kernel(const float* __restrict__ packed, int ld,
                      const int* __restrict__ levels,
                      const int* __restrict__ blocks, int cell_, int run_,
                      float thr, int border, float* __restrict__ cv,
                      int* __restrict__ ci) {
  extern __shared__ float smem[];
  __shared__ int n_cand;
  __shared__ float red_v[WARPS][MAXRUN];
  __shared__ int red_i[WARPS][MAXRUN];
  const int cell = CELL_T ? CELL_T : cell_;
  const int run = RUN_T ? RUN_T : run_;
  const int* bl = blocks + 3 * blockIdx.x;
  const int* lv = levels + 6 * bl[0];
  const int cy = bl[1], cx0 = bl[2];
  const int oy = lv[0], ox = lv[1], lh = lv[2], lw = lv[3], ncx = lv[4];
  const int tw = run * cell + 2, th = cell + 2;   // score tile (NMS halo)
  const int sw = tw + 2 * FR, sh = th + 2 * FR;   // slab (FAST radius)
  float* slab = smem;                             // [sh, sw]
  float* s = smem + ((sh * sw + 3) & ~3);  // [th, sw]: (r, c) at r * sw + c
  unsigned short* list =
      reinterpret_cast<unsigned short*>(s + th * sw);   // [th * tw]
  const int ty0 = cy * cell - 1, tx0 = cx0 * cell - 1;  // tile origin
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) n_cand = 0;
  {  // stage the slab with asynchronous copies, all in flight at once:
     // 16 bytes each where the slab's rows lie inside the level and align,
     // else 4 bytes each with zero fill; zero the score tile meanwhile
    const int x0 = tx0 - FR, q4 = sw >> 2;        // slab column 0's level x
    const bool vec = (sw & 3) == 0 && (ld & 3) == 0 && x0 >= 0 &&
                     x0 + sw <= lw && ((ox + x0) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
    if (vec) {        // (r, c) advance with the flat index of float4s
      int r = threadIdx.x / q4, c = threadIdx.x - r * q4;
      for (int i = threadIdx.x; i < sh * q4; i += THREADS) {
        const int y = ty0 - FR + r;
        float* dst = slab + r * sw + 4 * c;
        if (y >= 0 && y < lh)
          copy16(dst, packed + (long long)(oy + y) * ld + ox + x0 + 4 * c);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        for (c += THREADS; c >= q4; c -= q4) ++r;
      }
    } else {          // (r, c) advance with the flat index of floats
      int r = threadIdx.x / sw, c = threadIdx.x - r * sw;
      for (int i = threadIdx.x; i < sh * sw; i += THREADS) {
        const int y = ty0 - FR + r, x = x0 + c;
        const bool in = y >= 0 && y < lh && x >= 0 && x < lw;
        copy4(slab + i,
              in ? packed + (long long)(oy + y) * ld + ox + x : packed, in);
        for (c += THREADS; c >= sw; c -= sw) ++r;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    float4* s4 = reinterpret_cast<float4*>(s);
    for (int i = threadIdx.x; i < th * sw / 4; i += THREADS)
      s4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = th * sw / 4 * 4 + threadIdx.x; i < th * sw; i += THREADS)
      s[i] = 0.f;
    asm volatile("cp.async.wait_all;\n" ::);
  }
  __syncthreads();  // slab staged
  {  // pass 1: the pretest, the pixels that pass appended to the list.
     // Whole 32-column chunks of the tile: a warp slides down `rows` rows
     // of a chunk, a lane a column, with the taps in registers (5 shared
     // reads a pixel: column c at row + 3, c -+ 2 at row + 2, c -+ 3 at
     // row); the last tw % 32 columns take a pass of their own.
    const int full = tw / 32, parts = max(1, WARPS / max(full, 1));
    const int rows = (th + parts - 1) / parts;
    for (int u = warp; u < full * parts; u += WARPS) {
      const int c = (u / parts) * 32 + lane, r0 = (u - u / parts * parts) *
                                                   rows;
      const int x = tx0 + c;
      const bool col_ok = x >= border && x < lw - border;
      const float* p = slab + (r0 + FR) * sw + c + FR;   // at (r0, c)
      float m[7], l2[5], r2[5];
#pragma unroll
      for (int d = 0; d < 6; ++d) m[d] = p[(d - 3) * sw];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        l2[d] = p[(d - 2) * sw - 2];
        r2[d] = p[(d - 2) * sw + 2];
      }
#pragma unroll
      for (int i = 0; i < rows; ++i) {
        const int r = r0 + i;
        if (r >= th) break;                          // warp-uniform
        m[6] = p[3 * sw];
        l2[4] = p[2 * sw - 2];
        r2[4] = p[2 * sw + 2];
        const float c0 = m[3], l3 = p[-3], r3 = p[3];
        // the pretest of may_pass on the register taps
        const float hi = fminf(fminf(fmaxf(m[0], m[6]), fmaxf(r3, l3)),
                               fminf(fmaxf(r2[0], l2[4]), fmaxf(r2[4], l2[0])));
        const float lo = fmaxf(fmaxf(fminf(m[0], m[6]), fminf(r3, l3)),
                               fmaxf(fminf(r2[0], l2[4]), fminf(r2[4], l2[0])));
        const int y = ty0 + r;
        const bool cand = col_ok && y >= border && y < lh - border &&
                          (hi - c0 > thr || lo - c0 < -thr);
        append(list, &n_cand, cand, (r << 8) | c, lane);
#pragma unroll
        for (int d = 0; d < 6; ++d) m[d] = m[d + 1];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          l2[d] = l2[d + 1];
          r2[d] = r2[d + 1];
        }
        p += sw;
      }
    }
    const int tail = tw - full * 32;                 // the last columns
    for (int base = 0; base < th * tail; base += THREADS) {
      const int i = base + threadIdx.x;
      const int r = i / tail, c = full * 32 + i - r * tail;
      const int y = ty0 + r, x = tx0 + c;
      const bool cand = i < th * tail && y >= border && y < lh - border &&
                        x >= border && x < lw - border &&
                        may_pass(slab + (r + FR) * sw + c + FR, sw, thr);
      append(list, &n_cand, cand, (r << 8) | c, lane);
    }
  }
  __syncthreads();  // pretest done
  const int n = n_cand;
  for (int k = threadIdx.x; k < n; k += THREADS) {  // pass 2: score
    const int e = list[k], r = e >> 8, c = e & 255;
    const float sc = fast16(slab + (r + FR) * sw + c + FR, sw);
    s[r * sw + c] = sc > thr ? sc : 0.f;
  }
  __syncthreads();  // scores done
  // pass 3: NMS of the candidates in the cells, (max, first index) a cell
  const int wp = ncx * cell;
  float bv[MAXRUN];
  int bi[MAXRUN];
#pragma unroll
  for (int q = 0; q < MAXRUN; ++q) {
    bv[q] = 0.f;
    bi[q] = INT_MAX;
  }
  for (int k = threadIdx.x; k < n; k += THREADS) {
    const int e = list[k], r = e >> 8, c = e & 255;
    const float* p = s + r * sw + c;
    const float v = p[0];
    if (!(v > 0.f) || r < 1 || r > cell || c < 1 || c > run * cell)
      continue;                      // masked, or in the halo
    float m = fmaxf(fmaxf(p[-sw - 1], p[-sw]), p[-sw + 1]);
    m = fmaxf(m, fmaxf(p[-1], p[1]));
    m = fmaxf(m, fmaxf(fmaxf(p[sw - 1], p[sw]), p[sw + 1]));
    if (v < m) continue;
    const int px = c - 1;
    const int idx = (cy * cell + r - 1) * wp + cx0 * cell + px;
#pragma unroll
    for (int q = 0; q < MAXRUN; ++q)  // static indices: stays in registers
      if (px >= q * cell && px < (q + 1) * cell) take(bv[q], bi[q], v, idx);
  }
#pragma unroll
  for (int q = 0; q < MAXRUN; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      take(bv[q], bi[q], __shfl_down_sync(0xffffffffu, bv[q], off),
           __shfl_down_sync(0xffffffffu, bi[q], off));
    if (lane == 0) {
      red_v[warp][q] = bv[q];
      red_i[warp][q] = bi[q];
    }
  }
  __syncthreads();
  const int q = threadIdx.x;
  if (q < run && cx0 + q < ncx) {
    float v = red_v[0][q];
    int i = red_i[0][q];
    for (int w = 1; w < WARPS; ++w) take(v, i, red_v[w][q], red_i[w][q]);
    const int cx = cx0 + q;
    if (i == INT_MAX) i = cy * cell * wp + cx * cell;  // no corner: first px
    const int o = lv[5] + cy * ncx + cx;
    cv[o] = v;
    ci[o] = i;
  }
}

// Raise the kernel's dynamic shared-memory limit once for each larger size
// (the default 48 KB counts the static shared memory too), per device and
// instantiation.
template <int CELL_T, int RUN_T>
int set_smem(int smem) {
  static int done[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  if (smem <= done[dev]) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      fastselect_kernel<CELL_T, RUN_T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) done[dev] = smem;
  return (int)e;
}

template <int CELL_T, int RUN_T>
int occupancy(int smem) {
  if (set_smem<CELL_T, RUN_T>(smem) != 0) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fastselect_kernel<CELL_T, RUN_T>, THREADS, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

template <int CELL_T, int RUN_T>
int launch(const float* packed, int ld, const int* levels, const int* blocks,
           int n_blocks, int cell, int run, float thr, int border,
           float* cv, int* ci, int smem, cudaStream_t stream) {
  const int e = set_smem<CELL_T, RUN_T>(smem);
  if (e != 0) return e;
  fastselect_kernel<CELL_T, RUN_T><<<n_blocks, THREADS, smem, stream>>>(
      packed, ld, levels, blocks, cell, run, thr, border, cv, ci);
  return (int)cudaGetLastError();
}

}  // namespace

// The dynamic shared memory a block of `run` cells of `cell` px needs: the
// slab (rounded up to whole float4s), the score tile and the list.
extern "C" int fastselect_smem(int cell, int run) {
  const int tw = run * cell + 2, th = cell + 2;
  const int sw = tw + 2 * FR, sh = th + 2 * FR;
  return (((sh * sw + 3) & ~3) + th * sw) * (int)sizeof(float) +
         ((th * tw * 2 + 3) & ~3);
}

// Resident blocks an SM at that shared memory (registers included), or -1.
extern "C" int fastselect_occupancy(int cell, int run) {
  const int smem = fastselect_smem(cell, run);
  return cell == 32 && run == 4 ? occupancy<32, 4>(smem)
                                : occupancy<0, 0>(smem);
}

// packed: f32 rows of pitch ld; cv / ci: one entry per cell of every level.
// Cell 32 in runs of 4 (ORB's) takes an instantiation with both fixed.
extern "C" int fastselect_launch(const float* packed, int ld,
                                 const int* levels, const int* blocks,
                                 int n_blocks, int cell, int run, float thr,
                                 int border, float* cv, int* ci,
                                 void* stream) {
  if (run < 1 || run > MAXRUN || run * cell + 2 > 256)
    return (int)cudaErrorInvalidValue;
  const int smem = fastselect_smem(cell, run);
  cudaStream_t s = (cudaStream_t)stream;
  return cell == 32 && run == 4
             ? launch<32, 4>(packed, ld, levels, blocks, n_blocks, cell, run,
                             thr, border, cv, ci, smem, s)
             : launch<0, 0>(packed, ld, levels, blocks, n_blocks, cell, run,
                            thr, border, cv, ci, smem, s);
}
