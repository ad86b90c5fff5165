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
// Bound on the H100: operations. 1080p / 8 levels reads 6.42 Mpx (25.7 MB)
// and does ~190 f32 subtractions, minima and maxima a pixel. One block of
// RUN warps takes RUN cells of one cell row: it stages their slab (the
// cells, a 1-px NMS halo and FAST's 3-px radius) in shared memory with
// coalesced row reads, computes the halo'd score tile into shared memory,
// and each warp reduces one cell (lanes along x, then a shuffle reduction).
// Pixels outside the level load as 0 and are never read by an unmasked
// score (the border, >= 3, covers FAST's radius; masked scores are 0, as
// the reference's zero-padded cells are). Only subtractions, min and max
// are used, so the result equals the plain version's in any order.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RUN = 4;              // cells a block, one warp each
constexpr int THREADS = RUN * 32;
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

// levels: [L, 6] (oy, ox, lh, lw, ncx, first output cell); blocks:
// [n_blocks, 3] (level, cell row, first cell of the run).
__global__ void fastselect_kernel(const float* __restrict__ packed, int ld,
                                  const int* __restrict__ levels,
                                  const int* __restrict__ blocks, int cell,
                                  float thr, int border,
                                  float* __restrict__ cv,
                                  int* __restrict__ ci) {
  extern __shared__ float smem[];
  const int* bl = blocks + 3 * blockIdx.x;
  const int* lv = levels + 6 * bl[0];
  const int cy = bl[1], cx0 = bl[2];
  const int oy = lv[0], ox = lv[1], lh = lv[2], lw = lv[3], ncx = lv[4];
  const int tw = RUN * cell + 2, th = cell + 2;   // score tile (NMS halo)
  const int sw = tw + 2 * FR, sh = th + 2 * FR;   // slab (FAST radius)
  float* slab = smem;                             // [sh, sw]
  float* s = smem + sh * sw;                      // [th, tw]
  const int ty0 = cy * cell - 1, tx0 = cx0 * cell - 1;   // tile origin
  for (int i = threadIdx.x; i < sh * sw; i += THREADS) {
    const int r = i / sw;
    const int y = ty0 - FR + r, x = tx0 - FR + (i - r * sw);
    slab[i] = (y >= 0 && y < lh && x >= 0 && x < lw)
                  ? packed[(long long)(oy + y) * ld + ox + x]
                  : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < th * tw; i += THREADS) {
    const int r = i / tw, c = i - r * tw;
    const int y = ty0 + r, x = tx0 + c;
    float v = 0.f;
    if (y >= border && y < lh - border && x >= border && x < lw - border) {
      const float sc = fast16(slab + (r + FR) * sw + c + FR, sw);
      v = sc > thr ? sc : 0.f;
    }
    s[i] = v;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cx = cx0 + warp;
  if (cx >= ncx) return;              // warp-uniform; no barrier follows
  const int wp = ncx * cell;
  float bv = -1.f;
  int bi = INT_MAX;
  for (int p = lane; p < cell * cell; p += 32) {
    const int py = p / cell, px = p - py * cell;
    const float* q = s + (py + 1) * tw + warp * cell + px + 1;
    float m = fmaxf(fmaxf(q[-tw - 1], q[-tw]), q[-tw + 1]);
    m = fmaxf(m, fmaxf(q[-1], q[1]));
    m = fmaxf(m, fmaxf(fmaxf(q[tw - 1], q[tw]), q[tw + 1]));
    const float v = q[0] >= m ? q[0] : 0.f;
    const int idx = (cy * cell + py) * wp + cx * cell + px;
    if (v > bv || (v == bv && idx < bi)) {
      bv = v;
      bi = idx;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    const int o = lv[5] + cy * ncx + cx;
    cv[o] = bv;
    ci[o] = bi;
  }
}

}  // namespace

// packed: f32 rows of pitch ld; cv / ci: one entry per cell of every level.
extern "C" int fastselect_launch(const float* packed, int ld,
                                 const int* levels, const int* blocks,
                                 int n_blocks, int cell, float thr,
                                 int border, float* cv, int* ci,
                                 void* stream) {
  const int tw = RUN * cell + 2, th = cell + 2;
  const size_t smem =
      ((size_t)(th + 2 * FR) * (tw + 2 * FR) + (size_t)th * tw) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fastselect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  fastselect_kernel<<<n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      packed, ld, levels, blocks, cell, thr, border, cv, ci);
  return (int)cudaGetLastError();
}
