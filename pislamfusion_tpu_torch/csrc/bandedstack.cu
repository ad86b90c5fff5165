// K5: P banded sandwiches of one image, out[p] = mhs[p] @ x @ mws[p]^T.
//
// Replaces pislamfusion_tpu/ops/stencil_pallas.py banded_stack_pallas
// (pallas_call in _stack_call at :338): SIFT's Gaussian octave stack.
//
// With the nonzero span of each operator row from host tables
// (ops/stencil.py):
//   t1[p, y, c]  = sum_k row_w[p, y, k] * x[row_start[p, y] + k, c]  (rows)
//   out[p, y, x] = sum_k col_w[p, x, k] * t1[p, y, col_start[p, x] + k]
// all in f32 (the TPU kernel ran at Precision.HIGHEST; no TF32 here).
//
// Bound on the H100: operations. Octave 0 at 1080p is ~1.43 GFLOP of f32
// multiply-adds against ~50 MB of traffic. One block owns a 32x32 output
// tile of every scale: it stages the tile's input slab (the union of all
// scales' row and column spans, at most (32 + 2 * 33)^2 floats at the
// default SIFT chain) in shared memory once, then for each scale runs the
// row pass over the slab's columns into shared memory and the column pass
// from there to HBM. The input is read from HBM about once per tile and
// the row-pass intermediate never leaves the SM, which is what the TPU
// kernel's slab DMA did. Threads of a warp read consecutive shared words
// in both passes; row weights are warp-wide broadcasts and column weights
// (stored [P, KC, w]) coalesced loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;

__global__ void bandedstack_kernel(
    const float* __restrict__ x, int h, int w, int P,
    const int* __restrict__ row_start, const int* __restrict__ row_len,
    const float* __restrict__ row_w, int kr,
    const int* __restrict__ col_start, const int* __restrict__ col_len,
    const float* __restrict__ col_wt, int kc,
    const int* __restrict__ tile_r0, const int* __restrict__ tile_rn,
    const int* __restrict__ tile_c0, const int* __restrict__ tile_cn,
    int sc, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int rn = tile_rn[blockIdx.y];
  float* slab = smem;               // [rn, sc]
  float* t1 = smem + rn * sc;       // [TILE, sc]
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const int r0 = tile_r0[blockIdx.y];
  const int c0 = tile_c0[blockIdx.x];
  const int cn = tile_cn[blockIdx.x];
  for (int i = threadIdx.x; i < rn * cn; i += blockDim.x) {
    const int r = i / cn;
    const int c = i - r * cn;
    slab[r * sc + c] = x[(long long)(r0 + r) * w + c0 + c];
  }
  __syncthreads();
  const long long plane = (long long)h * w;
  for (int p = 0; p < P; ++p) {
    for (int i = threadIdx.x; i < TILE * cn; i += blockDim.x) {
      const int ty = i / cn;
      const int c = i - ty * cn;
      const int y = y0 + ty;
      float acc = 0.f;
      if (y < h) {
        const long long pr = (long long)p * h + y;
        const float* src = slab + (row_start[pr] - r0) * sc + c;
        const float* wt = row_w + pr * kr;
        const int n = row_len[pr];
        for (int k = 0; k < n; ++k) acc = fmaf(wt[k], src[k * sc], acc);
      }
      t1[ty * sc + c] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) {
      const int ty = i / TILE;
      const int xo = x0 + (i - ty * TILE);
      const int y = y0 + ty;
      if (y < h && xo < w) {
        const long long pc = (long long)p * w + xo;
        const float* src = t1 + ty * sc + (col_start[pc] - c0);
        const float* wt = col_wt + (long long)p * kc * w + xo;
        const int n = col_len[pc];
        float acc = 0.f;
        for (int k = 0; k < n; ++k) {
          acc = fmaf(wt[(long long)k * w], src[k], acc);
        }
        out[p * plane + (long long)y * w + xo] = acc;
      }
    }
    __syncthreads();   // the next scale's row pass overwrites t1
  }
}

}  // namespace

// sr, sc: the largest tile_rn and tile_cn (the shared-memory row pitch).
extern "C" int bandedstack_launch(
    const float* x, int h, int w, int P, const int* row_start,
    const int* row_len, const float* row_w, int kr, const int* col_start,
    const int* col_len, const float* col_wt, int kc, const int* tile_r0,
    const int* tile_rn, const int* tile_c0, const int* tile_cn, int sr,
    int sc, float* out, void* stream) {
  const size_t smem = (size_t)(sr + TILE) * sc * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bandedstack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  bandedstack_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, h, w, P, row_start, row_len, row_w, kr, col_start, col_len, col_wt,
      kc, tile_r0, tile_rn, tile_c0, tile_cn, sc, out);
  return (int)cudaGetLastError();
}
