// K8: one banded sandwich per channel, out[b, :, :, c] = mh @ x[b, :, :, c] @ mw^T.
//
// Replaces pislamfusion_tpu/ops/stencil_pallas.py banded_sandwich_pallas
// (pallas_call in _sandwich_call at :178): the separable stencils of
// ops/image.py's `_matmul_sep`. Here it serves every pyrDown and pyrUp
// (image.pyr_down / pyr_up), so the Laplacian pyramids of the mosaic feed,
// the weight pyramids and the canvas reconstruction.
//
// With the nonzero span of each matrix row from host tables
// (ops/stencil.py SandwichTables):
//   t1[y, q]      = sum_k row_w[y, k] * x[row_start[y] + k, q]     (rows)
//   out[y, xo, c] = sum_k col_w[xo, k] * t1[y, col_start[xo] + k, c]
// with q = (column, channel) interleaved as in memory. Every product and
// every sum is rounded on its own (__fmul_rn / __fadd_rn, never an FMA) and
// the taps are summed in order from 0.f, which is exactly what the plain
// PyTorch version's separate tensor operations do: the two are equal, not
// merely close. No TF32 (the TPU kernel ran at Precision.HIGHEST).
//
// Bound on the H100: bytes. A 1536^2 x 3 pyrDown reads 28.3 MB and writes
// 7.1 MB against ~0.2 GFLOP. One block owns a 32x32-pixel output tile
// with all its channels: it stages the tile's input slab (the union of its
// rows' and columns' spans, 67 x 67 pixels for pyrDown, 18 x 18 for pyrUp)
// in shared memory with coalesced row reads, runs the row pass from there
// into shared memory and the column pass out to device memory, so the
// row-pass intermediate never leaves the SM, which is what the TPU kernel
// kept in VMEM. Neighbouring threads read neighbouring shared words in the
// row pass and write neighbouring output words in the column pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;

__global__ void bandedsandwich_kernel(
    const float* __restrict__ x, int H, int W, int C, int Ho, int Wo,
    const int* __restrict__ row_start, const int* __restrict__ row_len,
    const float* __restrict__ row_w, int kr,
    const int* __restrict__ col_start, const int* __restrict__ col_len,
    const float* __restrict__ col_w, int kc,
    const int* __restrict__ tile_r0, const int* __restrict__ tile_rn,
    const int* __restrict__ tile_c0, const int* __restrict__ tile_cn,
    int pitch, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int rn = tile_rn[blockIdx.y];
  float* slab = smem;                 // [rn, pitch]: input rows x (col, ch)
  float* t1 = smem + rn * pitch;      // [TILE, pitch]: row-pass result
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const int r0 = tile_r0[blockIdx.y];
  const int c0 = tile_c0[blockIdx.x];
  const int qn = tile_cn[blockIdx.x] * C;   // live words of a slab row
  const float* xb = x + (long long)blockIdx.z * H * W * C;
  float* ob = out + (long long)blockIdx.z * Ho * Wo * C;
  for (int i = threadIdx.x; i < rn * qn; i += blockDim.x) {
    const int r = i / qn;
    const int q = i - r * qn;
    slab[r * pitch + q] = xb[((long long)(r0 + r) * W + c0) * C + q];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * qn; i += blockDim.x) {
    const int ty = i / qn;
    const int q = i - ty * qn;
    const int y = y0 + ty;
    float acc = 0.f;
    if (y < Ho) {
      const float* src = slab + (row_start[y] - r0) * pitch + q;
      const float* wt = row_w + (long long)y * kr;
      const int n = row_len[y];
      for (int k = 0; k < n; ++k)
        acc = __fadd_rn(acc, __fmul_rn(wt[k], src[k * pitch]));
    }
    t1[ty * pitch + q] = acc;
  }
  __syncthreads();
  const int tc = TILE * C;
  for (int i = threadIdx.x; i < TILE * tc; i += blockDim.x) {
    const int ty = i / tc;
    const int r = i - ty * tc;
    const int xl = r / C;
    const int c = r - xl * C;
    const int y = y0 + ty;
    const int xo = x0 + xl;
    if (y < Ho && xo < Wo) {
      const float* src = t1 + ty * pitch + (col_start[xo] - c0) * C + c;
      const float* wt = col_w + (long long)xo * kc;
      const int n = col_len[xo];
      float acc = 0.f;
      for (int k = 0; k < n; ++k)
        acc = __fadd_rn(acc, __fmul_rn(wt[k], src[k * C]));
      ob[((long long)y * Wo + xo) * C + c] = acc;
    }
  }
}

}  // namespace

// x: [B, H, W, C] f32, out: [B, Ho, Wo, C] f32, both contiguous. sr: the
// largest tile_rn; pitch: the largest tile_cn times C (the shared-memory
// row pitch in floats).
extern "C" int bandedsandwich_launch(
    const float* x, int B, int H, int W, int C, int Ho, int Wo,
    const int* row_start, const int* row_len, const float* row_w, int kr,
    const int* col_start, const int* col_len, const float* col_w, int kc,
    const int* tile_r0, const int* tile_rn, const int* tile_c0,
    const int* tile_cn, int sr, int pitch, float* out, void* stream) {
  const size_t smem = (size_t)(sr + TILE) * pitch * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bandedsandwich_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Wo + TILE - 1) / TILE, (Ho + TILE - 1) / TILE, B);
  bandedsandwich_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, H, W, C, Ho, Wo, row_start, row_len, row_w, kr, col_start, col_len,
      col_w, kc, tile_r0, tile_rn, tile_c0, tile_cn, pitch, out);
  return (int)cudaGetLastError();
}
