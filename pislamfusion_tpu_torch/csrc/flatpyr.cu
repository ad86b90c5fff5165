// K1: the flat ORB pyramid, every level straight from level 0.
//
// Replaces pislamfusion_tpu/ops/features/flatpyr_pallas.py
// build_flat_pyramid (pallas_call at :227).
//
// For level l >= 1, with the composed bilinear matrices mr_l [rows, h] and
// mc_l [wp, w] (both rounded to bf16 on the host):
//   t1    = bf16( sum_q mr_l[r, q] * bf16(img[q, x]) )        (row pass)
//   out_l = sum_q t1[r, q] * mc_l[c, q]                        (col pass)
// and level 0's block is the exact f32 edge pad of img.
//
// Bound on the H100: bytes. 1080p / 8 levels reads 8.3 MB and writes a
// 51 MB packed buffer; the banded products are ~0.1 GFLOP. The matrices are
// banded, so each output walks only its row's nonzero span, taken from
// host tables (start, length, weights). Products of two bf16 values are
// exact in f32, so only the summation order differs from a dense product.
// The row pass reads image rows coalesced along x (the 8 MB image stays in
// L2 across the ~14 taps); the column pass reads t1 (bf16) rows whose spans
// advance with the output column, so a warp reads one contiguous stretch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// t1[r, x] for r in [0, R1) (the rows of levels 1..L-1, in packed order).
__global__ void row_pass(const float* __restrict__ img, int w,
                         const int* __restrict__ row_start,
                         const int* __restrict__ row_len,
                         const float* __restrict__ row_w, int kr, int r1,
                         __nv_bfloat16* __restrict__ t1) {
  const int r = blockIdx.y;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= r1 || x >= w) return;
  const int s = row_start[r];
  const int n = row_len[r];
  const float* wt = row_w + (long long)r * kr;
  float acc = 0.f;
  for (int k = 0; k < n; ++k) {
    acc = fmaf(wt[k], round_bf16(img[(long long)(s + k) * w + x]), acc);
  }
  t1[(long long)r * w + x] = __float2bfloat16_rn(acc);
}

// Every packed row p: level 0's edge pad for p < br0, else the column pass
// of t1 row p - br0.
__global__ void col_pass(const float* __restrict__ img, int h, int w,
                         const __nv_bfloat16* __restrict__ t1,
                         const int* __restrict__ row_level,
                         const int* __restrict__ col_start,
                         const int* __restrict__ col_len,
                         const float* __restrict__ col_w, int kc, int wp,
                         int br0, int total_rows, int cell, int pad_left,
                         float* __restrict__ out) {
  const int p = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total_rows || c >= wp) return;
  float v;
  if (p < br0) {
    const int y = min(max(p - cell, 0), h - 1);
    const int x = min(max(c - pad_left, 0), w - 1);
    v = img[(long long)y * w + x];
  } else {
    const int r = p - br0;
    const long long lc = (long long)row_level[r] * wp + c;
    const int s = col_start[lc];
    const int n = col_len[lc];
    const float* wt = col_w + lc * kc;
    const __nv_bfloat16* row = t1 + (long long)r * w + s;
    float acc = 0.f;
    for (int k = 0; k < n; ++k) {
      acc = fmaf(__bfloat162float(row[k]), wt[k], acc);
    }
    v = acc;
  }
  out[(long long)p * wp + c] = v;
}

}  // namespace

extern "C" int flatpyr_launch(const float* img, int h, int w,
                              const int* row_start, const int* row_len,
                              const float* row_w, int kr,
                              const int* row_level, int r1,
                              const int* col_start, const int* col_len,
                              const float* col_w, int kc, int wp, int br0,
                              int total_rows, int cell, int pad_left,
                              void* t1, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  dim3 g1((w + threads - 1) / threads, r1);
  row_pass<<<g1, threads, 0, st>>>(img, w, row_start, row_len, row_w, kr,
                                   r1, (__nv_bfloat16*)t1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2((wp + threads - 1) / threads, total_rows);
  col_pass<<<g2, threads, 0, st>>>(img, h, w, (const __nv_bfloat16*)t1,
                                   row_level, col_start, col_len, col_w, kc,
                                   wp, br0, total_rows, cell, pad_left, out);
  return (int)cudaGetLastError();
}
