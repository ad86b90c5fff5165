// K7: the packed serial ORB pyramid, one launch a level l >= 1.
//
// Replaces pislamfusion_tpu/ops/features/pyramid_pallas.py
// build_packed_pyramid (pallas_call at :279).
//
// Level l's block of the packed [total_rows, wpl] f32 buffer, rows
// [base, base + blk_rows): for t < lh + 2r and u < lw + 2r
//   out[t, u] = sum_j col_w[u, j] * (sum_k row_w[t, k] *
//                                    src[row_start[t] + k, col_start[u] + j])
// over each pad-clamp matrix row's nonzero span (host tables), src being
// level l-1's raw pixels (the image for l = 1, else level l-1's block
// interior in the same buffer); 0 elsewhere in the block. The launch of
// level 1 also writes level 0's block (the image edge-padded by r, 0
// beyond) and the zero rows [tail_lo, tail_hi) after the last block.
// Each sum is a chain of fused multiply-adds over the taps in order from
// 0 (__fmaf_rn, rounded once each), as the reference's dense products
// contract; the plain PyTorch version computes each step exactly in
// float64, so the two are equal.
//
// Bound on the H100: bytes. 1080p / 8 levels / r = 21 reads an 8.3 MB
// image and writes a 48.2 MB buffer; each output pixel takes at most 2x2
// taps. One thread an output pixel, neighbouring threads on neighbouring
// lanes: the writes are coalesced and the 2-4 source rows a warp reads sit
// in L1/L2. Level l reads what level l-1's launch wrote, so the launches
// run in stream order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// src and out may point into the same buffer (level l-1's block and level
// l's block are disjoint rows of it), so neither is __restrict__.
__global__ void packedpyr_kernel(
    const float* src, int ld, const int* __restrict__ row_start,
    const int* __restrict__ row_len, const float* __restrict__ row_w, int kr,
    const int* __restrict__ col_start, const int* __restrict__ col_len,
    const float* __restrict__ col_w, int kc, int lh, int lw, int r,
    float* out, int wpl, int base, int blk_rows, int blk0_rows, int h0,
    int w0, int tail_lo) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= wpl) return;
  int y = blockIdx.y;
  long long row;
  float v = 0.f;
  if (y < blk_rows) {                      // level l
    row = base + y;
    if (y < lh + 2 * r && u < lw + 2 * r) {
      const int s0 = row_start[y], nr = row_len[y];
      const float* wr = row_w + (long long)y * kr;
      const int nc = col_len[u];
      const float* wc = col_w + (long long)u * kc;
      const float* col = src + (long long)s0 * ld + col_start[u];
      for (int j = 0; j < nc; ++j) {
        float t1 = 0.f;
        for (int k = 0; k < nr; ++k)
          t1 = __fmaf_rn(wr[k], col[(long long)k * ld + j], t1);
        v = __fmaf_rn(wc[j], t1, v);
      }
    }
  } else if ((y -= blk_rows) < blk0_rows) {   // level 0: the edge pad
    row = y;
    if (y < h0 + 2 * r && u < w0 + 2 * r) {
      const int iy = min(max(y - r, 0), h0 - 1);
      const int ix = min(max(u - r, 0), w0 - 1);
      v = src[(long long)iy * ld + ix];
    }
  } else {                                  // the zero tail
    row = tail_lo + (y - blk0_rows);
  }
  out[row * wpl + u] = v;
}

}  // namespace

// src: level l-1's pixel (0, 0), rows of pitch ld; the tables of level l
// (lh + 2r rows, lw + 2r lanes); out: the packed buffer.
extern "C" int packedpyr_level(
    const float* src, int ld, const int* row_start,
    const int* row_len, const float* row_w, int kr, const int* col_start,
    const int* col_len, const float* col_w, int kc, int lh, int lw, int r,
    float* out, int wpl, int base, int blk_rows, int blk0_rows, int h0,
    int w0, int tail_lo, int tail_hi, void* stream) {
  dim3 grid((wpl + THREADS - 1) / THREADS,
            blk_rows + blk0_rows + (tail_hi - tail_lo));
  packedpyr_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      src, ld, row_start, row_len, row_w, kr, col_start, col_len, col_w, kc,
      lh, lw, r, out, wpl, base, blk_rows, blk0_rows, h0, w0, tail_lo);
  return (int)cudaGetLastError();
}
