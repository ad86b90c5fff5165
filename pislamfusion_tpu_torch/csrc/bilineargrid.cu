// K6: bilinear samples, zero fill, at K x M sub-pixel offsets from integer
// centres.
//
// Replaces pislamfusion_tpu/ops/features/patchgather.py
// bilinear_grid_pallas (pallas_call at :282): SIFT's orientation and
// descriptor grids over the packed gradient image.
//
// For keypoint k and sample m, with the TPU kernel's slab geometry (origin
// ya, xa in the image padded by R + 2, centre offset dy0, dx0 in the slab):
//   ry = rel[k, 1, m] + dy0,  y0 = clip(floor(ry), 0, WH - 2),
//   fy = clip(ry - y0, 0, 1)  (and the same along x with WWpx)
//   A_j = (1 - fy) * v[y0, x0 + j] + fy * v[y0 + 1, x0 + j]
//   out[k, m, c] = (1 - fx) * A_0 + fx * A_1
// where v reads 0 outside the image. Every product and sum is rounded on
// its own (__fmul_rn / __fadd_rn): nvcc would otherwise contract them into
// FMAs, and the kernel would no longer equal its plain version.
//
// Bound on the H100: bytes (the 2 MB output at K = 1000, M = 256, C = 2,
// the offsets and the pixels the grids cover; ~20 flops a sample). One
// thread per (keypoint, sample): consecutive threads take consecutive
// samples of one keypoint, read their offsets coalesced and their taps
// from the few rows around the keypoint, which stay in L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ float tap(const float* __restrict__ img, int H,
                                     int W, int C, int y, int x, int c) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0.f;
  return img[((long long)y * W + x) * C + c];
}

__global__ void bilineargrid_kernel(const float* __restrict__ img, int H,
                                    int W, int C,
                                    const int* __restrict__ centers,
                                    const float* __restrict__ rel, int K,
                                    int M, int R, int WH, int XA, int WWpx,
                                    float* __restrict__ out) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= (long long)K * M) return;
  const int k = (int)(e / M);
  const int m = (int)(e - (long long)k * M);
  const int cy = centers[2 * k + 1] + R + 2;
  const int cx = centers[2 * k] + R + 2;
  const int ya = floor_div(cy - R, 8) * 8;
  const int xa = floor_div(cx - R, XA) * XA;
  const float ry = __fadd_rn(rel[((long long)k * 2 + 1) * M + m],
                             (float)(cy - ya));
  const float rx = __fadd_rn(rel[((long long)k * 2) * M + m],
                             (float)(cx - xa));
  const float y0 = fminf(fmaxf(floorf(ry), 0.f), (float)(WH - 2));
  const float fy = fminf(fmaxf(__fsub_rn(ry, y0), 0.f), 1.f);
  const float x0 = fminf(fmaxf(floorf(rx), 0.f), (float)(WWpx - 2));
  const float fx = fminf(fmaxf(__fsub_rn(rx, x0), 0.f), 1.f);
  const float gy = __fsub_rn(1.f, fy);
  const float gx = __fsub_rn(1.f, fx);
  const int iy = ya + (int)y0 - (R + 2);
  const int ix = xa + (int)x0 - (R + 2);
  for (int c = 0; c < C; ++c) {
    const float a0 =
        __fadd_rn(__fmul_rn(gy, tap(img, H, W, C, iy, ix, c)),
                  __fmul_rn(fy, tap(img, H, W, C, iy + 1, ix, c)));
    const float a1 =
        __fadd_rn(__fmul_rn(gy, tap(img, H, W, C, iy, ix + 1, c)),
                  __fmul_rn(fy, tap(img, H, W, C, iy + 1, ix + 1, c)));
    out[e * C + c] = __fadd_rn(__fmul_rn(gx, a0), __fmul_rn(fx, a1));
  }
}

}  // namespace

extern "C" int bilineargrid_launch(const float* img, int H, int W, int C,
                                   const int* centers, const float* rel,
                                   int K, int M, int R, int WH, int XA,
                                   int WWpx, float* out, void* stream) {
  const int threads = 256;
  const long long total = (long long)K * M;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  bilineargrid_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      img, H, W, C, centers, rel, K, M, R, WH, XA, WWpx, out);
  return (int)cudaGetLastError();
}
