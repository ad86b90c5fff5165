// K6: bilinear samples, zero fill, at K x M sub-pixel offsets from integer
// centres, over a 2-channel image.
//
// Replaces pislamfusion_tpu/ops/features/patchgather.py
// bilinear_grid_pallas (pallas_call at :282): SIFT's orientation and
// descriptor grids over the packed gradient image (C = 2, the only
// caller's: sift._sample_grid).
//
// For keypoint k and sample m, with the TPU kernel's slab geometry (origin
// ya, xa in the image padded by R + 2, centre offset dy0, dx0 in the slab;
// ya on 8 rows, xa on XA = 128 / C = 64 columns):
//   ry = rel[k, 1, m] + dy0,  y0 = clip(floor(ry), 0, WH - 2),
//   fy = clip(ry - y0, 0, 1)  (and the same along x with WWpx)
//   A_j = (1 - fy) * v[y0, x0 + j] + fy * v[y0 + 1, x0 + j]
//   out[k, m, c] = (1 - fx) * A_0 + fx * A_1
// where v reads 0 outside the image. Every product and sum is rounded on
// its own (__fmul_rn / __fadd_rn): nvcc would otherwise contract them into
// FMAs, and the kernel would no longer equal its plain version.
//
// Bound on the H100: bytes (the 2 MB output at K = 1000, M = 256, the
// offsets and the pixels the grids cover; ~26 flops a sample), but at
// ~0.002 ms of bytes one call is latency: the offsets, then the taps, two
// dependent trips to memory, and the launch. The design keeps those trips
// few and wide: four warps serve one keypoint; each lane reads the centre
// (a broadcast within the warp) and its offsets in one trip, computes the
// slab geometry with shifts (the alignments being compile-time), takes 2
// samples, reads their offsets as two float2, each tap's two channels as
// one float2 through the read-only path (8 independent loads in flight a
// lane), and writes its 4 output words as one float4. Of the mappings
// tried on an H100 (4 samples a lane with float4 offsets, 4 strided samples
// a lane, one sample a lane), this one was the fastest summed over SIFT's
// two grids.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 2;
constexpr int LOG_XA = 6;            // XA = 128 / C = 64 columns
constexpr int LOG_YA = 3;            // 8 rows
constexpr int LANES = 128;           // threads a keypoint (four warps)
constexpr int KEYS = 2;              // keypoints a block

__device__ __forceinline__ float2 tap(const float2* __restrict__ img, int H,
                                      int W, int y, int x) {
  if (y < 0 || y >= H || x < 0 || x >= W) return make_float2(0.f, 0.f);
  return __ldg(img + (long long)y * W + x);
}

__device__ __forceinline__ float lerp2(float g, float f, float a, float b) {
  return __fadd_rn(__fmul_rn(g, a), __fmul_rn(f, b));
}

__global__ void __launch_bounds__(LANES * KEYS)
    bilineargrid_kernel(const float2* __restrict__ img, int H, int W,
                        const int* __restrict__ centers,
                        const float* __restrict__ rel, int K, int M, int R,
                        int WH, int WWpx, float* __restrict__ out) {
  const int k = blockIdx.x * KEYS + threadIdx.y;
  if (k >= K) return;
  // every lane reads the centre (one broadcast load a warp), issued beside
  // its offsets: the two loads are one trip to memory, not two in turn
  const int2 cen = __ldg(reinterpret_cast<const int2*>(centers) + k);
  const float ymax = (float)(WH - 2);
  const float xmax = (float)(WWpx - 2);
  const float2* rx2 =
      reinterpret_cast<const float2*>(rel + (long long)k * 2 * M);
  const float2* ry2 =
      reinterpret_cast<const float2*>(rel + ((long long)k * 2 + 1) * M);
  float4* o4 = reinterpret_cast<float4*>(out + (long long)k * M * C);
  for (int q = threadIdx.x; q < (M >> 1); q += LANES) {
    const float2 vx = __ldg(rx2 + q);
    const float2 vy = __ldg(ry2 + q);
    const int cx = cen.x + R + 2;
    const int cy = cen.y + R + 2;
    const int ya = ((cy - R) >> LOG_YA) << LOG_YA;   // floor, any sign
    const int xa = ((cx - R) >> LOG_XA) << LOG_XA;
    const float dy0 = (float)(cy - ya);
    const float dx0 = (float)(cx - xa);
    const int oy = ya - (R + 2);       // the slab's origin in the image
    const int ox = xa - (R + 2);
    const float rxs[2] = {vx.x, vx.y};
    const float rys[2] = {vy.x, vy.y};
    float res[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float ry = __fadd_rn(rys[e], dy0);
      const float rx = __fadd_rn(rxs[e], dx0);
      const float y0 = fminf(fmaxf(floorf(ry), 0.f), ymax);
      const float fy = fminf(fmaxf(__fsub_rn(ry, y0), 0.f), 1.f);
      const float x0 = fminf(fmaxf(floorf(rx), 0.f), xmax);
      const float fx = fminf(fmaxf(__fsub_rn(rx, x0), 0.f), 1.f);
      const float hy = __fsub_rn(1.f, fy);
      const float hx = __fsub_rn(1.f, fx);
      const int iy = oy + (int)y0;
      const int ix = ox + (int)x0;
      const float2 v00 = tap(img, H, W, iy, ix);
      const float2 v10 = tap(img, H, W, iy + 1, ix);
      const float2 v01 = tap(img, H, W, iy, ix + 1);
      const float2 v11 = tap(img, H, W, iy + 1, ix + 1);
      res[2 * e] = lerp2(hx, fx, lerp2(hy, fy, v00.x, v10.x),
                         lerp2(hy, fy, v01.x, v11.x));
      res[2 * e + 1] = lerp2(hx, fx, lerp2(hy, fy, v00.y, v10.y),
                             lerp2(hy, fy, v01.y, v11.y));
    }
    o4[q] = make_float4(res[0], res[1], res[2], res[3]);
  }
}

}  // namespace

// img: [H, W, 2] f32, centers: [K, 2] int32 (x, y), rel: [K, 2, M] f32
// (M even), the three 8-byte aligned; out: [K, M, 2] f32.
extern "C" int bilineargrid_launch(const float* img, int H, int W,
                                   const int* centers, const float* rel,
                                   int K, int M, int R, int WH, int WWpx,
                                   float* out, void* stream) {
  const dim3 block(LANES, KEYS);
  const unsigned blocks = (unsigned)((K + KEYS - 1) / KEYS);
  bilineargrid_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(img), H, W, centers, rel, K, M, R, WH,
      WWpx, out);
  return (int)cudaGetLastError();
}
