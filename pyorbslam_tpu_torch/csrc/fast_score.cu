// FAST-9/16 corner strength over a float32 image (the atlas canvas).
//
// Replaces the TPU kernel pyorbslam_tpu/ops/pallas_kernels.py
// fast_score_map_pallas (_fast_kernel): for each pixel, the 16
// Bresenham-circle differences (circle minus centre); for bright and for
// dark, the max over the 16 circular 9-arcs of the arc minimum; clamped
// at 0.  Plain twin: pyorbslam_tpu_torch/ops/fast.py::fast_score_map.
//
// What bounds it on an H100: instruction issue, not device memory.  A
// pixel moves 8 bytes (one f32 read, one f32 write; 43 MB for a 4224x1279
// canvas, about 13 us at 3.35 TB/s) but costs about 160 float min/max
// plus 16 subtractions, and min/max issue at half the FP32 add rate, so
// the arithmetic floor is several times the memory floor.
//
// What the design does about it: one thread per output pixel in a 32x8
// block; the block stages its tile plus a 3-pixel halo in shared memory,
// so each input pixel is read from device memory about once instead of 17
// times, and the 16 differences stay in registers.  Halo reads clamp to
// the image edge, which is the twin's mode="edge" padding, so the result
// equals the twin on every pixel, border included (min and max are exact;
// there is no rounding to disagree on).  The Pallas form's wrapped-column
// border is not reproduced.
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int HALO = 3;
constexpr int TW = BX + 2 * HALO;
constexpr int TH = BY + 2 * HALO;

// (dx, dy) of the 16 circle pixels, OpenCV order (ops/fast.py CIRCLE_OFFSETS)
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

__device__ __forceinline__ float arc_strength(const float (&v)[16]) {
  float m3[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    m3[i] = fminf(fminf(v[i], v[(i + 1) & 15]), v[(i + 2) & 15]);
  float best = fminf(fminf(m3[0], m3[3]), m3[6]);
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    float m9 = fminf(fminf(m3[i], m3[(i + 3) & 15]), m3[(i + 6) & 15]);
    best = fmaxf(best, m9);
  }
  return best;
}

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int h, int w) {
  __shared__ float tile[TH][TW];
  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BY;
  for (int i = threadIdx.y * BX + threadIdx.x; i < TH * TW; i += BX * BY) {
    const int ty = i / TW;
    const int tx = i - ty * TW;
    const int gy = min(max(y0 + ty - HALO, 0), h - 1);
    const int gx = min(max(x0 + tx - HALO, 0), w - 1);
    tile[ty][tx] = img[(size_t)gy * w + gx];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  const int cy = threadIdx.y + HALO;
  const int cx = threadIdx.x + HALO;
  const float c = tile[cy][cx];
  float d[16], nd[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    d[i] = tile[cy + kDy[i]][cx + kDx[i]] - c;
    nd[i] = -d[i];
  }
  const float score = fmaxf(arc_strength(d), arc_strength(nd));
  out[(size_t)y * w + x] = fmaxf(score, 0.0f);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = launched).
extern "C" int fast_score_launch(const float* img, float* out, int h, int w,
                                 void* stream) {
  dim3 block(BX, BY);
  dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
