// FAST-9/16 corner strength over a list of float32 images in one launch:
// the atlas canvas alone, or the 16 pyramid-level images of a stereo frame.
//
// Replaces the TPU kernel pyorbslam_tpu/ops/pallas_kernels.py
// fast_score_map_pallas (_fast_kernel): for each pixel, the 16
// Bresenham-circle differences (circle minus centre); for bright and for
// dark, the max over the 16 circular 9-arcs of the arc minimum; clamped
// at 0.  Plain twin: pyorbslam_tpu_torch/ops/fast.py::fast_score_map, once
// per image.
//
// What bounds it on an H100: the rate of min/max, not device memory.
// A pixel moves 8 bytes (43 MB for a 4224x1279 canvas, 12.9 us at
// 3.35 TB/s) and needs, in the least form with two-input operations, 158
// min/max and 5 others (13.1 us at the data sheet's 67e12 FP32 operations a
// second, which counts a multiply-add as two).  Measured, the card retires
// about 8.5e12 two-input min/max a second: a float form of this kernel and
// the one-pixel-a-thread kernel before it both took 0.10 ms for the canvas'
// 853 M min/max, whatever else they did.  With three-input min/max the
// count halves and the bytes govern the bound.  For the 16 level images of
// a frame (36k..467k pixels each) the bound is the launch: 16 launches cost
// more than their work.
//
// What the design does about it:
//  * Rounding is monotone, so min_i fl(p_i - c) = fl(min_i p_i - c): the
//    arc searches run on the raw pixel values and the centre is subtracted
//    once per polarity, not 16 times; the dark polarity is
//    -(min over arcs of arc max - c), so one value is negated, not 16.
//  * The tile is staged as order-preserving integer keys (two ALU ops per
//    staged pixel), so that the searches use Hopper's three-input integer
//    min/max (__vimin3_s32 / __vimax3_s32): 80 operations a pixel
//    instead of 158, which is where the time goes (0.065 ms against 0.10
//    with floats and fminf/fmaxf).
//  * Register tiling: a thread makes a 4 x 1 patch of outputs from a 7 x 12
//    window it loads with 16-byte shared-memory reads (21 for 4 pixels,
//    against 17 four-byte reads a pixel before); the circle positions are
//    then compile-time register picks with no addressing.  64 registers, 4
//    blocks an SM; a 4 x 2 patch took 98 registers and more time.
//  * A 64 x 16 output tile a block: the 3-pixel halo costs 1.5x instead of
//    2.1x.  A warp stages one row per pass, with 16-byte loads where the
//    row is aligned and inside the image (the canvas interior) and clamped
//    scalar loads elsewhere (level images, whose pitch is odd, and every
//    image's edge).  Clamping is the twin's mode="replicate" padding, so
//    the result equals the twin on every pixel, border included: min, max
//    and the one subtraction are exact.
//  * The image table (pointers, sizes, tile prefix) travels by value in the
//    kernel's parameters; a block finds its image by scanning at most 16
//    prefix entries, so one launch serves all 16 level images of a frame.
//  * No early-out.  Every 9-arc holds two of the four compass pixels, so a
//    warp in which no pixel has two compass values on one side of its
//    centre could skip the searches; a third of the canvas' warp passes
//    could, and measured it does not pay: the test costs the other two
//    thirds more than the skip saves.
// The times are from an H100 at 700 W (PERF.md says which runs).  Inputs
// must be finite (no NaN), as images are.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxImages = 16;

extern "C" {
struct FastImage {
  const float* img;
  float* out;
  int h;
  int w;
  int tiles_x;   // tiles along x               (filled in by the launch
  int tile_end;  // first tile after this image's  function, not the caller)
};
struct FastTable {
  FastImage im[kMaxImages];
  int n;
};
}

namespace {

constexpr int PX = 4;          // outputs a thread makes, along x
constexpr int NTX = 16;        // threads along x
constexpr int NTY = 16;        // threads along y
constexpr int THREADS = NTX * NTY;
constexpr int TILE_W = NTX * PX;
constexpr int TILE_H = NTY;
constexpr int HALO = 3;
constexpr int PADL = 4;        // staged columns start at x0 - 4: 16-byte aligned
constexpr int SW = TILE_W + 2 * PADL;
constexpr int SH = TILE_H + 2 * HALO;
constexpr int WIN_H = 1 + 2 * HALO;
constexpr int WIN_W = PX + 2 * PADL;

typedef int val_t;
// float -> int whose signed order is the float order (and back: the map is
// its own inverse)
__device__ __forceinline__ int flip(int b) { return b ^ ((b >> 31) & 0x7fffffff); }
__device__ __forceinline__ val_t to_val(float f) { return flip(__float_as_int(f)); }
__device__ __forceinline__ float from_val(val_t v) { return __int_as_float(flip(v)); }
__device__ __forceinline__ val_t mn3(val_t a, val_t b, val_t c) { return __vimin3_s32(a, b, c); }
__device__ __forceinline__ val_t mx3(val_t a, val_t b, val_t c) { return __vimax3_s32(a, b, c); }
__device__ __forceinline__ val_t mn2(val_t a, val_t b) { return min(a, b); }
__device__ __forceinline__ val_t mx2(val_t a, val_t b) { return max(a, b); }

// max over the 16 circular 9-arcs of the arc minimum (BRIGHT), or min over
// the arcs of the arc maximum: m3 -> m9 -> reduce, 16 + 16 + 8 three-input ops
template <bool BRIGHT>
__device__ __forceinline__ val_t arc_search(const val_t (&v)[16]) {
  val_t m3[16], m9[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    m3[i] = BRIGHT ? mn3(v[i], v[(i + 1) & 15], v[(i + 2) & 15])
                   : mx3(v[i], v[(i + 1) & 15], v[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    m9[i] = BRIGHT ? mn3(m3[i], m3[(i + 3) & 15], m3[(i + 6) & 15])
                   : mx3(m3[i], m3[(i + 3) & 15], m3[(i + 6) & 15]);
  val_t a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    a[i] = BRIGHT ? mx3(m9[3 * i], m9[3 * i + 1], m9[3 * i + 2])
                  : mn3(m9[3 * i], m9[3 * i + 1], m9[3 * i + 2]);
  if (BRIGHT) return mx2(mx3(a[0], a[1], a[2]), mx3(a[3], a[4], m9[15]));
  return mn2(mn3(a[0], a[1], a[2]), mn3(a[3], a[4], m9[15]));
}

struct alignas(16) val4 { val_t x, y, z, w; };

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(THREADS)
fast_score_kernel(const __grid_constant__ FastTable tab) {
  // (dx, dy) of the 16 circle pixels, OpenCV order (ops/fast.py CIRCLE_OFFSETS)
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int kDy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  __shared__ __align__(16) val_t tile[SH][SW];

  // which image, and which tile of it
  const int b = blockIdx.x;
  int k = 0;
  while (k < tab.n - 1 && b >= tab.im[k].tile_end) ++k;
  const int first_tile = k ? tab.im[k - 1].tile_end : 0;
  const float* __restrict__ img = tab.im[k].img;
  float* __restrict__ out = tab.im[k].out;
  const int h = tab.im[k].h;
  const int w = tab.im[k].w;
  const int tiles_x = tab.im[k].tiles_x;
  const int t = b - first_tile;
  const int tile_y = t / tiles_x;
  const int x0 = (t - tile_y * tiles_x) * TILE_W;
  const int y0 = tile_y * TILE_H;

  // stage rows y0-3 .. y0+TILE_H+2, columns x0-4 .. x0+TILE_W+3, one row
  // per warp pass, clamped to the image (the twin's replicate padding)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool vec_in = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0 &&
                      x0 >= PADL && x0 + TILE_W + PADL <= w;
  for (int r = warp; r < SH; r += THREADS / 32) {
    const float* __restrict__ row = img + (size_t)clampi(y0 + r - HALO, 0, h - 1) * w;
    if (vec_in) {
      if (lane < SW / 4) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(row + x0 - PADL) + lane);
        *reinterpret_cast<val4*>(&tile[r][4 * lane]) =
            val4{to_val(f.x), to_val(f.y), to_val(f.z), to_val(f.w)};
      }
    } else {
      for (int c = lane; c < SW; c += 32)
        tile[r][c] = to_val(__ldg(row + clampi(x0 - PADL + c, 0, w - 1)));
    }
  }
  __syncthreads();

  // the thread's window: rows ly .. ly+6, columns 4*lx .. 4*lx+11 of the
  // staged tile; output px has its centre at win[3][px + 4]
  const int lx = threadIdx.x & (NTX - 1);
  const int ly = threadIdx.x / NTX;
  val_t win[WIN_H][WIN_W];
#pragma unroll
  for (int r = 0; r < WIN_H; ++r) {
#pragma unroll
    for (int q = 0; q < WIN_W / 4; ++q) {
      const val4 v = *reinterpret_cast<const val4*>(&tile[ly + r][4 * (lx + q)]);
      win[r][4 * q] = v.x;
      win[r][4 * q + 1] = v.y;
      win[r][4 * q + 2] = v.z;
      win[r][4 * q + 3] = v.w;
    }
  }

  float score[PX];
#pragma unroll
  for (int px = 0; px < PX; ++px) {
    val_t v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = win[HALO + kDy[i]][px + PADL + kDx[i]];
    const float cf = from_val(win[HALO][px + PADL]);
    const float bright = __fsub_rn(from_val(arc_search<true>(v)), cf);
    const float dark = -__fsub_rn(from_val(arc_search<false>(v)), cf);
    score[px] = fmaxf(fmaxf(bright, dark), 0.0f);
  }
  const int x = x0 + PX * lx;
  const int y = y0 + ly;
  if (y < h && x < w) {
    float* __restrict__ dst = out + (size_t)y * w + x;
    if ((w & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(score[0], score[1], score[2], score[3]);
    } else {
#pragma unroll
      for (int px = 0; px < PX; ++px)
        if (x + px < w) dst[px] = score[px];
    }
  }
}

}  // namespace

// One launch on `stream` over every tile of the `in->n` images (img, out,
// h, w of each entry); returns cudaGetLastError() as an int (0 = launched).
extern "C" int fast_score_launch(const FastTable* in, void* stream) {
  if (in->n < 1 || in->n > kMaxImages) return static_cast<int>(cudaErrorInvalidValue);
  FastTable tab = *in;
  int tiles = 0;
  for (int i = 0; i < tab.n; ++i) {
    FastImage& im = tab.im[i];
    im.tiles_x = (im.w + TILE_W - 1) / TILE_W;
    tiles += im.tiles_x * ((im.h + TILE_H - 1) / TILE_H);
    im.tile_end = tiles;
  }
  if (tiles == 0) return 0;
  fast_score_kernel<<<tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(tab);
  return static_cast<int>(cudaGetLastError());
}
