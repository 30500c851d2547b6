// Device code shared by the two steered-rBRIEF kernels (brief_canvas.cu,
// brief_level.cu): a lane's share of the pattern in registers, the rotated
// and rounded pattern offset, and the warp-wide compare-and-pack of one
// descriptor.
//
// One warp makes one descriptor.  Lane l only ever compares pairs 32w + l
// (w = 0..7), and the pattern as stored (point j at floats 2j, 2j + 1) keeps
// pair p in float4 number p = (x0, y0, x1, y1).  So a lane reads its eight
// float4s straight from device memory, 512 contiguous bytes a warp-load,
// before anything else: no shared memory, no block barrier, and the reads
// fly together with the keypoint's own coordinates and angle.  The 4 KiB
// pattern is the same for every warp and stays in L1 / L2.  Then the lane
// computes its 16 sample addresses, starts the 16 four-byte gathers from the
// image where the samples lie (a 39x39 window that sits in L2; all loads of
// a lane independent), and only then compares: eight __ballot_sync pack the
// eight words.  (Staging the window in shared memory first was measured
// slower on an H100; brief_level.cu says by how much.)
//
// Exactness contract with the plain PyTorch twins: cos and sin come from
// the wrapper (computed in torch), the rotated offsets use __fmul_rn /
// __fadd_rn / __fsub_rn so nvcc cannot contract them into an FMA, and
// __float2int_rn rounds half to even like torch.round.  Samples are
// picked, never blended, so every packed word equals the twin's.
#pragma once
#include <cuda_runtime.h>

namespace brief {

constexpr int kWords = 8;  // 32-bit words of a descriptor, 32 pairs each

// The lane's eight pattern pairs: pair 32w + lane is float4 number
// 32w + lane of the 1024-float pattern (16-byte aligned).
struct LanePattern {
  float4 pair[kWords];
};

__device__ __forceinline__ LanePattern load_lane_pattern(
    const float* __restrict__ pattern, int lane) {
  const float4* p4 = reinterpret_cast<const float4*>(pattern);
  LanePattern lp;
#pragma unroll
  for (int w = 0; w < kWords; ++w) lp.pair[w] = __ldg(p4 + 32 * w + lane);
  return lp;
}

// Offset, in floats, of pattern point (px, py) rotated by (a, b) =
// (cos, sin) from the keypoint's pixel in a row-major image of `stride`
// floats per row.
__device__ __forceinline__ int sample_offset(float px, float py, float a,
                                             float b, int stride) {
  const int row = __float2int_rn(__fadd_rn(__fmul_rn(px, b), __fmul_rn(py, a)));
  const int col = __float2int_rn(__fsub_rn(__fmul_rn(px, a), __fmul_rn(py, b)));
  return row * stride + col;
}

// One warp, one keypoint at (x, y) of `img`: lane j compares pair 32w + j
// for w = 0..7 and __ballot_sync packs word w.  All 16 samples of the lane
// are loaded before the first comparison.  Returns word `lane` in lanes 0..7.
__device__ __forceinline__ unsigned int warp_descriptor(
    const float* __restrict__ img, int stride, int x, int y,
    const LanePattern& lp, float a, float b, int lane) {
  const float* at = img + (size_t)y * stride + x;
  float s0[kWords], s1[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const float4 q = lp.pair[w];
    s0[w] = __ldg(at + sample_offset(q.x, q.y, a, b, stride));
    s1[w] = __ldg(at + sample_offset(q.z, q.w, a, b, stride));
  }
  unsigned int mine = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const unsigned int word = __ballot_sync(0xffffffffu, s0[w] < s1[w]);
    if (lane == w) mine = word;
  }
  return mine;
}

}  // namespace brief
