// Device code shared by the two steered-rBRIEF kernels (brief_canvas.cu,
// brief_level.cu): the pattern in shared memory, the rotated and rounded
// pattern offset, and the warp-wide compare-and-pack of one descriptor.
// A warp gathers its keypoint's 512 samples from device memory where they
// lie: 16 independent 4-byte loads a lane, each its own 32-byte sector,
// from rows a whole image pitch apart.  (Staging the 39x39 window that
// holds them in shared memory first was measured slower on an H100;
// brief_level.cu says by how much.)
//
// Exactness contract with the plain PyTorch twins: cos and sin come from
// the wrapper (computed in torch), the rotated offsets use __fmul_rn /
// __fadd_rn / __fsub_rn so nvcc cannot contract them into an FMA, and
// __float2int_rn rounds half to even like torch.round.  Samples are
// picked, never blended, so every packed word equals the twin's.
#pragma once
#include <cuda_runtime.h>

namespace brief {

constexpr int kWarps = 8;         // keypoints per block, one warp each
constexpr int kPatternFloats = 1024;  // 512 (x, y) pattern points

// Copy the 512-point pattern into the block's shared memory.
__device__ __forceinline__ void load_pattern(float* pat,
                                             const float* __restrict__ pattern) {
  for (int i = threadIdx.x; i < kPatternFloats; i += blockDim.x)
    pat[i] = pattern[i];
  __syncthreads();
}

// Sample pattern point j around (x, y) of a row-major image of `stride`
// floats per row, rotated by (a, b) = (cos, sin).
__device__ __forceinline__ float sample(const float* __restrict__ img,
                                        int stride, int x, int y,
                                        const float* pat, int j,
                                        float a, float b) {
  const float px = pat[2 * j];
  const float py = pat[2 * j + 1];
  const int row = __float2int_rn(__fadd_rn(__fmul_rn(px, b), __fmul_rn(py, a)));
  const int col = __float2int_rn(__fsub_rn(__fmul_rn(px, a), __fmul_rn(py, b)));
  return img[(size_t)(y + row) * stride + (x + col)];
}

// One warp, one keypoint: lane j compares pair 32w + j for w = 0..7 and
// __ballot_sync packs word w.  Returns word `lane` in lanes 0..7.
__device__ __forceinline__ unsigned int warp_descriptor(
    const float* __restrict__ img, int stride, int x, int y, const float* pat,
    float a, float b, int lane) {
  unsigned int mine = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int p = 32 * w + lane;
    const float s0 = sample(img, stride, x, y, pat, 2 * p, a, b);
    const float s1 = sample(img, stride, x, y, pat, 2 * p + 1, a, b);
    const unsigned int word = __ballot_sync(0xffffffffu, s0 < s1);
    if (lane == w) mine = word;
  }
  return mine;
}

}  // namespace brief
