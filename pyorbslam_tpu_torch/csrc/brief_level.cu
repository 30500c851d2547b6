// Steered rBRIEF on one pyramid level's reflect-padded, blurred image.
//
// Replaces the TPU kernel pyorbslam_tpu/ops/pallas_kernels.py
// brief_descriptors_pallas (_brief_kernel) together with the pair compare
// and bit pack that the JAX package runs after it: for each keypoint of
// the level, the 256 pattern pairs rotated by the IC angle and rounded
// half to even (reach <= 19 px), both points of each pair sampled from
// the padded float image (not rounded to u8), and bit j of word w set
// when sample[2p] < sample[2p+1] for pair p = 32w + j.
// Plain twin: pyorbslam_tpu_torch/ops/orb_descriptor.py::brief_descriptors.
//
// What bounds it on an H100: launch latency, then scattered reads.  A
// level holds a few hundred keypoints (434 at level 0 down to 122 at
// level 7 of a 2000-feature frame), so a launch is 16..55 blocks on 132
// SMs and moves under 1 MB; the per-level path makes 16 such launches a
// frame.  Inside a launch the work is 512 four-byte gathers per keypoint
// from a 39x39 window of an image that sits in L2.
//
// What the design does about it: the TPU form's one-hot selection matmul
// over an aligned 56x256 window (its way to read scattered pixels) is
// dropped; a warp takes one keypoint, each lane reads its own two samples
// per word and __ballot_sync packs the word, so the compare and the bit
// pack happen in the kernel and the (N, 512) sample matrix never reaches
// device memory.  The keypoint's level coordinates are shifted by the pad
// here, so the wrapper passes them as the extractor made them.  One launch
// per level is kept; batching the 16 levels of a frame into one launch is
// later work.
#include "brief_common.cuh"

namespace {

__global__ void brief_level_kernel(const float* __restrict__ padded, int wp,
                                   int border, const int* __restrict__ xy,
                                   const float* __restrict__ cosv,
                                   const float* __restrict__ sinv,
                                   const float* __restrict__ pattern,
                                   int* __restrict__ out, int n) {
  __shared__ float pat[brief::kPatternFloats];
  brief::load_pattern(pat, pattern);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * brief::kWarps + warp;
  if (k >= n) return;  // uniform across the warp
  const int x = xy[2 * k] + border;
  const int y = xy[2 * k + 1] + border;
  const unsigned int mine = brief::warp_descriptor(
      padded, wp, x, y, pat, cosv[k], sinv[k], lane);
  if (lane < 8) out[8 * k + lane] = static_cast<int>(mine);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = launched).
extern "C" int brief_level_launch(const float* padded, int wp, int border,
                                  const int* xy, const float* cosv,
                                  const float* sinv, const float* pattern,
                                  int* out, int n, void* stream) {
  if (n == 0) return 0;
  dim3 block(32 * brief::kWarps);
  dim3 grid((n + brief::kWarps - 1) / brief::kWarps);
  brief_level_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      padded, wp, border, xy, cosv, sinv, pattern, out, n);
  return static_cast<int>(cudaGetLastError());
}
