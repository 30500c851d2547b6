// Steered rBRIEF on the u8-rounded, blurred atlas canvas.
//
// Replaces the TPU kernel pyorbslam_tpu/ops/pallas_kernels.py
// brief_descriptors_canvas (_brief_canvas_kernel): for each keypoint, the
// 256 pattern pairs rotated by the IC angle and rounded half to even
// (reach <= 19 px), both points of each pair sampled from the canvas, and
// bit j of word w set when sample[2p] < sample[2p+1] for pair p = 32w + j.
// Plain twin: pyorbslam_tpu_torch/ops/kernels.py::brief_descriptors_canvas_ref.
//
// What bounds it on an H100: scattered reads.  512 samples per keypoint
// from a 39x39 window anywhere on a 21.6 MB canvas; at 4000 keypoints that
// is 2M four-byte loads, each touching its own 32-byte sector, against a
// few integer ops per sample.  The canvas fits in the 50 MB L2, so the
// gathers are served mostly from L2, not device memory, and at 4000
// keypoints the 500 blocks of 8 warps fill under half of the card's warp
// slots in one wave: the kernel waits on load latency.
//
// What the design does about it: one warp per keypoint.  Lane j computes
// pair 32w + j for w = 0..7, so a warp's 32 loads for one word land in one
// keypoint's window, and __ballot_sync packs word w directly from the 32
// comparisons: no one-hot selection matmul (the TPU form's way of reading
// scattered pixels) and no bit-packing pass.  The pattern sits in shared
// memory.  cos and sin come from the wrapper, computed in torch exactly as
// the twin computes them; the rotated offsets use __fmul_rn / __fadd_rn /
// __fsub_rn so nvcc cannot contract them into an FMA, and __float2int_rn
// rounds half to even like torch.round, so the offsets equal the twin's.
// The pattern load, the rotated offset and the ballot pack are shared with
// brief_level.cu through brief_common.cuh.  Staging each keypoint's window
// in shared memory is later work.
#include "brief_common.cuh"

namespace {

__global__ void brief_canvas_kernel(const float* __restrict__ canvas, int wc,
                                    const int* __restrict__ xy,
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
  const unsigned int mine = brief::warp_descriptor(
      canvas, wc, xy[2 * k], xy[2 * k + 1], pat, cosv[k], sinv[k], lane);
  if (lane < 8) out[8 * k + lane] = static_cast<int>(mine);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = launched).
extern "C" int brief_canvas_launch(const float* canvas, int wc, const int* xy,
                                   const float* cosv, const float* sinv,
                                   const float* pattern, int* out, int n,
                                   void* stream) {
  if (n == 0) return 0;
  dim3 block(32 * brief::kWarps);
  dim3 grid((n + brief::kWarps - 1) / brief::kWarps);
  brief_canvas_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      canvas, wc, xy, cosv, sinv, pattern, out, n);
  return static_cast<int>(cudaGetLastError());
}
