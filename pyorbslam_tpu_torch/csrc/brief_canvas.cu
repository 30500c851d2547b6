// Steered rBRIEF on the u8-rounded, blurred atlas canvas.
//
// Replaces the TPU kernel pyorbslam_tpu/ops/pallas_kernels.py
// brief_descriptors_canvas (_brief_canvas_kernel): for each keypoint, the
// 256 pattern pairs rotated by the IC angle and rounded half to even
// (reach <= 19 px), both points of each pair sampled from the canvas, and
// bit j of word w set when sample[2p] < sample[2p+1] for pair p = 32w + j.
// Plain twin: pyorbslam_tpu_torch/ops/kernels.py::brief_descriptors_canvas_ref.
//
// What bounds it on an H100: scattered reads and the launch itself.  512
// samples per keypoint from a 39x39 window anywhere on a 21.6 MB canvas; at
// 4000 keypoints that is 2M four-byte loads, each touching its own 32-byte
// sector, against a few integer ops per sample.  The canvas fits in the 50
// MB L2, so the gathers are served from L2 and L1, not device memory.  The
// whole job is one wave of ~4000 warps whose time is a chain of dependent
// memory round trips (keypoint -> samples -> store) on top of what the card
// takes to start any grid of this size (brief_canvas_floor_launch below
// measures that share).
//
// What the design does about it: one warp per keypoint, nothing shared
// between warps.  A lane reads its own eight pattern pairs into registers
// with 16-byte loads (brief_common.cuh) while the keypoint's coordinates,
// cos and sin are on their way, so the chain is two round trips, not the
// three of a block that first fills shared memory with the pattern and
// waits at a barrier.  All 16 sample loads of a lane are started before the
// first comparison; __ballot_sync packs word w directly from the 32
// comparisons: no one-hot selection matmul (the TPU form's way of reading
// scattered pixels) and no bit-packing pass.  Without shared memory the
// block size is a pure launch parameter (the kernel reads blockDim), so the
// launch function takes it and a run can time 1, 2, 4 and 8 warps a block on
// the same binary; kernels.py passes the one that measured best.  The
// exactness contract (cos and sin from the wrapper, no FMA, half to even)
// and the body are brief_common.cuh's, shared with brief_level.cu.
#include "brief_common.cuh"

namespace {

__global__ void brief_canvas_kernel(const float* __restrict__ canvas, int wc,
                                    const int* __restrict__ xy,
                                    const float* __restrict__ cosv,
                                    const float* __restrict__ sinv,
                                    const float* __restrict__ pattern,
                                    int* __restrict__ out, int n) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (k >= n) return;  // uniform across the warp
  const brief::LanePattern lp = brief::load_lane_pattern(pattern, lane);
  const int2 p = __ldg(reinterpret_cast<const int2*>(xy) + k);
  const unsigned int mine = brief::warp_descriptor(
      canvas, wc, p.x, p.y, lp, __ldg(cosv + k), __ldg(sinv + k), lane);
  if (lane < brief::kWords) out[brief::kWords * k + lane] = static_cast<int>(mine);
}

// The same grid with no work: what the card takes to start and retire it.
__global__ void brief_canvas_floor_kernel(int n) {}

inline bool bad_warps(int warps) { return warps < 1 || warps > 32; }

}  // namespace

// Launch on `stream` with `warps` warps (keypoints) a block; returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int brief_canvas_launch(const float* canvas, int wc, const int* xy,
                                   const float* cosv, const float* sinv,
                                   const float* pattern, int* out, int n,
                                   int warps, void* stream) {
  if (bad_warps(warps)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  brief_canvas_kernel<<<(n + warps - 1) / warps, 32 * warps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      canvas, wc, xy, cosv, sinv, pattern, out, n);
  return static_cast<int>(cudaGetLastError());
}

// Launch the empty kernel on brief_canvas_launch's grid for `n` keypoints.
extern "C" int brief_canvas_floor_launch(int n, int warps, void* stream) {
  if (bad_warps(warps)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  brief_canvas_floor_kernel<<<(n + warps - 1) / warps, 32 * warps, 0,
                              static_cast<cudaStream_t>(stream)>>>(n);
  return static_cast<int>(cudaGetLastError());
}
