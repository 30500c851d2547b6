// Steered rBRIEF on the reflect-padded, blurred pyramid-level images of a
// frame: one launch for up to 16 images (8 levels x left and right).
//
// Replaces the TPU kernel pyorbslam_tpu/ops/pallas_kernels.py
// brief_descriptors_pallas (_brief_kernel) together with the pair compare
// and bit pack that the JAX package runs after it: for each keypoint of
// each level, the 256 pattern pairs rotated by the IC angle and rounded
// half to even (reach <= 19 px), both points of each pair sampled from
// the padded float image (not rounded to u8), and bit j of word w set
// when sample[2p] < sample[2p+1] for pair p = 32w + j.
// Plain twin: pyorbslam_tpu_torch/ops/orb_descriptor.py::brief_descriptors,
// once per image (kernels.brief_descriptors_levels_ref).
//
// What bounds it on an H100: the launch, then instruction count and load
// latency.  A level holds 122..434 keypoint slots of a 2000-feature frame:
// 16..55 blocks on 132 SMs, so a launch per level never fills the card, and
// a frame paid 16 launches (3 us each on the card, 20..40 us each on the
// host) for ~4000 keypoints.  Inside a launch the work is 512 four-byte
// gathers per keypoint from a 39x39 window of an image that sits in L2; all
// ~4000 warps are resident at once, so the kernel is one chain of a few
// memory round trips plus the work its warps execute.
//
// What the design does about it:
//  * One grid over all keypoints of all images.  The image table (pointer,
//    pitch, first keypoint) travels by value in the kernel's parameters:
//    nothing to allocate, copy or keep alive.  A warp takes one keypoint
//    and finds its image by scanning at most 16 prefix entries; an image
//    without keypoints is an entry like any other.  ~4000 slots are ~500
//    blocks of 8 warps: the card is filled once instead of 16 times a
//    sixth.
//  * A lane keeps its own eight pattern pairs in registers (16-byte loads
//    from device memory, no shared memory and no block barrier), gathers its
//    16 samples where they lie, all loads of a lane independent and all
//    started before the first comparison, and __ballot_sync packs the words
//    (brief_common.cuh: load_lane_pattern and warp_descriptor, the body
//    brief_canvas.cu runs too).  Staging the keypoint's 39x39 window in
//    shared memory first, with loads or cp.async along image rows, was built
//    and measured on an H100: it reads fewer sectors but makes 48 copies a
//    lane before the first sample, and with every warp resident the gathers'
//    latency is already hidden; it took 1.6x the time (0.0107 against 0.0066
//    ms for a frame's 4000 keypoints) and is not kept.
//  * 8 warps a block, the size measured for this body when the block still
//    filled shared memory with the pattern (4 measured slower then);
//    brief_canvas.cu's launch takes the block size as an argument and
//    chip_smoke.py times 1, 2, 4 and 8 warps on the same body.  __constant__
//    memory for the pattern would serialise: the index differs in every lane.
//  * Compare and bit pack stay in the kernel (__ballot_sync); the TPU
//    form's one-hot selection matmul over an aligned 56x256 window is not
//    carried over.  The exactness contract is brief_common.cuh's.
#include "brief_common.cuh"

constexpr int kMaxImages = 16;
constexpr int kBorder = 19;  // reflect pad of a level image = the pattern's reach
constexpr int kWarps = 8;    // keypoints per block, one warp each

extern "C" {
struct BriefImage {
  const float* img;  // padded blurred level image
  int pitch;         // floats per row
  int first;         // index of its first keypoint in the concatenated arrays
};
struct BriefTable {
  BriefImage im[kMaxImages];
  int n;
};
}

namespace {

__global__ void __launch_bounds__(32 * kWarps)
brief_levels_kernel(const __grid_constant__ BriefTable tab,
                    const int* __restrict__ xy, const float* __restrict__ cosv,
                    const float* __restrict__ sinv,
                    const float* __restrict__ pattern, int* __restrict__ out,
                    int n) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= n) return;  // uniform across the warp
  const brief::LanePattern lp = brief::load_lane_pattern(pattern, lane);
  int i = 0;
  while (i < tab.n - 1 && k >= tab.im[i + 1].first) ++i;
  // level (x, y) sits at (x + 19, y + 19) of the image padded by 19
  const int2 p = __ldg(reinterpret_cast<const int2*>(xy) + k);
  const unsigned int mine = brief::warp_descriptor(
      tab.im[i].img, tab.im[i].pitch, p.x + kBorder, p.y + kBorder, lp,
      __ldg(cosv + k), __ldg(sinv + k), lane);
  if (lane < brief::kWords) out[brief::kWords * k + lane] = static_cast<int>(mine);
}

}  // namespace

// One launch on `stream` for the `n` keypoints of `tab->n` images; returns
// the first CUDA error as an int (0 = launched).
extern "C" int brief_level_launch(const BriefTable* tab, const int* xy,
                                  const float* cosv, const float* sinv,
                                  const float* pattern, int* out, int n,
                                  void* stream) {
  if (tab->n < 1 || tab->n > kMaxImages) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  dim3 block(32 * kWarps);
  dim3 grid((n + kWarps - 1) / kWarps);
  brief_levels_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      *tab, xy, cosv, sinv, pattern, out, n);
  return static_cast<int>(cudaGetLastError());
}
