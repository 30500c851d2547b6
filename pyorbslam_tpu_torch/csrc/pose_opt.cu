// Motion-only pose optimization of one frame in one launch: every round
// and every Levenberg-Marquardt iteration of
// pyorbslam_tpu_torch/optim/pose_opt.py::pose_optimization_ref (4 rounds
// x 10 iterations on SE(3) over N stereo edges, Huber kernel in the first
// three rounds, a chi2 gate of 7.815 after each, each round restarting
// from Tcw0, the fallback to Tcw0 below 3 active edges).
//
// Replaces no TPU kernel.  The JAX package runs the same loop as
// jax.lax.fori_loop (pyorbslam_tpu/optim/pose_opt.py:126, inside
// pose_optimization at :132), which XLA compiles into one program; eager
// PyTorch has no such program, and the loop was ~180 small launches an
// iteration, 7,200 a call, two calls a frame.  The host's enqueue of those
// launches set the pace of the whole frame; the device did ~1.9 us of work
// per launch.  This kernel is what the fori_loop is on the TPU: one launch.
// Plain twin: pyorbslam_tpu_torch/optim/pose_opt.py::pose_optimization_ref
// (the arithmetic below follows it term by term, in float32, with IEEE
// division and square root).
//
// What bounds it on an H100: latency.  40 iterations are a chain: each
// needs the sums of the one before (H, b and two costs) and a 6x6 solve,
// so one block does the work and the card's other 131 SMs idle.  Per
// iteration: two passes over the edges (~120 and ~40 float operations an
// edge), two block reductions (28 sums, then 1) and one solve; the inputs
// are 28 bytes an edge (~57 KB at N = 2048) and bound nothing.
//
// What the design does about it:
//  * One block of 512 threads per call; edge i belongs to thread i % 512
//    for the whole call, so a thread keeps its edges' active and inlier
//    flags as bits of a 64-bit register (N <= 64 x 512 = 32768).
//  * The inputs stay on chip: Xw, obs and inv_sigma2 are copied once into
//    shared memory (28 bytes an edge, up to ~8,200 edges: the 2048 slots
//    of a 2000-feature frame and the 8064 of an 8000-feature one) and read
//    there by all 40 iterations.  Beyond that the same loop reads them
//    where they lie in device memory (L1 / L2), through the same pointers.
//  * A pass accumulates the 21 unique entries of H = J^T W J, the 6 of b
//    and the cost in registers; warp shuffles, then one shared-memory row
//    a warp, give the block's sums in a fixed order (the same value in
//    every run).
//  * One warp solves (H + lam diag(H) + 1e-9 I) dx = -b: lane i holds row i,
//    pivots are chosen by a warp argmax (partial pivoting, as LAPACK's
//    getrf), rows swap and eliminate by shuffles.  Its lane 0 forms
//    exp(dx) T with geometry/se3.py's coefficients and small-angle branch.
//  * Poses live in three shared buffers (current, candidate, Tcw0): every
//    thread takes the accept decision itself from the same sums, so an
//    iteration has three block barriers and no pose copy.
//  * The arithmetic is the twin's, term for term; nothing is skipped: an
//    inactive edge is computed and weighted by 0, as the twin weights it,
//    and every iteration runs.  Sums are taken in another order than the
//    twin's, so a pose agrees to float32 rounding and an accept decision at
//    the noise floor may go the other way.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEdgesPerThread = 64;   // bits of a flag register
constexpr int kHuberRounds = 3;          // the robust kernel is dropped after round 2
constexpr int kSumsH = 21;               // unique entries of the symmetric 6x6 H
constexpr int kSums = kSumsH + 6 + 1;    // H, b, the cost
constexpr int kStagedFloats = 7;         // Xw (3), obs (3), inv_sigma2 an edge
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* T0;               // (4, 4)
  const float* xw;               // (N, 3)
  const float* obs;              // (N, 3)
  const float* isig;             // (N,)
  const unsigned char* active0;  // (N,) bool
  const float* cam;              // (5,) fx, fy, cx, cy, bf
  float* T_out;                  // (4, 4)
  unsigned char* inl_out;        // (N,) bool
  int* n_in_out;                 // ()
  float* chi2_out;               // (N,)
  int n, rounds, iters, staged;
  float delta, delta2, two_delta, gate;  // sqrt(chi2), its square, 2 delta, chi2
};

struct Cam {
  float fx, fy, cx, cy, bf;
};

// index of H[j][m], j <= m, in the row-major upper triangle
__host__ __device__ constexpr int sym(int j, int m) {
  return j * 6 - j * (j - 1) / 2 + (m - j);
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// The twin's _camera_points: camera-frame point and e = obs - (u, v, ur).
__device__ __forceinline__ void project(const float* T, const Cam& c,
                                        const float* xw, const float* obs,
                                        int i, float& px, float& py, float& pz,
                                        float& invz, float e[3]) {
  const float X = xw[3 * i], Y = xw[3 * i + 1], Z = xw[3 * i + 2];
  px = T[0] * X + T[1] * Y + T[2] * Z + T[3];
  py = T[4] * X + T[5] * Y + T[6] * Z + T[7];
  pz = T[8] * X + T[9] * Y + T[10] * Z + T[11];
  const float z = fabsf(pz) < 1e-6f ? 1e-6f : pz;
  invz = 1.0f / z;
  const float u = c.fx * px * invz + c.cx;
  const float v = c.fy * py * invz + c.cy;
  const float ur = u - c.bf * invz;
  e[0] = obs[3 * i] - u;
  e[1] = obs[3 * i + 1] - v;
  e[2] = obs[3 * i + 2] - ur;
}

__device__ __forceinline__ float chi2_of(const float e[3], float isig) {
  return (e[0] * e[0] + e[1] * e[1] + e[2] * e[2]) * isig;
}

// the twin's total(): rho(chi2), Huber or plain
__device__ __forceinline__ float rho(float c, bool huber, const Params& p) {
  if (!huber) return c;
  const float s = sqrtf(clamp_min(c, 1e-12f));
  return c <= p.delta2 ? c : p.two_delta * s - p.delta2;
}

// the warp's sum in lane 0
template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void load_pose(const float* s, float T[12]) {
#pragma unroll
  for (int q = 0; q < 12; ++q) T[q] = s[q];
}

// Pass 1 over one thread's edges at pose T: the 21 + 6 sums of H and b and
// the cost, each edge as stereo_residual_jacobian, _chi2, _huber_weight and
// total() compute it.
__device__ __forceinline__ void normal_equations(
    const float* T, const Cam& c, const float* xw, const float* obs,
    const float* isig, uint64_t act, bool huber, const Params& p,
    float acc[kSums]) {
#pragma unroll
  for (int q = 0; q < kSums; ++q) acc[q] = 0.f;
  int k = 0;
  for (int i = threadIdx.x; i < p.n; i += kThreads, ++k) {
    const float a = (act >> k) & 1ull ? 1.f : 0.f;
    float px, py, pz, invz, e[3];
    project(T, c, xw, obs, i, px, py, pz, invz, e);
    const float is = isig[i];
    const float chi2 = chi2_of(e, is);
    float w = 1.f;
    if (huber)
      w = chi2 <= p.delta2 ? 1.f : p.delta / sqrtf(clamp_min(chi2, 1e-12f));
    w = w * is * a;
    // dh/dPc rows (a_, b_, c_) of u, v, ur; J = -(dh/dPc)(dPc/dxi) with
    // dPc/dxi = [-[Pc]x | I]
    const float invz2 = invz * invz;
    const float au = c.fx * invz, cu = -c.fx * px * invz2;
    const float bv = c.fy * invz, cv = -c.fy * py * invz2;
    const float cr = cu + c.bf * invz2;
    const float J[3][6] = {
        {-(cu * py), -(au * pz - cu * px), -(-au * py), -au, 0.f, -cu},
        {-(-bv * pz + cv * py), -(-cv * px), -(bv * px), 0.f, -bv, -cv},
        {-(cr * py), -(au * pz - cr * px), -(-au * py), -au, 0.f, -cr}};
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int m = j; m < 6; ++m)
        acc[sym(j, m)] += w * (J[0][j] * J[0][m] + J[1][j] * J[1][m] +
                               J[2][j] * J[2][m]);
      acc[kSumsH + j] += w * (J[0][j] * e[0] + J[1][j] * e[1] + J[2][j] * e[2]);
    }
    acc[kSums - 1] += rho(chi2, huber, p) * a;
  }
}

// Pass 2: the cost alone at pose T.
__device__ __forceinline__ float cost_at(const float* T, const Cam& c,
                                         const float* xw, const float* obs,
                                         const float* isig, uint64_t act,
                                         bool huber, const Params& p) {
  float sum = 0.f;
  int k = 0;
  for (int i = threadIdx.x; i < p.n; i += kThreads, ++k) {
    const float a = (act >> k) & 1ull ? 1.f : 0.f;
    float px, py, pz, invz, e[3];
    project(T, c, xw, obs, i, px, py, pz, invz, e);
    sum += rho(chi2_of(e, isig[i]), huber, p) * a;
  }
  return sum;
}

// Warp 0: solve (H + lam diag(H) + 1e-9 I) x = b with partial pivoting from
// the block's sums (lane q holds sum q), and return x in every lane.
__device__ __forceinline__ void solve6(float tot, float lam, float x[6]) {
  const int lane = threadIdx.x & 31;
  const int r = lane < 6 ? lane : 0;
  float a[6], rhs;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float h = __shfl_sync(kFull, tot, r <= j ? sym(r, j) : sym(j, r));
    a[j] = r == j ? (h + lam * h) + 1e-9f : h;
  }
  rhs = __shfl_sync(kFull, tot, kSumsH + r);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    // pivot: the largest |a[i][k]| over rows i >= k, the first on a tie
    float v = lane >= k && lane < 6 ? fabsf(a[k]) : -2.f;
    if (v != v) v = -1.f;
    int idx = lane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(kFull, v, o);
      const int i2 = __shfl_xor_sync(kFull, idx, o);
      if (v2 > v || (v2 == v && i2 < idx)) {
        v = v2;
        idx = i2;
      }
    }
    const int src = lane == k ? idx : (lane == idx ? k : lane);
#pragma unroll
    for (int j = 0; j < 6; ++j) a[j] = __shfl_sync(kFull, a[j], src);
    rhs = __shfl_sync(kFull, rhs, src);
    float pk[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) pk[j] = __shfl_sync(kFull, a[j], k);
    const float pr = __shfl_sync(kFull, rhs, k);
    if (lane > k && lane < 6) {
      const float l = a[k] / pk[k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) a[j] -= l * pk[j];
      rhs -= l * pr;
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = rhs;
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= a[j] * x[j];
    x[i] = __shfl_sync(kFull, s / a[i], i);
  }
}

// exp(dx) @ T (geometry/se3.py::retract), written to out (4x4 row-major).
__device__ void retract(const float dx[6], const float* T, float* out) {
  const float w0 = dx[0], w1 = dx[1], w2 = dx[2];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + 1e-16f);
  const bool small = th2 < 1e-8f;
  const float A = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
  const float B = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / th2;
  const float C = small ? (1.0f / 6.0f) - th2 / 120.0f : (1.0f - A) / th2;
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float E[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float W2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float I = i == j ? 1.f : 0.f;
      E[i][j] = I + A * W[i][j] + B * W2;
      t += (I + B * W[i][j] + C * W2) * dx[3 + j];
    }
    E[i][3] = t;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.f;
  E[3][3] = 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] +
                       E[i][2] * T[8 + j] + E[i][3] * T[12 + j];
}

__global__ void __launch_bounds__(kThreads)
pose_opt_kernel(const __grid_constant__ Params p) {
  extern __shared__ float staged[];
  __shared__ float sT[3][16];  // two working poses and Tcw0 (index 2)
  __shared__ float sRed[kWarps][kSums];
  __shared__ float sCost[kWarps];
  __shared__ float sCostCur;
  __shared__ int sCount[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xw = p.xw;
  const float* obs = p.obs;
  const float* isig = p.isig;
  if (p.staged) {
    float* s_xw = staged;
    float* s_obs = staged + 3 * p.n;
    float* s_isig = staged + 6 * p.n;
    for (int i = tid; i < 3 * p.n; i += kThreads) {
      s_xw[i] = p.xw[i];
      s_obs[i] = p.obs[i];
    }
    for (int i = tid; i < p.n; i += kThreads) s_isig[i] = p.isig[i];
    xw = s_xw;
    obs = s_obs;
    isig = s_isig;
  }
  if (tid < 16) sT[2][tid] = p.T0[tid];
  const Cam c{p.cam[0], p.cam[1], p.cam[2], p.cam[3], p.cam[4]};

  uint64_t act0 = 0;
  int cnt = 0;
  {
    int k = 0;
    for (int i = tid; i < p.n; i += kThreads, ++k)
      if (p.active0[i]) {
        act0 |= 1ull << k;
        ++cnt;
      }
  }
  cnt = warp_sum(cnt);
  if (lane == 0) sCount[warp] = cnt;
  __syncthreads();
  int n_active = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_active += sCount[w];

  uint64_t inl = act0;
  int cur = 2;
  float T[12], acc[kSums];
  for (int r = 0; r < p.rounds; ++r) {
    const bool huber = r < kHuberRounds;
    const uint64_t act = inl;
    float lam = 1e-4f;
    cur = 2;
    for (int it = 0; it < p.iters; ++it) {
      const int cand = cur == 0 ? 1 : 0;
      load_pose(sT[cur], T);
      normal_equations(T, c, xw, obs, isig, act, huber, p, acc);
#pragma unroll
      for (int q = 0; q < kSums; ++q) acc[q] = warp_sum(acc[q]);
      if (lane == 0)
#pragma unroll
        for (int q = 0; q < kSums; ++q) sRed[warp][q] = acc[q];
      __syncthreads();
      if (warp == 0) {
        float tot = 0.f;
        if (lane < kSums)
          for (int w = 0; w < kWarps; ++w) tot += sRed[w][lane];
        float x[6];
        solve6(tot, lam, x);
        const float cost = __shfl_sync(kFull, tot, kSums - 1);
        if (lane == 0) {
          float dx[6];
#pragma unroll
          for (int j = 0; j < 6; ++j) dx[j] = -x[j];
          sCostCur = cost;
          retract(dx, sT[cur], sT[cand]);
        }
      }
      __syncthreads();
      load_pose(sT[cand], T);
      const float part = warp_sum(cost_at(T, c, xw, obs, isig, act, huber, p));
      if (lane == 0) sCost[warp] = part;
      __syncthreads();
      float cost_new = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) cost_new += sCost[w];
      if (cost_new < sCostCur) {
        cur = cand;
        lam = lam * 0.5f;
      } else {
        lam = lam * 4.0f;
      }
    }
    // the gate: inliers of the next round
    load_pose(sT[cur], T);
    uint64_t next = 0;
    int k = 0;
    for (int i = tid; i < p.n; i += kThreads, ++k) {
      float px, py, pz, invz, e[3];
      project(T, c, xw, obs, i, px, py, pz, invz, e);
      if (((act0 >> k) & 1ull) && chi2_of(e, isig[i]) <= p.gate)
        next |= 1ull << k;
    }
    inl = next;
  }

  // the final residuals at the round's pose, the inlier mask and its count
  load_pose(sT[cur], T);
  cnt = 0;
  {
    int k = 0;
    for (int i = tid; i < p.n; i += kThreads, ++k) {
      float px, py, pz, invz, e[3];
      project(T, c, xw, obs, i, px, py, pz, invz, e);
      p.chi2_out[i] = chi2_of(e, isig[i]);
      const int in = (int)((inl >> k) & 1ull);
      p.inl_out[i] = (unsigned char)in;
      cnt += in;
    }
  }
  cnt = warp_sum(cnt);
  __syncthreads();  // every thread has read sCount's first use
  if (lane == 0) sCount[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += sCount[w];
    *p.n_in_out = total;
  }
  // too few correspondences: the initial pose (Optimizer.py:171)
  if (tid < 16) p.T_out[tid] = n_active >= 3 ? sT[cur][tid] : sT[2][tid];
}

// Dynamic shared memory a block may take on each device (after the
// kernel's static shared memory), set once a device.
constexpr int kMaxDevices = 64;
int g_dyn_limit[kMaxDevices] = {0};

cudaError_t dyn_limit(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_dyn_limit[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, pose_opt_kernel);
    if (err != cudaSuccess) return err;
    const int limit = optin - (int)fa.sharedSizeBytes;
    err = cudaFuncSetAttribute(pose_opt_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return err;
    g_dyn_limit[dev] = limit;
  }
  *out = g_dyn_limit[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One pose optimization: all ``rounds`` x ``iters`` iterations, the gates
// and the final residual pass.  Returns the CUDA error of the launch.
int pose_opt_launch(const float* T0, const float* xw, const float* obs,
                    const float* isig, const unsigned char* active0,
                    const float* cam, int n, int rounds, int iters,
                    double chi2_gate, float* T_out, unsigned char* inl_out,
                    int* n_in_out, float* chi2_out, cudaStream_t stream) {
  if (n < 0 || n > kThreads * kMaxEdgesPerThread || rounds < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = dyn_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)n * kStagedFloats * sizeof(float);
  const int staged = bytes <= (size_t)limit ? 1 : 0;
  const double delta = sqrt(chi2_gate);
  Params p{T0, xw, obs, isig, active0, cam, T_out, inl_out, n_in_out, chi2_out,
           n, rounds, iters, staged,
           (float)delta, (float)(delta * delta), (float)(2.0 * delta),
           (float)chi2_gate};
  pose_opt_kernel<<<1, kThreads, staged ? bytes : 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
