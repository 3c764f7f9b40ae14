// K2: fused random-sample LM (RANSAC-like) PnP initialisation.
//
// Replaces epropnp_tpu/ops/pnp/pallas_rslm.py::rslm_init_pallas on both of
// its layouts: the packed one, _rslm_init_packed (body _make_packed_kernel),
// and the legacy one (body _make_kernel), which scores on the full set and
// takes any N and num_points. The wrapper (rslm_kernel.py) picks the
// scoring layout as the JAX entry does. Per object:
//   1. the centre-based translation init (means and unbiased variances of
//      the normalised image points and of the 3D points; at dof 4 the
//      scale is std(y3d) / std(yc));
//   2. an inclusive cdf of mean(w2d, -1), and num_proposals subsets of
//      num_points indices drawn WITH replacement by inverse cdf: the first
//      index whose inclusive cdf reaches u * total (u in (0, 1], so a
//      zero-weight point is never drawn), clamped to N - 1;
//   3. a random unit quaternion (Box-Muller from uniforms, tiny-norm guard)
//      per proposal, or at dof 4 a random yaw in [0, 2 pi);
//   4. num_iter trust-region LM steps on every proposal's subset;
//   5. each proposal's Huber cost on the strided scoring subsample
//      (points 0, s, 2s, ... with s = N / score_n; the legacy layout and
//      full scoring pass s = 1, score_n = N), and the argmin. On an
//      exact tie the FIRST proposal wins (the TPU kernel averages the tied
//      poses); a NaN cost never wins unless every cost is NaN.
//
// Random bits: Philox4x32-10 from curand, one subsequence per proposal,
// seeded per object from the caller's (B,) int32 seed tensor. Draw order
// per proposal: num_points index uniforms, then 8 uniforms (4 Box-Muller
// pairs) for the quaternion, or 1 uniform for the yaw. The PyTorch twin
// (rslm_kernel.py) replays the same stream.
//
// Projection bounds (template BOUNDS, packed layout only, as the JAX entry
// asserts for its legacy layout): a per-object box [lb_u, ub_u] x
// [lb_v, ub_v] clamps every projection, in the proposal LM and in the
// scoring (pallas_rslm.py _evaluate with bounds). In the proposal LM a
// clamped coordinate loses only its own Jacobian row; "inside" is strict,
// lb < u < ub, as in JAX.
//
// What bounds it on an H100: the latency of small dependent scalar work.
// Per proposal: a 16-point LM with an unrolled 6x6 Cholesky per step, then
// a score_n-point cost loop; per object only 28 N bytes are read. No
// tensor-core shape fits 6x6 products (and TF32 could not hold rtol 1e-4),
// so the design is about occupancy, shared-memory traffic and instruction
// slots:
//
// * One block per object, one thread per proposal (the block rounded up to
//   whole warps), so a warp runs the serial LM of 32 proposals at once.
// * The object's points are staged once in shared memory as two float4
//   planes (pnp_common.cuh; where they fit, up to kStageBytes), read by the
//   centre init, the cdf, every proposal's LM and the scoring: no point is
//   read twice from device memory.
// * A proposal's samples are kept as point indices, [K][P] in shared
//   memory (neighbouring proposals on neighbouring words: no bank
//   conflict), not as copies of the 7 floats: about 22 KB a block at B=1024,
//   N=512, 64 x 16, so 8 blocks fit an SM (the registers allow 8 too) and
//   B=1024 runs in one wave of 132 SMs.
// * The cdf is a chunked scan whose chunk totals are scanned by warp
//   shuffles; the scoring points are read as broadcasts (every proposal
//   scores the same point at once).

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <math.h>

#include "pnp_common.cuh"

namespace epropnp {
namespace {

constexpr int kStageBytes = 96 * 1024;

// Sum of K values over the block (blockDim.x a multiple of 32); every
// thread receives the same sums. ``scratch`` holds 32 * K floats.
template <int K>
__device__ __forceinline__ void block_allreduce(float* v, float* scratch) {
  warp_allreduce<K>(v);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) scratch[warp * K + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += scratch[w * K + i];
    v[i] = s;
  }
  __syncthreads();
}

// Exclusive prefix sum of one value a thread over the block (blockDim.x a
// multiple of 32): warp shuffles, then the warps' totals scanned by warp 0.
// ``warp_tot`` holds 32 floats.
__device__ __forceinline__ float block_exclusive_scan(float v,
                                                      float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? warp_tot[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < nwarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const float before = __shfl_up_sync(0xffffffffu, incl, 1);
  return (lane ? before : 0.f) + (warp ? warp_tot[warp - 1] : 0.f);
}

template <int DOF, bool BOUNDS>
__global__ void rslm_init_kernel(
    const int* __restrict__ seeds, const float* __restrict__ x3d,
    const float* __restrict__ x2d, const float* __restrict__ w2d,
    const float* __restrict__ cam, const float* __restrict__ delta,
    const float* __restrict__ bounds, float* __restrict__ pose_out,
    float* __restrict__ cost_out, int N, int P, int K, int score_stride,
    int score_n, int staged, LMParams prm) {
  extern __shared__ float4 smem4[];
  float4* plane = smem4;                                    // 2 N if staged
  float* cdf = reinterpret_cast<float*>(smem4 + (staged ? 2 * N : 0));  // N
  int* sidx = reinterpret_cast<int*>(cdf + N);              // K * P
  __shared__ float scratch[32 * 5];
  __shared__ float win_key[32];
  __shared__ int win_idx[32];

  const int T = blockDim.x;
  const int b = blockIdx.x;
  const int p = threadIdx.x;
  const ObjParams o = load_obj(cam, delta, b);
  const Bounds bnd = BOUNDS ? load_bounds(bounds, b) : Bounds{};
  const float* px3 = x3d + (size_t)b * N * 3;
  const float* px2 = x2d + (size_t)b * N * 2;
  const float* pw2 = w2d + (size_t)b * N * 2;
  PointSource pts{nullptr, nullptr, px3, px2, pw2};
  if (staged) {
    stage_points(plane, plane + N, px3, px2, pw2, N, p, T);
    pts.a = plane;
    pts.c = plane + N;
    __syncthreads();
  }

  // ---- 1. centre-based translation init (two-pass mean / variance) ----
  const float inv_n = 1.f / (float)N, bessel = 1.f / (float)(N - 1);
  float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = p; n < N; n += T) {
    const Pt q = pts(n);
    s[0] += (q.u - o.cx) / o.fx;
    s[1] += (q.v - o.cy) / o.fy;
    s[2] += q.x;
    s[3] += q.y;
    s[4] += q.z;
  }
  block_allreduce<5>(s, scratch);
  float mu[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) mu[i] = s[i] * inv_n;
  float qs[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = p; n < N; n += T) {
    const Pt q = pts(n);
    float d[5];
    d[0] = (q.u - o.cx) / o.fx - mu[0];
    d[1] = (q.v - o.cy) / o.fy - mu[1];
    d[2] = q.x - mu[2];
    d[3] = q.y - mu[3];
    d[4] = q.z - mu[4];
#pragma unroll
    for (int i = 0; i < 5; ++i) qs[i] += d[i] * d[i];
  }
  block_allreduce<5>(qs, scratch);
  float var[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) var[i] = qs[i] * bessel;
  float scale;
  if constexpr (DOF == 4) {
    scale = sqrtf(var[3]) / fmaxf(sqrtf(var[1]), 1e-6f);
  } else {
    const float norm3 = sqrtf(var[2] + var[3] + var[4]);
    const float normc = sqrtf(fmaxf(var[0] + var[1], 1e-12f));
    scale = 0.816496580927726f * norm3 / fmaxf(normc, 1e-6f);  // sqrt(2/3)
  }
  const float t0[3] = {mu[0] * scale, mu[1] * scale, scale};

  // ---- 2. inclusive cdf of mean(w2d, -1): chunk scans + chunk offsets ----
  const int chunk = (N + T - 1) / T;
  const int c0 = min(N, p * chunk), c1 = min(N, c0 + chunk);
  float run = 0.f;
  for (int n = c0; n < c1; ++n) {
    const Pt q = pts(n);
    run += (q.wu + q.wv) * 0.5f;
    cdf[n] = run;
  }
  const float off = block_exclusive_scan(run, scratch);
  for (int n = c0; n < c1; ++n) cdf[n] += off;
  __syncthreads();
  const float total = cdf[N - 1];

  constexpr int kD = DOF, kP = pose_dim<DOF>(), kT = tri<DOF>();
  float pose[kP];
  float cost = INFINITY;
  if (p < P) {
    // ---- 3. sampling and the proposal's initial pose ----
    curandStatePhilox4_32_10_t st;
    curand_init((unsigned long long)(unsigned int)seeds[b],
                (unsigned long long)p, 0ull, &st);
    for (int i = 0; i < K; ++i) {
      const float u = curand_uniform(&st) * total;
      // first index whose inclusive cdf reaches u (searchsorted, left)
      int lo = 0, hi = N;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cdf[mid] < u) lo = mid + 1;
        else hi = mid;
      }
      sidx[i * P + p] = min(lo, N - 1);
    }
    pose[0] = t0[0];
    pose[1] = t0[1];
    pose[2] = t0[2];
    if constexpr (DOF == 4) {
      pose[3] = curand_uniform(&st) * (2.f * (float)M_PI);
    } else {
      float nrm[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float u1 = fmaxf(curand_uniform(&st), 1e-12f);
        const float u2 = curand_uniform(&st);
        nrm[c] = sqrtf(-2.f * logf(u1)) * cosf(2.f * (float)M_PI * u2);
      }
      const float qn = sqrtf(nrm[0] * nrm[0] + nrm[1] * nrm[1] +
                             nrm[2] * nrm[2] + nrm[3] * nrm[3]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pose[3 + c] = qn < prm.eps ? (c == 0 ? 1.f : 0.f)
                                   : nrm[c] / fmaxf(qn, 1e-30f);
    }

    // ---- 4. trust-region LM on the proposal's subset ----
    auto ev = [&](const float* ps, float& c, float* jtj, float* g) {
      float r[9], t[3];
      pose_rt<DOF>(ps, r, t);
      c = 0.f;
#pragma unroll
      for (int i = 0; i < kT; ++i) jtj[i] = 0.f;
#pragma unroll
      for (int i = 0; i < kD; ++i) g[i] = 0.f;
#pragma unroll 2
      for (int i = 0; i < K; ++i)
        accumulate_point<true, DOF, BOUNDS>(r, t, o, prm.z_min, bnd,
                                            pts(sidx[i * P + p]), c, jtj, g);
    };
    float jtj[kT], g[kD];
    ev(pose, cost, jtj, g);
    float radius = prm.initial_trust_region_radius, decrease = 2.f;
    for (int it = 0; it < prm.num_iter; ++it)
      lm_trust_region_step<DOF>(prm, pose, cost, jtj, g, radius, decrease,
                                ev);

    // ---- 5. score on the strided subsample (or the full set) ----
    float r[9], t[3];
    pose_rt<DOF>(pose, r, t);
    cost = 0.f;
#pragma unroll 4
    for (int j = 0; j < score_n; ++j)
      cost += point_cost<DOF, BOUNDS>(r, t, o, prm.z_min, bnd,
                                      pts(j * score_stride));
  }

  // ---- argmin over proposals: (key, index) lexicographic ----
  float key = (p < P && !isnan(cost)) ? cost : INFINITY;
  int idx = p;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const float k2 = __shfl_xor_sync(0xffffffffu, key, w);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, w);
    if (k2 < key || (k2 == key && i2 < idx)) {
      key = k2;
      idx = i2;
    }
  }
  if ((p & 31) == 0) {
    win_key[p >> 5] = key;
    win_idx[p >> 5] = idx;
  }
  __syncthreads();
  if (p == 0) {
    for (int w = 1; w < (T >> 5); ++w) {
      if (win_key[w] < win_key[0] ||
          (win_key[w] == win_key[0] && win_idx[w] < win_idx[0])) {
        win_key[0] = win_key[w];
        win_idx[0] = win_idx[w];
      }
    }
  }
  __syncthreads();
  if (p == win_idx[0]) {
#pragma unroll
    for (int i = 0; i < kP; ++i) pose_out[b * kP + i] = pose[i];
    cost_out[b] = cost;
  }
}

template <int DOF, bool BOUNDS>
int launch(const int* seeds, const float* x3d, const float* x2d,
           const float* w2d, const float* cam, const float* delta,
           const float* bounds, float* pose_out, float* cost_out, int B,
           int N, int P, int K,
           int score_stride, int score_n, const LMParams& prm,
           cudaStream_t stream, int* occ) {
  auto kernel = rslm_init_kernel<DOF, BOUNDS>;
  const int threads = (P + 31) / 32 * 32;
  const size_t stage = sizeof(float4) * 2 * (size_t)N;
  const int staged = stage <= (size_t)kStageBytes ? 1 : 0;
  const size_t smem = (staged ? stage : 0) +
                      sizeof(float) * ((size_t)N + (size_t)P * K);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (occ != nullptr) {  // resources only, as epropnp_lm_occupancy
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[3], kernel,
                                                          threads, smem);
    occ[0] = attr.numRegs;
    occ[1] = threads;
    occ[2] = (int)smem;
    return (int)err;
  }
  kernel<<<B, threads, smem, stream>>>(
      seeds, x3d, x2d, w2d, cam, delta, bounds, pose_out, cost_out, N, P, K,
      score_stride, score_n, staged, prm);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace epropnp

// Plain C entry point (loaded with ctypes). ``pose_out`` is (B, 7) at dof 6
// and (B, 4) at dof 4; ``bounds`` is (B, 4) [lb_u, lb_v, ub_u, ub_v] or
// null (no bounds). Returns the cudaError_t of the launch; 0 means the
// kernel was queued on ``stream``.
extern "C" int epropnp_rslm_init(
    const int* seeds, const float* x3d, const float* x2d, const float* w2d,
    const float* cam, const float* delta, const float* bounds,
    float* pose_out, float* cost_out,
    int B, int N, int dof, int num_points, int num_proposals, int num_iter,
    int score_stride, int score_n, float z_min, float eps,
    float min_lm_diagonal, float max_lm_diagonal,
    float min_relative_decrease, float initial_trust_region_radius,
    float max_trust_region_radius, void* stream) {
  if (B <= 0) return 0;
  if (N < 2 || num_points < 1 || num_proposals < 1 || num_proposals > 1024 ||
      score_n < 1 || (long long)(score_n - 1) * score_stride >= N ||
      (dof != 4 && dof != 6))
    return (int)cudaErrorInvalidValue;
  epropnp::LMParams prm{num_iter, z_min, eps, min_lm_diagonal,
                        max_lm_diagonal, min_relative_decrease,
                        initial_trust_region_radius,
                        max_trust_region_radius};
  auto s = static_cast<cudaStream_t>(stream);
#define EPROPNP_RSLM_LAUNCH(D, BND)                                        \
  return epropnp::launch<D, BND>(seeds, x3d, x2d, w2d, cam, delta, bounds, \
                                 pose_out, cost_out, B, N, num_proposals,  \
                                 num_points, score_stride, score_n, prm, s, \
                                 nullptr)
  if (dof == 4) {
    if (bounds) EPROPNP_RSLM_LAUNCH(4, true);
    EPROPNP_RSLM_LAUNCH(4, false);
  }
  if (bounds) EPROPNP_RSLM_LAUNCH(6, true);
  EPROPNP_RSLM_LAUNCH(6, false);
#undef EPROPNP_RSLM_LAUNCH
}

// Resources of the instance (dof, bounds: 0 or 1) for N points, P
// proposals of K points, without a launch: ``out`` receives registers a
// thread, threads a block, dynamic shared memory (bytes) and resident
// blocks an SM. Returns a cudaError_t.
extern "C" int epropnp_rslm_occupancy(int dof, int bounds, int N, int P,
                                      int K, int* out) {
  if (N < 2 || K < 1 || P < 1 || P > 1024 || (dof != 4 && dof != 6))
    return (int)cudaErrorInvalidValue;
  const epropnp::LMParams prm{};
#define EPROPNP_RSLM_OCC(D, BND)                                          \
  return epropnp::launch<D, BND>(nullptr, nullptr, nullptr, nullptr,      \
                                 nullptr, nullptr, nullptr, nullptr,      \
                                 nullptr, 1, N, P, K, 1, N, prm, nullptr, \
                                 out)
  if (dof == 4) {
    if (bounds) EPROPNP_RSLM_OCC(4, true);
    EPROPNP_RSLM_OCC(4, false);
  }
  if (bounds) EPROPNP_RSLM_OCC(6, true);
  EPROPNP_RSLM_OCC(6, false);
#undef EPROPNP_RSLM_OCC
}
