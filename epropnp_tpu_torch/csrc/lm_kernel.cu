// K1: fused batched Levenberg-Marquardt / Gauss-Newton PnP solve.
//
// Replaces epropnp_tpu/ops/pnp/pallas_lm.py::lm_solve_pallas (body
// _make_kernel, with _evaluate, _chol_solve and _pose_add). Computes, for
// every object, a fixed number of steps: projection, Huber cost + IRLS
// rescale, analytic Jacobian, the JtJ and gradient sums, a damped Cholesky
// solve, the tangent pose update and, outside fast mode, the Ceres-style
// trust-region accept/reject. Scope: every mode of lm_solve_pallas that a
// caller reaches: fast mode (pure Gauss-Newton) or the trust region, at
// dof 6 or 4, with or without per-object projection bounds, with or
// without the undamped JtJ output (the pose covariance of the Monte Carlo
// forward). The Pallas kernel's cost_only mode has no caller outside
// pallas_lm.py and is not ported.
//
// What bounds it on an H100: per object the work is a reduction over N
// points followed by a few hundred dependent scalar flops (Cholesky,
// pose update, trust region). It is latency- and issue-bound small-matrix
// work; no tensor-core shape fits it. Bytes per evaluation are 28 N
// (x3d, x2d, w2d), re-read from L1/L2 every iteration: 28 * 512 * 1024
// = 14.7 MB at the bench shape, well inside the 50 MB L2.
//
// Design: one warp per object, points strided across the 32 lanes, and
// xor-butterfly warp shuffles for the cost, JtJ and gradient sums. Every
// lane ends up with bit-identical sums, so each lane runs the unrolled
// Cholesky, the pose update and the accept/reject itself, with no shared
// memory round trip and no divergence. The ragged edge (N not a multiple
// of 32, B not a multiple of the warps per block) is masked, not padded.

#include <cuda_runtime.h>

#include "pnp_common.cuh"

namespace epropnp {
namespace {

constexpr int kWarpsPerBlock = 8;

template <int K>
__device__ __forceinline__ void warp_allreduce(float* v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
}

template <int DOF, bool FAST, bool BOUNDS, bool JTJ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lm_solve_kernel(const float* __restrict__ x3d, const float* __restrict__ x2d,
                const float* __restrict__ w2d, const float* __restrict__ cam,
                const float* __restrict__ delta,
                const float* __restrict__ bounds,
                const float* __restrict__ pose0, float* __restrict__ pose_out,
                float* __restrict__ cost_out, float* __restrict__ jtj_out,
                int B, int N, LMParams prm) {
  constexpr int kD = DOF, kP = pose_dim<DOF>(), kT = tri<DOF>();
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // the whole warp leaves together

  const ObjParams o = load_obj(cam, delta, b);
  const Bounds bnd = BOUNDS ? load_bounds(bounds, b) : Bounds{};
  const float* px3 = x3d + (size_t)b * N * 3;
  const float* px2 = x2d + (size_t)b * N * 2;
  const float* pw2 = w2d + (size_t)b * N * 2;

  auto ev = [&](const float* pose, float& cost, float* jtj, float* g) {
    float r[9], t[3];
    pose_rt<DOF>(pose, r, t);
    float acc[1 + kT + kD];
#pragma unroll
    for (int i = 0; i < 1 + kT + kD; ++i) acc[i] = 0.f;
    for (int n = lane; n < N; n += 32) {
      accumulate_point<!FAST, DOF, BOUNDS>(
          r, t, o, prm.z_min, bnd, __ldg(px3 + 3 * n), __ldg(px3 + 3 * n + 1),
          __ldg(px3 + 3 * n + 2), __ldg(px2 + 2 * n), __ldg(px2 + 2 * n + 1),
          __ldg(pw2 + 2 * n), __ldg(pw2 + 2 * n + 1), acc[0], acc + 1,
          acc + 1 + kT);
    }
    warp_allreduce<1 + kT + kD>(acc);
    cost = acc[0];
#pragma unroll
    for (int i = 0; i < kT; ++i) jtj[i] = acc[1 + i];
#pragma unroll
    for (int i = 0; i < kD; ++i) g[i] = acc[1 + kT + i];
  };

  float pose[kP];
#pragma unroll
  for (int i = 0; i < kP; ++i) pose[i] = pose0[b * kP + i];
  float cost, jtj[kT], g[kD];

  if (FAST) {
    // pure Gauss-Newton; the cost and JtJ are those at the pose before the
    // last update (the reference's loop carry), zero after no iteration
    cost = 0.f;
#pragma unroll
    for (int i = 0; i < kT; ++i) jtj[i] = 0.f;
    for (int it = 0; it < prm.num_iter; ++it) {
      ev(pose, cost, jtj, g);
      float damped[kT], step[kD], pose_new[kP];
#pragma unroll
      for (int i = 0; i < kT; ++i) damped[i] = jtj[i];
#pragma unroll
      for (int a = 0; a < kD; ++a) damped[a * (a + 1) / 2 + a] += prm.eps;
      chol_solve<DOF>(damped, g, step);
      pose_add<DOF>(pose, step, pose_new);
#pragma unroll
      for (int i = 0; i < kP; ++i) pose[i] = pose_new[i];
    }
  } else {
    // the JtJ kept by the trust region is that at the accepted pose
    ev(pose, cost, jtj, g);
    float radius = prm.initial_trust_region_radius, decrease = 2.f;
    for (int it = 0; it < prm.num_iter; ++it)
      lm_trust_region_step<DOF>(prm, pose, cost, jtj, g, radius, decrease,
                                ev);
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kP; ++i) pose_out[b * kP + i] = pose[i];
    cost_out[b] = cost;
    if (JTJ) {
#pragma unroll
      for (int i = 0; i < kT; ++i) jtj_out[b * kT + i] = jtj[i];
    }
  }
}

template <int DOF, bool FAST, bool BOUNDS, bool JTJ>
void launch(const float* x3d, const float* x2d, const float* w2d,
            const float* cam, const float* delta, const float* bounds,
            const float* pose0, float* pose_out, float* cost_out,
            float* jtj_out, int B, int N, const LMParams& prm,
            cudaStream_t stream) {
  const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lm_solve_kernel<DOF, FAST, BOUNDS, JTJ>
      <<<grid, kWarpsPerBlock * 32, 0, stream>>>(
          x3d, x2d, w2d, cam, delta, bounds, pose0, pose_out, cost_out,
          jtj_out, B, N, prm);
}

// Picks one of the 16 instances (dof x fast x bounds x jtj) at run time.
template <int DOF, bool... Flags>
void dispatch(const bool* flags, const float* x3d, const float* x2d,
              const float* w2d, const float* cam, const float* delta,
              const float* bounds, const float* pose0, float* pose_out,
              float* cost_out, float* jtj_out, int B, int N,
              const LMParams& prm, cudaStream_t stream) {
  if constexpr (sizeof...(Flags) == 3) {
    launch<DOF, Flags...>(x3d, x2d, w2d, cam, delta, bounds, pose0,
                          pose_out, cost_out, jtj_out, B, N, prm, stream);
  } else {
    auto next = flags[sizeof...(Flags)]
                    ? &dispatch<DOF, Flags..., true>
                    : &dispatch<DOF, Flags..., false>;
    next(flags, x3d, x2d, w2d, cam, delta, bounds, pose0, pose_out,
         cost_out, jtj_out, B, N, prm, stream);
  }
}

}  // namespace
}  // namespace epropnp

// Plain C entry point (loaded with ctypes). ``bounds`` is (B, 4)
// [lb_u, lb_v, ub_u, ub_v] or null; ``jtj_out`` is (B, dof (dof + 1) / 2),
// the undamped JtJ lower triangle row by row, or null for no JtJ. Returns
// the cudaError_t of the launch; 0 means the kernel was queued on
// ``stream``; a dof other than 4 or 6 returns cudaErrorInvalidValue
// without a launch.
extern "C" int epropnp_lm_solve(
    const float* x3d, const float* x2d, const float* w2d, const float* cam,
    const float* delta, const float* bounds, const float* pose0,
    float* pose_out, float* cost_out, float* jtj_out, int B, int N, int dof,
    int fast_mode, int num_iter, float z_min, float eps,
    float min_lm_diagonal, float max_lm_diagonal,
    float min_relative_decrease, float initial_trust_region_radius,
    float max_trust_region_radius, void* stream) {
  if (B <= 0) return 0;
  epropnp::LMParams prm{num_iter, z_min, eps, min_lm_diagonal,
                        max_lm_diagonal, min_relative_decrease,
                        initial_trust_region_radius,
                        max_trust_region_radius};
  auto s = static_cast<cudaStream_t>(stream);
  const bool flags[3] = {fast_mode != 0, bounds != nullptr,
                         jtj_out != nullptr};
  if (dof == 6)
    epropnp::dispatch<6>(flags, x3d, x2d, w2d, cam, delta, bounds, pose0,
                         pose_out, cost_out, jtj_out, B, N, prm, s);
  else if (dof == 4)
    epropnp::dispatch<4>(flags, x3d, x2d, w2d, cam, delta, bounds, pose0,
                         pose_out, cost_out, jtj_out, B, N, prm, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
