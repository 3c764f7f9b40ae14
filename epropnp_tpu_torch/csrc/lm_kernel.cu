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
// points followed by a few hundred dependent scalar flops (Cholesky, pose
// update, trust region). It is small-matrix work bound by latency and by
// instruction throughput; the products are 6x6, no tensor-core shape fits
// them and TF32 could not hold the twin's rtol 1e-4. So the design is
// about occupancy, reuse and instruction slots:
//
// * A group of G threads (a power of two, 1 to 512, picked by the wrapper,
//   lm_kernel.group_size: up to 4 points a thread in a group of up to a
//   warp, up to 8 in a larger one, more threads while B leaves the card
//   short of warps) shares one object. Groups of fewer than 32 threads
//   pack a block of 128 threads and reduce with an xor butterfly at their
//   width; every thread of the group holds the same sums and runs the
//   unrolled Cholesky, the pose update and the trust region itself (a warp
//   runs that tail once for all its groups). A group of 32 is a warp: a
//   reduce-scatter (31 shuffles for 28 values) and a broadcast. A group of
//   64-512 threads is a block: each warp reduce-scatters into shared
//   memory, every warp adds the warps' partial sums in the same fixed
//   order, and the first warp runs the tail alone and hands the next pose
//   to the others through shared memory: two barriers an evaluation.
// * The points are read from device memory once: each object's points are
//   staged in shared memory as two float4 planes before the first
//   evaluation (where they fit: up to kStageBytes a block).
// * The solver's state (pose, JtJ, gradient, step, radius) lives in shared
//   memory between tails, so an evaluation holds only its sums, the
//   rotation and the point in registers: no local memory, no spill.
// * The Jacobian's structural zeros cost no product (pnp_common.cuh). The
//   rest of a point is bound by instruction throughput: about 250
//   instructions on sm_90a, 7 IEEE divisions of 10 each among them.
// * A ragged edge (N not a multiple of G, B not a multiple of the groups
//   of a block) is masked, not padded; a group past B computes on the last
//   object and stores nothing, so every barrier and shuffle sees all its
//   threads.

#include <cuda_runtime.h>

#include "pnp_common.cuh"

namespace epropnp {
namespace {

constexpr int kMaxGroup = 512;    // threads an object (and a block)
constexpr int kNarrowBlock = 128;  // threads a block of groups <= 32
constexpr int kStageBytes = 160 * 1024;

// One object's solver state, in shared memory between the tails, so that
// an evaluation keeps only its sums and the point in registers.
template <int DOF>
struct State {
  float pose[8], pose_new[8], step[DOF], jtj[tri<DOF>()], g[DOF];
  float cost, radius, decrease;
};

template <int N>
__device__ __forceinline__ void load(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = src[i];
}

template <int DOF>
__host__ __device__ constexpr size_t state_bytes(int objs) {
  return sizeof(State<DOF>) * (size_t)objs;
}

template <int DOF, bool FAST, bool BOUNDS, bool JTJ>
__global__ void __launch_bounds__(kMaxGroup)
lm_solve_kernel(const float* __restrict__ x3d, const float* __restrict__ x2d,
                const float* __restrict__ w2d, const float* __restrict__ cam,
                const float* __restrict__ delta,
                const float* __restrict__ bounds,
                const float* __restrict__ pose0, float* __restrict__ pose_out,
                float* __restrict__ cost_out, float* __restrict__ jtj_out,
                int B, int N, int G, int staged, LMParams prm) {
  constexpr int kD = DOF, kP = pose_dim<DOF>(), kT = tri<DOF>();
  constexpr int kK = 1 + kT + kD;  // cost, JtJ, gradient
  extern __shared__ float4 smem4[];
  __shared__ float red[kMaxGroup / 32][32];

  const int objs = blockDim.x / G;  // objects a block (1 when G > 32)
  const int slot = threadIdx.x / G;
  const int lane = threadIdx.x & (G - 1);
  const bool wide = G > 32;
  const bool leader = !wide || threadIdx.x < 32;
  const int b_raw = blockIdx.x * objs + slot;
  const bool store = b_raw < B;
  const int b = store ? b_raw : B - 1;

  const ObjParams o = load_obj(cam, delta, b);
  const Bounds bnd = BOUNDS ? load_bounds(bounds, b) : Bounds{};
  const float* px3 = x3d + (size_t)b * N * 3;
  const float* px2 = x2d + (size_t)b * N * 2;
  const float* pw2 = w2d + (size_t)b * N * 2;
  PointSource pts{nullptr, nullptr, px3, px2, pw2};
  const size_t plane_floats4 = staged ? (size_t)objs * 2 * N : 0;
  State<DOF>* st = reinterpret_cast<State<DOF>*>(smem4 + plane_floats4) + slot;
  if (staged) {
    float4* a = smem4 + (size_t)slot * 2 * N;
    stage_points(a, a + N, px3, px2, pw2, N, lane, G);
    pts.a = a;
    pts.c = a + N;
  }
  // every thread of the group writes the same values; each reads its own
  if (leader) {
#pragma unroll
    for (int i = 0; i < kP; ++i) st->pose_new[i] = pose0[b * kP + i];
    st->cost = 0.f;
#pragma unroll
    for (int i = 0; i < kT; ++i) st->jtj[i] = 0.f;
  }
  __syncthreads();

  // Sums of one evaluation at st->pose_new, in every thread of the group.
  auto ev = [&](float* tot) {
    float r[9], t[3];
    {
      float pose[kP];
      load<kP>(pose, st->pose_new);
      pose_rt<DOF>(pose, r, t);
    }
    float acc[kK];
#pragma unroll
    for (int i = 0; i < kK; ++i) acc[i] = 0.f;
#pragma unroll 2
    for (int n = lane; n < N; n += G)
      accumulate_point<!FAST, DOF, BOUNDS>(r, t, o, prm.z_min, bnd, pts(n),
                                           acc[0], acc + 1, acc + 1 + kT);
    if (G < 32) {
      group_allreduce<kK>(acc, G);
#pragma unroll
      for (int i = 0; i < kK; ++i) tot[i] = acc[i];
      return;
    }
    float mine = warp_reduce_scatter<kK>(acc);
    if (wide) {  // the warps' partial sums, added in a fixed order
      red[threadIdx.x >> 5][threadIdx.x & 31] = mine;
      __syncthreads();
      mine = 0.f;
      for (int w = 0; w < (G >> 5); ++w) mine += red[w][threadIdx.x & 31];
    }
#pragma unroll
    for (int i = 0; i < kK; ++i) tot[i] = __shfl_sync(0xffffffffu, mine, i);
  };
  // The leader's new pose to the other warps of a wide group.
  auto publish = [&]() {
    if (wide) __syncthreads();
  };

  float tot[kK];
  if (FAST) {
    // pure Gauss-Newton; the cost and JtJ are those at the pose before the
    // last update (the reference's loop carry), zero after no iteration
    for (int it = 0; it < prm.num_iter; ++it) {
      ev(tot);
      if (leader) {
        float pose[kP];
        load<kP>(pose, st->pose_new);
        gn_step<DOF>(prm, tot + 1, tot + 1 + kT, pose);
#pragma unroll
        for (int i = 0; i < kP; ++i) st->pose_new[i] = pose[i];
        st->cost = tot[0];
#pragma unroll
        for (int i = 0; i < kT; ++i) st->jtj[i] = tot[1 + i];
      }
      publish();
    }
    if (leader) {
#pragma unroll
      for (int i = 0; i < kP; ++i) st->pose[i] = st->pose_new[i];
    }
  } else {
    // the JtJ kept by the trust region is that at the accepted pose
    ev(tot);
    if (leader) {
#pragma unroll
      for (int i = 0; i < kP; ++i) st->pose[i] = st->pose_new[i];
      st->cost = tot[0];
#pragma unroll
      for (int i = 0; i < kT; ++i) st->jtj[i] = tot[1 + i];
#pragma unroll
      for (int i = 0; i < kD; ++i) st->g[i] = tot[1 + kT + i];
      st->radius = prm.initial_trust_region_radius;
      st->decrease = 2.f;
    }
    for (int it = 0; it < prm.num_iter; ++it) {
      if (leader) {
        float pose[kP], jtj[kT], g[kD], step[kD], pose_new[kP];
        load<kP>(pose, st->pose);
        load<kT>(jtj, st->jtj);
        load<kD>(g, st->g);
        tr_propose<DOF>(prm, pose, jtj, g, st->radius, step, pose_new);
#pragma unroll
        for (int i = 0; i < kD; ++i) st->step[i] = step[i];
#pragma unroll
        for (int i = 0; i < kP; ++i) st->pose_new[i] = pose_new[i];
      }
      publish();
      ev(tot);
      if (leader) {
        float pose[kP], jtj[kT], g[kD], step[kD], pose_new[kP];
        load<kP>(pose, st->pose);
        load<kT>(jtj, st->jtj);
        load<kD>(g, st->g);
        load<kD>(step, st->step);
        load<kP>(pose_new, st->pose_new);
        float cost = st->cost, radius = st->radius, decrease = st->decrease;
        tr_accept<DOF>(prm, pose, cost, jtj, g, radius, decrease, step,
                       pose_new, tot[0], tot + 1, tot + 1 + kT);
#pragma unroll
        for (int i = 0; i < kP; ++i) st->pose[i] = pose[i];
#pragma unroll
        for (int i = 0; i < kT; ++i) st->jtj[i] = jtj[i];
#pragma unroll
        for (int i = 0; i < kD; ++i) st->g[i] = g[i];
        st->cost = cost;
        st->radius = radius;
        st->decrease = decrease;
      }
    }
  }

  if (store && lane == 0) {
#pragma unroll
    for (int i = 0; i < kP; ++i) pose_out[b * kP + i] = st->pose[i];
    cost_out[b] = st->cost;
    if (JTJ) {
#pragma unroll
      for (int i = 0; i < kT; ++i) jtj_out[b * kT + i] = st->jtj[i];
    }
  }
}

// Launches one instance, or with ``occ`` set only reports its resources
// at this launch shape: registers, threads a block, dynamic shared memory
// and resident blocks an SM.
template <int DOF, bool FAST, bool BOUNDS, bool JTJ>
int launch(const float* x3d, const float* x2d, const float* w2d,
           const float* cam, const float* delta, const float* bounds,
           const float* pose0, float* pose_out, float* cost_out,
           float* jtj_out, int B, int N, int G, const LMParams& prm,
           cudaStream_t stream, int* occ) {
  auto kernel = lm_solve_kernel<DOF, FAST, BOUNDS, JTJ>;
  const int threads = G > 32 ? G : kNarrowBlock;
  const int objs = threads / G;
  const size_t stage = sizeof(float4) * 2 * (size_t)N * objs;
  const int staged = stage <= (size_t)kStageBytes ? 1 : 0;
  const size_t smem = (staged ? stage : 0) + state_bytes<DOF>(objs);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBytes + (int)state_bytes<DOF>(kNarrowBlock));
    if (err != cudaSuccess) return (int)err;
  }
  if (occ != nullptr) {
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
  const int grid = (B + objs - 1) / objs;
  kernel<<<grid, threads, smem, stream>>>(x3d, x2d, w2d, cam, delta, bounds,
                                          pose0, pose_out, cost_out, jtj_out,
                                          B, N, G, staged, prm);
  return (int)cudaGetLastError();
}

// Picks one of the 16 instances (dof x fast x bounds x jtj) at run time.
template <int DOF, bool... Flags>
int dispatch(const bool* flags, const float* x3d, const float* x2d,
             const float* w2d, const float* cam, const float* delta,
             const float* bounds, const float* pose0, float* pose_out,
             float* cost_out, float* jtj_out, int B, int N, int G,
             const LMParams& prm, cudaStream_t stream, int* occ) {
  if constexpr (sizeof...(Flags) == 3) {
    return launch<DOF, Flags...>(x3d, x2d, w2d, cam, delta, bounds, pose0,
                                 pose_out, cost_out, jtj_out, B, N, G, prm,
                                 stream, occ);
  } else {
    auto next = flags[sizeof...(Flags)]
                    ? &dispatch<DOF, Flags..., true>
                    : &dispatch<DOF, Flags..., false>;
    return next(flags, x3d, x2d, w2d, cam, delta, bounds, pose0, pose_out,
                cost_out, jtj_out, B, N, G, prm, stream, occ);
  }
}

}  // namespace
}  // namespace epropnp

// Plain C entry point (loaded with ctypes). ``bounds`` is (B, 4)
// [lb_u, lb_v, ub_u, ub_v] or null; ``jtj_out`` is (B, dof (dof + 1) / 2),
// the undamped JtJ lower triangle row by row, or null for no JtJ;
// ``group`` is the threads an object (a power of two, 1 to 512; the
// wrapper's ``lm_kernel.group_size``). Returns the cudaError_t of the
// launch; 0 means the kernel was queued on ``stream``; a dof other than 4
// or 6, or a group out of range, returns cudaErrorInvalidValue without a
// launch.
extern "C" int epropnp_lm_solve(
    const float* x3d, const float* x2d, const float* w2d, const float* cam,
    const float* delta, const float* bounds, const float* pose0,
    float* pose_out, float* cost_out, float* jtj_out, int B, int N, int dof,
    int group, int fast_mode, int num_iter, float z_min, float eps,
    float min_lm_diagonal, float max_lm_diagonal,
    float min_relative_decrease, float initial_trust_region_radius,
    float max_trust_region_radius, void* stream) {
  if (B <= 0) return 0;
  if (group < 1 || group > epropnp::kMaxGroup || (group & (group - 1)) ||
      N < 0 || (dof != 4 && dof != 6))
    return (int)cudaErrorInvalidValue;
  epropnp::LMParams prm{num_iter, z_min, eps, min_lm_diagonal,
                        max_lm_diagonal, min_relative_decrease,
                        initial_trust_region_radius,
                        max_trust_region_radius};
  auto s = static_cast<cudaStream_t>(stream);
  const bool flags[3] = {fast_mode != 0, bounds != nullptr,
                         jtj_out != nullptr};
  if (dof == 6)
    return epropnp::dispatch<6>(flags, x3d, x2d, w2d, cam, delta, bounds,
                                pose0, pose_out, cost_out, jtj_out, B, N,
                                group, prm, s, nullptr);
  return epropnp::dispatch<4>(flags, x3d, x2d, w2d, cam, delta, bounds,
                              pose0, pose_out, cost_out, jtj_out, B, N,
                              group, prm, s, nullptr);
}

// Resources of the instance (dof, fast_mode, bounds, jtj: 0 or 1) at the
// launch shape of (N, group), without a launch: ``out`` receives its
// registers a thread, threads a block, dynamic shared memory (bytes) and
// resident blocks an SM. Returns a cudaError_t.
extern "C" int epropnp_lm_occupancy(int dof, int fast_mode, int bounds,
                                    int jtj, int N, int group, int* out) {
  if (group < 1 || group > epropnp::kMaxGroup || (group & (group - 1)) ||
      N < 0 || (dof != 4 && dof != 6))
    return (int)cudaErrorInvalidValue;
  const bool flags[3] = {fast_mode != 0, bounds != 0, jtj != 0};
  const epropnp::LMParams prm{};
  if (dof == 6)
    return epropnp::dispatch<6>(flags, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, 1, N, group, prm, nullptr, out);
  return epropnp::dispatch<4>(flags, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, 1, N, group, prm, nullptr, out);
}
