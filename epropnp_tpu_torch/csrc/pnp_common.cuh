// Shared device code of the PnP kernels: per-point projection, Huber cost
// with the IRLS sqrt-derivative rescale, the analytic pose Jacobian, the
// unrolled damped Cholesky solve and the tangent-space pose update, for
// 6DoF poses [tx, ty, tz, qw, qi, qj, qk] and 4DoF poses [tx, ty, tz, yaw]
// (template argument DOF, 6 by default); the group reductions and the
// point staging that both kernels use.
//
// The arithmetic follows epropnp_tpu/ops/pnp/pallas_lm.py (_evaluate,
// _chol_solve, _pose_add) term by term, so the plain PyTorch twins in
// epropnp_tpu_torch/ops/pnp/lm_kernel.py compute the same function:
//   * the z clamp divides by zc but keeps zc_raw in the numerator;
//   * epsilons 1e-24 (squared residual) and 1e-10 (Huber derivative);
//   * the quaternion is renormalised inside the evaluation;
//   * 4DoF rotates by yaw about y: xr = c x + s z, yr = y, zr = -s x + c z;
//   * with BOUNDS the projection is clamped into the per-object box
//     [lb_u, ub_u] x [lb_v, ub_v] before the residual and the Jacobian;
//   * with CLIP (trust-region mode) Jacobian rows are zeroed where the z
//     clamp is active (both rows) or where a bound clamp is active (that
//     row: u strictly inside (lb_u, ub_u) keeps the u row). Fast mode keeps
//     them, also at an active bound clamp.
// Every division stays a division, as in the twins: a reciprocal taken
// once and multiplied rounds otherwise, and f32 rounding decides the
// near-tied objects that the agreement checks count. Products with the
// Jacobian's structural zeros (u does not depend on ty, v not on tx) are
// left out of the sums: for finite values each point's rounded terms are
// the same bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace epropnp {

// Pose size ([t, q] or [t, yaw]) and JtJ lower-triangle size of a dof.
template <int DOF>
__host__ __device__ constexpr int pose_dim() { return DOF == 4 ? 4 : 7; }
template <int DOF>
__host__ __device__ constexpr int tri() { return DOF * (DOF + 1) / 2; }

// Per-object camera and Huber delta.
struct ObjParams {
  float fx, fy, cx, cy, delta;
};

// Scalar parameters of the trust-region LM (LMSolver fields).
struct LMParams {
  int num_iter;
  float z_min, eps, min_lm_diagonal, max_lm_diagonal, min_relative_decrease,
      initial_trust_region_radius, max_trust_region_radius;
};

__device__ __forceinline__ ObjParams load_obj(const float* cam,
                                              const float* delta, int b) {
  ObjParams o;
  o.fx = cam[b * 4 + 0];
  o.fy = cam[b * 4 + 1];
  o.cx = cam[b * 4 + 2];
  o.cy = cam[b * 4 + 3];
  o.delta = delta[b];
  return o;
}

// Projection box of one object: [lb_u, ub_u] x [lb_v, ub_v].
struct Bounds {
  float lb_u, lb_v, ub_u, ub_v;
};

__device__ __forceinline__ Bounds load_bounds(const float* bounds, int b) {
  return Bounds{bounds[b * 4 + 0], bounds[b * 4 + 1], bounds[b * 4 + 2],
                bounds[b * 4 + 3]};
}

// ---- the points of one object ----
//
// A point is (x, y, z, u, v, wu, wv). Staged, an object's points sit in
// shared memory as two float4 planes, a = (x, y, z, u) and c = (v, wu, wv,
// 0), so that neighbouring threads reading neighbouring points make
// conflict-free 16-byte loads; unstaged (more points than shared memory
// holds), they are read from device memory. The choice is one uniform
// branch a point: hoisting it out of the loops (one loop a source)
// changed the compiler's contractions and register use for the worse.
struct Pt {
  float x, y, z, u, v, wu, wv;
};

struct PointSource {
  const float4* a;  // staged planes (null: read device memory)
  const float4* c;
  const float* x3d;  // the object's rows in device memory
  const float* x2d;
  const float* w2d;

  __device__ __forceinline__ Pt operator()(int n) const {
    if (a != nullptr) {
      const float4 p = a[n], q = c[n];
      return Pt{p.x, p.y, p.z, p.w, q.x, q.y, q.z};
    }
    return Pt{__ldg(x3d + 3 * n), __ldg(x3d + 3 * n + 1),
              __ldg(x3d + 3 * n + 2), __ldg(x2d + 2 * n),
              __ldg(x2d + 2 * n + 1), __ldg(w2d + 2 * n),
              __ldg(w2d + 2 * n + 1)};
  }
};

// Copies points [0, n) of one object into the planes (threads ``first``,
// ``first + step``, ... of the caller's group); a barrier must follow.
__device__ __forceinline__ void stage_points(float4* a, float4* c,
                                             const float* x3d,
                                             const float* x2d,
                                             const float* w2d, int n,
                                             int first, int step) {
  for (int i = first; i < n; i += step) {
    a[i] = make_float4(__ldg(x3d + 3 * i), __ldg(x3d + 3 * i + 1),
                       __ldg(x3d + 3 * i + 2), __ldg(x2d + 2 * i));
    c[i] = make_float4(__ldg(x2d + 2 * i + 1), __ldg(w2d + 2 * i),
                       __ldg(w2d + 2 * i + 1), 0.f);
  }
}

// ---- reductions ----

// Sums K values over each aligned group of ``width`` lanes (a power of two,
// at most 32, the same in the whole warp) with an xor butterfly. Addition
// commutes, so every lane of a group ends with bit-identical sums. The
// whole warp must call it.
template <int K>
__device__ __forceinline__ void group_allreduce(float* v, int width) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < width) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    }
  }
}

template <int K>
__device__ __forceinline__ void warp_allreduce(float* v) {
  group_allreduce<K>(v, 32);
}

// One level of the reduce-scatter below: lanes with bit H keep the upper
// half of the H * 2 values they carry, the others the lower half, and each
// adds its partner's copy of the half it keeps.
template <int H>
__device__ __forceinline__ void reduce_scatter_level(float* v, int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
  if constexpr (H > 1) reduce_scatter_level<H / 2>(v, lane);
}

// Reduce-scatter over the warp (K <= 32): lane l returns the warp's sum of
// v[l] (0 for l >= K). Each level halves the values a lane carries, so it
// takes 31 shuffles where an all-reduce of K values takes 5 K.
template <int K>
__device__ __forceinline__ float warp_reduce_scatter(const float* in) {
  static_assert(K <= 32, "at most one value a lane");
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = i < K ? in[i] : 0.f;
  reduce_scatter_level<16>(v, threadIdx.x & 31);
  return v[0];
}

// ---- per point ----

// Rotation matrix (row major) and translation of a pose.
template <int DOF = 6>
__device__ __forceinline__ void pose_rt(const float* pose, float* r,
                                        float* t) {
  t[0] = pose[0];
  t[1] = pose[1];
  t[2] = pose[2];
  if constexpr (DOF == 4) {
    const float c = cosf(pose[3]), s = sinf(pose[3]);
    r[0] = c;
    r[1] = 0.f;
    r[2] = s;
    r[3] = 0.f;
    r[4] = 1.f;
    r[5] = 0.f;
    r[6] = -s;
    r[7] = 0.f;
    r[8] = c;
    return;
  }
  const float qn = rsqrtf(pose[3] * pose[3] + pose[4] * pose[4] +
                          pose[5] * pose[5] + pose[6] * pose[6] + 1e-24f);
  const float w = pose[3] * qn, i = pose[4] * qn, j = pose[5] * qn,
              k = pose[6] * qn;
  r[0] = 1.f - 2.f * (j * j + k * k);
  r[1] = 2.f * (i * j - k * w);
  r[2] = 2.f * (i * k + j * w);
  r[3] = 2.f * (i * j + k * w);
  r[4] = 1.f - 2.f * (i * i + k * k);
  r[5] = 2.f * (j * k - i * w);
  r[6] = 2.f * (i * k - j * w);
  r[7] = 2.f * (j * k + i * w);
  r[8] = 1.f - 2.f * (i * i + j * j);
}

// Projection of one point: the rotated point, the raw and clamped depth,
// and u, v.
struct Proj {
  float xr, yr, zr, zc_raw, zc, u, v;
};

template <int DOF = 6>
__device__ __forceinline__ Proj project(const float* r, const float* t,
                                        const ObjParams& o, float z_min,
                                        float x, float y, float z) {
  Proj p;
  if constexpr (DOF == 4) {  // r = [c 0 s; 0 1 0; -s 0 c]
    p.xr = r[0] * x + r[2] * z;
    p.yr = y;
    p.zr = r[6] * x + r[8] * z;
  } else {
    p.xr = r[0] * x + r[1] * y + r[2] * z;
    p.yr = r[3] * x + r[4] * y + r[5] * z;
    p.zr = r[6] * x + r[7] * y + r[8] * z;
  }
  const float xc = p.xr + t[0], yc = p.yr + t[1];
  p.zc_raw = p.zr + t[2];
  p.zc = fmaxf(p.zc_raw, z_min);
  p.u = (o.fx * xc + o.cx * p.zc_raw) / p.zc;
  p.v = (o.fy * yc + o.cy * p.zc_raw) / p.zc;
  return p;
}

__device__ __forceinline__ float huber_cost(float ss, float s_sqrt,
                                            float delta) {
  return s_sqrt <= delta ? 0.5f * ss : delta * s_sqrt - 0.5f * delta * delta;
}

// Huber cost of one point (scoring: no Jacobian). BOUNDS clamps u, v
// into the object's box first, as accumulate_point does.
template <int DOF = 6, bool BOUNDS = false>
__device__ __forceinline__ float point_cost(const float* r, const float* t,
                                            const ObjParams& o, float z_min,
                                            const Bounds& bnd, const Pt& q) {
  Proj p = project<DOF>(r, t, o, z_min, q.x, q.y, q.z);
  if constexpr (BOUNDS) {
    p.u = fminf(fmaxf(p.u, bnd.lb_u), bnd.ub_u);
    p.v = fminf(fmaxf(p.v, bnd.lb_v), bnd.ub_v);
  }
  const float ru = (p.u - q.u) * q.wu, rv = (p.v - q.v) * q.wv;
  const float ss = ru * ru + rv * rv;
  return huber_cost(ss, sqrtf(fmaxf(ss, 1e-24f)), o.delta);
}

// Adds one point's cost, JtJ lower triangle (row-major) and gradient.
// BOUNDS clamps u, v into the object's box. With CLIP the Jacobian row of
// a clamped coordinate is zeroed (pallas_lm.py _evaluate, clip_jac); fast
// mode keeps it, as the reference's fast Gauss-Newton does.
template <bool CLIP, int DOF = 6, bool BOUNDS = false>
__device__ __forceinline__ void accumulate_point(
    const float* r, const float* t, const ObjParams& o, float z_min,
    const Bounds& bnd, const Pt& q, float& cost, float* jtj, float* g) {
  Proj p = project<DOF>(r, t, o, z_min, q.x, q.y, q.z);
  float in_u = 1.f, in_v = 1.f;
  if constexpr (BOUNDS) {
    in_u = (p.u > bnd.lb_u && p.u < bnd.ub_u) ? 1.f : 0.f;
    in_v = (p.v > bnd.lb_v && p.v < bnd.ub_v) ? 1.f : 0.f;
    p.u = fminf(fmaxf(p.u, bnd.lb_u), bnd.ub_u);
    p.v = fminf(fmaxf(p.v, bnd.lb_v), bnd.ub_v);
  }
  const float ru = (p.u - q.u) * q.wu, rv = (p.v - q.v) * q.wv;
  const float ss = ru * ru + rv * rv;
  const float s_sqrt = sqrtf(fmaxf(ss, 1e-24f));
  cost += huber_cost(ss, s_sqrt, o.delta);
  const float rho = sqrtf(fminf(o.delta / fmaxf(s_sqrt, 1e-10f), 1.f));

  const float live = (!CLIP || p.zc_raw >= z_min) ? 1.f : 0.f;
  const float live_u = CLIP ? live * in_u : live;
  const float live_v = CLIP ? live * in_v : live;
  const float du0 = o.fx / p.zc * live_u;
  const float du2 = (o.cx - p.u) / p.zc * live_u;
  const float dv1 = o.fy / p.zc * live_v;
  const float dv2 = (o.cy - p.v) / p.zc * live_v;
  const float swu = q.wu * rho, swv = q.wv * rho;

  // ju[1] and jv[0] are structural zeros: a sum with one nonzero product
  // adds that product rounded alone (__fmul_rn: not fused into the
  // accumulation), as ju_a ju_b + 0 rounds
  float ju[DOF], jv[DOF];
  ju[0] = du0 * swu;
  ju[1] = 0.f;
  ju[2] = du2 * swu;
  jv[0] = 0.f;
  jv[1] = dv1 * swv;
  jv[2] = dv2 * swv;
  if constexpr (DOF == 4) {
    ju[3] = (du0 * p.zr - du2 * p.xr) * swu;
    jv[3] = (-dv2 * p.xr) * swv;
  } else {
    const float w0 = 2.f * p.xr, w1 = 2.f * p.yr, w2 = 2.f * p.zr;
    ju[3] = (-du2 * w1) * swu;
    ju[4] = (-du0 * w2 + du2 * w0) * swu;
    ju[5] = (du0 * w1) * swu;
    jv[3] = (dv1 * w2 - dv2 * w1) * swv;
    jv[4] = (dv2 * w0) * swv;
    jv[5] = (-dv1 * w0) * swv;
  }
  const float ru_s = ru * rho, rv_s = rv * rho;
  int idx = 0;
#pragma unroll
  for (int a = 0; a < DOF; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const bool has_u = a != 1 && b != 1, has_v = a != 0 && b != 0;
      if (has_u && has_v)
        jtj[idx] += ju[a] * ju[b] + jv[a] * jv[b];
      else if (has_u)
        jtj[idx] += __fmul_rn(ju[a], ju[b]);
      else if (has_v)
        jtj[idx] += __fmul_rn(jv[a], jv[b]);
      ++idx;
    }
    if (a == 0)
      g[a] += __fmul_rn(ju[a], ru_s);
    else if (a == 1)
      g[a] += __fmul_rn(jv[a], rv_s);
    else
      g[a] += ju[a] * ru_s + jv[a] * rv_s;
  }
}

// ---- per object ----

// Solve (damped) x = -g for SPD ``a`` given as its lower triangle.
template <int DOF = 6>
__device__ __forceinline__ void chol_solve(const float* a, const float* g,
                                           float* x) {
  float l[tri<DOF>()];
#pragma unroll
  for (int i = 0; i < DOF; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = a[i * (i + 1) / 2 + j];
#pragma unroll
      for (int k = 0; k < j; ++k)
        s -= l[i * (i + 1) / 2 + k] * l[j * (j + 1) / 2 + k];
      l[i * (i + 1) / 2 + j] = (i == j) ? sqrtf(s) : s / l[j * (j + 1) / 2 + j];
    }
  }
  float y[DOF];
#pragma unroll
  for (int i = 0; i < DOF; ++i) {
    float s = -g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= l[i * (i + 1) / 2 + k] * y[k];
    y[i] = s / l[i * (i + 1) / 2 + i];
  }
#pragma unroll
  for (int i = DOF - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < DOF; ++k) s -= l[k * (k + 1) / 2 + i] * x[k];
    x[i] = s / l[i * (i + 1) / 2 + i];
  }
}

template <int DOF = 6>
__device__ __forceinline__ void pose_add(const float* pose, const float* step,
                                         float* out) {
  out[0] = pose[0] + step[0];
  out[1] = pose[1] + step[1];
  out[2] = pose[2] + step[2];
  if constexpr (DOF == 4) {
    out[3] = pose[3] + step[3];
    return;
  }
  const float w = pose[3], i = pose[4], j = pose[5], k = pose[6];
  const float d0 = step[3], d1 = step[4], d2 = step[5];
  const float qw = w + (i * d0 + j * d1 + k * d2);
  const float qi = i + (-w * d0 - k * d1 + j * d2);
  const float qj = j + (k * d0 - w * d1 - i * d2);
  const float qk = k + (-j * d0 + i * d1 - w * d2);
  const float n = fmaxf(sqrtf(qw * qw + qi * qi + qj * qj + qk * qk), 1e-12f);
  out[3] = qw / n;
  out[4] = qi / n;
  out[5] = qj / n;
  out[6] = qk / n;
}

// Gauss-Newton step of fast mode: the eps-damped solve and the update.
template <int DOF = 6>
__device__ __forceinline__ void gn_step(const LMParams& prm,
                                        const float* jtj, const float* g,
                                        float* pose) {
  constexpr int kD = DOF, kP = pose_dim<DOF>(), kT = tri<DOF>();
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

// The first half of one trust-region LM update (pallas_lm.py lm_body):
// the damped step from the current (jtj, g) and the candidate pose.
template <int DOF = 6>
__device__ __forceinline__ void tr_propose(const LMParams& prm,
                                           const float* pose,
                                           const float* jtj, const float* g,
                                           float radius, float* step,
                                           float* pose_new) {
  constexpr int kD = DOF, kT = tri<DOF>();
  float damped[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) damped[i] = jtj[i];
#pragma unroll
  for (int a = 0; a < kD; ++a) {
    const float d = jtj[a * (a + 1) / 2 + a];
    damped[a * (a + 1) / 2 + a] =
        d + fminf(fmaxf(d, prm.min_lm_diagonal), prm.max_lm_diagonal) /
                radius + prm.eps;
  }
  chol_solve<DOF>(damped, g, step);
  pose_add<DOF>(pose, step, pose_new);
}

// The second half: accept or reject the candidate evaluated at
// (cost_new, jtj_new, g_new), and the new radius. State is updated in
// place; the order is that of the reference.
template <int DOF = 6>
__device__ __forceinline__ void tr_accept(
    const LMParams& prm, float* pose, float& cost, float* jtj, float* g,
    float& radius, float& decrease, const float* step, const float* pose_new,
    float cost_new, const float* jtj_new, const float* g_new) {
  constexpr int kD = DOF, kP = pose_dim<DOF>(), kT = tri<DOF>();
  float mcc = 0.f;
#pragma unroll
  for (int a = 0; a < kD; ++a) {
    float hs = 0.f;
#pragma unroll
    for (int b = 0; b < kD; ++b) {
      const int key = a >= b ? a * (a + 1) / 2 + b : b * (b + 1) / 2 + a;
      hs += jtj[key] * step[b];
    }
    mcc -= step[a] * (hs * 0.5f + g[a]);
  }
  const float rel = (cost - cost_new) / mcc;
  const bool ok = rel >= prm.min_relative_decrease && mcc > 0.f;
  if (ok) {
#pragma unroll
    for (int i = 0; i < kP; ++i) pose[i] = pose_new[i];
    cost = cost_new;
#pragma unroll
    for (int i = 0; i < kT; ++i) jtj[i] = jtj_new[i];
#pragma unroll
    for (int i = 0; i < kD; ++i) g[i] = g_new[i];
  }
  const float c = 2.f * rel - 1.f;
  const float r_ok = radius / fmaxf(1.f - c * c * c, 1.f / 3.f);
  radius = fminf(fmaxf(ok ? r_ok : radius, prm.eps),
                 prm.max_trust_region_radius);
  radius = ok ? radius : radius / decrease;
  decrease = ok ? 2.f : decrease * 2.f;
}

// One trust-region LM update where one thread holds the whole object.
// ``ev`` evaluates a pose into (cost, jtj, g).
template <int DOF = 6, typename Eval>
__device__ __forceinline__ void lm_trust_region_step(
    const LMParams& prm, float* pose, float& cost, float* jtj, float* g,
    float& radius, float& decrease, Eval ev) {
  constexpr int kD = DOF, kP = pose_dim<DOF>(), kT = tri<DOF>();
  float step[kD], pose_new[kP];
  tr_propose<DOF>(prm, pose, jtj, g, radius, step, pose_new);
  float cost_new, jtj_new[kT], g_new[kD];
  ev(pose_new, cost_new, jtj_new, g_new);
  tr_accept<DOF>(prm, pose, cost, jtj, g, radius, decrease, step, pose_new,
                 cost_new, jtj_new, g_new);
}

}  // namespace epropnp
