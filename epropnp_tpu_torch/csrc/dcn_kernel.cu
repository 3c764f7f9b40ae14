// K3: the DCNv2 sampling contraction (3x3 modulated deformable conv).
//
// Replaces epropnp_tpu/ops/pallas_dcn.py::_contract_pallas (body
// _contract_kernel), as reached by dcn_gather_contract (float tables) and
// dcn_gather_contract_q (int8 tables) from epropnp_tpu/ops/deform_conv.py,
// per level and level-packed. For every output position (img, i, j) of a
// level and output channel o:
//
//   out = bias[o] + sum_tap sum_ci round_k(s_tap[ci]) * W[tap, ci, o]
//   s_tap = sum_corner w_corner * x[img, y0 + yy, x0 + xx, ci]   (in f32)
//   p_tap = (j s + dx_tap + off_x, i s + dy_tap + off_y)   in [x, y]
//   w_corner = bilinear weight * sigmoid(mask_tap) * modulation_scale
//
// with (dx_tap, dy_tap) in {-1, 0, 1}^2 row-major by (dy, dx). The offsets
// and mask logits come raw from conv_offset in mmcv's channel order:
// (dy, dx) for each of the 9 taps, then the 9 mask logits, read in f32.
// A corner outside [0, h) x [0, w) of its own level contributes 0.
//
// Variants (template XT, WT), as _contract_kernel computes them: the map x
// is f32, bf16 or int8 (per-channel scales already folded into W); the
// kernel dtype is WT (f32 or bf16). The 4-corner combine runs in f32 and
// is then rounded to WT (round_k, the operand the TPU kernel feeds its
// dot); the products accumulate in f32; bias and output are in WT. Pairs
// built: (f32, f32), (bf16, bf16), (int8, bf16), (int8, f32).
//
// Level table: up to kMaxLevels entries (y0, x0, h, w, ho, wo, first
// position). Output positions run level by level, then image, then
// row-major (the order of deform_conv.py's rows_cat); a position reads
// offset_mask at its canvas pixel (y0 + i, x0 + j) and samples x at
// (y0 + yy, x0 + xx). The per-level path is the one-entry table at the
// origin with the layer's stride; the packed path has stride 1 and one
// entry per pyramid level on a shared canvas.
//
// Unlike the TPU kernel, the gather happens here: the TPU version gathers
// a 4c-wide patch-row table in XLA because Mosaic cannot slice single rows
// of a tiled memref; on Hopper a block reads the 4 corners straight from
// the NHWC map.
//
// What bounds it on an H100: 2 * L * 9 * c * cout operations (29.7 GFLOP
// for one backbone stage-3 layer at 672x1600 x 6 images) against a few MB
// of inputs and outputs. This kernel runs them on the CUDA cores in f32
// (67 TFLOP/s), so it is bound by operations; for the bf16 and int8
// variants the card's bound is the bf16 tensor cores (989 TFLOP/s), which
// mma.sync / wgmma would reach in a later version.
//
// Design: an implicit GEMM. A block owns a 64-position x 64-channel output
// tile; per tap it stages its positions' 4 corner offsets and 4 corner
// weights (modulation folded in) in shared memory; per chunk of input
// channels the 256 threads gather and combine the corners into an f32 A
// tile (4 threads per position, one 16-byte load per corner each: 4 f32,
// 8 bf16 or 16 int8 channels, so a chunk is 16, 32 or 64 channels) and
// load the matching B tile of W as f32; each thread then accumulates a
// 4x4 micro-tile in registers. Ragged L and cout are masked (cout in
// steps of 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace epropnp {
namespace {

constexpr int kTileL = 64;   // output positions per block
constexpr int kTileO = 64;   // output channels per block
constexpr int kThreads = 256;
constexpr int kTaps = 9;
constexpr int kOmChannels = 27;  // 18 offsets + 9 mask logits
constexpr int kPadL = kTileL + 4;  // A rows padded: fewer bank conflicts
constexpr int kMaxLevels = 8;

struct Levels {
  int num;
  int y0[kMaxLevels], x0[kMaxLevels], h[kMaxLevels], w[kMaxLevels];
  int ho[kMaxLevels], wo[kMaxLevels], first[kMaxLevels + 1];
};

struct DcnShape {
  int hx, wx;    // canvas of x: (n, hx, wx, c)
  int hom, wom;  // canvas of offset_mask: (n, hom, wom, 27)
  int c, cout, stride;
  float modulation_scale;
};

// Channels one thread loads per corner: 16 bytes of the map.
template <typename T>
__host__ __device__ constexpr int vec_of() { return 16 / (int)sizeof(T); }

// 16 bytes of the map -> f32 values.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float* v) {
  const int4 u = __ldg(reinterpret_cast<const int4*>(p));
  const char4* c = reinterpret_cast<const char4*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[4 * i] = (float)c[i].x;
    v[4 * i + 1] = (float)c[i].y;
    v[4 * i + 2] = (float)c[i].z;
    v[4 * i + 3] = (float)c[i].w;
  }
}

// 4 consecutive weights (or bias entries) -> f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The combined corner value as the kernel dtype holds it.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(kThreads)
dcn_forward_kernel(const XT* __restrict__ x, const float* __restrict__ om,
                   const WT* __restrict__ w3, const WT* __restrict__ bias,
                   WT* __restrict__ out, DcnShape s, Levels lv) {
  constexpr int kVec = vec_of<XT>();
  constexpr int kChunkC = 4 * kVec;  // input channels per shared stage
  __shared__ __align__(16) float a_s[kChunkC][kPadL];   // [ci][position]
  __shared__ __align__(16) float b_s[kChunkC][kTileO];  // [ci][o]
  __shared__ int corner_idx[kTileL][4];
  __shared__ float corner_w[kTileL][4];

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * kTileL;
  const int o0 = blockIdx.y * kTileO;
  const int num_l = lv.first[lv.num];
  const int ty = tid >> 4, tx = tid & 15;  // micro-tile: rows ty*4, cols tx*4
  const int gp = tid >> 2, gq = tid & 3;   // gather: position, channel part
  const int bk = tid >> 4, bo = (tid & 15) * 4;  // B tile: row, column

  // this thread's staging position: its level, image and pixel
  int my_lvl = 0, my_img = 0, my_i = 0, my_j = 0;
  const float* my_om = nullptr;
  if (tid < kTileL && l0 + tid < num_l) {
    const int l = l0 + tid;
    while (my_lvl + 1 < lv.num && l >= lv.first[my_lvl + 1]) ++my_lvl;
    const int local = l - lv.first[my_lvl];
    const int per_img = lv.ho[my_lvl] * lv.wo[my_lvl];
    my_img = local / per_img;
    my_i = (local % per_img) / lv.wo[my_lvl];
    my_j = local % lv.wo[my_lvl];
    my_om = om + ((size_t)(my_img * s.hom + lv.y0[my_lvl] + my_i) * s.wom +
                  lv.x0[my_lvl] + my_j) * kOmChannels;
  }

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  for (int tap = 0; tap < kTaps; ++tap) {
    if (tid < kTileL) {
      int idx[4] = {0, 0, 0, 0};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (my_om != nullptr) {
        const int h = lv.h[my_lvl], w = lv.w[my_lvl];
        const float mod =
            s.modulation_scale / (1.f + expf(-my_om[2 * kTaps + tap]));
        const float py =
            (float)(my_i * s.stride + tap / 3 - 1) + my_om[2 * tap];
        const float px =
            (float)(my_j * s.stride + tap % 3 - 1) + my_om[2 * tap + 1];
        const float y0f = floorf(py), x0f = floorf(px);
        const float wy = py - y0f, wx = px - x0f;
        // clamp before the int conversion: beyond [-2, size] both corners
        // of that axis are outside anyway (a NaN lands outside as well)
        const int yb = (int)fminf(fmaxf(y0f, -2.f), (float)h);
        const int xb = (int)fminf(fmaxf(x0f, -2.f), (float)w);
        const float cw[4] = {(1.f - wy) * (1.f - wx), (1.f - wy) * wx,
                             wy * (1.f - wx), wy * wx};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int yy = yb + (k >> 1), xx = xb + (k & 1);
          if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
            idx[k] = ((my_img * s.hx + lv.y0[my_lvl] + yy) * s.wx +
                      lv.x0[my_lvl] + xx) * s.c;
            wt[k] = cw[k] * mod;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        corner_idx[tid][k] = idx[k];
        corner_w[tid][k] = wt[k];
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < s.c; c0 += kChunkC) {
      {  // A tile: combine the 4 corners of position gp, kVec channels
        const int ci = c0 + kVec * gq;
        float v[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wk = corner_w[gp][k];
          float xv[kVec];
          load16(x + corner_idx[gp][k] + ci, xv);
#pragma unroll
          for (int e = 0; e < kVec; ++e) v[e] += wk * xv[e];
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          a_s[kVec * gq + e][gp] = round_to(v[e], w3);
      }
#pragma unroll
      for (int r0 = 0; r0 < kChunkC; r0 += kThreads / 16) {
        // B tile: W[tap, c0 + r0 + bk, o0 + bo .. +3]
        float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (o0 + bo < s.cout)
          bv = load4(w3 + ((size_t)tap * s.c + c0 + r0 + bk) * s.cout + o0 +
                     bo);
        *reinterpret_cast<float4*>(&b_s[r0 + bk][bo]) = bv;
      }
      __syncthreads();
#pragma unroll 16
      for (int k = 0; k < kChunkC; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += av[r] * bv[q];
      }
      __syncthreads();
    }
  }

  const int o = o0 + tx * 4;
  if (o >= s.cout) return;
  float4 bs = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias != nullptr) bs = load4(bias + o);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int l = l0 + ty * 4 + r;
    if (l < num_l)
      store4(out + (size_t)l * s.cout + o,
             make_float4(acc[r][0] + bs.x, acc[r][1] + bs.y,
                         acc[r][2] + bs.z, acc[r][3] + bs.w));
  }
}

template <typename XT, typename WT>
int launch(const void* x, const float* om, const void* w3, const void* bias,
           void* out, const DcnShape& s, const Levels& lv,
           cudaStream_t stream) {
  if (s.c % (4 * vec_of<XT>()) != 0) return (int)cudaErrorInvalidValue;
  const int num_l = lv.first[lv.num];
  const dim3 grid((num_l + kTileL - 1) / kTileL,
                  (s.cout + kTileO - 1) / kTileO);
  dcn_forward_kernel<XT, WT><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), om, static_cast<const WT*>(w3),
      static_cast<const WT*>(bias), static_cast<WT*>(out), s, lv);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace epropnp

// Plain C entry point (loaded with ctypes). x (n, hx, wx, c) and
// offset_mask (n, hom, wom, 27, f32) are NHWC, w3 is (9, c, cout), bias
// (cout,) or null, out (L, cout) with L = n * sum(ho * wo) over the
// levels; x, w3, bias and out contiguous and 16-byte aligned, cout % 4 ==
// 0, c a multiple of 16 (f32), 32 (bf16) or 64 (int8) (the wrapper
// checks). ``levels`` is a host array of num_levels rows (y0, x0, h, w,
// ho, wo). ``x_type``: 0 f32, 1 bf16, 2 int8; ``w_type`` (also bias and
// out): 0 f32, 1 bf16. Returns the cudaError_t of the launch; 0 means the
// kernel was queued on ``stream``.
extern "C" int epropnp_dcn_forward(const void* x, const float* offset_mask,
                                   const void* w3, const void* bias,
                                   void* out, const int* levels,
                                   int num_levels, int n, int hx, int wx,
                                   int hom, int wom, int c, int cout,
                                   int stride, float modulation_scale,
                                   int x_type, int w_type, void* stream) {
  using epropnp::launch;
  if (num_levels < 1 || num_levels > epropnp::kMaxLevels || cout % 4 != 0 ||
      c <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  epropnp::Levels lv{};
  lv.num = num_levels;
  lv.first[0] = 0;
  for (int k = 0; k < num_levels; ++k) {
    const int* e = levels + 6 * k;
    lv.y0[k] = e[0];
    lv.x0[k] = e[1];
    lv.h[k] = e[2];
    lv.w[k] = e[3];
    lv.ho[k] = e[4];
    lv.wo[k] = e[5];
    lv.first[k + 1] = lv.first[k] + n * e[4] * e[5];
  }
  if (lv.first[num_levels] <= 0 || cout <= 0) return 0;
  const epropnp::DcnShape s{hx, wx, hom, wom, c, cout, stride,
                            modulation_scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (x_type == 0 && w_type == 0)
    return launch<float, float>(x, offset_mask, w3, bias, out, s, lv, st);
  if (x_type == 1 && w_type == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, offset_mask, w3, bias,
                                                out, s, lv, st);
  if (x_type == 2 && w_type == 1)
    return launch<int8_t, __nv_bfloat16>(x, offset_mask, w3, bias, out, s,
                                         lv, st);
  if (x_type == 2 && w_type == 0)
    return launch<int8_t, float>(x, offset_mask, w3, bias, out, s, lv, st);
  return (int)cudaErrorInvalidValue;
}
