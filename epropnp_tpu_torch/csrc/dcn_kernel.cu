// K3: the DCNv2 sampling contraction (3x3 modulated deformable conv).
//
// Replaces epropnp_tpu/ops/pallas_dcn.py::_contract_pallas (body
// _contract_kernel), as reached by dcn_gather_contract from
// epropnp_tpu/ops/deform_conv.py. For every output position (img, i, j)
// and output channel o:
//
//   out = bias[o] + sum_tap sum_ci bilinear_zeros(x[img], p_tap)[ci]
//                                  * mod_tap * W[tap, ci, o]
//   p_tap = (j s + dx_tap + off_x, i s + dy_tap + off_y)   in [x, y]
//   mod_tap = sigmoid(mask_tap) * modulation_scale
//
// with (dx_tap, dy_tap) in {-1, 0, 1}^2 row-major by (dy, dx). The offsets
// and mask logits come raw from conv_offset in mmcv's channel order:
// (dy, dx) for each of the 9 taps, then the 9 mask logits. A corner
// outside the map contributes 0 (ops/bilinear_sample.py, 'zeros').
//
// Unlike the TPU kernel, the gather happens here: the TPU version gathers
// a 4c-wide patch-row table in XLA because Mosaic cannot slice single rows
// of a tiled memref; on Hopper a block reads the 4 corners straight from
// the NHWC map.
//
// What bounds it on an H100: the contraction, 2 * L * 9 * c * cout flops
// (29.7 GFLOP for one backbone stage-3 layer at 672x1600 x 6 images),
// against a few MB of inputs and outputs: compute, at 67 TFLOP/s in f32
// outside the tensor cores (f32 throughout; TF32 would not hold the
// 1e-4 agreement).
//
// Design: an implicit GEMM in f32. A block owns a 64-position x 64-channel
// output tile; per tap it stages its positions' 4 corner offsets and 4
// corner weights (modulation folded in) in shared memory; per chunk of 16
// input channels the 256 threads gather and combine the corners into an A
// tile (4 threads per position, one float4 of channels each, so the 4
// threads of a position read 64 contiguous bytes of each corner) and load
// the matching B tile of W; each thread then accumulates a 4x4 micro-tile
// in registers. Ragged L and cout are masked (cout in steps of 4).

#include <cuda_runtime.h>

namespace epropnp {
namespace {

constexpr int kTileL = 64;   // output positions per block
constexpr int kTileO = 64;   // output channels per block
constexpr int kChunkC = 16;  // input channels per shared-memory stage
constexpr int kThreads = 256;
constexpr int kTaps = 9;
constexpr int kOmChannels = 27;  // 18 offsets + 9 mask logits
constexpr int kPadL = kTileL + 4;  // A rows padded: fewer bank conflicts

struct DcnShape {
  int n, h, w, c, ho, wo, cout, stride;
  float modulation_scale;
};

__global__ void __launch_bounds__(kThreads)
dcn_forward_kernel(const float* __restrict__ x, const float* __restrict__ om,
                   const float* __restrict__ w3,
                   const float* __restrict__ bias, float* __restrict__ out,
                   DcnShape s) {
  __shared__ __align__(16) float a_s[kChunkC][kPadL];   // [ci][position]
  __shared__ __align__(16) float b_s[kChunkC][kTileO];  // [ci][o]
  __shared__ int corner_idx[kTileL][4];
  __shared__ float corner_w[kTileL][4];

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * kTileL;
  const int o0 = blockIdx.y * kTileO;
  const int num_l = s.n * s.ho * s.wo;
  const int ty = tid >> 4, tx = tid & 15;  // micro-tile: rows ty*4, cols tx*4
  const int gp = tid >> 2, gq = tid & 3;   // gather: position, channel quad
  const int bk = tid >> 4, bo = (tid & 15) * 4;  // B tile: row, column

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  for (int tap = 0; tap < kTaps; ++tap) {
    if (tid < kTileL) {
      const int l = l0 + tid;
      int idx[4] = {0, 0, 0, 0};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (l < num_l) {
        const int j = l % s.wo;
        const int i = (l / s.wo) % s.ho;
        const int img = l / (s.wo * s.ho);
        const float* o = om + (size_t)l * kOmChannels;
        const float mod =
            s.modulation_scale / (1.f + expf(-o[2 * kTaps + tap]));
        const float py = (float)(i * s.stride + tap / 3 - 1) + o[2 * tap];
        const float px = (float)(j * s.stride + tap % 3 - 1) + o[2 * tap + 1];
        const float y0f = floorf(py), x0f = floorf(px);
        const float wy = py - y0f, wx = px - x0f;
        // clamp before the int conversion: beyond [-2, size] both corners
        // of that axis are outside anyway (a NaN lands outside as well)
        const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)s.h);
        const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)s.w);
        const float cw[4] = {(1.f - wy) * (1.f - wx), (1.f - wy) * wx,
                             wy * (1.f - wx), wy * wx};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int yy = y0 + (k >> 1), xx = x0 + (k & 1);
          if (yy >= 0 && yy < s.h && xx >= 0 && xx < s.w) {
            idx[k] = ((img * s.h + yy) * s.w + xx) * s.c;
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
      {  // A tile: combine the 4 corners of position gp, channels c0+4gq..
        const int ci = c0 + 4 * gq;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wk = corner_w[gp][k];
          const float4 xv = __ldg(reinterpret_cast<const float4*>(
              x + corner_idx[gp][k] + ci));
          v.x += wk * xv.x;
          v.y += wk * xv.y;
          v.z += wk * xv.z;
          v.w += wk * xv.w;
        }
        a_s[4 * gq + 0][gp] = v.x;
        a_s[4 * gq + 1][gp] = v.y;
        a_s[4 * gq + 2][gp] = v.z;
        a_s[4 * gq + 3][gp] = v.w;
      }
      {  // B tile: W[tap, c0 + bk, o0 + bo .. +3]
        float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (o0 + bo < s.cout)
          bv = __ldg(reinterpret_cast<const float4*>(
              w3 + ((size_t)tap * s.c + c0 + bk) * s.cout + o0 + bo));
        *reinterpret_cast<float4*>(&b_s[bk][bo]) = bv;
      }
      __syncthreads();
#pragma unroll
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
  if (bias != nullptr) bs = __ldg(reinterpret_cast<const float4*>(bias + o));
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int l = l0 + ty * 4 + r;
    if (l < num_l)
      *reinterpret_cast<float4*>(out + (size_t)l * s.cout + o) =
          make_float4(acc[r][0] + bs.x, acc[r][1] + bs.y, acc[r][2] + bs.z,
                      acc[r][3] + bs.w);
  }
}

}  // namespace
}  // namespace epropnp

// Plain C entry point (loaded with ctypes). x (n, h, w, c) and
// offset_mask (n, ho, wo, 27) are NHWC, w3 is (9, c, cout), bias (cout,)
// or null, out (n, ho, wo, cout); all f32, contiguous, 16-byte aligned,
// c % 16 == 0 and cout % 4 == 0 (the wrapper checks). Returns the
// cudaError_t of the launch; 0 means the kernel was queued on ``stream``.
extern "C" int epropnp_dcn_forward(const float* x, const float* offset_mask,
                                   const float* w3, const float* bias,
                                   float* out, int n, int h, int w, int c,
                                   int ho, int wo, int cout, int stride,
                                   float modulation_scale, void* stream) {
  const int num_l = n * ho * wo;
  if (num_l <= 0 || cout <= 0) return 0;
  if (c % epropnp::kChunkC != 0 || cout % 4 != 0)
    return (int)cudaErrorInvalidValue;
  epropnp::DcnShape s{n, h, w, c, ho, wo, cout, stride, modulation_scale};
  const dim3 grid((num_l + epropnp::kTileL - 1) / epropnp::kTileL,
                  (cout + epropnp::kTileO - 1) / epropnp::kTileO);
  epropnp::dcn_forward_kernel<<<grid, epropnp::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      x, offset_mask, w3, bias, out, s);
  return (int)cudaGetLastError();
}
