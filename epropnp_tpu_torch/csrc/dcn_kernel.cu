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
// Variants, as _contract_kernel computes them: the map x is f32, bf16 or
// int8 (per-channel scales already folded into W); the kernel dtype is WT
// (f32 or bf16). The 4-corner combine runs in f32 and is then rounded to
// WT (round_k, the operand the TPU kernel feeds its dot); the products
// accumulate in f32; bias and output are in WT. Pairs built: (f32, f32)
// and (int8, f32) by the f32 kernel, (bf16, bf16) and (int8, bf16) by the
// tensor-core kernel.
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
// of inputs and outputs: operations, at the f32 CUDA-core peak (67
// TFLOP/s) for WT = f32 (the JAX kernel keeps that product in full f32,
// pallas_dcn.py:52-54), at the bf16 tensor-core peak (989 TFLOP/s) for
// WT = bf16.
//
// Design, both kernels: an implicit GEMM, two blocks an SM. A block first
// stages the 4 corner offsets and 4 corner weights (modulation folded in)
// of all 9 taps of its positions in dynamic shared memory, behind one
// barrier. The K loop then runs over chunks of input channels,
// channel-slice-major and tap-minor (the 9 taps of a channel slice follow
// each other, so the corner rows they share are still in L1),
// double-buffered with one barrier per chunk: while the products of chunk
// k run, the W tile of chunk k+1 arrives by cp.async and the raw corner
// vectors of chunk k+2 come into registers; at the start of chunk k+1's
// turn they are combined (in f32, then rounded to WT) into the free A
// buffer. So a whole chunk of products covers the gathers' latency with
// one chunk's registers. 4 threads read a corner's contiguous bytes, and
// a thread combines what it loaded. No split-K and no atomics: each
// output is summed in one fixed order. Ragged L and cout are masked (cout
// in steps of 4; the W tile past cout is zero-filled). An int8 map
// becomes f32 by a byte permute and one add (exact), off the quarter-rate
// I2F unit.
//
// - f32 kernel (WT = f32): exact f32 FMA on the CUDA cores (TF32 is never
//   used). Block tile 96 positions x 128 outputs, 192 threads (stage 3's
//   25200 positions make 526 blocks: two full waves of two blocks on 132
//   SMs), chunks of 16 channels; A held [channel][position] (rows padded
//   by 4 floats), W [channel][output]; each thread accumulates an 8x8
//   micro-tile (rows ty*4 and 48 + ty*4, columns tx*4 and 64 + tx*4): 64
//   FMAs for 4 16-byte shared-memory reads; 2 (position, 4-channel)
//   gather units a thread. 56 KB of shared memory.
// - tensor-core kernel (WT = bf16): mma.sync m16n8k16 with bf16 operands
//   and f32 accumulators. Block tile 64 positions x 256 outputs (at cout
//   256 each corner is gathered once), 256 threads, chunks of 32
//   channels; A held [position][channel] (rows padded to 80 bytes) and W
//   [channel][output] (rows padded to 528 bytes), so that ldmatrix (A) and
//   ldmatrix.trans (W) read 8 rows in 8 distinct bank groups. 8 warps,
//   each owning all 64 positions x 32 outputs (4 x 4 MMA tiles); one
//   (position, 8-channel) gather unit a thread. The W tile arrives in
//   16-byte cp.async pieces (8-byte ones where cout % 8 != 0). 61 KB of
//   shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace epropnp {
namespace {

constexpr int kTaps = 9;
constexpr int kOmChannels = 27;  // 18 offsets + 9 mask logits
constexpr int kMaxLevels = 8;
constexpr int kMaxDevices = 64;

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

// The corners of a block's BL positions, all taps: element offsets into x
// of the 4 corners (0 where a corner is outside) and their weights (0
// there).
template <int BL>
struct Corners {
  int4 idx[kTaps][BL];
  float4 w[kTaps][BL];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies into shared memory that the thread does not wait for; a piece
// past the ragged edge (valid false) is zero-filled and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage the corners of positions [l0, l0 + BL) for every tap.
template <int BL>
__device__ void stage_corners(Corners<BL>& cs, const float* __restrict__ om,
                              const DcnShape& s, const Levels& lv, int l0) {
  const int num_l = lv.first[lv.num];
  for (int e = threadIdx.x; e < kTaps * BL; e += blockDim.x) {
    const int tap = e / BL, p = e % BL, l = l0 + p;
    int idx[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (l < num_l) {
      int lvl = 0;
      while (lvl + 1 < lv.num && l >= lv.first[lvl + 1]) ++lvl;
      const int local = l - lv.first[lvl];
      const int per_img = lv.ho[lvl] * lv.wo[lvl];
      const int img = local / per_img;
      const int i = (local % per_img) / lv.wo[lvl];
      const int j = local % lv.wo[lvl];
      const float* o = om + ((size_t)(img * s.hom + lv.y0[lvl] + i) * s.wom +
                             lv.x0[lvl] + j) * kOmChannels;
      const int h = lv.h[lvl], w = lv.w[lvl];
      const float mod = s.modulation_scale / (1.f + expf(-o[2 * kTaps + tap]));
      const float py = (float)(i * s.stride + tap / 3 - 1) + o[2 * tap];
      const float px = (float)(j * s.stride + tap % 3 - 1) + o[2 * tap + 1];
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
          idx[k] = ((img * s.hx + lv.y0[lvl] + yy) * s.wx + lv.x0[lvl] + xx) *
                   s.c;
          wt[k] = cw[k] * mod;
        }
      }
    }
    cs.idx[tap][p] = make_int4(idx[0], idx[1], idx[2], idx[3]);
    cs.w[tap][p] = make_float4(wt[0], wt[1], wt[2], wt[3]);
  }
}

// The 4-corner combine of one channel, in f32, in a fixed order.
__device__ __forceinline__ float combine4(float4 wt, float x0, float x1,
                                          float x2, float x3) {
  float v = wt.x * x0;
  v = fmaf(wt.y, x1, v);
  v = fmaf(wt.z, x2, v);
  return fmaf(wt.w, x3, v);
}

// 4 int8 values -> f32, exactly: each biased byte is placed in the
// mantissa of 2^23 (PRMT) and 2^23 + 128 subtracted, which keeps the
// conversion off the quarter-rate I2F unit.
__device__ __forceinline__ void int8x4_to_f32(unsigned u, float* v) {
  const unsigned b = u ^ 0x80808080u;  // byte + 128, unsigned
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440u | i)) -
           8388736.f;
}

// ------------------------------------------------------------ f32 kernel

namespace f32k {

constexpr int kBlockL = 96;           // output positions per block
constexpr int kBlockO = 128;          // output channels per block
constexpr int kThreads = 192;         // 12 x 16, 8x8 outputs each
constexpr int kChunk = 16;            // input channels per stage
constexpr int kPadL = kBlockL + 4;    // A rows [channel][position], padded
using Corners = epropnp::Corners<kBlockL>;
constexpr int kSmem = (int)sizeof(Corners) + 2 * kChunk * kPadL * 4 +
                      2 * kChunk * kBlockO * 4;

// 4 consecutive channels of the map -> f32.
__device__ __forceinline__ float4 load_map4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_map4(const int8_t* p) {
  float v[4];
  int8x4_to_f32(__ldg(reinterpret_cast<const unsigned*>(p)), v);
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <typename XT>
__global__ void __launch_bounds__(kThreads, 2)
dcn_forward_f32(const XT* __restrict__ x, const float* __restrict__ om,
                const float* __restrict__ w3, const float* __restrict__ bias,
                float* __restrict__ out, DcnShape s, Levels lv,
                int o_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  Corners& cs = *reinterpret_cast<Corners*>(smem);
  auto a_s = reinterpret_cast<float(*)[kChunk][kPadL]>(smem + sizeof(Corners));
  auto b_s = reinterpret_cast<float(*)[kChunk][kBlockO]>(
      smem + sizeof(Corners) + 2 * kChunk * kPadL * 4);

  const int tid = threadIdx.x;
  const int o0 = (blockIdx.x % o_tiles) * kBlockO;
  const int l0 = (blockIdx.x / o_tiles) * kBlockL;
  const int num_l = lv.first[lv.num];
  // gather: positions gp and gp + 48, channels 4 gq .. 4 gq + 3 of a chunk
  // (4 threads read a corner's 64 contiguous bytes)
  const int gp = tid >> 2, gq = tid & 3;
  // products: rows ty*4 + r and 48 + ty*4 + r, columns tx*4 + q and
  // 64 + tx*4 + q
  const int ty = tid >> 4, tx = tid & 15;
  const int steps = kTaps * (s.c / kChunk);

  stage_corners(cs, om, s, lv, l0);
  __syncthreads();

  auto load_w = [&](int tap, int c0, int buf) {
    // kChunk rows of kBlockO / 4 16-byte pieces
    for (int i = tid; i < kChunk * kBlockO / 4; i += kThreads) {
      const int row = i >> 5, col = (i & 31) * 4;
      const bool ok = o0 + col < s.cout;
      const float* src =
          ok ? w3 + (size_t)(tap * s.c + c0 + row) * s.cout + o0 + col : w3;
      cp_async16(&b_s[buf][row][col], src, ok);
    }
    cp_async_commit();
  };
  float4 raw[2][4];
  auto gather = [&](int tap, int c0) {
    const XT* base = x + c0 + 4 * gq;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int4 ix = cs.idx[tap][gp + 48 * u];
      raw[u][0] = load_map4(base + ix.x);
      raw[u][1] = load_map4(base + ix.y);
      raw[u][2] = load_map4(base + ix.z);
      raw[u][3] = load_map4(base + ix.w);
    }
  };
  auto combine = [&](int tap, int buf) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = gp + 48 * u;
      const float4 wt = cs.w[tap][p];
      const float4* r = raw[u];
      a_s[buf][4 * gq + 0][p] = combine4(wt, r[0].x, r[1].x, r[2].x, r[3].x);
      a_s[buf][4 * gq + 1][p] = combine4(wt, r[0].y, r[1].y, r[2].y, r[3].y);
      a_s[buf][4 * gq + 2][p] = combine4(wt, r[0].z, r[1].z, r[2].z, r[3].z);
      a_s[buf][4 * gq + 3][p] = combine4(wt, r[0].w, r[1].w, r[2].w, r[3].w);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  auto products = [&](int buf) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][k][48 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
  };

  // chunk k: channels (k / 9) * kChunk of tap k % 9 (9 <= steps)
  load_w(0, 0, 0);
  gather(0, 0);
  combine(0, 0);
  gather(1, 0);
  cp_async_wait_all();
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1, nxt = cur ^ 1;
    if (step + 1 < steps) {
      const int tap = (step + 1) % kTaps, c0 = (step + 1) / kTaps * kChunk;
      combine(tap, nxt);
      load_w(tap, c0, nxt);
    }
    if (step + 2 < steps)
      gather((step + 2) % kTaps, (step + 2) / kTaps * kChunk);
    products(cur);
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int hq = 0; hq < 2; ++hq) {
    const int o = o0 + 64 * hq + tx * 4;
    if (o >= s.cout) continue;
    float4 bs = make_float4(0.f, 0.f, 0.f, 0.f);
    if (bias != nullptr) bs = __ldg(reinterpret_cast<const float4*>(bias + o));
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int l = l0 + 48 * (r >> 2) + ty * 4 + (r & 3);
      if (l < num_l)
        *reinterpret_cast<float4*>(out + (size_t)l * s.cout + o) =
            make_float4(acc[r][4 * hq] + bs.x, acc[r][4 * hq + 1] + bs.y,
                        acc[r][4 * hq + 2] + bs.z, acc[r][4 * hq + 3] + bs.w);
    }
  }
}

}  // namespace f32k

// ---------------------------------------------------- tensor-core kernel

namespace tck {

constexpr int kBlockL = 64;           // output positions per block
constexpr int kBlockO = 256;          // output channels per block
constexpr int kThreads = 256;         // 8 warps, 64 x 32 outputs each
constexpr int kChunk = 32;            // input channels per stage
constexpr int kPadC = kChunk + 8;     // A rows [position][channel]: 80 bytes
constexpr int kPadO = kBlockO + 8;    // W rows [channel][output]: 528 bytes
using Corners = epropnp::Corners<kBlockL>;
constexpr int kSmem = (int)sizeof(Corners) + 2 * kBlockL * kPadC * 2 +
                      2 * kChunk * kPadO * 2;

// 8 consecutive channels of the map, raw (16 bytes of bf16, 8 of int8),
// and their f32 values.
template <typename XT>
struct Map8;
template <>
struct Map8<__nv_bfloat16> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void to_f32(const Raw& u, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Map8<int8_t> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void to_f32(const Raw& u, float* v) {
    int8x4_to_f32(u.x, v);
    int8x4_to_f32(u.y, v + 4);
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename XT>
__global__ void __launch_bounds__(kThreads, 2)
dcn_forward_tc(const XT* __restrict__ x, const float* __restrict__ om,
               const __nv_bfloat16* __restrict__ w3,
               const __nv_bfloat16* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, DcnShape s, Levels lv,
               int o_tiles) {
  using M = Map8<XT>;
  extern __shared__ __align__(16) unsigned char smem[];
  Corners& cs = *reinterpret_cast<Corners*>(smem);
  auto a_s = reinterpret_cast<__nv_bfloat16(*)[kBlockL][kPadC]>(
      smem + sizeof(Corners));
  auto b_s = reinterpret_cast<__nv_bfloat16(*)[kChunk][kPadO]>(
      smem + sizeof(Corners) + 2 * kBlockL * kPadC * 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o0 = (blockIdx.x % o_tiles) * kBlockO;
  const int l0 = (blockIdx.x / o_tiles) * kBlockL;
  const int num_l = lv.first[lv.num];
  // gather: position gp, channels 8 gg .. 8 gg + 7 of a chunk (4 threads
  // read a corner's 64 contiguous bytes of bf16, 32 of int8)
  const int gp = tid >> 2, gg = tid & 3;
  // products: warp w owns all 64 rows and columns 32 w .. 32 w + 31
  const int steps = kTaps * (s.c / kChunk);
  // W tile pieces of this thread: 16 bytes (8 outputs) where cout % 8 ==
  // 0, else 8 bytes (4 outputs); rows w_row + k * w_rows_step
  const bool wide = s.cout % 8 == 0;
  const int w_col = wide ? (tid & 31) * 8 : (tid & 63) * 4;
  const int w_row = wide ? tid >> 5 : tid >> 6;
  const int w_rows_step = wide ? 8 : 4;
  const bool w_ok = o0 + w_col < s.cout;

  stage_corners(cs, om, s, lv, l0);
  __syncthreads();

  auto load_w = [&](int tap, int c0, int buf) {
    const __nv_bfloat16* src =
        w3 + (size_t)(tap * s.c + c0 + w_row) * s.cout + o0 + w_col;
    __nv_bfloat16* dst = &b_s[buf][w_row][w_col];
    const int src_step = w_rows_step * s.cout;
    if (wide) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cp_async16(dst + r * 8 * kPadO, w_ok ? src + r * src_step : w3, w_ok);
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        cp_async8(dst + r * 4 * kPadO, w_ok ? src + r * src_step : w3, w_ok);
    }
    cp_async_commit();
  };
  typename M::Raw raw[4];
  auto gather = [&](int tap, int c0) {
    const int4 ix = cs.idx[tap][gp];
    const XT* base = x + c0 + 8 * gg;
    raw[0] = M::load(base + ix.x);
    raw[1] = M::load(base + ix.y);
    raw[2] = M::load(base + ix.z);
    raw[3] = M::load(base + ix.w);
  };
  auto combine = [&](int tap, int buf) {
    const float4 wt = cs.w[tap][gp];
    float v[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k) M::to_f32(raw[k], v[k]);
    float sum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      sum[e] = combine4(wt, v[0][e], v[1][e], v[2][e], v[3][e]);
    // round_k: the combined value, rounded once to bf16
    *reinterpret_cast<uint4*>(&a_s[buf][gp][8 * gg]) =
        make_uint4(pack_bf16(sum[0], sum[1]), pack_bf16(sum[2], sum[3]),
                   pack_bf16(sum[4], sum[5]), pack_bf16(sum[6], sum[7]));
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  auto products = [&](int buf, int kk) {
    uint32_t bf[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, &b_s[buf][kk + (lane & 15)]
                               [warp * 32 + np * 16 + 8 * (lane >> 4)]);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t af[4];
      ldmatrix_x4(af, &a_s[buf][mt * 16 + (lane & 15)][kk + 8 * (lane >> 4)]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af, bf[nt]);
    }
  };

  // chunk k: channels (k / 9) * kChunk of tap k % 9 (9 <= steps)
  load_w(0, 0, 0);
  gather(0, 0);
  combine(0, 0);
  gather(1, 0);
  cp_async_wait_all();
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1, nxt = cur ^ 1;
    if (step + 1 < steps) {
      const int tap = (step + 1) % kTaps, c0 = (step + 1) / kTaps * kChunk;
      combine(tap, nxt);
      load_w(tap, c0, nxt);
    }
    if (step + 2 < steps)
      gather((step + 2) % kTaps, (step + 2) / kTaps * kChunk);
    products(cur, 0);
    products(cur, 16);
    cp_async_wait_all();
    __syncthreads();
  }

  // accumulator (mt, nt): rows lane/4 and lane/4 + 8 of the 16, columns
  // 2 (lane % 4) and + 1 of the 8
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int o = o0 + warp * 32 + nt * 8 + 2 * (lane & 3);
    if (o >= s.cout) continue;  // cout % 4 == 0: o + 1 < cout too
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = __bfloat162float(bias[o]);
      b1 = __bfloat162float(bias[o + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int l = l0 + mt * 16 + (lane >> 2) + 8 * hh;
        if (l < num_l)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)l * s.cout + o) =
              __floats2bfloat162_rn(acc[mt][nt][2 * hh] + b0,
                                    acc[mt][nt][2 * hh + 1] + b1);
      }
  }
}

}  // namespace tck

// Allow the kernel its dynamic shared memory (above the 48 KB default),
// once per kernel instance and device; returns the cudaError_t.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return (int)err;
}

template <typename XT>
int launch_f32(const void* x, const float* om, const void* w3,
               const void* bias, void* out, const DcnShape& s,
               const Levels& lv, cudaStream_t stream) {
  if (s.c % f32k::kChunk != 0) return (int)cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  auto kernel = f32k::dcn_forward_f32<XT>;
  const int err = allow_smem(kernel, f32k::kSmem, done);
  if (err != 0) return err;
  const int o_tiles = (s.cout + f32k::kBlockO - 1) / f32k::kBlockO;
  const int l_tiles = (lv.first[lv.num] + f32k::kBlockL - 1) / f32k::kBlockL;
  kernel<<<l_tiles * o_tiles, f32k::kThreads, f32k::kSmem, stream>>>(
      static_cast<const XT*>(x), om, static_cast<const float*>(w3),
      static_cast<const float*>(bias), static_cast<float*>(out), s, lv,
      o_tiles);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_tc(const void* x, const float* om, const void* w3,
              const void* bias, void* out, const DcnShape& s,
              const Levels& lv, cudaStream_t stream) {
  if (s.c % tck::kChunk != 0) return (int)cudaErrorInvalidValue;
  static bool done[kMaxDevices] = {};
  auto kernel = tck::dcn_forward_tc<XT>;
  const int err = allow_smem(kernel, tck::kSmem, done);
  if (err != 0) return err;
  const int o_tiles = (s.cout + tck::kBlockO - 1) / tck::kBlockO;
  const int l_tiles = (lv.first[lv.num] + tck::kBlockL - 1) / tck::kBlockL;
  kernel<<<l_tiles * o_tiles, tck::kThreads, tck::kSmem, stream>>>(
      static_cast<const XT*>(x), om, static_cast<const __nv_bfloat16*>(w3),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), s, lv, o_tiles);
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
  using epropnp::launch_f32;
  using epropnp::launch_tc;
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
    return launch_f32<float>(x, offset_mask, w3, bias, out, s, lv, st);
  if (x_type == 2 && w_type == 0)
    return launch_f32<int8_t>(x, offset_mask, w3, bias, out, s, lv, st);
  if (x_type == 1 && w_type == 1)
    return launch_tc<__nv_bfloat16>(x, offset_mask, w3, bias, out, s, lv, st);
  if (x_type == 2 && w_type == 1)
    return launch_tc<int8_t>(x, offset_mask, w3, bias, out, s, lv, st);
  return (int)cudaErrorInvalidValue;
}
