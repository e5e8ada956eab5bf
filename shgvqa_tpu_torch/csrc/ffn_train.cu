// Fused BERT FFN block with dropout on the output dense, forward and backward,
// for Hopper (sm_90a):
//
//   u = x . W1 + b1,  h = bf16(gelu_erf(u)),  o = h . W2 + b2
//   y = LN(x + dropout(o)) * gamma + beta
//
// Replaces shgvqa_tpu/kernels/ffn.py::_make_train_pair, the Pallas TPU
// kernels fwd_kernel (forward) and bwd_kernel (backward) behind the JAX
// fused_ffn_train; the plain versions are ffn_train_reference and
// ffn_train_backward_reference in shgvqa_tpu_torch/kernels/ffn.py.  The
// forward's chain at rate 0 also replaces _make_call there, the inference
// kernel behind the JAX fused_ffn (plain version ffn_reference).
//
// Numerics (as the TPU kernels): x, dy, W1, W2 bf16; b1, b2, gamma, beta f32;
// every product accumulates in f32; h is rounded to bf16 before the second
// product; dropout acts on o (bias included) before the residual, kept
// values scaled by 1/(1 - rate); LayerNorm is two-pass in f32.  Backward:
// a = dy * gamma, dr = (a - mean(a) - xhat * mean(a * xhat)) * rstd,
// do = dropout(dr) rounded to bf16, dh = do . W2^T, du = dh * gelu'(u)
// rounded to bf16 with gelu'(u) = Phi(u) + u phi(u), dx = dr + du . W1^T
// summed in f32 and stored in bf16; dgamma = sum(dy * xhat), dbeta =
// sum(dy) over all rows.  du, do and h are written out (bf16) for the
// weight-gradient products, which the caller runs outside the kernel.
//
// Dropout: keep (row, col) where bits >= threshold, threshold =
// round(rate * 2^32) (the TPU kernel's), bits = word col % 4 of
// Philox4x32-10 keyed on the call's 64-bit seed (read from device memory)
// with the counter (col / 4, row0 + row, 0, 0).  The counter depends on the
// absolute row and column only, so the forward's and the backward's row
// passes and shgvqa_ffn_train_keep_mask draw one mask.  row0, the caller's
// row offset, is 0 in one process; a data-parallel rank passes its first
// row of the global batch's rows, so each rank draws its rows of the global
// mask.
// (The TPU kernel seeds per program id, with 128-row programs forward and
// 64-row programs backward, so its backward regenerates another mask.)
//
// What bounds it on the card: forward 4*M*D*F operations, backward 8*M*D*F
// (the JAX cost estimates) against ~4*M*D + 4*D*F bytes forward and
// (4*M*D + 2*M*F + 2*D*F) * 2 backward: at the model's shapes (D=768,
// F=3072, M >= 80) the tensor cores, not device memory.
//
// Design: two chains of launches on one stream, each shaped to fill the
// card at M = 1280 (10 row tiles).  The products run the mainloop of
// wgmma_gemm.cuh (128-row tiles of two consumer warpgroups issuing
// wgmma.mma_async, a producer warp keeping a ring of TMA tiles with the
// 128-byte swizzle in flight on mbarriers, 3 stages for the 128-wide tiles
// and 4 for the 64-wide ones, so that two blocks share an SM and one's
// epilogue overlaps the other's products), each with its own epilogue.
// - forward, three launches:
//   1. u = x . W1 + b1 over (M, F) tiles 128 wide: h = bf16(gelu(u)) out;
//   2. o = h . W2 + b2 over (M, D) tiles, out in f32: 192 wide (5 stages,
//      one block an SM) where they fill the SMs' waves (M = 12576 at
//      B=32), else 64 wide;
//   3. a row pass, one warp per row holding the row in registers: the
//      dropout, the residual, the two-pass LayerNorm, y (bf16) out.
//   A single kernel would keep h on the chip, but a 128 x 768 f32 output
//   tile does not fit in a warpgroup's registers, and its blocks would each
//   stream both weights; the chain tiles over F and D instead, at the cost
//   of writing h and o once and reading them back.
// - backward, six launches:
//   1. u as the forward's (the same instructions, so the same h), with
//      gelu'(u) (an f32 spill, M x F) out as well;
//   2. o as the forward's;
//   3. a row pass, one warp per row: the dropout, the LayerNorm recompute,
//      dr (f32, over o) and do (bf16) out, and per 16-row tile the partial
//      dgamma and dbeta;
//   4. dh = do . W2^T over (M, F) tiles: du = bf16(dh * gelu'(u)) out;
//   5. dx = dr + du . W1^T over (M, D) tiles, out in bf16;
//   6. dgamma and dbeta: the partials summed column by column, in eighths
//      of the tiles in tile order and then the eighths in order.
// W1 and W2 are read as the nn.Linear weights are stored: K-major where the
// product takes W^T (u, o), MN-major, transposed by the wgmma, where it
// takes W (dh, dx).  Nothing is summed with atomics: two calls on the same
// inputs give the same bits.
// Ragged M: rows past M are zero-filled by the TMA, never stored and never
// summed into dgamma or dbeta.
//
// Tensor parallelism (W1's columns and W2's rows split over the model
// group, F / mp columns a rank) splits each chain at its all-reduce, with
// the same kernels: the forward's products (u, then o with a zero b2: the
// partial h . W2) in one call, the caller's all-reduce and + b2, then its
// row pass in another; the backward's row pass (dr in place over o + b2,
// do, the dgamma/dbeta partials and their sum) in one call, then its
// products (u with gelu'(u), dh, dx over a zero dr: the partial du . W1^T,
// to which the caller adds dr once after the all-reduce) in another.

#include "wgmma_gemm.cuh"

namespace {

// Widest row the forward's row pass holds in registers (6 float4 a lane);
// the backward's keeps 16 rows of it in shared memory.
constexpr int kMaxD = 768;
constexpr int kRowVecs = kMaxD / 128;

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// gelu(u) = u * Phi(u) (the erf GeLU), and gelu'(u) = Phi(u) + u * phi(u)
// into grad, from one erf
__device__ __forceinline__ float gelu_and_grad(float u, float& grad) {
  const float phi_cdf = 0.5f * (1.0f + erff(u * 0.70710678118654752f));
  grad = phi_cdf + u * __expf(-0.5f * u * u) * 0.3989422804014327f;
  return u * phi_cdf;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Dropout mask

// Philox4x32-10.
__device__ __forceinline__ uint4 philox(uint4 c, uint2 key) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return c;
}

struct Drop {
  const long long* seed;               // 2 values on the device (read when on)
  uint32_t threshold;
  float inv_keep;
  int on;
  int row0;                            // the counter's row offset
};

__device__ __forceinline__ uint2 drop_key(const Drop& p) {
  return p.on ? make_uint2(static_cast<uint32_t>(p.seed[0]), static_cast<uint32_t>(p.seed[1]))
              : make_uint2(0u, 0u);
}

// Keep bits of columns col..col+3 (col % 4 == 0) of `row`: bit j for col + j.
__device__ __forceinline__ uint32_t keep4(uint2 key, uint32_t threshold, int row, int col) {
  const uint4 w = philox(
      make_uint4(static_cast<uint32_t>(col) >> 2, static_cast<uint32_t>(row), 0u, 0u), key);
  return (w.x >= threshold ? 1u : 0u) | (w.y >= threshold ? 2u : 0u) |
         (w.z >= threshold ? 4u : 0u) | (w.w >= threshold ? 8u : 0u);
}

// ---------------------------------------------------------------------------
// The chains: the products on the wgmma mainloop of wgmma_gemm.cuh, each
// with its own epilogue, and the LayerNorm (forward or backward) as a row
// pass after the second.

constexpr int kWideN = 128;                       // tile width of the (M, F) products
constexpr int kNarrowN = 64;                      // tile width of the (M, D) products
// ring stages: 3 x 32 KB (wide) and 4 x 24 KB (narrow) let two blocks share
// an SM, so that one block's epilogue overlaps the other's products
constexpr int kWideStages = 3;
constexpr int kNarrowStages = 4;
// the o stage's tiles where M fills the SMs: 192 wide (4 column tiles at D =
// 768), 5 stages of 40 KB, one block an SM; each A tile of h feeds three
// times the columns of a 64-wide tile
constexpr int kOWideN = 192;
constexpr int kOWideStages = 5;
constexpr int kRowTile = 16;                      // rows of a row-pass block: a warp each
constexpr int kRowThreads = 32 * kRowTile;

// What the kernels of both chains read and write; a chain leaves the
// pointers it does not use null.
struct Params {
  const bf16* x;
  const float* b1;
  const float* b2;
  const float* gamma;
  const float* beta;                   // forward
  bf16* y;                             // forward
  const bf16* dy;                      // backward from here
  bf16* dx;
  bf16* du;                            // (M, F)
  bf16* dout;                          // do, (M, D)
  bf16* h;                             // (M, F), both chains
  float* gd;                           // gelu'(u), (M, F) scratch
  float* dr;                           // o + b2 (both chains), then dr, (M, D) scratch
  float* part;                         // (row tiles, 2 D): sum dy * xhat | sum dy
  int m, d, f;
  float eps;
  Drop drop;
};

// 1. u = x . W1 + b1 over (M, F) tiles: h = bf16(gelu(u)), and with kGrad
// gelu'(u) in f32.  Both chains compute h with these instructions.
template <bool kGrad>
__device__ __forceinline__ void u_stage(const CUtensorMap* xmap, const CUtensorMap* w1map,
                                        const Params& p) {
  float acc[kWideN / 2];
  if (!gemm_mainloop<kWideN, false, kWideStages>(xmap, w1map, p.d, acc)) return;
  gemm_epilogue<kWideN>(
      acc, p.m, [&](int, int col) { return __ldg(reinterpret_cast<const float2*>(p.b1 + col)); },
      [&](int row, int col, float a0, float a1, float2 bias) {
        float2 gd;
        const float h0 = gelu_and_grad(a0 + bias.x, gd.x), h1 = gelu_and_grad(a1 + bias.y, gd.y);
        const size_t off = static_cast<size_t>(row) * p.f + col;
        *reinterpret_cast<uint32_t*>(p.h + off) = pack_bf16(h0, h1);
        if (kGrad) *reinterpret_cast<float2*>(p.gd + off) = gd;
      });
}

__global__ void __launch_bounds__(kGemmThreads, 2)
ffn_fwd_u_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
                 const Params p) {
  u_stage<false>(&xmap, &w1map, p);
}

__global__ void __launch_bounds__(kGemmThreads, 2)
ffn_bwd_u_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
                 const Params p) {
  u_stage<true>(&xmap, &w1map, p);
}

// 2. o = h . W2 + b2 over (M, D) tiles BN wide, in f32 (into p.dr); kBlocks
// blocks share an SM.
template <int BN, int kStages, int kBlocks>
__global__ void __launch_bounds__(kGemmThreads, kBlocks)
ffn_o_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap w2map,
             const Params p) {
  float acc[BN / 2];
  if (!gemm_mainloop<BN, false, kStages>(&hmap, &w2map, p.f, acc)) return;
  gemm_epilogue<BN>(
      acc, p.m, [&](int, int col) { return __ldg(reinterpret_cast<const float2*>(p.b2 + col)); },
      [&](int row, int col, float a0, float a1, float2 bias) {
        *reinterpret_cast<float2*>(p.dr + static_cast<size_t>(row) * p.d + col) =
            make_float2(a0 + bias.x, a1 + bias.y);
      });
}

// 3 (forward). The row pass, one warp per row (d <= kMaxD), the row in
// registers: r = dropout(o + b2) + x, its two-pass LayerNorm in f32, y =
// bf16(xhat * gamma + beta).  Rows past M are neither read nor stored.
__global__ void __launch_bounds__(kRowThreads) ffn_fwd_rows_kernel(const Params p) {
  const int d = p.d;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowTile + threadIdx.x / 32;
  if (row >= p.m) return;
  const float inv_d = 1.0f / static_cast<float>(d);
  const uint2 key = drop_key(p.drop);
  const float* orow = p.dr + static_cast<size_t>(row) * d;
  const bf16* xrow = p.x + static_cast<size_t>(row) * d;
  float v[kRowVecs][4];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int c = lane * 4 + 128 * i;
    if (c < d) {
      const float4 o4 = *reinterpret_cast<const float4*>(orow + c);
      const uint2 x4 = *reinterpret_cast<const uint2*>(xrow + c);
      const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x4.x));
      const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x4.y));
      const float xs[4] = {x01.x, x01.y, x23.x, x23.y};
      v[i][0] = o4.x;
      v[i][1] = o4.y;
      v[i][2] = o4.z;
      v[i][3] = o4.w;
      const uint32_t keep = p.drop.on ? keep4(key, p.drop.threshold, p.drop.row0 + row, c) : 0xFu;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (p.drop.on) v[i][j] = (keep >> j) & 1u ? v[i][j] * p.drop.inv_keep : 0.0f;
        v[i][j] += xs[j];
        sum += v[i][j];
      }
    }
  }
  const float mean = warp_sum(sum) * inv_d;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    if (lane * 4 + 128 * i < d) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dev = v[i][j] - mean;
        sq += dev * dev;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + p.eps);
  bf16* yrow = p.y + static_cast<size_t>(row) * d;
#pragma unroll
  for (int i = 0; i < kRowVecs; ++i) {
    const int c = lane * 4 + 128 * i;
    if (c < d) {
      float out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = (v[i][j] - mean) * rstd * p.gamma[c + j] + p.beta[c + j];
      *reinterpret_cast<uint2*>(yrow + c) =
          make_uint2(pack_bf16(out[0], out[1]), pack_bf16(out[2], out[3]));
    }
  }
}

// 3 (backward). The row pass, one warp per row: r = dropout(o + b2) + x, its two-pass
// LayerNorm statistics, xhat, a = dy * gamma, dr = (a - mean(a) - xhat *
// mean(a * xhat)) * rstd (over o + b2 in place) and do = bf16(dropout(dr));
// then the block's partial dgamma = sum dy * xhat and dbeta = sum dy, column
// by column over its rows in order.  Rows past M are skipped.
__global__ void __launch_bounds__(kRowThreads) ffn_bwd_rows_kernel(const Params p) {
  extern __shared__ float xhat_s[];    // kRowTile x d
  const int d = p.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowTile;
  const int valid = min(kRowTile, p.m - row0);
  const float inv_d = 1.0f / static_cast<float>(d);
  const uint2 key = drop_key(p.drop);
  if (warp < valid) {
    const int row = row0 + warp;
    float* xr = xhat_s + warp * d;
    float* orow = p.dr + static_cast<size_t>(row) * d;
    const bf16* xrow = p.x + static_cast<size_t>(row) * d;
    const bf16* dyrow = p.dy + static_cast<size_t>(row) * d;
    float sum = 0.0f;
    for (int c = lane * 4; c < d; c += 128) {
      const float4 o4 = *reinterpret_cast<const float4*>(orow + c);
      float v[4] = {o4.x, o4.y, o4.z, o4.w};
      const uint32_t keep = p.drop.on ? keep4(key, p.drop.threshold, p.drop.row0 + row, c) : 0xFu;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (p.drop.on) v[j] = (keep >> j) & 1u ? v[j] * p.drop.inv_keep : 0.0f;
        v[j] += __bfloat162float(xrow[c + j]);
        sum += v[j];
      }
      *reinterpret_cast<float4*>(xr + c) = make_float4(v[0], v[1], v[2], v[3]);
    }
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.0f;
    for (int c = lane * 4; c < d; c += 128) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dev = xr[c + j] - mean;
        sq += dev * dev;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + p.eps);
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane * 4; c < d; c += 128) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xhat = (xr[c + j] - mean) * rstd;
        const float a = __bfloat162float(dyrow[c + j]) * p.gamma[c + j];
        xr[c + j] = xhat;
        s1 += a;
        s2 += a * xhat;
      }
    }
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
    bf16* dorow = p.dout + static_cast<size_t>(row) * d;
    for (int c = lane * 4; c < d; c += 128) {
      const uint32_t keep = p.drop.on ? keep4(key, p.drop.threshold, p.drop.row0 + row, c) : 0xFu;
      float dr[4], dv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = __bfloat162float(dyrow[c + j]) * p.gamma[c + j];
        dr[j] = (a - m1 - xr[c + j] * m2) * rstd;
        dv[j] = p.drop.on ? ((keep >> j) & 1u ? dr[j] * p.drop.inv_keep : 0.0f) : dr[j];
      }
      *reinterpret_cast<float4*>(orow + c) = make_float4(dr[0], dr[1], dr[2], dr[3]);
      *reinterpret_cast<uint2*>(dorow + c) =
          make_uint2(pack_bf16(dv[0], dv[1]), pack_bf16(dv[2], dv[3]));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kRowThreads) {
    float sg = 0.0f, sb = 0.0f;
    for (int r = 0; r < valid; ++r) {
      const float dyv = __bfloat162float(p.dy[static_cast<size_t>(row0 + r) * d + c]);
      sg += dyv * xhat_s[r * d + c];
      sb += dyv;
    }
    p.part[static_cast<size_t>(blockIdx.x) * 2 * d + c] = sg;
    p.part[static_cast<size_t>(blockIdx.x) * 2 * d + d + c] = sb;
  }
}

// 4. dh = do . W2^T over (M, F) tiles (W2^T read MN-major from w2t as
// stored): du = bf16(dh * gelu'(u)).
__global__ void __launch_bounds__(kGemmThreads, 2)
ffn_bwd_dh_kernel(const __grid_constant__ CUtensorMap domap,
                  const __grid_constant__ CUtensorMap w2map, const Params p) {
  float acc[kWideN / 2];
  if (!gemm_mainloop<kWideN, true, kWideStages>(&domap, &w2map, p.d, acc)) return;
  gemm_epilogue<kWideN>(
      acc, p.m,
      [&](int row, int col) {
        return __ldg(reinterpret_cast<const float2*>(p.gd + static_cast<size_t>(row) * p.f + col));
      },
      [&](int row, int col, float a0, float a1, float2 gd) {
        *reinterpret_cast<uint32_t*>(p.du + static_cast<size_t>(row) * p.f + col) =
            pack_bf16(a0 * gd.x, a1 * gd.y);
      });
}

// 5. dx = dr + du . W1^T over (M, D) tiles (W1^T read MN-major from w1t as
// stored), summed in f32 and stored in bf16.
__global__ void __launch_bounds__(kGemmThreads, 2)
ffn_bwd_dx_kernel(const __grid_constant__ CUtensorMap dumap,
                  const __grid_constant__ CUtensorMap w1map, const Params p) {
  float acc[kNarrowN / 2];
  if (!gemm_mainloop<kNarrowN, true, kNarrowStages>(&dumap, &w1map, p.f, acc)) return;
  gemm_epilogue<kNarrowN>(
      acc, p.m,
      [&](int row, int col) {
        return __ldg(reinterpret_cast<const float2*>(p.dr + static_cast<size_t>(row) * p.d + col));
      },
      [&](int row, int col, float a0, float a1, float2 dr) {
        *reinterpret_cast<uint32_t*>(p.dx + static_cast<size_t>(row) * p.d + col) =
            pack_bf16(a0 + dr.x, a1 + dr.y);
      });
}

// Whether the o stage of an (m, d) output takes the 192-wide tiles: when
// they fill at least 3/4 of the SMs' waves (at D = 768: M = 12576 gives
// 396 tiles, 3 waves of 132); else the 64-wide tiles, two blocks an SM,
// whose finer grain fills the card at the small and middle sites.  Both
// chains decide alike.
bool o_takes_wide_tiles(int m, int d, int sms) {
  if (d % kOWideN != 0) return false;
  const int tiles = ceil_div(m, kGemmBM) * (d / kOWideN);
  const int waves = ceil_div(tiles, sms);
  return tiles >= sms && 4 * tiles >= 3 * waves * sms;
}

// The first launch of either chain: u (h out, and gelu'(u) in the
// backward).
template <bool kGrad>
cudaError_t launch_u(const Params& p, const CUtensorMap& xmap, const CUtensorMap& w1map,
                     cudaStream_t s) {
  return gemm_launch<kWideN, kWideStages>(kGrad ? ffn_bwd_u_kernel : ffn_fwd_u_kernel, p.m, p.f,
                                          s, xmap, w1map, p);
}

// The second: o + b2 into p.dr.
cudaError_t launch_o(const Params& p, const CUtensorMap& hmap, const CUtensorMap& w2map,
                     cudaStream_t s) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = o_takes_wide_tiles(p.m, p.d, sms)
              ? gemm_launch<kOWideN, kOWideStages>(ffn_o_kernel<kOWideN, kOWideStages, 1>, p.m,
                                                   p.d, s, hmap, w2map, p)
              : gemm_launch<kNarrowN, kNarrowStages>(ffn_o_kernel<kNarrowN, kNarrowStages, 2>,
                                                     p.m, p.d, s, hmap, w2map, p);
  }
  return err;
}

template <bool kGrad>
cudaError_t launch_u_o(const Params& p, const CUtensorMap& xmap, const CUtensorMap& hmap,
                       const CUtensorMap& w1map, const CUtensorMap& w2map, cudaStream_t s) {
  cudaError_t err = launch_u<kGrad>(p, xmap, w1map, s);
  if (err == cudaSuccess) err = launch_o(p, hmap, w2map, s);
  return err;
}

// The forward's row pass over o + b2 in p.dr: y.
cudaError_t launch_fwd_rows(const Params& p, cudaStream_t s) {
  ffn_fwd_rows_kernel<<<ceil_div(p.m, kRowTile), kRowThreads, 0, s>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_fwd(const Params& p, const bf16* w1t, const bf16* w2t, cudaStream_t s) {
  CUtensorMap xmap, hmap, w1map, w2map;
  cudaError_t err = gemm_a_map(&xmap, p.x, p.m, p.d);
  if (err == cudaSuccess) err = gemm_a_map(&hmap, p.h, p.m, p.f);
  if (err == cudaSuccess) err = gemm_b_map(&w1map, w1t, p.f, p.d);
  if (err == cudaSuccess) err = gemm_b_map(&w2map, w2t, p.d, p.f);
  if (err == cudaSuccess) err = launch_u_o<false>(p, xmap, hmap, w1map, w2map, s);
  if (err == cudaSuccess) err = launch_fwd_rows(p, s);
  return err;
}

// The forward's products alone (the split chain's first call): h, and h .
// W2 + b2 into p.dr.
cudaError_t launch_fwd_products(const Params& p, const bf16* w1t, const bf16* w2t,
                                cudaStream_t s) {
  CUtensorMap xmap, hmap, w1map, w2map;
  cudaError_t err = gemm_a_map(&xmap, p.x, p.m, p.d);
  if (err == cudaSuccess) err = gemm_a_map(&hmap, p.h, p.m, p.f);
  if (err == cudaSuccess) err = gemm_b_map(&w1map, w1t, p.f, p.d);
  if (err == cudaSuccess) err = gemm_b_map(&w2map, w2t, p.d, p.f);
  if (err == cudaSuccess) err = launch_u_o<false>(p, xmap, hmap, w1map, w2map, s);
  return err;
}

cudaError_t launch_bwd(const Params& p, const bf16* w1t, const bf16* w2t, cudaStream_t s) {
  CUtensorMap xmap, hmap, domap, dumap, w1map, w2map;
  cudaError_t err = gemm_a_map(&xmap, p.x, p.m, p.d);
  if (err == cudaSuccess) err = gemm_a_map(&hmap, p.h, p.m, p.f);
  if (err == cudaSuccess) err = gemm_a_map(&domap, p.dout, p.m, p.d);
  if (err == cudaSuccess) err = gemm_a_map(&dumap, p.du, p.m, p.f);
  if (err == cudaSuccess) err = gemm_b_map(&w1map, w1t, p.f, p.d);
  if (err == cudaSuccess) err = gemm_b_map(&w2map, w2t, p.d, p.f);
  if (err == cudaSuccess) err = launch_u_o<true>(p, xmap, hmap, w1map, w2map, s);
  if (err == cudaSuccess) {
    const int smem = static_cast<int>(sizeof(float)) * kRowTile * p.d;
    err = cudaFuncSetAttribute(ffn_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) {
      ffn_bwd_rows_kernel<<<ceil_div(p.m, kRowTile), kRowThreads, smem, s>>>(p);
      err = cudaGetLastError();
    }
  }
  if (err == cudaSuccess) {
    err = gemm_launch<kWideN, kWideStages>(ffn_bwd_dh_kernel, p.m, p.f, s, domap, w2map, p);
  }
  if (err == cudaSuccess) {
    err = gemm_launch<kNarrowN, kNarrowStages>(ffn_bwd_dx_kernel, p.m, p.d, s, dumap, w1map, p);
  }
  return err;
}

// out[c] = sum over tiles t of part[t][c] (c < cols), in a fixed order: a
// block takes 32 columns, each of its 8 warps sums a contiguous eighth of
// the tiles in tile order, and the eight sums are added in slice order.
// Deterministic, no atomics.
constexpr int kSumCols = 32;
constexpr int kSumSlices = 8;

__global__ void __launch_bounds__(kSumCols * kSumSlices)
sum_partials_kernel(const float* __restrict__ part, int tiles, int cols, float* __restrict__ out) {
  __shared__ float slice_sum[kSumSlices][kSumCols];
  const int lane = threadIdx.x % kSumCols, slice = threadIdx.x / kSumCols;
  const int c = blockIdx.x * kSumCols + lane;
  const int per = (tiles + kSumSlices - 1) / kSumSlices;
  const int t0 = slice * per, t1 = min(tiles, t0 + per);
  float s = 0.0f;
  if (c < cols) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) s += part[static_cast<size_t>(t) * cols + c];
  }
  slice_sum[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && c < cols) {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kSumSlices; ++i) total += slice_sum[i][lane];
    out[c] = total;
  }
}

// The backward's row pass on o + b2 in p.dr (dr in place, do, the
// partials), then the partials' sum into dgb (the split chain's first
// backward call).
cudaError_t launch_bwd_rows(const Params& p, float* dgb, cudaStream_t s) {
  const int smem = static_cast<int>(sizeof(float)) * kRowTile * p.d;
  cudaError_t err = cudaFuncSetAttribute(ffn_bwd_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && p.m > 0) {
    ffn_bwd_rows_kernel<<<ceil_div(p.m, kRowTile), kRowThreads, smem, s>>>(p);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    sum_partials_kernel<<<ceil_div(2 * p.d, kSumCols), kSumCols * kSumSlices, 0, s>>>(
        p.part, ceil_div(p.m, kRowTile), 2 * p.d, dgb);
    err = cudaGetLastError();
  }
  return err;
}

// The backward's products on do (the split chain's second backward call):
// u with gelu'(u), du = (do . W2^T) * gelu'(u), dx = p.dr + du . W1^T.
cudaError_t launch_bwd_products(const Params& p, const bf16* w1t, const bf16* w2t,
                                cudaStream_t s) {
  CUtensorMap xmap, domap, dumap, w1map, w2map;
  cudaError_t err = gemm_a_map(&xmap, p.x, p.m, p.d);
  if (err == cudaSuccess) err = gemm_a_map(&domap, p.dout, p.m, p.d);
  if (err == cudaSuccess) err = gemm_a_map(&dumap, p.du, p.m, p.f);
  if (err == cudaSuccess) err = gemm_b_map(&w1map, w1t, p.f, p.d);
  if (err == cudaSuccess) err = gemm_b_map(&w2map, w2t, p.d, p.f);
  if (err == cudaSuccess) err = launch_u<true>(p, xmap, w1map, s);
  if (err == cudaSuccess) {
    err = gemm_launch<kWideN, kWideStages>(ffn_bwd_dh_kernel, p.m, p.f, s, domap, w2map, p);
  }
  if (err == cudaSuccess) {
    err = gemm_launch<kNarrowN, kNarrowStages>(ffn_bwd_dx_kernel, p.m, p.d, s, dumap, w1map, p);
  }
  return err;
}

__global__ void keep_mask_kernel(const long long* __restrict__ seed, uint8_t* __restrict__ out,
                                 int d, uint32_t threshold, int row0) {
  const uint2 key = make_uint2(static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(seed[1]));
  const int row = blockIdx.x;
  for (int c = threadIdx.x * 4; c < d; c += blockDim.x * 4) {
    const uint32_t keep = keep4(key, threshold, row0 + row, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c + j < d) out[static_cast<size_t>(row) * d + c + j] = (keep >> j) & 1u;
    }
  }
}

// The fields both chains read; the rest null.
Params chain_params(const void* x, const void* b1, const void* b2, const void* gamma, void* h,
                    void* o, int m, int d, int f, float eps, const void* seed,
                    unsigned threshold, float inv_keep, int dropout, int row0) {
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  p.h = static_cast<bf16*>(h);
  p.dr = static_cast<float*>(o);
  p.m = m;
  p.d = d;
  p.f = f;
  p.eps = eps;
  p.drop = Drop{static_cast<const long long*>(seed), threshold, inv_keep, dropout, row0};
  return p;
}

}  // namespace

extern "C" {

// Largest hidden width the kernels take (the forward's row pass holds a
// row in registers).
int shgvqa_ffn_train_max_d() { return kMaxD; }

// Rows of a row-pass block: the wrapper sizes the (tiles, 2 D) f32 scratch
// of the dgamma / dbeta partials with it.
int shgvqa_ffn_train_bwd_rows() { return kRowTile; }

// Forward on `stream` (three launches); returns cudaGetLastError() (0 =
// launched).  x, y (m, d) bf16; w1t (f, d), w2t (d, f) bf16; b1 (f), b2,
// gamma, beta (d) f32; the dropout: seed (2 int64 on the device, read when
// dropout != 0), threshold, 1 / (1 - rate) and the counter's row offset
// row0; scratch h (m, f) bf16 and o
// (m, d) f32.  d is a multiple of 64 (<= 768), f a multiple of 128; every
// pointer 16-byte aligned.
int shgvqa_ffn_train_fwd_bf16(const void* x, const void* w1t, const void* b1, const void* w2t,
                              const void* b2, const void* gamma, const void* beta,
                              const void* seed, void* y, void* h, void* o, int m, int d, int f,
                              float eps, unsigned threshold, float inv_keep, int dropout,
                              int row0, void* stream) {
  if (m < 0 || d <= 0 || f <= 0 || d % kNarrowN != 0 || f % kWideN != 0 || d > kMaxD ||
      (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  Params p = chain_params(x, b1, b2, gamma, h, o, m, d, f, eps, seed, threshold, inv_keep,
                          dropout, row0);
  p.beta = static_cast<const float*>(beta);
  p.y = static_cast<bf16*>(y);
  return static_cast<int>(launch_fwd(p, static_cast<const bf16*>(w1t),
                                     static_cast<const bf16*>(w2t),
                                     static_cast<cudaStream_t>(stream)));
}

// Backward on `stream` (six launches); returns cudaGetLastError().  Inputs
// as the forward (beta is not read) plus dy (m, d) bf16; outputs dx, do
// (m, d) and du, h (m, f) bf16, dgb (2 d) f32 = [dgamma | dbeta]; scratch
// gd (m, f) f32, dr (m, d) f32 and part (ceil(m / 16), 2 d) f32.  d is a
// multiple of 64 (<= 768), f a multiple of 128; every pointer 16-byte
// aligned.
int shgvqa_ffn_train_bwd_bf16(const void* x, const void* w1t, const void* b1, const void* w2t,
                              const void* b2, const void* gamma, const void* seed,
                              const void* dy, void* dx, void* du, void* dout, void* h, void* gd,
                              void* dr, void* part, void* dgb, int m, int d, int f, float eps,
                              unsigned threshold, float inv_keep, int dropout, int row0,
                              void* stream) {
  if (m < 0 || d <= 0 || f <= 0 || d % kNarrowN != 0 || f % kWideN != 0 || d > kMaxD ||
      (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ceil_div(m, kRowTile);
  if (m > 0) {
    Params p = chain_params(x, b1, b2, gamma, h, dr, m, d, f, eps, seed, threshold, inv_keep,
                            dropout, row0);
    p.dy = static_cast<const bf16*>(dy);
    p.dx = static_cast<bf16*>(dx);
    p.du = static_cast<bf16*>(du);
    p.dout = static_cast<bf16*>(dout);
    p.gd = static_cast<float*>(gd);
    p.part = static_cast<float*>(part);
    const cudaError_t err =
        launch_bwd(p, static_cast<const bf16*>(w1t), static_cast<const bf16*>(w2t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sum_partials_kernel<<<ceil_div(2 * d, kSumCols), kSumCols * kSumSlices, 0, s>>>(
      static_cast<const float*>(part), tiles, 2 * d, static_cast<float*>(dgb));
  return static_cast<int>(cudaGetLastError());
}

// The split chain (tensor parallelism; f is this rank's F / mp columns).
// Forward, first call (two launches): h (m, f) bf16 and the partial o =
// h . W2 + b2 (m, d) f32, with b2 a zero vector (d) f32 here.  Inputs as
// shgvqa_ffn_train_fwd_bf16.
int shgvqa_ffn_train_fwd_products_bf16(const void* x, const void* w1t, const void* b1,
                                       const void* w2t, const void* b2, void* h, void* o, int m,
                                       int d, int f, void* stream) {
  if (m < 0 || d <= 0 || f <= 0 || d % kNarrowN != 0 || f % kWideN != 0 || d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  Params p = chain_params(x, b1, b2, nullptr, h, o, m, d, f, 0.0f, nullptr, 0u, 1.0f, 0, 0);
  return static_cast<int>(launch_fwd_products(p, static_cast<const bf16*>(w1t),
                                              static_cast<const bf16*>(w2t),
                                              static_cast<cudaStream_t>(stream)));
}

// Forward, second call (one launch): the row pass over o (m, d) f32, the
// model group's sum of the partials plus b2: dropout, + x, LayerNorm, y
// (m, d) bf16.  Dropout as shgvqa_ffn_train_fwd_bf16.
int shgvqa_ffn_train_fwd_rows_bf16(const void* x, const void* o, const void* gamma,
                                   const void* beta, const void* seed, void* y, int m, int d,
                                   float eps, unsigned threshold, float inv_keep, int dropout,
                                   int row0, void* stream) {
  if (m < 0 || d <= 0 || d % kNarrowN != 0 || d > kMaxD || (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  Params p = chain_params(x, nullptr, nullptr, gamma, nullptr, const_cast<void*>(o), m, d, 0, eps,
                          seed, threshold, inv_keep, dropout, row0);
  p.beta = static_cast<const float*>(beta);
  p.y = static_cast<bf16*>(y);
  return static_cast<int>(launch_fwd_rows(p, static_cast<cudaStream_t>(stream)));
}

// Backward, first call (two launches): the row pass over o + b2 in dr (m,
// d) f32, overwritten with dr; do (m, d) bf16, the dgamma / dbeta partials
// (ceil(m / 16), 2 d) f32 in part and their sum dgb (2 d) f32.
int shgvqa_ffn_train_bwd_rows_bf16(const void* x, const void* gamma, const void* seed,
                                   const void* dy, void* dout, void* dr, void* part, void* dgb,
                                   int m, int d, float eps, unsigned threshold, float inv_keep,
                                   int dropout, int row0, void* stream) {
  if (m < 0 || d <= 0 || d % kNarrowN != 0 || d > kMaxD || (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = chain_params(x, nullptr, nullptr, gamma, nullptr, dr, m, d, 0, eps, seed, threshold,
                          inv_keep, dropout, row0);
  p.dy = static_cast<const bf16*>(dy);
  p.dout = static_cast<bf16*>(dout);
  p.part = static_cast<float*>(part);
  return static_cast<int>(launch_bwd_rows(p, static_cast<float*>(dgb),
                                          static_cast<cudaStream_t>(stream)));
}

// Backward, second call (three launches): from do (m, d) bf16, h and du
// (m, f) bf16 out (gd (m, f) f32 scratch) and dx = dr + du . W1^T (m, d)
// bf16, with dr (m, d) f32 zeros here: this rank's partial.
int shgvqa_ffn_train_bwd_products_bf16(const void* x, const void* w1t, const void* b1,
                                       const void* w2t, const void* dout, const void* dr,
                                       void* dx, void* du, void* h, void* gd, int m, int d, int f,
                                       void* stream) {
  if (m < 0 || d <= 0 || f <= 0 || d % kNarrowN != 0 || f % kWideN != 0 || d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  Params p = chain_params(x, b1, nullptr, nullptr, h, const_cast<void*>(dr), m, d, f, 0.0f,
                          nullptr, 0u, 1.0f, 0, 0);
  p.dout = static_cast<bf16*>(const_cast<void*>(dout));
  p.dx = static_cast<bf16*>(dx);
  p.du = static_cast<bf16*>(du);
  p.gd = static_cast<float*>(gd);
  return static_cast<int>(launch_bwd_products(p, static_cast<const bf16*>(w1t),
                                              static_cast<const bf16*>(w2t),
                                              static_cast<cudaStream_t>(stream)));
}

// The keep mask (m, d) uint8 that a call with this seed, threshold and
// row offset draws; for holding the kernels to their plain version.
int shgvqa_ffn_train_keep_mask(const void* seed, void* out, int m, int d, unsigned threshold,
                               int row0, void* stream) {
  if (m <= 0 || d <= 0 || d % 4 != 0 || seed == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  keep_mask_kernel<<<m, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), static_cast<uint8_t*>(out), d, threshold, row0);
  return static_cast<int>(cudaGetLastError());
}

const char* shgvqa_ffn_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
