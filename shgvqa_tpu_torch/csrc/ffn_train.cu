// Fused BERT FFN block with dropout on the output dense, forward and backward,
// for Hopper (sm_90a):
//
//   u = x . W1 + b1,  h = bf16(gelu_erf(u)),  o = h . W2 + b2
//   y = LN(x + dropout(o)) * gamma + beta
//
// Replaces shgvqa_tpu/kernels/ffn.py::_make_train_pair, the Pallas TPU
// kernels fwd_kernel (forward) and bwd_kernel (backward) behind the JAX
// fused_ffn_train; the plain versions are ffn_train_reference and
// ffn_train_backward_reference in shgvqa_tpu_torch/kernels/ffn.py.
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
// with the counter (col / 4, row, 0, 0).  The counter depends on the
// absolute row and column only, so the forward (32- or 48-row tiles), the
// backward's row pass (16-row tiles) and shgvqa_ffn_train_keep_mask draw
// one mask.
// (The TPU kernel seeds per program id, with 128-row programs forward and
// 64-row programs backward, so its backward regenerates another mask.)
//
// What bounds it on the card: forward 4*M*D*F operations, backward 8*M*D*F
// (the JAX cost estimates) against ~4*M*D + 4*D*F bytes forward and
// (4*M*D + 2*M*F + 2*D*F) * 2 backward: at the model's shapes (D=768,
// F=3072, M >= 80) the tensor cores, not device memory.
//
// Design:
// - forward: the design of csrc/ffn.cu (TMA-fed weight ring, ldmatrix +
//   mma.sync, 16 warps, 32- or 48-row tiles, the (rows, D) f32 output kept
//   in registers), with the dropout in the LayerNorm epilogue;
// - backward: six launches on one stream, each shaped to fill the card at
//   M = 1280 (10 row tiles).  The four products run the mainloop of
//   wgmma_gemm.cuh (128-row tiles of two consumer warpgroups issuing
//   wgmma.mma_async, a producer warp keeping a ring of TMA tiles with the
//   128-byte swizzle in flight on mbarriers, 3 stages for the 128-wide
//   tiles and 4 for the 64-wide ones, so that two blocks share an SM and
//   one's epilogue overlaps the other's products), each with its own
//   epilogue:
//   1. u = x . W1 + b1 over (M, F) tiles 128 wide: h (bf16) and gelu'(u)
//      (an f32 spill, M x F) out;
//   2. o = h . W2 + b2 over (M, D) tiles 64 wide, out in f32;
//   3. a row pass, one warp per row: the dropout, the LayerNorm recompute,
//      dr (f32, over o) and do (bf16) out, and per 16-row tile the partial
//      dgamma and dbeta;
//   4. dh = do . W2^T over (M, F) tiles: du = bf16(dh * gelu'(u)) out;
//   5. dx = dr + du . W1^T over (M, D) tiles, out in bf16;
//   6. dgamma and dbeta: the partials summed column by column, in eighths
//      of the tiles in tile order and then the eighths in order.
//   W1 and W2 are read as the nn.Linear weights are stored: K-major where
//   the product takes W^T (1, 2), MN-major, transposed by the wgmma, where
//   it takes W (4, 5).  Nothing is summed with atomics: two calls on the
//   same inputs give the same bits.
// Ragged M: rows past M are zero-filled by the TMA, never stored and never
// summed into dgamma or dbeta.

#include "wgmma_gemm.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpCols = 48;                     // output columns per warp
constexpr int kMaxD = kWarps * kWarpCols;         // 768
constexpr int kChunk = 16 * kWarps;               // F columns per chunk, 16 per warp
constexpr int kKU = 64;                           // D depth of a W1 tile: 128-byte rows
constexpr int kKO = 16;                           // F depth of a W2 tile: 32-byte rows
constexpr int kBoxRows = 256;                     // most rows one TMA box takes
constexpr int kPad = 8;                           // bf16 pad of shared rows: 16 bytes
constexpr int kLdH = kChunk + kPad;
constexpr size_t kStageBytes = 32768;             // >= 256 x 128 B (W1) and 768 x 32 B (W2)

__host__ __device__ inline size_t align_up(size_t n, size_t a) { return (n + a - 1) / a * a; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of a row of matrix l/8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b on one m16n8k16 tile (a row-major, b col-major, f32 sums).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand: the 16 x 16 block at p of a row-major matrix with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* p, int ld, int lane) {
  ldsm_x4(r, smem_addr(p + (lane % 16) * ld + (lane / 16) * 8));
}

// B operands of two n8 tiles from a TMA-swizzled [n][k] weight tile: rows
// n0..n0+15, 16-byte chunks c0 and c0+1 of each row; r[0..1] is n 0-7,
// r[2..3] is n 8-15.  The 128-byte swizzle puts chunk c of row r at
// c ^ (r % 8), the 32-byte swizzle at c ^ ((r / 4) % 2).
__device__ __forceinline__ void load_b2_sw128(uint32_t (&r)[4], uint32_t tile, int n0, int c0,
                                              int lane) {
  const int row = n0 + (lane % 8) + (lane / 16) * 8;
  const int chunk = c0 + (lane / 8) % 2;
  ldsm_x4(r, tile + row * 128 + ((chunk ^ (row % 8)) << 4));
}

__device__ __forceinline__ void load_b2_sw32(uint32_t (&r)[4], uint32_t tile, int n0, int lane) {
  const int row = n0 + (lane % 8) + (lane / 16) * 8;
  const int chunk = (lane / 8) % 2;
  ldsm_x4(r, tile + row * 32 + ((chunk ^ ((row / 4) % 2)) << 4));
}

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// gelu(u) = u * Phi(u) (bit-equal to gelu_erf: both round u (1 + erf) / 2
// once), and gelu'(u) = Phi(u) + u * phi(u) into grad, from one erf
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
// Forward: csrc/ffn.cu's kernel with the dropout in its epilogue.

template <int kMTiles>
struct Tile {
  static constexpr int kRows = 16 * kMTiles;
  static constexpr int kStages = kMTiles == 2 ? 4 : 3;   // what fits in 227 KB
};

// Shared memory: x tile | h chunk | weight ring (1 KB aligned, as the
// 128-byte swizzle repeats every 1 KB) | mbarriers.  The f32 output tile
// reuses h and the ring in the epilogue.
template <int kMTiles>
struct Layout {
  size_t xs, hs, ws, os, bars, total;
  __host__ __device__ explicit Layout(int d) {
    constexpr int rows = Tile<kMTiles>::kRows;
    xs = 0;
    hs = align_up(sizeof(bf16) * rows * (d + kPad), 128);
    ws = align_up(hs + sizeof(bf16) * rows * kLdH, 1024);
    os = hs;
    const size_t ring_end = ws + Tile<kMTiles>::kStages * kStageBytes;
    const size_t os_end = os + sizeof(float) * rows * d;
    bars = align_up(ring_end > os_end ? ring_end : os_end, 8);
    total = bars + sizeof(uint64_t) * Tile<kMTiles>::kStages;
  }
};

// Position in the weight stream: per F chunk f0, the W1 tiles over D (k is
// the D offset), then the W2 tiles over the chunk (k is the F offset in it).
struct Cursor {
  int f0, k;
  bool w1;
  __device__ void next(int d, int f) {
    if (w1) {
      k += kKU;
      if (k >= d) { w1 = false; k = 0; }
    } else {
      k += kKO;
      if (k >= min(kChunk, f - f0)) { f0 += kChunk; k = 0; w1 = true; }
    }
  }
};

// One thread issues the tile at c into the stage at dst, to complete on bar
// (nothing past the end).  A W1 tile is one box of w1_rows F rows x 64 D
// columns; a W2 tile is boxes of w2_rows D rows x 16 F columns, stacked.
// Boxes past the matrix edge are zero-filled and still count in full.
__device__ __forceinline__ void issue_tile(const Cursor& c, uint32_t dst, uint32_t bar,
                                           const CUtensorMap* w1map, const CUtensorMap* w2map,
                                           int d, int f, int w1_rows, int w2_rows) {
  if (c.f0 >= f) return;
  if (c.w1) {
    mbar_expect_tx(bar, w1_rows * kKU * sizeof(bf16));
    tma_2d(dst, w1map, c.k, c.f0, bar);
  } else {
    const int boxes = (d + w2_rows - 1) / w2_rows;
    const int box_bytes = w2_rows * kKO * sizeof(bf16);
    mbar_expect_tx(bar, boxes * box_bytes);
    for (int b = 0; b < boxes; ++b) tma_2d(dst + b * box_bytes, w2map, c.f0 + c.k, b * w2_rows, bar);
  }
}

template <int kMTiles>
__global__ void __launch_bounds__(kThreads, 1)
ffn_train_fwd_kernel(const __grid_constant__ CUtensorMap w1map,
                     const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ x,
                     const float* __restrict__ b1, const float* __restrict__ b2,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     bf16* __restrict__ y, int m, int d, int f, int w1_rows, int w2_rows,
                     float eps, const Drop drop) {
  constexpr int kRows = Tile<kMTiles>::kRows;
  constexpr int kStages = Tile<kMTiles>::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Layout<kMTiles> lay(d);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.xs);
  bf16* hs = reinterpret_cast<bf16*>(smem + lay.hs);
  float* os = reinterpret_cast<float*>(smem + lay.os);
  const uint32_t ws = smem_addr(smem + lay.ws);
  const uint32_t bars = smem_addr(smem + lay.bars);
  const int ldx = d + kPad;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                 // accumulator rows g and g + 8
  const int q = (lane % 4) * 2;           // accumulator columns q and q + 1
  const int row0 = blockIdx.x * kRows;
  const int ucol = warp * 16;             // this warp's 16 columns of each F chunk

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // x tile, rows past m zero
  const int vec_per_row = d / 8;
  for (int i = threadIdx.x; i < kRows * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row;
    const int c = (i % vec_per_row) * 8;
    bf16* dst = xs + r * ldx + c;
    if (row0 + r < m) {
      cp_async16(dst, x + static_cast<size_t>(row0 + r) * d + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_commit();
  __syncthreads();   // the mbarriers are initialized
  Cursor load{0, 0, true};
  for (int s = 0; s < kStages - 1; ++s) {
    if (threadIdx.x == 0) {
      issue_tile(load, ws + s * kStageBytes, bars + 8 * s, &w1map, &w2map, d, f, w1_rows,
                 w2_rows);
    }
    load.next(d, f);
  }
  cp_wait<0>();
  __syncthreads();   // the x tile is in

  float acc[kMTiles][kWarpCols / 8][4];   // rows 16 i.., columns 48 warp + 8 n..
  float uacc[kMTiles][2][4];              // rows 16 i.., chunk columns ucol + 8 n..
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int n = 0; n < kWarpCols / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
    }
  }

  Cursor cur{0, 0, true};
  for (int t = 0; cur.f0 < f; ++t) {
    const int stage = t % kStages;
    mbar_wait(bars + 8 * stage, (t / kStages) % 2);   // tile t landed
    __syncthreads();                                  // everyone is done with tile t-1
    if (threadIdx.x == 0) {                           // ... so its stage takes tile t+S-1
      const int s = (t + kStages - 1) % kStages;
      issue_tile(load, ws + s * kStageBytes, bars + 8 * s, &w1map, &w2map, d, f, w1_rows,
                 w2_rows);
    }
    load.next(d, f);
    const uint32_t tile = ws + stage * kStageBytes;
    const int fc = min(kChunk, f - cur.f0);
    if (cur.w1) {
      // u[:, ucol..] += x[:, k..k+64] . W1[k..k+64, f0 + ucol..]
      if (cur.k == 0) {
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) uacc[i][n][e] = 0.0f;
          }
        }
      }
      if (ucol < fc) {
        const int kw = min(kKU, d - cur.k);
#pragma unroll
        for (int kk = 0; kk < kKU; kk += 16) {
          if (kk < kw) {
            uint32_t b[4];
            load_b2_sw128(b, tile, ucol, kk / 8, lane);
#pragma unroll
            for (int i = 0; i < kMTiles; ++i) {
              uint32_t a[4];
              load_a(a, xs + i * 16 * ldx + cur.k + kk, ldx, lane);
              mma16816(uacc[i][0], a, b[0], b[1]);
              mma16816(uacc[i][1], a, b[2], b[3]);
            }
          }
        }
        if (cur.k + kKU >= d) {   // u is complete: bias + GeLU -> h (bf16)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int c = ucol + n * 8 + q;
            const float bias0 = b1[cur.f0 + c], bias1 = b1[cur.f0 + c + 1];
#pragma unroll
            for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int r = i * 16 + g + half * 8;
                *reinterpret_cast<__nv_bfloat162*>(hs + r * kLdH + c) = __floats2bfloat162_rn(
                    gelu_erf(uacc[i][n][2 * half] + bias0),
                    gelu_erf(uacc[i][n][2 * half + 1] + bias1));
              }
            }
          }
        }
      }
    } else {
      // acc[:, 48 warp..] += h[:, k..k+16] . W2[f0+k..f0+k+16, 48 warp..]; the
      // barrier at the top of this step made every warp's h visible
      uint32_t a[kMTiles][4];
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) load_a(a[i], hs + i * 16 * kLdH + cur.k, kLdH, lane);
#pragma unroll
      for (int p = 0; p < kWarpCols / 16; ++p) {
        const int n0 = warp * kWarpCols + p * 16;
        if (n0 < d) {
          uint32_t b[4];
          load_b2_sw32(b, tile, n0, lane);
#pragma unroll
          for (int i = 0; i < kMTiles; ++i) {
            mma16816(acc[i][2 * p], a[i], b[0], b[1]);
            mma16816(acc[i][2 * p + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    cur.next(d, f);
  }
  __syncthreads();   // h and the ring are dead (every tile issued was waited for)

#pragma unroll
  for (int n = 0; n < kWarpCols / 8; ++n) {
    const int c = warp * kWarpCols + n * 8 + q;
    if (c < d) {
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = i * 16 + g + half * 8;
          *reinterpret_cast<float2*>(os + r * d + c) =
              make_float2(acc[i][n][2 * half], acc[i][n][2 * half + 1]);
        }
      }
    }
  }
  __syncthreads();

  // epilogue: bias, dropout, residual, two-pass LayerNorm; one warp per row,
  // four columns a lane at a time (one Philox call)
  const float inv_d = 1.0f / static_cast<float>(d);
  const uint2 key = drop_key(drop);
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = row0 + r;
    if (row >= m) break;               // warp-uniform; later rows are past m too
    float* orow = os + r * d;
    const bf16* xrow = xs + r * ldx;
    float sum = 0.0f;
    for (int c = lane * 4; c < d; c += 128) {
      const float4 o4 = *reinterpret_cast<const float4*>(orow + c);
      float v[4] = {o4.x + b2[c], o4.y + b2[c + 1], o4.z + b2[c + 2], o4.w + b2[c + 3]};
      const uint32_t keep = drop.on ? keep4(key, drop.threshold, row, c) : 0xFu;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (drop.on) v[j] = (keep >> j) & 1u ? v[j] * drop.inv_keep : 0.0f;
        v[j] += __bfloat162float(xrow[c + j]);
        sum += v[j];
      }
      *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
    }
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.0f;
    for (int c = lane * 4; c < d; c += 128) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dev = orow[c + j] - mean;
        sq += dev * dev;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
    bf16* yrow = y + static_cast<size_t>(row) * d;
    for (int c = lane * 4; c < d; c += 128) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        yrow[c + j] = __float2bfloat16((orow[c + j] - mean) * rstd * gamma[c + j] + beta[c + j]);
      }
    }
  }
}

template <int kMTiles>
cudaError_t launch_fwd(const void* x, const void* w1t, const void* b1, const void* w2t,
                       const void* b2, const void* gamma, const void* beta, void* y, int m, int d,
                       int f, float eps, const Drop& drop, cudaStream_t stream) {
  CUtensorMap w1map, w2map;
  const int w1_rows = min(kBoxRows, f), w2_rows = min(kBoxRows, d);
  cudaError_t err = tensor_map(&w1map, w1t, f, d, w1_rows, kKU, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = tensor_map(&w2map, w2t, d, f, w2_rows, kKO, CU_TENSOR_MAP_SWIZZLE_32B);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = Layout<kMTiles>(d).total + 1024;   // slack to align the base to 1 KB
  err = cudaFuncSetAttribute(ffn_train_fwd_kernel<kMTiles>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + Tile<kMTiles>::kRows - 1) / Tile<kMTiles>::kRows);
  ffn_train_fwd_kernel<kMTiles><<<grid, kThreads, smem, stream>>>(
      w1map, w2map, static_cast<const bf16*>(x), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(y), m, d, f, w1_rows, w2_rows, eps, drop);
  return cudaGetLastError();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Backward: a chain of launches on one stream.  The four products run the
// wgmma mainloop of wgmma_gemm.cuh, each with its own epilogue; the
// LayerNorm backward is a row pass between them.

constexpr int kWideN = 128;                       // tile width of the (M, F) products
constexpr int kNarrowN = 64;                      // tile width of the (M, D) products
// ring stages: 3 x 32 KB (wide) and 4 x 24 KB (narrow) let two blocks share
// an SM, so that one block's epilogue overlaps the other's products
constexpr int kWideStages = 3;
constexpr int kNarrowStages = 4;
constexpr int kRowTile = 16;                      // rows of a row-pass block: a warp each
constexpr int kRowThreads = 32 * kRowTile;

struct BwdParams {
  const bf16* x;
  const float* b1;
  const float* b2;
  const float* gamma;
  const bf16* dy;
  bf16* dx;
  bf16* du;                            // (M, F)
  bf16* dout;                          // do, (M, D)
  bf16* h;                             // (M, F)
  float* gd;                           // gelu'(u), (M, F) scratch
  float* dr;                           // o + b2, then dr, (M, D) scratch
  float* part;                         // (row tiles, 2 D): sum dy * xhat | sum dy
  int m, d, f;
  float eps;
  Drop drop;
};

// 1. u = x . W1 + b1 over (M, F) tiles: h = bf16(gelu(u)), gelu'(u) in f32.
__global__ void __launch_bounds__(kGemmThreads, 2)
ffn_bwd_u_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
                 const BwdParams p) {
  float acc[kWideN / 2];
  if (!gemm_mainloop<kWideN, false, kWideStages>(&xmap, &w1map, p.d, acc)) return;
  gemm_epilogue<kWideN>(
      acc, p.m, [&](int, int col) { return __ldg(reinterpret_cast<const float2*>(p.b1 + col)); },
      [&](int row, int col, float a0, float a1, float2 bias) {
        float2 gd;
        const float h0 = gelu_and_grad(a0 + bias.x, gd.x), h1 = gelu_and_grad(a1 + bias.y, gd.y);
        const size_t off = static_cast<size_t>(row) * p.f + col;
        *reinterpret_cast<uint32_t*>(p.h + off) = pack_bf16(h0, h1);
        *reinterpret_cast<float2*>(p.gd + off) = gd;
      });
}

// 2. o = h . W2 + b2 over (M, D) tiles, in f32.
__global__ void __launch_bounds__(kGemmThreads, 2)
ffn_bwd_o_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap w2map,
                 const BwdParams p) {
  float acc[kNarrowN / 2];
  if (!gemm_mainloop<kNarrowN, false, kNarrowStages>(&hmap, &w2map, p.f, acc)) return;
  gemm_epilogue<kNarrowN>(
      acc, p.m, [&](int, int col) { return __ldg(reinterpret_cast<const float2*>(p.b2 + col)); },
      [&](int row, int col, float a0, float a1, float2 bias) {
        *reinterpret_cast<float2*>(p.dr + static_cast<size_t>(row) * p.d + col) =
            make_float2(a0 + bias.x, a1 + bias.y);
      });
}

// 3. The row pass, one warp per row: r = dropout(o + b2) + x, its two-pass
// LayerNorm statistics, xhat, a = dy * gamma, dr = (a - mean(a) - xhat *
// mean(a * xhat)) * rstd (over o + b2 in place) and do = bf16(dropout(dr));
// then the block's partial dgamma = sum dy * xhat and dbeta = sum dy, column
// by column over its rows in order.  Rows past M are skipped.
__global__ void __launch_bounds__(kRowThreads) ffn_bwd_rows_kernel(const BwdParams p) {
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
      const uint32_t keep = p.drop.on ? keep4(key, p.drop.threshold, row, c) : 0xFu;
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
      const uint32_t keep = p.drop.on ? keep4(key, p.drop.threshold, row, c) : 0xFu;
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
                  const __grid_constant__ CUtensorMap w2map, const BwdParams p) {
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
                  const __grid_constant__ CUtensorMap w1map, const BwdParams p) {
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

cudaError_t launch_bwd(const BwdParams& p, const bf16* w1t, const bf16* w2t, cudaStream_t s) {
  CUtensorMap xmap, hmap, domap, dumap, w1map, w2map;
  cudaError_t err = gemm_a_map(&xmap, p.x, p.m, p.d);
  if (err == cudaSuccess) err = gemm_a_map(&hmap, p.h, p.m, p.f);
  if (err == cudaSuccess) err = gemm_a_map(&domap, p.dout, p.m, p.d);
  if (err == cudaSuccess) err = gemm_a_map(&dumap, p.du, p.m, p.f);
  if (err == cudaSuccess) err = gemm_b_map(&w1map, w1t, p.f, p.d);
  if (err == cudaSuccess) err = gemm_b_map(&w2map, w2t, p.d, p.f);
  if (err == cudaSuccess) {
    err = gemm_launch<kWideN, kWideStages>(ffn_bwd_u_kernel, p.m, p.f, s, xmap, w1map, p);
  }
  if (err == cudaSuccess) {
    err = gemm_launch<kNarrowN, kNarrowStages>(ffn_bwd_o_kernel, p.m, p.d, s, hmap, w2map, p);
  }
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

__global__ void keep_mask_kernel(const long long* __restrict__ seed, uint8_t* __restrict__ out,
                                 int d, uint32_t threshold) {
  const uint2 key = make_uint2(static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(seed[1]));
  const int row = blockIdx.x;
  for (int c = threadIdx.x * 4; c < d; c += blockDim.x * 4) {
    const uint32_t keep = keep4(key, threshold, row, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c + j < d) out[static_cast<size_t>(row) * d + c + j] = (keep >> j) & 1u;
    }
  }
}

Drop make_drop(const void* seed, unsigned threshold, float inv_keep, int dropout) {
  return Drop{static_cast<const long long*>(seed), threshold, inv_keep, dropout};
}

}  // namespace

extern "C" {

// Largest hidden width the kernels take (D <= warps * columns per warp).
int shgvqa_ffn_train_max_d() { return kMaxD; }

// Rows of a row-pass block: the wrapper sizes the (tiles, 2 D) f32 scratch
// of the dgamma / dbeta partials with it.
int shgvqa_ffn_train_bwd_rows() { return kRowTile; }

// Forward on `stream`; returns cudaGetLastError() (0 = launched).  As
// csrc/ffn.cu's shgvqa_fused_ffn_bf16 (x, y (m, d) bf16; w1t (f, d), w2t
// (d, f) bf16; b1 (f), b2, gamma, beta (d) f32; d, f multiples of 16,
// d <= 768), plus the dropout: seed (2 int64 on the device, read when
// dropout != 0), threshold and 1 / (1 - rate).
int shgvqa_ffn_train_fwd_bf16(const void* x, const void* w1t, const void* b1, const void* w2t,
                              const void* b2, const void* gamma, const void* beta,
                              const void* seed, void* y, int m, int d, int f, float eps,
                              unsigned threshold, float inv_keep, int dropout, void* stream) {
  if (m < 0 || d <= 0 || f <= 0 || d % 16 != 0 || f % 16 != 0 || d > kMaxD ||
      (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop drop = make_drop(seed, threshold, inv_keep, dropout);
  if (ceil_div(ceil_div(m, 48), sms) < ceil_div(ceil_div(m, 32), sms)) {
    err = launch_fwd<3>(x, w1t, b1, w2t, b2, gamma, beta, y, m, d, f, eps, drop, s);
  } else {
    err = launch_fwd<2>(x, w1t, b1, w2t, b2, gamma, beta, y, m, d, f, eps, drop, s);
  }
  return static_cast<int>(err);
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
                              unsigned threshold, float inv_keep, int dropout, void* stream) {
  if (m < 0 || d <= 0 || f <= 0 || d % kNarrowN != 0 || f % kWideN != 0 || d > kMaxD ||
      (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ceil_div(m, kRowTile);
  if (m > 0) {
    BwdParams p;
    p.x = static_cast<const bf16*>(x);
    p.b1 = static_cast<const float*>(b1);
    p.b2 = static_cast<const float*>(b2);
    p.gamma = static_cast<const float*>(gamma);
    p.dy = static_cast<const bf16*>(dy);
    p.dx = static_cast<bf16*>(dx);
    p.du = static_cast<bf16*>(du);
    p.dout = static_cast<bf16*>(dout);
    p.h = static_cast<bf16*>(h);
    p.gd = static_cast<float*>(gd);
    p.dr = static_cast<float*>(dr);
    p.part = static_cast<float*>(part);
    p.m = m;
    p.d = d;
    p.f = f;
    p.eps = eps;
    p.drop = make_drop(seed, threshold, inv_keep, dropout);
    const cudaError_t err =
        launch_bwd(p, static_cast<const bf16*>(w1t), static_cast<const bf16*>(w2t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sum_partials_kernel<<<ceil_div(2 * d, kSumCols), kSumCols * kSumSlices, 0, s>>>(
      static_cast<const float*>(part), tiles, 2 * d, static_cast<float*>(dgb));
  return static_cast<int>(cudaGetLastError());
}

// The keep mask (m, d) uint8 that a call with this seed and threshold
// draws; for holding the kernels to their plain version.
int shgvqa_ffn_train_keep_mask(const void* seed, void* out, int m, int d, unsigned threshold,
                               void* stream) {
  if (m <= 0 || d <= 0 || d % 4 != 0 || seed == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  keep_mask_kernel<<<m, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), static_cast<uint8_t*>(out), d, threshold);
  return static_cast<int>(cudaGetLastError());
}

const char* shgvqa_ffn_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
