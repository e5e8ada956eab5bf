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
// backward (32-row tiles) and shgvqa_ffn_train_keep_mask draw one mask.
// (The TPU kernel seeds per program id, with 128-row programs forward and
// 64-row programs backward, so its backward regenerates another mask.)
//
// What bounds it on the card: forward 4*M*D*F operations, backward 8*M*D*F
// (the JAX cost estimates) against ~4*M*D + 4*D*F bytes forward and
// (4*M*D + 2*M*F + 2*D*F) * 2 backward: at the model's shapes (D=768,
// F=3072, M >= 80) the tensor cores, not device memory.
//
// Design (simple and right first):
// - forward: the design of csrc/ffn.cu (TMA-fed weight ring, ldmatrix +
//   mma.sync, 16 warps, 32- or 48-row tiles, the (rows, D) f32 output kept
//   in registers), with the dropout in the LayerNorm epilogue;
// - backward: one block of 16 warps per 32-row tile, weights streamed by
//   cp.async through a ring of three padded shared-memory buffers (two
//   tiles in flight while one is used, one barrier per tile).  Pass 1
//   recomputes u, h and o chunk by chunk over F (256 columns a chunk) exactly as the
//   forward does, writing h (bf16) and gelu'(u) (an f32 spill, M x F, read
//   back in pass 2 instead of recomputing u).  Between the passes, one warp
//   per row redoes the LayerNorm, the mask and dr, writes do, and the block
//   sums dy * xhat and dy over its rows into a per-tile partial.  Pass 2
//   walks F again: dh = do . W2^T[:, chunk], du = dh * gelu'(u), written
//   out and staged in shared memory, then dx += du . W1^T[chunk, :] in a
//   rows x D f32 register accumulator that starts at dr.  The transposed
//   reads of W2^T and W1^T use ldmatrix.trans on the nn.Linear layouts as
//   stored: no transposed copy of a weight exists;
// - dgamma and dbeta: a second kernel sums the per-tile partials column by
//   column in tile order: deterministic, no atomics.
// Ragged M: rows past M are zero-filled on load, never stored and never
// summed into dgamma or dbeta.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete; trap after a
// second instead of hanging on a copy that never lands.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (start == 0) start = now;
    if (now - start > 1000000000ull) __trap();
  }
}

// TMA: the box of `map` at (column c0, row c1) into shared memory at dst.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of a row of matrix l/8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// B operands of the n8 tiles n0 and n0+8 over k0..k0+15 from a padded tile
// stored [n][k] (rows are n, row stride ld): r[0..1] for n0, r[2..3] for
// n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const bf16* tile, int ld, int n0,
                                          int k0, int lane) {
  ldsm_x4(r, smem_addr(tile + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 + ((lane / 8) % 2) * 8));
}

// The same from a padded tile stored [k][n] (rows are k), transposed by
// ldmatrix.
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const bf16* tile, int ld, int k0,
                                          int n0, int lane) {
  ldsm_x4_trans(r,
                smem_addr(tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 + (lane / 16) * 8));
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

// gelu'(u) = Phi(u) + u * phi(u)
__device__ __forceinline__ float gelu_grad(float u) {
  return 0.5f * (1.0f + erff(u * 0.70710678118654752f)) +
         u * __expf(-0.5f * u * u) * 0.3989422804014327f;
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

// A TMA map of a row-major (rows, cols) bf16 matrix in boxes of
// (box_rows, box_cols).  cuTensorMapEncodeTiled is a driver function: it is
// found through the runtime, so the library needs no -lcuda.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                       int box_cols, CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
// Backward

constexpr int kBRows = 32;                        // rows of a backward tile
constexpr int kBMT = kBRows / 16;                 // its m16 tiles
constexpr int kKX = 16;                           // F rows of a W1^T tile (pass 2)
constexpr int kRing = 3;                          // weight buffers of a backward block
constexpr int kLdW1 = kKU + kPad;                 // pass 1 W1 tile: 256 F rows x 64 D
constexpr int kLdW2 = kKO + kPad;                 // pass 1 W2 tile: D rows x 16 F
constexpr int kLdW2T = kChunk + kPad;             // pass 2 W2^T tile: 64 D rows x 256 F

struct BwdParams {
  const bf16* x;
  const bf16* w1t;                     // (F, D)
  const float* b1;
  const bf16* w2t;                     // (D, F)
  const float* b2;
  const float* gamma;
  const bf16* dy;
  bf16* dx;
  bf16* du;                            // (M, F)
  bf16* dout;                          // do, (M, D)
  bf16* h;                             // (M, F)
  float* gd;                           // gelu'(u), (M, F) scratch
  float* part;                         // (tiles, 2 D): sum dy * xhat | sum dy
  int m, d, f;
  float eps;
  Drop drop;
};

// Shared memory of a backward block: x tile | do tile | h (pass 1) or du
// (pass 2) chunk | row statistics | kRing weight buffers.  The f32 (rows, D)
// LayerNorm tile of the epilogue between the passes reuses the buffers.
struct BwdLayout {
  size_t xs, dos, hs, stats, buf0, buf, total;
  __host__ __device__ explicit BwdLayout(int d) {
    const size_t x_bytes = sizeof(bf16) * kBRows * (d + kPad);
    size_t largest = sizeof(bf16) * kChunk * kLdW1;                 // W1, pass 1
    const size_t w2 = sizeof(bf16) * d * kLdW2;                     // W2, pass 1
    const size_t w2t = sizeof(bf16) * kKU * kLdW2T;                 // W2^T, pass 2
    const size_t w1t = sizeof(bf16) * kKX * (d + kPad);             // W1^T, pass 2
    largest = largest > w2 ? largest : w2;
    largest = largest > w2t ? largest : w2t;
    largest = largest > w1t ? largest : w1t;
    buf = align_up(largest, 128);
    xs = 0;
    dos = align_up(xs + x_bytes, 128);
    hs = align_up(dos + x_bytes, 128);
    stats = align_up(hs + sizeof(bf16) * kBRows * kLdH, 128);
    buf0 = align_up(stats + sizeof(float) * 3 * kBRows, 128);
    total = buf0 + kRing * buf;
  }
};

// rows x cols bf16 block at (r0, c0) of a row-major matrix with row stride
// ld_g into shared memory with row stride lds, by cp.async (cols % 8 == 0).
__device__ __forceinline__ void load_block(bf16* dst, int lds, const bf16* src, int ld_g, int r0,
                                           int c0, int rows, int cols) {
  const int vec = cols / 8;
  for (int i = threadIdx.x; i < rows * vec; i += kThreads) {
    const int r = i / vec;
    const int c = (i % vec) * 8;
    cp_async16(dst + r * lds + c, src + static_cast<size_t>(r0 + r) * ld_g + c0 + c);
  }
}

// Run use(t, tile) over the n tiles that load(t, buffer) brings in, through
// a ring of kRing buffers of `stride` bytes: tiles t+1 and t+2 are in flight
// while tile t is used.  Every thread calls it; it ends with every tile used
// and the buffers free.  Each iteration commits one cp.async group (empty
// past the end), so "all but the newest group" is always tile t and before.
template <typename Load, typename Use>
__device__ __forceinline__ void stream_tiles(int n, unsigned char* ring, size_t stride, Load load,
                                             Use use) {
  for (int t = 0; t < kRing - 1; ++t) {
    if (t < n) load(t, ring + t * stride);
    cp_commit();
  }
  for (int t = 0; t < n; ++t) {
    cp_wait<kRing - 2>();
    __syncthreads();   // tile t is in for every thread, and every thread is done with tile t-1
    const int next = t + kRing - 1;   // ... whose buffer takes tile t+kRing-1
    if (next < n) load(next, ring + (next % kRing) * stride);
    cp_commit();
    use(t, reinterpret_cast<const bf16*>(ring + (t % kRing) * stride));
  }
  cp_wait<0>();
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) ffn_train_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_b[];
  const int d = p.d, f = p.f, m = p.m;
  const BwdLayout lay(d);
  bf16* xs = reinterpret_cast<bf16*>(smem_b + lay.xs);
  bf16* dos = reinterpret_cast<bf16*>(smem_b + lay.dos);
  bf16* hs = reinterpret_cast<bf16*>(smem_b + lay.hs);
  float* rstd_s = reinterpret_cast<float*>(smem_b + lay.stats);
  float* m1_s = rstd_s + kBRows;
  float* m2_s = m1_s + kBRows;
  unsigned char* ring = smem_b + lay.buf0;
  float* os = reinterpret_cast<float*>(ring);
  const int ldx = d + kPad;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int q = (lane % 4) * 2;
  const int row0 = blockIdx.x * kBRows;
  const int valid = min(kBRows, m - row0);
  const int ucol = warp * 16;             // this warp's 16 columns of each F chunk
  const int wcol = warp * kWarpCols;      // this warp's 48 columns of D
  const int nk = d / kKU;                 // 64-deep D steps
  const int chunks = f / kChunk;

  // x tile (rows past m zero); do rows past m stay zero
  const int vec_per_row = d / 8;
  for (int i = threadIdx.x; i < kBRows * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row;
    const int c = (i % vec_per_row) * 8;
    if (r < valid) {
      cp_async16(xs + r * ldx + c, p.x + static_cast<size_t>(row0 + r) * d + c);
    } else {
      *reinterpret_cast<uint4*>(xs + r * ldx + c) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dos + r * ldx + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_commit();

  float acc[kBMT][kWarpCols / 8][4];      // o (pass 1), then dx (pass 2)
  float wacc[kBMT][2][4];                 // u (pass 1), then dh (pass 2), chunk columns ucol..
#pragma unroll
  for (int i = 0; i < kBMT; ++i) {
#pragma unroll
    for (int n = 0; n < kWarpCols / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
    }
  }

  // ---- pass 1: u, h = gelu(u) (written out, gelu'(u) spilled), o += h . W2
  const int t1 = nk + kChunk / kKO;
  stream_tiles(
      chunks * t1, ring, lay.buf,
      [&](int t, unsigned char* buf) {
        const int f0 = (t / t1) * kChunk, j = t % t1;
        bf16* dst = reinterpret_cast<bf16*>(buf);
        if (j < nk) {
          load_block(dst, kLdW1, p.w1t, d, f0, j * kKU, kChunk, kKU);
        } else {
          load_block(dst, kLdW2, p.w2t, f, 0, f0 + (j - nk) * kKO, d, kKO);
        }
      },
      [&](int t, const bf16* tile) {
        const int f0 = (t / t1) * kChunk, j = t % t1;
        if (j < nk) {
          if (j == 0) {
#pragma unroll
            for (int i = 0; i < kBMT; ++i) {
#pragma unroll
              for (int n = 0; n < 2; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) wacc[i][n][e] = 0.0f;
              }
            }
          }
#pragma unroll
          for (int kk = 0; kk < kKU; kk += 16) {
            uint32_t b[4];
            load_b_nk(b, tile, kLdW1, ucol, kk, lane);
#pragma unroll
            for (int i = 0; i < kBMT; ++i) {
              uint32_t a[4];
              load_a(a, xs + i * 16 * ldx + j * kKU + kk, ldx, lane);
              mma16816(wacc[i][0], a, b[0], b[1]);
              mma16816(wacc[i][1], a, b[2], b[3]);
            }
          }
          if (j == nk - 1) {   // u is complete: h to shared memory and out, gelu'(u) out
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int c = ucol + n * 8 + q;
              const float bias0 = p.b1[f0 + c], bias1 = p.b1[f0 + c + 1];
#pragma unroll
              for (int i = 0; i < kBMT; ++i) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  const int r = i * 16 + g + half * 8;
                  const float u0 = wacc[i][n][2 * half] + bias0;
                  const float u1 = wacc[i][n][2 * half + 1] + bias1;
                  const uint32_t hv = pack_bf16(gelu_erf(u0), gelu_erf(u1));
                  *reinterpret_cast<uint32_t*>(hs + r * kLdH + c) = hv;
                  if (r < valid) {
                    const size_t off = static_cast<size_t>(row0 + r) * f + f0 + c;
                    *reinterpret_cast<uint32_t*>(p.h + off) = hv;
                    *reinterpret_cast<float2*>(p.gd + off) =
                        make_float2(gelu_grad(u0), gelu_grad(u1));
                  }
                }
              }
            }
          }
        } else {
          // acc[:, wcol..] += h[:, k..k+16] . W2[f0+k.., wcol..]
          const int k = (j - nk) * kKO;
          uint32_t a[kBMT][4];
#pragma unroll
          for (int i = 0; i < kBMT; ++i) load_a(a[i], hs + i * 16 * kLdH + k, kLdH, lane);
#pragma unroll
          for (int pp = 0; pp < kWarpCols / 16; ++pp) {
            const int n0 = wcol + pp * 16;
            if (n0 < d) {
              uint32_t b[4];
              load_b_nk(b, tile, kLdW2, n0, 0, lane);
#pragma unroll
              for (int i = 0; i < kBMT; ++i) {
                mma16816(acc[i][2 * pp], a[i], b[0], b[1]);
                mma16816(acc[i][2 * pp + 1], a[i], b[2], b[3]);
              }
            }
          }
        }
      });

  // ---- between the passes: LayerNorm backward on the (rows, D) tile in os
  // (the ring, free once stream_tiles returned)
#pragma unroll
  for (int n = 0; n < kWarpCols / 8; ++n) {
    const int c = wcol + n * 8 + q;
    if (c < d) {
#pragma unroll
      for (int i = 0; i < kBMT; ++i) {
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

  const float inv_d = 1.0f / static_cast<float>(d);
  const uint2 key = drop_key(p.drop);
  // phase A, one warp per row: r = dropout(o + b2) + x, its statistics,
  // xhat (into os), mean(a) and mean(a * xhat) with a = dy * gamma
  for (int r = warp; r < valid; r += kWarps) {
    const int row = row0 + r;
    float* orow = os + r * d;
    const bf16* xrow = xs + r * ldx;
    const bf16* dyrow = p.dy + static_cast<size_t>(row) * d;
    float sum = 0.0f;
    for (int c = lane * 4; c < d; c += 128) {
      const float4 o4 = *reinterpret_cast<const float4*>(orow + c);
      float v[4] = {o4.x + p.b2[c], o4.y + p.b2[c + 1], o4.z + p.b2[c + 2], o4.w + p.b2[c + 3]};
      const uint32_t keep = p.drop.on ? keep4(key, p.drop.threshold, row, c) : 0xFu;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (p.drop.on) v[jj] = (keep >> jj) & 1u ? v[jj] * p.drop.inv_keep : 0.0f;
        v[jj] += __bfloat162float(xrow[c + jj]);
        sum += v[jj];
      }
      *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
    }
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.0f;
    for (int c = lane * 4; c < d; c += 128) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float dev = orow[c + jj] - mean;
        sq += dev * dev;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + p.eps);
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane * 4; c < d; c += 128) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float xhat = (orow[c + jj] - mean) * rstd;
        const float a = __bfloat162float(dyrow[c + jj]) * p.gamma[c + jj];
        orow[c + jj] = xhat;
        s1 += a;
        s2 += a * xhat;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      rstd_s[r] = rstd;
      m1_s[r] = s1 * inv_d;
      m2_s[r] = s2 * inv_d;
    }
  }
  __syncthreads();
  // this tile's partial dgamma = sum dy * xhat and dbeta = sum dy, column by
  // column over its valid rows
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sg = 0.0f, sb = 0.0f;
    for (int r = 0; r < valid; ++r) {
      const float dyv = __bfloat162float(p.dy[static_cast<size_t>(row0 + r) * d + c]);
      sg += dyv * os[r * d + c];
      sb += dyv;
    }
    p.part[static_cast<size_t>(blockIdx.x) * 2 * d + c] = sg;
    p.part[static_cast<size_t>(blockIdx.x) * 2 * d + d + c] = sb;
  }
  __syncthreads();
  // phase B, one warp per row: dr (into os), do = dropout(dr) in bf16 to
  // shared memory and out
  for (int r = warp; r < valid; r += kWarps) {
    const int row = row0 + r;
    float* orow = os + r * d;
    const bf16* dyrow = p.dy + static_cast<size_t>(row) * d;
    bf16* dorow = p.dout + static_cast<size_t>(row) * d;
    const float rstd = rstd_s[r], m1 = m1_s[r], m2 = m2_s[r];
    for (int c = lane * 4; c < d; c += 128) {
      const uint32_t keep = p.drop.on ? keep4(key, p.drop.threshold, row, c) : 0xFu;
      float dr[4], dv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float a = __bfloat162float(dyrow[c + jj]) * p.gamma[c + jj];
        dr[jj] = (a - m1 - orow[c + jj] * m2) * rstd;
        dv[jj] = p.drop.on ? ((keep >> jj) & 1u ? dr[jj] * p.drop.inv_keep : 0.0f) : dr[jj];
      }
      *reinterpret_cast<float4*>(orow + c) = make_float4(dr[0], dr[1], dr[2], dr[3]);
      const uint2 packed = make_uint2(pack_bf16(dv[0], dv[1]), pack_bf16(dv[2], dv[3]));
      *reinterpret_cast<uint2*>(dos + r * ldx + c) = packed;
      *reinterpret_cast<uint2*>(dorow + c) = packed;
    }
  }
  __syncthreads();
  // dx starts at dr
#pragma unroll
  for (int n = 0; n < kWarpCols / 8; ++n) {
    const int c = wcol + n * 8 + q;
    if (c < d) {
#pragma unroll
      for (int i = 0; i < kBMT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = i * 16 + g + half * 8;
          const float2 v = *reinterpret_cast<const float2*>(os + r * d + c);
          acc[i][n][2 * half] = v.x;
          acc[i][n][2 * half + 1] = v.y;
        }
      }
    }
  }
  __syncthreads();   // os (the ring) is free for pass 2

  // ---- pass 2: dh = do . W2^T[:, chunk], du = dh * gelu'(u) (out, and to
  // shared memory), dx += du . W1^T[chunk, :]
  const int t2 = nk + kChunk / kKX;
  stream_tiles(
      chunks * t2, ring, lay.buf,
      [&](int t, unsigned char* buf) {
        const int f0 = (t / t2) * kChunk, j = t % t2;
        bf16* dst = reinterpret_cast<bf16*>(buf);
        if (j < nk) {
          load_block(dst, kLdW2T, p.w2t, f, j * kKU, f0, kKU, kChunk);
        } else {
          load_block(dst, d + kPad, p.w1t, d, f0 + (j - nk) * kKX, 0, kKX, d);
        }
      },
      [&](int t, const bf16* tile) {
        const int f0 = (t / t2) * kChunk, j = t % t2;
        if (j < nk) {
          if (j == 0) {
#pragma unroll
            for (int i = 0; i < kBMT; ++i) {
#pragma unroll
              for (int n = 0; n < 2; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) wacc[i][n][e] = 0.0f;
              }
            }
          }
          // dh[:, ucol..] += do[:, 64 j + k..] . W2^T[64 j + k.., f0 + ucol..]
#pragma unroll
          for (int kk = 0; kk < kKU; kk += 16) {
            uint32_t b[4];
            load_b_kn(b, tile, kLdW2T, kk, ucol, lane);
#pragma unroll
            for (int i = 0; i < kBMT; ++i) {
              uint32_t a[4];
              load_a(a, dos + i * 16 * ldx + j * kKU + kk, ldx, lane);
              mma16816(wacc[i][0], a, b[0], b[1]);
              mma16816(wacc[i][1], a, b[2], b[3]);
            }
          }
          if (j == nk - 1) {   // dh is complete: du = dh * gelu'(u) in bf16
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int c = ucol + n * 8 + q;
#pragma unroll
              for (int i = 0; i < kBMT; ++i) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  const int r = i * 16 + g + half * 8;
                  uint32_t dv = 0u;
                  if (r < valid) {
                    const size_t off = static_cast<size_t>(row0 + r) * f + f0 + c;
                    const float2 gd = *reinterpret_cast<const float2*>(p.gd + off);
                    dv = pack_bf16(wacc[i][n][2 * half] * gd.x, wacc[i][n][2 * half + 1] * gd.y);
                    *reinterpret_cast<uint32_t*>(p.du + off) = dv;
                  }
                  *reinterpret_cast<uint32_t*>(hs + r * kLdH + c) = dv;
                }
              }
            }
          }
        } else {
          // dx[:, wcol..] += du[:, k..k+32] . W1^T[f0+k.., wcol..]
          const int k = (j - nk) * kKX;
#pragma unroll
          for (int kk = 0; kk < kKX; kk += 16) {
            uint32_t a[kBMT][4];
#pragma unroll
            for (int i = 0; i < kBMT; ++i) load_a(a[i], hs + i * 16 * kLdH + k + kk, kLdH, lane);
#pragma unroll
            for (int pp = 0; pp < kWarpCols / 16; ++pp) {
              const int n0 = wcol + pp * 16;
              if (n0 < d) {
                uint32_t b[4];
                load_b_kn(b, tile, d + kPad, kk, n0, lane);
#pragma unroll
                for (int i = 0; i < kBMT; ++i) {
                  mma16816(acc[i][2 * pp], a[i], b[0], b[1]);
                  mma16816(acc[i][2 * pp + 1], a[i], b[2], b[3]);
                }
              }
            }
          }
        }
      });

  // dx out (bf16), valid rows only
#pragma unroll
  for (int n = 0; n < kWarpCols / 8; ++n) {
    const int c = wcol + n * 8 + q;
    if (c < d) {
#pragma unroll
      for (int i = 0; i < kBMT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = i * 16 + g + half * 8;
          if (r < valid) {
            *reinterpret_cast<uint32_t*>(p.dx + static_cast<size_t>(row0 + r) * d + c) =
                pack_bf16(acc[i][n][2 * half], acc[i][n][2 * half + 1]);
          }
        }
      }
    }
  }
}

// out[c] = sum over tiles t, in order, of part[t][c] (c < cols).
__global__ void sum_partials_kernel(const float* __restrict__ part, int tiles, int cols,
                                    float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += part[static_cast<size_t>(t) * cols + c];
  out[c] = s;
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

// Rows of a backward tile: the wrapper sizes the (tiles, 2 D) f32 scratch
// of the dgamma / dbeta partials with it.
int shgvqa_ffn_train_bwd_rows() { return kBRows; }

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

// Backward on `stream` (two kernels); returns cudaGetLastError().  Inputs
// as the forward (beta is not read) plus dy (m, d) bf16; outputs dx, do
// (m, d) and du, h (m, f) bf16, dgb (2 d) f32 = [dgamma | dbeta]; scratch
// gd (m, f) f32 and part (ceil(m / 32), 2 d) f32.  d is a multiple of 64
// (<= 768), f a multiple of 256; every pointer 16-byte aligned.
int shgvqa_ffn_train_bwd_bf16(const void* x, const void* w1t, const void* b1, const void* w2t,
                              const void* b2, const void* gamma, const void* seed,
                              const void* dy, void* dx, void* du, void* dout, void* h, void* gd,
                              void* part, void* dgb, int m, int d, int f, float eps,
                              unsigned threshold, float inv_keep, int dropout, void* stream) {
  if (m < 0 || d <= 0 || f <= 0 || d % kKU != 0 || f % kChunk != 0 || d > kMaxD ||
      (dropout && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = ceil_div(m, kBRows);
  if (m > 0) {
    BwdParams p;
    p.x = static_cast<const bf16*>(x);
    p.w1t = static_cast<const bf16*>(w1t);
    p.b1 = static_cast<const float*>(b1);
    p.w2t = static_cast<const bf16*>(w2t);
    p.b2 = static_cast<const float*>(b2);
    p.gamma = static_cast<const float*>(gamma);
    p.dy = static_cast<const bf16*>(dy);
    p.dx = static_cast<bf16*>(dx);
    p.du = static_cast<bf16*>(du);
    p.dout = static_cast<bf16*>(dout);
    p.h = static_cast<bf16*>(h);
    p.gd = static_cast<float*>(gd);
    p.part = static_cast<float*>(part);
    p.m = m;
    p.d = d;
    p.f = f;
    p.eps = eps;
    p.drop = make_drop(seed, threshold, inv_keep, dropout);
    const size_t smem = BwdLayout(d).total;
    cudaError_t err = cudaFuncSetAttribute(
        ffn_train_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ffn_train_bwd_kernel<<<tiles, kThreads, smem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sum_partials_kernel<<<ceil_div(2 * d, 256), 256, 0, s>>>(static_cast<const float*>(part), tiles,
                                                          2 * d, static_cast<float*>(dgb));
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
