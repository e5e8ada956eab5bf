// Fused BERT FFN block for Hopper (sm_90a):
//
//   y = LN(x + gelu_erf(x . W1 + b1) . W2 + b2) * gamma + beta
//
// Replaces shgvqa_tpu/kernels/ffn.py::_make_call (the Pallas TPU kernel behind
// fused_ffn); its oracle is _reference there and ffn_reference in
// shgvqa_tpu_torch/kernels/ffn.py.
//
// Numerics (as the TPU kernel): x, W1, W2 bf16; b1, b2, gamma, beta f32;
// both products accumulate in f32; the GeLU is the exact erf form in f32 and
// is rounded to bf16 before the second product; LayerNorm is two-pass in f32
// (var = mean((r - mean)^2)); y is stored in bf16.
//
// What bounds it on the card: 4*M*D*F operations against ~4*M*D + 4*D*F
// bytes, so at the model's shapes (D=768, F=3072, M >= 80) it is bound by
// the tensor cores, not by device memory.  The (M, F) intermediate never
// leaves the chip, which is what the fusion is for.  The LayerNorm needs
// whole rows, so one block owns a tile of rows and walks all of F; each
// block therefore streams both weights (9.4 MB, L2-resident) once.
//
// Design:
// - one block of 16 warps per tile of 32 or 48 rows (kMTiles 16-row tiles;
//   the launcher takes 48 when that needs fewer waves of blocks); the ragged
//   last tile is zero-filled on load and masked on store;
// - the weights stream through shared memory in a ring of kStages tiles,
//   kStages - 1 tiles ahead of the tile in use.  One thread issues each
//   tile as TMA tensor copies that complete on the stage's mbarrier, so the
//   warps spend no instructions on copies.  Per 256-column chunk of F: the
//   W1 tiles (256 F rows x 64 D columns, 128-byte rows, 128-byte swizzle),
//   then the W2 tiles (D rows x 16 F columns, 32-byte rows, 32-byte
//   swizzle).  nn.Linear stores W1^T as (F, D) and W2^T as (D, F), both
//   the [n][k] layout the B operand wants, so no transpose copy exists;
// - the products are ldmatrix + mma.sync m16n8k16 (bf16 in, f32 sums):
//   u = x . W1 with each warp on 16 columns of the chunk, then bias + GeLU
//   on the accumulators and h staged in shared memory as bf16; the output
//   accumulator (rows x D, f32) stays in registers, 48 columns per warp;
// - the epilogue stages the accumulator in shared memory (reusing the ring)
//   and one warp per row does bias, residual and LayerNorm.
// Where the rest of a block's time goes is measured by ffn_floor.py
// (PERF.md); wgmma, which reads both operands from shared memory, is the
// next step.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Which products run: bit 0 the first, bit 1 the second.  Always 3 in the
// port; ffn_floor.py builds 0-2 to time the block without them.
#ifndef SHGVQA_FFN_PRODUCTS
#define SHGVQA_FFN_PRODUCTS 3
#endif

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
constexpr int kPad = 8;                           // bf16 pad of x and h rows: 16 bytes
constexpr int kLdH = kChunk + kPad;
constexpr size_t kStageBytes = 32768;             // >= 256 x 128 B (W1) and 768 x 32 B (W2)

template <int kMTiles>
struct Tile {
  static constexpr int kRows = 16 * kMTiles;
  static constexpr int kStages = kMTiles == 2 ? 4 : 3;   // what fits in 227 KB
};

__host__ __device__ inline size_t align_up(size_t n, size_t a) { return (n + a - 1) / a * a; }

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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
fused_ffn_bf16_kernel(const __grid_constant__ CUtensorMap w1map,
                      const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ x,
                      const float* __restrict__ b1, const float* __restrict__ b2,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      bf16* __restrict__ y, int m, int d, int f, int w1_rows, int w2_rows,
                      float eps) {
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
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  __syncthreads();   // the mbarriers are initialized
  Cursor load{0, 0, true};
  for (int s = 0; s < kStages - 1; ++s) {
    if (threadIdx.x == 0) {
      issue_tile(load, ws + s * kStageBytes, bars + 8 * s, &w1map, &w2map, d, f, w1_rows,
                 w2_rows);
    }
    load.next(d, f);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
      if ((SHGVQA_FFN_PRODUCTS & 1) && ucol < fc) {
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
    } else if (SHGVQA_FFN_PRODUCTS & 2) {
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

  // epilogue: bias + residual + two-pass LayerNorm, one warp per row
  const float inv_d = 1.0f / static_cast<float>(d);
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = row0 + r;
    if (row >= m) break;               // warp-uniform; later rows are past m too
    float* orow = os + r * d;
    const bf16* xrow = xs + r * ldx;
    float sum = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float v = orow[c] + b2[c] + __bfloat162float(xrow[c]);
      orow[c] = v;
      sum += v;
    }
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float dev = orow[c] - mean;
      sq += dev * dev;
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
    bf16* yrow = y + static_cast<size_t>(row) * d;
    for (int c = lane; c < d; c += 32) {
      yrow[c] = __float2bfloat16((orow[c] - mean) * rstd * gamma[c] + beta[c]);
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
cudaError_t launch(const void* x, const void* w1t, const void* b1, const void* w2t,
                   const void* b2, const void* gamma, const void* beta, void* y, int m, int d,
                   int f, float eps, cudaStream_t stream) {
  CUtensorMap w1map, w2map;
  const int w1_rows = min(kBoxRows, f), w2_rows = min(kBoxRows, d);
  cudaError_t err = tensor_map(&w1map, w1t, f, d, w1_rows, kKU, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = tensor_map(&w2map, w2t, d, f, w2_rows, kKO, CU_TENSOR_MAP_SWIZZLE_32B);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = Layout<kMTiles>(d).total + 1024;   // slack to align the base to 1 KB
  err = cudaFuncSetAttribute(fused_ffn_bf16_kernel<kMTiles>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + Tile<kMTiles>::kRows - 1) / Tile<kMTiles>::kRows);
  fused_ffn_bf16_kernel<kMTiles><<<grid, kThreads, smem, stream>>>(
      w1map, w2map, static_cast<const bf16*>(x), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(y), m, d, f, w1_rows, w2_rows, eps);
  return cudaGetLastError();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Largest hidden width the kernel takes (D <= warps * columns per warp).
int shgvqa_fused_ffn_max_d() { return kMaxD; }

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
// Pointers are device pointers: x, y (m, d) bf16; w1t (f, d) bf16;
// w2t (d, f) bf16; b1 (f) f32; b2, gamma, beta (d) f32; all contiguous and
// 16-byte aligned.  d and f are multiples of 16 and d <= kMaxD.  The row
// tile is 48 rows when that takes fewer waves of blocks over the SMs than
// 32 rows (a 48-row block costs ~1.2x a 32-row one), else 32.
int shgvqa_fused_ffn_bf16(const void* x, const void* w1t, const void* b1,
                          const void* w2t, const void* b2, const void* gamma,
                          const void* beta, void* y, int m, int d, int f,
                          float eps, void* stream) {
  if (m < 0 || d <= 0 || f <= 0 || d % 16 != 0 || f % 16 != 0 || d > kMaxD) {
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
  if (ceil_div(ceil_div(m, 48), sms) < ceil_div(ceil_div(m, 32), sms)) {
    err = launch<3>(x, w1t, b1, w2t, b2, gamma, beta, y, m, d, f, eps, s);
  } else {
    err = launch<2>(x, w1t, b1, w2t, b2, gamma, beta, y, m, d, f, eps, s);
  }
  return static_cast<int>(err);
}

const char* shgvqa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
