// Fused attention-output block for Hopper (sm_90a):
//
//   y = LN(x . W^T + b + residual) * gamma + beta
//
// Replaces shgvqa_tpu/kernels/ffn.py::_make_out_ln (the Pallas TPU kernel
// behind fused_out_ln); its oracle is _out_ln_reference there and
// out_ln_reference in shgvqa_tpu_torch/kernels/ffn.py.
//
// Numerics (as the TPU kernel): x, W and the residual bf16; b, gamma, beta
// f32; the product accumulates in f32 and is not rounded before the f32
// bias and the residual are added; LayerNorm is two-pass in f32 (var =
// mean((r - mean)^2)); y is stored in bf16.
//
// What bounds it on the card: 2*M*D*D operations against (3*M*D + D*D)*2
// bytes, ~D/3 = 256 operations a byte at D = 768, under the H100's ~295, so
// device memory bounds it at every row count of the model (M = B*L for L in
// 40, 177, 393).  The fusion keeps the (M, D) product out of device memory:
// the unfused block writes it and reads it back twice (bias + residual, then
// the LayerNorm).  The TPU kernel kept W (1.18 MB at D = 768) resident in
// VMEM under 512-row tiles; here W does not fit in a block's 227 KB, so it
// streams through shared memory from L2 for every row tile.
//
// Design (one product over K = D, the residual read from its own tensor):
// - one block of 16 warps per tile of 32 or 48 rows (kMTiles 16-row tiles;
//   the launcher takes 48 when that needs fewer waves of blocks); the x tile
//   is copied once with cp.async, the ragged last tile zero-filled on load
//   and masked on store.  The LayerNorm needs all D columns of a row, so a
//   block owns whole rows;
// - W (nn.Linear's (out, in) layout, i.e. the [n][k] layout the B operand
//   wants) streams through a ring of kStages stages, kStages - 1 ahead of
//   the stage in use.  A stage is kSub sub-tiles of D rows x 16 K columns
//   (32-byte rows, 32-byte swizzle), each as TMA boxes of up to 256 rows
//   that one thread issues and that complete on the stage's mbarrier;
// - the product is ldmatrix + mma.sync m16n8k16 (bf16 in, f32 sums); each
//   warp owns 48 output columns for all rows of the tile, in registers;
// - the epilogue stages the accumulator in shared memory (reusing the ring)
//   and one warp per row adds the bias and the residual and normalizes.
// At B=2 the model's row counts (80, 354, 786) give 3-17 blocks for 132
// SMs: the grid is far too small there; it is left so (a split of the
// columns would need a cross-block LayerNorm).

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
constexpr int kK = 16;                            // K depth of a sub-tile: 32-byte rows
constexpr int kSub = 2;                           // sub-tiles per stage
constexpr int kBoxRows = 256;                     // most rows one TMA box takes
constexpr int kPad = 8;                           // bf16 pad of x rows: 16 bytes
constexpr size_t kSubBytes = static_cast<size_t>(kMaxD) * kK * sizeof(bf16);   // 24 KB
constexpr size_t kStageBytes = kSub * kSubBytes;
constexpr int kStages = 3;

__host__ __device__ inline size_t align_up(size_t n, size_t a) { return (n + a - 1) / a * a; }

// Shared memory: x tile | W ring (1 KB aligned) | mbarriers.  The f32 output
// tile reuses the ring in the epilogue.
template <int kMTiles>
struct Layout {
  size_t xs, ws, os, bars, total;
  __host__ __device__ explicit Layout(int d) {
    constexpr int rows = 16 * kMTiles;
    xs = 0;
    ws = align_up(sizeof(bf16) * rows * (d + kPad), 1024);
    os = ws;
    const size_t ring_end = ws + kStages * kStageBytes;
    const size_t os_end = os + sizeof(float) * rows * d;
    bars = align_up(ring_end > os_end ? ring_end : os_end, 8);
    total = bars + sizeof(uint64_t) * kStages;
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

// B operands of two n8 tiles from a TMA-swizzled [n][k] sub-tile of 32-byte
// rows: rows n0..n0+15; r[0..1] is n 0-7, r[2..3] is n 8-15.  The 32-byte
// swizzle puts 16-byte chunk c of row r at c ^ ((r / 4) % 2).
__device__ __forceinline__ void load_b2_sw32(uint32_t (&r)[4], uint32_t tile, int n0, int lane) {
  const int row = n0 + (lane % 8) + (lane / 16) * 8;
  const int chunk = (lane / 8) % 2;
  ldsm_x4(r, tile + row * 32 + ((chunk ^ ((row / 4) % 2)) << 4));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One thread issues stage `s` of W (K columns kSub*16*s ..) into dst, to
// complete on bar: per sub-tile, boxes of w_rows rows x 16 columns stacked
// over the D rows.  Sub-tiles past K are not issued.
__device__ __forceinline__ void issue_stage(int s, uint32_t dst, uint32_t bar,
                                            const CUtensorMap* wmap, int d, int w_rows) {
  const int k0 = s * kSub * kK;
  if (k0 >= d) return;
  const int subs = min(kSub, (d - k0) / kK);
  const int boxes = (d + w_rows - 1) / w_rows;
  const int box_bytes = w_rows * kK * sizeof(bf16);
  mbar_expect_tx(bar, subs * boxes * box_bytes);
  for (int j = 0; j < subs; ++j) {
    for (int b = 0; b < boxes; ++b) {
      tma_2d(dst + j * kSubBytes + b * box_bytes, wmap, k0 + j * kK, b * w_rows, bar);
    }
  }
}

template <int kMTiles>
__global__ void __launch_bounds__(kThreads, 1)
fused_out_ln_bf16_kernel(const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ x,
                         const float* __restrict__ bias, const bf16* __restrict__ res,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         bf16* __restrict__ y, int m, int d, int w_rows, float eps) {
  constexpr int kRows = 16 * kMTiles;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Layout<kMTiles> lay(d);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.xs);
  float* os = reinterpret_cast<float*>(smem + lay.os);
  const uint32_t ws = smem_addr(smem + lay.ws);
  const uint32_t bars = smem_addr(smem + lay.bars);
  const int ldx = d + kPad;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                 // accumulator rows g and g + 8
  const int q = (lane % 4) * 2;           // accumulator columns q and q + 1
  const int row0 = blockIdx.x * kRows;
  const int steps = (d + kSub * kK - 1) / (kSub * kK);

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
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages - 1; ++s) {
      issue_stage(s, ws + s * kStageBytes, bars + 8 * s, &wmap, d, w_rows);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();   // the x tile is in

  float acc[kMTiles][kWarpCols / 8][4];   // rows 16 i.., columns 48 warp + 8 n..
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int n = 0; n < kWarpCols / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
    }
  }

  for (int t = 0; t < steps; ++t) {
    const int stage = t % kStages;
    mbar_wait(bars + 8 * stage, (t / kStages) % 2);   // stage t landed
    __syncthreads();                                  // everyone is done with stage t-1
    if (threadIdx.x == 0) {                           // ... so its slot takes stage t+S-1
      const int s = (t + kStages - 1) % kStages;
      issue_stage(t + kStages - 1, ws + s * kStageBytes, bars + 8 * s, &wmap, d, w_rows);
    }
    const int k0 = t * kSub * kK;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      if (k0 + j * kK < d) {
        const uint32_t tile = ws + stage * kStageBytes + j * kSubBytes;
        uint32_t a[kMTiles][4];
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) load_a(a[i], xs + i * 16 * ldx + k0 + j * kK, ldx, lane);
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
    }
  }
  __syncthreads();   // the ring is dead (every stage issued was waited for)

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

  // epilogue: bias + residual + two-pass LayerNorm, one warp per row, two
  // columns a lane at a time
  const float inv_d = 1.0f / static_cast<float>(d);
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = row0 + r;
    if (row >= m) break;               // warp-uniform; later rows are past m too
    float* orow = os + r * d;
    const bf16* rrow = res + static_cast<size_t>(row) * d;
    float sum = 0.0f;
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 bc = *reinterpret_cast<const float2*>(bias + c);
      const float2 rc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rrow + c));
      const float v0 = orow[c] + bc.x + rc.x, v1 = orow[c + 1] + bc.y + rc.y;
      orow[c] = v0;
      orow[c + 1] = v1;
      sum += v0 + v1;
    }
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.0f;
    for (int c = 2 * lane; c < d; c += 64) {
      const float d0 = orow[c] - mean, d1 = orow[c + 1] - mean;
      sq += d0 * d0 + d1 * d1;
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
    bf16* yrow = y + static_cast<size_t>(row) * d;
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 gc = *reinterpret_cast<const float2*>(gamma + c);
      const float2 be = *reinterpret_cast<const float2*>(beta + c);
      *reinterpret_cast<__nv_bfloat162*>(yrow + c) =
          __floats2bfloat162_rn((orow[c] - mean) * rstd * gc.x + be.x,
                                (orow[c + 1] - mean) * rstd * gc.y + be.y);
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
cudaError_t launch(const void* x, const void* w, const void* bias, const void* res,
                   const void* gamma, const void* beta, void* y, int m, int d, float eps,
                   cudaStream_t stream) {
  CUtensorMap wmap;
  const int w_rows = min(kBoxRows, d);
  cudaError_t err = tensor_map(&wmap, w, d, d, w_rows, kK, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err != cudaSuccess) return err;
  const size_t smem = Layout<kMTiles>(d).total + 1024;   // slack to align the base to 1 KB
  err = cudaFuncSetAttribute(fused_out_ln_bf16_kernel<kMTiles>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((m + 16 * kMTiles - 1) / (16 * kMTiles));
  fused_out_ln_bf16_kernel<kMTiles><<<grid, kThreads, smem, stream>>>(
      wmap, static_cast<const bf16*>(x), static_cast<const float*>(bias),
      static_cast<const bf16*>(res), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(y), m, d, w_rows, eps);
  return cudaGetLastError();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Largest width the kernel takes (D <= warps * columns per warp).
int shgvqa_out_ln_max_d() { return kMaxD; }

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
// Device pointers: x, res, y (m, d) bf16; w (d, d) bf16 in nn.Linear's
// (out, in) layout; bias, gamma, beta (d) f32; all contiguous and 16-byte
// aligned.  d is a multiple of 16 and d <= kMaxD.  The row tile is 48 rows
// when that takes fewer waves of blocks over the SMs than 32 rows, else 32.
int shgvqa_out_ln_bf16(const void* x, const void* w, const void* bias, const void* res,
                       const void* gamma, const void* beta, void* y, int m, int d, float eps,
                       void* stream) {
  if (m < 0 || d <= 0 || d % 16 != 0 || d > kMaxD) {
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
    err = launch<3>(x, w, bias, res, gamma, beta, y, m, d, eps, s);
  } else {
    err = launch<2>(x, w, bias, res, gamma, beta, y, m, d, eps, s);
  }
  return static_cast<int>(err);
}

const char* shgvqa_out_ln_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
