// Visual tokenizer convolution for Hopper (sm_90a): Conv3d(kT, 3, 3) + bias
// + exact GeLU on channels-last video features,
//
//   y[b, t, h, w, :] = gelu_erf(bias + sum over (dt, dy, dx, ci) of
//                      x[b, t + dt, h + dy - 1, w + dx - 1, ci] * W[:, dt, dy, dx, ci])
//
// valid in time (T' = T - kT + 1) and zero-padded by 1 in space.
//
// Replaces tools/proto_tok_kernel.py::_make_tok (the Pallas TPU prototype of
// the tokenizer's conv); its oracle is _xla_reference there and
// tok_conv_reference in shgvqa_tpu_torch/kernels/tok_conv.py.
//
// Numerics (as the TPU kernel): x and W bf16, f32 accumulation, the f32 bias
// added to the f32 sum, the exact erf GeLU in f32, y stored in bf16.
//
// What bounds it on the card: at the tokenizer's shapes it is a product of
// M = B*T'*H*W output positions by N = Co channels over K = kT*9*Ci, e.g.
// (B*588) x 768 x 92160 for conv1: ~85 operations per byte even at B=2, so
// it is bound by the tensor cores.  The TPU prototype laid out each of the
// 45 taps as a shifted copy of the input in VMEM; here nothing is copied.
//
// Design: an implicit GEMM on the warp-specialized wgmma + TMA ring of
// wgmma_gemm.cuh (ring_mainloop).
// - A work item is a 128 x 256 output tile (128 consecutive output
//   positions, 256 channels) over a range of K steps; one block of two
//   consumer warpgroups (64 rows each, wgmma m64n256k16, f32 sums in
//   registers) and a producer warp.  The producer's lane 0 keeps a ring of
//   4 stages of 48 KB in flight on full/empty mbarriers; no block-wide
//   barrier paces the K steps.
// - K runs in steps of 64 channels of one tap (dt, dy, dx) (Ci is a
//   multiple of 64).  A step's A tile is one TMA load in im2col mode over
//   the (B, T, H, W, Ci) input: the tile's first output position gives the
//   coordinates (w - 1, h - 1, t, b), the tap the offsets (dx, dy, dt), and
//   the hardware walks the 128 positions across rows, frames and clips
//   inside the bounding box of the output positions (lower corner (-1, -1,
//   0), upper (-1, -1, -(kT - 1)) in (W, H, T)), zero-filling taps in the
//   spatial padding and positions past the last clip.  So a tile takes 128
//   real positions wherever it starts, and nothing is copied.  B is the
//   weight in (Co, kT, kH, kW, Ci) order, i.e. [n][k] with K contiguous
//   (the memory of the Conv3d weight under channels_last_3d), one 2-D TMA
//   box of 256 x 64 a step.  Both land with the 128-byte swizzle that the
//   wgmma descriptors read.
// - The tail: tiles are taken row-major over (row tile, column tile).  The
//   first ones, whole waves of one tile an SM, each run all of K; the rest
//   (fewer than the SMs) each split K in `splits` ranges so that the last
//   wave fills the card (the wrapper's tile_plan).  A split writes an f32
//   partial tile; a second kernel sums a tile's partials in split order
//   (deterministic, no atomics), then adds the bias and applies the GeLU.
// - A whole tile's epilogue adds the bias, applies the GeLU and stores bf16
//   channels-last, rows past M never stored: that layout is the next conv's
//   input and the tokens' layout.

#include "wgmma_gemm.cuh"

namespace {

constexpr int kBN = 256;                          // output channels of a tile
constexpr int kStages = 4;                        // 4 x 48 KB: one block an SM
constexpr int kMaxSplits = 16;
// the im2col box: pixels (output positions) and channels of an A tile
constexpr int kPixels = kGemmBM;
constexpr int kChannels = kGemmBK;

int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// TMA in im2col mode: the kPixels x kChannels A tile of `map` whose first
// output position has input coordinates (w, h, t, b) (its bounding-box
// corner), channels c.., each pixel shifted by the tap's offsets (dx, dy,
// dt), into shared memory at dst.
__device__ __forceinline__ void tma_im2col_5d(uint32_t dst, const CUtensorMap* map, int c, int w,
                                              int h, int t, int b, uint16_t dx, uint16_t dy,
                                              uint16_t dt, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2], {%8, %9, %10};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(t), "r"(b),
      "h"(dx), "h"(dy), "h"(dt)
      : "memory");
}

struct Params {
  const float* bias;
  bf16* y;                 // (M, N)
  float* part;             // (split items, 128, 256) f32
  int m, n, nk;            // rows, Co, K steps of 64
  int ci, w, h, to;        // channels, width, height, T' = T - kT + 1
  int col_tiles;           // N / 256
  int full;                // the first `full` tiles run all of K
  int splits;              // K ranges of each later tile
  int gelu;
};

// One work item (blockIdx.x): item < full is tile `item` over all of K;
// item full + j is split j % splits of tile full + j / splits.
__global__ void __launch_bounds__(kGemmThreads, 1)
tok_conv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const Params p) {
  const int item = blockIdx.x;
  int tile = item, k0 = 0, k1 = p.nk;
  if (item >= p.full) {
    const int j = item - p.full, split = j % p.splits;
    tile = p.full + j / p.splits;
    k0 = static_cast<int>(static_cast<long long>(p.nk) * split / p.splits);
    k1 = static_cast<int>(static_cast<long long>(p.nk) * (split + 1) / p.splits);
  }
  const int row0 = (tile / p.col_tiles) * kGemmBM, col0 = (tile % p.col_tiles) * kBN;
  // the tile's first output position (w, h, t, b)
  const int wo = row0 % p.w, ho = (row0 / p.w) % p.h;
  const int frame = row0 / (p.w * p.h), to = frame % p.to, b = frame / p.to;

  float acc[kBN / 2];
  const bool consumer = ring_mainloop<kBN, false, kStages>(
      k1 - k0,
      [&](uint32_t a, uint32_t bs, int t, uint32_t bar) {
        const int kc = (k0 + t) * kGemmBK;
        const int tap = kc / p.ci;
        tma_im2col_5d(a, &xmap, kc - tap * p.ci, wo - 1, ho - 1, to, b,
                      static_cast<uint16_t>(tap % 3), static_cast<uint16_t>((tap / 3) % 3),
                      static_cast<uint16_t>(tap / 9), bar);
        tma_2d(bs, &wmap, kc, col0, bar);
      },
      acc);
  if (!consumer) return;

  if (item < p.full) {
    gemm_epilogue_at<kBN>(
        acc, p.m, row0, col0,
        [&](int, int col) { return __ldg(reinterpret_cast<const float2*>(p.bias + col)); },
        [&](int row, int col, float a0, float a1, float2 bias) {
          float v0 = a0 + bias.x, v1 = a1 + bias.y;
          if (p.gelu) {
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          }
          *reinterpret_cast<uint32_t*>(p.y + static_cast<size_t>(row) * p.n + col) =
              pack_bf16(v0, v1);
        });
  } else {
    float* tile_part = p.part + static_cast<size_t>(item - p.full) * kGemmBM * kBN;
    gemm_epilogue_at<kBN>(
        acc, p.m, row0, col0, [&](int, int) { return make_float2(0.0f, 0.0f); },
        [&](int row, int col, float a0, float a1, float2) {
          *reinterpret_cast<float2*>(tile_part + (row - row0) * kBN + (col - col0)) =
              make_float2(a0, a1);
        });
  }
}

// y = gelu(bias + the split tiles' partials summed in split order), one
// thread per 4 channels of a row of a split tile (the grid covers the split
// tiles exactly).
__global__ void tok_conv_reduce_kernel(const Params p) {
  constexpr int kQuads = kBN / 4;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int tt = idx / (kGemmBM * kQuads);                 // split tile, from 0
  const int r = (idx / kQuads) % kGemmBM, c = 4 * (idx % kQuads);
  const int tile = p.full + tt;
  const int row = (tile / p.col_tiles) * kGemmBM + r, col = (tile % p.col_tiles) * kBN + c;
  if (row >= p.m) return;
  const float* src = p.part + (static_cast<size_t>(tt) * p.splits * kGemmBM + r) * kBN + c;
  float4 s = *reinterpret_cast<const float4*>(src);
  for (int i = 1; i < p.splits; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(src + static_cast<size_t>(i) * kGemmBM * kBN);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float4 bias = *reinterpret_cast<const float4*>(p.bias + col);
  float v[4] = {s.x + bias.x, s.y + bias.y, s.z + bias.z, s.w + bias.w};
  if (p.gelu) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = gelu_erf(v[e]);
  }
  *reinterpret_cast<uint2*>(p.y + static_cast<size_t>(row) * p.n + col) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// The im2col TMA map of the (B, T, H, W, Ci) input: bounding box of the
// output positions (valid in T, padded by 1 in H and W), kPixels x kChannels
// boxes, 128-byte swizzle.
cudaError_t im2col_map(CUtensorMap* map, const void* x, int b, int t, int h, int w, int ci,
                       int kt) {
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
  static PFN_cuTensorMapEncodeIm2col_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeIm2col_v12000>(fn);
  }
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(ci), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(ci) * sizeof(bf16);
  const cuuint64_t strides[4] = {row, row * w, row * w * h, row * w * h * t};
  const int lower[3] = {-1, -1, 0};                  // (W, H, T)
  const int upper[3] = {-1, -1, -(kt - 1)};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides, lower,
             upper, kChannels, kPixels, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  // Drivers up to 13.1 mis-handle an im2col map of a tensor under 128 KB
  // unless bit 21 of its second word is cleared (CUTLASS's
  // make_im2col_tma_copy_desc does the same).
  int driver = 0;
  if (cudaDriverGetVersion(&driver) == cudaSuccess && driver <= 13010 &&
      static_cast<unsigned long long>(b) * t * h * w * row < 131072ull) {
    reinterpret_cast<uint64_t*>(map)[1] &= ~(1ull << 21);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the conv on `stream`; returns cudaGetLastError() (0 = launched).
// Device pointers: x (b, t, h, w, ci) bf16; wt (co, kt, 3, 3, ci) bf16; bias
// (co) f32; y (b, t - kt + 1, h, w, co) bf16; part ((tiles - full) *
// splits, 128, 256) f32 when full < tiles (else unused), tiles = ceil(M /
// 128) * co / 256.  ci % 64 == 0, co % 256 == 0, all 16-byte aligned.
int shgvqa_tok_conv_bf16(const void* x, const void* wt, const void* bias, void* y, void* part,
                         int b, int t, int h, int w, int ci, int co, int kt, int full, int splits,
                         int gelu, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || kt <= 0 || kt > 16 || t < kt || ci <= 0 ||
      ci % kGemmBK != 0 || co <= 0 || co % kBN != 0 || splits < 1 || splits > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m = static_cast<long long>(b) * (t - kt + 1) * h * w;
  const long long k = static_cast<long long>(kt) * 9 * ci;
  if (m > (1LL << 30) || k > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<bf16*>(y);
  p.part = static_cast<float*>(part);
  p.m = static_cast<int>(m);
  p.n = co;
  p.nk = static_cast<int>(k / kGemmBK);
  p.ci = ci;
  p.w = w;
  p.h = h;
  p.to = t - kt + 1;
  p.col_tiles = co / kBN;
  p.full = full;
  p.splits = splits;
  p.gelu = gelu;
  const int tiles = ceil_div(p.m, kGemmBM) * p.col_tiles;
  if (full < 0 || full > tiles || (full < tiles && (part == nullptr || p.nk < splits))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, wmap;
  cudaError_t err = im2col_map(&xmap, x, b, t, h, w, ci, kt);
  if (err == cudaSuccess) {
    err = tensor_map(&wmap, wt, co, static_cast<int>(k), kBN, kGemmBK, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int items = full + (tiles - full) * splits;
  const int smem = gemm_smem_bytes<kBN, kStages>();
  err = cudaFuncSetAttribute(tok_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tok_conv_kernel<<<items, kGemmThreads, smem, s>>>(xmap, wmap, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || full == tiles) return static_cast<int>(err);
  const int threads = 256;
  const int quads = (tiles - full) * kGemmBM * (kBN / 4);
  tok_conv_reduce_kernel<<<quads / threads, threads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* shgvqa_tok_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
