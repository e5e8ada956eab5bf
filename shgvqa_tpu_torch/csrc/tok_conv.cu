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
// Design (an implicit GEMM):
// - one block of 8 warps per 128 x 128 output tile, warps 2 (M) x 4 (N),
//   each on 64 x 32 with ldmatrix + mma.sync m16n8k16 (bf16 in, f32 sums);
// - K runs in steps of 64 channels of one tap (Ci is a multiple of 64).  An
//   A row of a step is one contiguous run of 128 bytes of the channels-last
//   input, copied with cp.async; a row that falls in the spatial padding,
//   or past M, is zero-filled (src-size 0).  B is the weight in (Co, kT, kH,
//   kW, Ci) order, i.e. [n][k] with K contiguous, which is the memory of the
//   Conv3d weight under channels_last_3d;
// - a ring of 3 stages (A and B tiles of 16 KB each) keeps two steps in
//   flight; the tiles are stored with 16-byte chunk c of row r at c ^ (r % 8)
//   so that ldmatrix reads them without bank conflicts;
// - when the output tiles are too few to fill the card (B=2: 60 tiles on 132
//   SMs) K is split over the blocks: each split writes an f32 partial tile,
//   and a second kernel sums the partials in split order (deterministic, no
//   atomics), then adds the bias and applies the GeLU;
// - otherwise the epilogue adds the bias, applies the GeLU and stores bf16
//   channels-last, rows past M masked: that layout is the next conv's input
//   and the tokens' layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 3;
constexpr int kTileBytes = kBM * kBK * 2;          // 16 KB; the B tile is the same size
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kSmemBytes = kStages * kStageBytes;  // 96 KB: two blocks per SM
constexpr int kMaxSplits = 16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem, or zeros when src_bytes is 0 (gmem is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Byte offset of 16-byte chunk c of row r in a tile of 128-byte rows.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

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

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

struct Geometry {
  int t, h, w, ci;     // input (B, T, H, W, Ci)
  int to;              // T' = T - kT + 1
  int m, n, k;         // GEMM: M = B*T'*H*W, N = Co, K = kT*9*Ci
};

// Split `split` of `splits` over the K steps of the tile at (blockIdx.x,
// blockIdx.y): y (bf16, bias + GeLU) when splits == 1, else the f32 partial
// into part[split].
__global__ void __launch_bounds__(kThreads, 2)
tok_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                const float* __restrict__ bias, bf16* __restrict__ y, float* __restrict__ part,
                Geometry g, int splits, int gelu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int nk = g.k / kBK;
  const int kbeg = static_cast<int>(static_cast<long long>(nk) * split / splits);
  const int kend = static_cast<int>(static_cast<long long>(nk) * (split + 1) / splits);

  // This thread copies chunk `chunk` of tile rows lrow + 32 j (A and B).
  const int chunk = tid & 7, lrow = tid >> 3;
  const bf16* arow[4];
  int ay[4], ax[4];
  const bf16* brow[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + lrow + 32 * j;
    ay[j] = -4;   // marks a row past M: never in range
    ax[j] = 0;
    arow[j] = x;
    if (m < g.m) {
      const int xx = m % g.w;
      const int yy = (m / g.w) % g.h;
      const int bt = m / (g.w * g.h);
      const int b = bt / g.to, t = bt % g.to;
      ay[j] = yy;
      ax[j] = xx;
      arow[j] = x + ((static_cast<long long>(b) * g.t + t) * g.h * g.w +
                     static_cast<long long>(yy) * g.w + xx) * g.ci + chunk * 8;
    }
    const int n = n0 + lrow + 32 * j;
    brow[j] = n < g.n ? wt + static_cast<long long>(n) * g.k + chunk * 8 : nullptr;
  }

  auto issue = [&](int ks, uint32_t st) {
    const int k0 = ks * kBK;
    const int tap = k0 / g.ci;
    const int ci0 = k0 - tap * g.ci;
    const int dt = tap / 9, dy = (tap % 9) / 3 - 1, dx = tap % 3 - 1;
    const long long off =
        (static_cast<long long>(dt) * g.h * g.w + dy * g.w + dx) * g.ci + ci0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int yy = ay[j] + dy, xx = ax[j] + dx;
      const bool ok = yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
      cp_async16(st + swz(lrow + 32 * j, chunk), ok ? arow[j] + off : x, ok ? 16 : 0);
      cp_async16(st + kTileBytes + swz(lrow + 32 * j, chunk),
                 brow[j] != nullptr ? brow[j] + k0 : wt, brow[j] != nullptr ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }

  const int steps = kend - kbeg;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(kbeg + s, ring + s * kStageBytes);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();   // step s landed (this thread's copies)
    __syncthreads();                // ... everyone's; and step s-1's stage is free
    const int next = s + kStages - 1;
    if (next < steps) issue(kbeg + next, ring + (next % kStages) * kStageBytes);
    cp_async_commit();
    const uint32_t sa = ring + (s % kStages) * kStageBytes;
    const uint32_t sb = sa + kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldsm_x4(a[i], sa + swz(wm * 64 + i * 16 + (lane & 15), kk * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t b[4];
        ldsm_x4(b, sb + swz(wn * 32 + p * 16 + (lane & 7) + ((lane >> 4) << 3),
                            kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma16816(acc[i][2 * p], a[i], b[0], b[1]);
          mma16816(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gr = lane / 4, q = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + q;
    if (col >= g.n) continue;
    const float b0 = splits == 1 ? bias[col] : 0.0f;
    const float b1 = splits == 1 ? bias[col + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + i * 16 + gr + half * 8;
        if (row >= g.m) continue;
        float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (splits == 1) {
          v0 += b0;
          v1 += b1;
          if (gelu) {
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(y + static_cast<long long>(row) * g.n + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(
              part + (static_cast<long long>(split) * g.m + row) * g.n + col) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

// y = gelu(bias + sum over splits of part), 4 channels a thread.
__global__ void tok_conv_reduce_kernel(const float* __restrict__ part,
                                       const float* __restrict__ bias, bf16* __restrict__ y,
                                       long long mn, int n, int splits, int gelu) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= mn) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int p = 1; p < splits; ++p) {
    const float4 v = *reinterpret_cast<const float4*>(part + p * mn + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const int c = static_cast<int>(i % n);
  float v[4] = {s.x + bias[c], s.y + bias[c + 1], s.z + bias[c + 2], s.w + bias[c + 3]};
  if (gelu) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = gelu_erf(v[e]);
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(y + i) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Number of K splits the launcher uses for an (m x n) output over k: 1 when
// the output tiles fill the card's SMs (two blocks each), else enough splits
// to fill them once, at most kMaxSplits and at least 16 K steps a split.
// Returns -1 on a CUDA error.
int shgvqa_tok_conv_splits(int m, int n, int k) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return -1;
  }
  const int tiles = ceil_div(m, kBM) * ceil_div(n, kBN);
  int splits = (2 * sms) / tiles;
  const int most = (k / kBK) / 16;
  if (splits > most) splits = most;
  if (splits > kMaxSplits) splits = kMaxSplits;
  return splits < 1 ? 1 : splits;
}

// Launches the conv on `stream`; returns cudaGetLastError() (0 = launched).
// Device pointers: x (b, t, h, w, ci) bf16; wt (co, kt, 3, 3, ci) bf16; bias
// (co) f32; y (b, t - kt + 1, h, w, co) bf16; part (splits, m, co) f32 when
// splits > 1 (else unused).  ci % 64 == 0, co % 8 == 0, all 16-byte aligned.
int shgvqa_tok_conv_bf16(const void* x, const void* wt, const void* bias, void* y, void* part,
                         int b, int t, int h, int w, int ci, int co, int kt, int splits,
                         int gelu, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || kt <= 0 || t < kt || ci <= 0 || ci % kBK != 0 ||
      co <= 0 || co % 8 != 0 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  g.t = t;
  g.h = h;
  g.w = w;
  g.ci = ci;
  g.to = t - kt + 1;
  const long long m = static_cast<long long>(b) * g.to * h * w;
  const long long k = static_cast<long long>(kt) * 9 * ci;
  if (m > (1LL << 30) || k > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  g.m = static_cast<int>(m);
  g.n = co;
  g.k = static_cast<int>(k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(tok_conv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(g.m, kBM), ceil_div(g.n, kBN), splits);
  tok_conv_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
      static_cast<const float*>(bias), static_cast<bf16*>(y), static_cast<float*>(part), g,
      splits, gelu);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = m * co;
  const int threads = 256;
  const long long blocks = (mn / 4 + threads - 1) / threads;
  tok_conv_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(bias), static_cast<bf16*>(y),
      mn, co, splits, gelu);
  return static_cast<int>(cudaGetLastError());
}

const char* shgvqa_tok_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
