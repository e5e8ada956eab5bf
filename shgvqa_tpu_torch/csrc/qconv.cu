// The int8 frozen trunk's convolution for Hopper (sm_90a): an s8 x s8 -> s32
// 3-D convolution on channels-last int8 activations with the dequantize,
// folded-BatchNorm, ReLU, residual and requantize epilogue,
//
//   acc[b, t, y, x, n] = sum over (dt, dy, dx, c) of
//       x_q[b, t + dt - kT/2, y*s + dy - kH/2, x*s + dx - kW/2, c] * w_q[n, dt, dy, dx, c]
//   v = (T(acc) * scale[n]) + shift[n]            (each product and sum rounded to T once)
//   mode 0 (conv_a, conv_b):  y_q = quant(relu(v), s_out)
//   mode 1 (conv_proj):       y   = v                                (T)
//   mode 2 (conv_c):          y_q = quant(relu(v + r), s_out)        (r: T tensor)
//   mode 3 (conv_c):          y_q = quant(relu(v + T(r_q) * T(max(s_res, 1e-12))), s_out)
//   quant(u, s) = clamp(rint(u / max(s, 1e-12)), -127, 127)          (IEEE f32 division)
//
// zero-padded by k/2 in every dimension, spatial stride s in {1, 2},
// temporal stride 1; (kT, kH, kW) in {(1,1,1), (3,1,1), (1,3,3)}; T is bf16
// or f32.
//
// It replaces no Pallas kernel: it is the counterpart of the JAX package's
// Bottleneck3D._quant_call (shgvqa_tpu/models/backbone.py: _qconv :167, deq
// :279, quant_sym :149), which leaves it to XLA.  No PyTorch or library call
// computes it (F.conv3d takes no int8 on CUDA; torch._int_mm is a plain
// GEMM), so the port needs it.  Its plain version is qconv_reference in
// shgvqa_tpu_torch/kernels/qconv.py; the kernel is bit-equal to it: the
// integer sums are exact, and the epilogue keeps its rounding points (int32
// -> f32 -> T by round to nearest even, as torch's acc.to(T); __fmul_rn /
// __fadd_rn so nothing contracts into an FMA; __fdiv_rn; rintf, half to
// even, as torch.round).  The wrapper reads no scale on the host: s_out and
// s_res are device pointers, scale and shift device vectors.
//
// What bounds it on the card: M = B*T*Ho*Wo output positions by N = Co over
// K = kT*kH*kW*Ci.  At the trunk's shapes the 1x1 convs of res_2 have
// K = 64-256 and ~40-120 operations per byte moved, below the ~590 of the
// card's int8 rate (1,979 TOP/s) over its 3.35 TB/s, so most launches are
// bound by bytes; the 3x3 and deep convs by operations.
//
// Design (an implicit GEMM, the first generation of the port's tokenizer
// conv, on s8 tensor cores):
// - one block of 8 warps per 128 x kBN output tile (kBN 128, or 64 when
//   Co = 64), warps 2 (M) x 4 (N), each on 64 x kBN/4 with ldmatrix +
//   mma.sync m16n8k32 (s8 in, s32 sums in registers);
// - K runs in steps of 64 channels of one tap (Ci is a multiple of 64).  An
//   A row of a step is one contiguous 64-byte run of the channels-last
//   input, copied with cp.async as four 16-byte chunks; a row whose tap
//   falls in the padding (time, height or width), or past M, is zero-filled
//   (src-size 0).  Stride 2 only changes a row's base address.  B is the
//   weight in (Co, kT, kH, kW, Ci) order, [n][k] with K contiguous;
// - a ring of 4 stages keeps three steps in flight; chunk c of row r is
//   stored at c ^ ((r / 2) % 4) so that ldmatrix reads 8 rows of 64 bytes
//   without bank conflicts;
// - the epilogue applies the mode above to each thread's pairs of columns
//   and stores int8 (or T) channels-last, rows past M masked: that layout
//   is the next conv's input.
// wgmma .s8 with TMA, and the whole bottleneck in one kernel, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBK = 64;                 // rows of a tile; channels (bytes) of a K step
constexpr int kStages = 4;
constexpr int kATileBytes = kBM * kBK;             // 8 KB

__host__ __device__ constexpr int stage_bytes(int bn) { return kATileBytes + bn * kBK; }

enum Mode { kQuant = 0, kDeq = 1, kRes = 2, kResQ = 3 };

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

// Byte offset of 16-byte chunk c (0..3) of row r in a tile of 64-byte rows.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kBK + ((c ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b on one m16n8k32 tile (a row-major, b col-major, s8 in, s32 sums).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 rounded to T and back (the identity for f32).
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* p, float a, float b) {
  // a and b are already bf16 values: the conversion is exact
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ int8_t quant(float u, float s) {
  float q = rintf(__fdiv_rn(u, s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

struct Geometry {
  int t, h, w, ci;        // input (B, T, H, W, Ci)
  int ho, wo;             // output sides (T is kept)
  int kt, kh, kw, stride;
  int m, n, k;            // GEMM: M = B*T*Ho*Wo, N = Co, K = kT*kH*kW*Ci
};

template <int kBN, typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
             const T* __restrict__ scale, const T* __restrict__ shift,
             const void* __restrict__ res, const float* __restrict__ s_res,
             const float* __restrict__ s_out, void* __restrict__ y, Geometry g) {
  constexpr int kWN = kBN / 4;                     // columns of a warp
  constexpr int kNT = kWN / 8;                     // its n8 tiles (4 or 2)
  constexpr int kBRows = kBN * 4 / kThreads;       // B rows this thread copies (2 or 1)
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = g.k / kBK;

  // This thread copies chunk `chunk` of tile rows lrow + 64 j.
  const int chunk = tid & 3, lrow = tid >> 2;
  long long abase[2];     // element offset of the row's tap (0, 0, 0), chunk included
  int at[2], ay[2], ax[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = m0 + lrow + 64 * j;
    at[j] = -(1 << 20);   // a row past M: never in range
    ay[j] = 0;
    ax[j] = 0;
    abase[j] = 0;
    if (m < g.m) {
      const int xo = m % g.wo;
      const int yo = (m / g.wo) % g.ho;
      const int bt = m / (g.wo * g.ho);
      const int b = bt / g.t, t = bt % g.t;
      at[j] = t - g.kt / 2;
      ay[j] = yo * g.stride - g.kh / 2;
      ax[j] = xo * g.stride - g.kw / 2;
      abase[j] = ((static_cast<long long>(b) * g.t + at[j]) * g.h + ay[j]) *
                     static_cast<long long>(g.w) * g.ci +
                 static_cast<long long>(ax[j]) * g.ci + chunk * 16;
    }
  }
  const int8_t* brow[kBRows];
#pragma unroll
  for (int j = 0; j < kBRows; ++j) {
    brow[j] = wt + static_cast<long long>(n0 + lrow + 64 * j) * g.k + chunk * 16;
  }

  auto issue = [&](int ks, uint32_t st) {
    const int k0 = ks * kBK;
    const int tap = k0 / g.ci;
    const int c0 = k0 - tap * g.ci;
    const int dt = tap / (g.kh * g.kw);
    const int dy = (tap / g.kw) % g.kh;
    const int dx = tap % g.kw;
    const long long off =
        ((static_cast<long long>(dt) * g.h + dy) * g.w + dx) * g.ci + c0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ti = at[j] + dt, yi = ay[j] + dy, xi = ax[j] + dx;
      const bool ok = ti >= 0 && ti < g.t && yi >= 0 && yi < g.h && xi >= 0 && xi < g.w;
      cp_async16(st + swz(lrow + 64 * j, chunk), ok ? x + abase[j] + off : x, ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < kBRows; ++j) {
      cp_async16(st + kATileBytes + swz(lrow + 64 * j, chunk), brow[j] + k0, 16);
    }
  };

  int acc[4][kNT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue(s, ring + s * stage_bytes(kBN));
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<kStages - 2>();   // step s landed (this thread's copies)
    __syncthreads();                // ... everyone's; and step s-1's stage is free
    const int next = s + kStages - 1;
    if (next < nk) issue(next, ring + (next % kStages) * stage_bytes(kBN));
    cp_async_commit();
    const uint32_t sa = ring + (s % kStages) * stage_bytes(kBN);
    const uint32_t sb = sa + kATileBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldsm_x4(a[i], sa + swz(wm * 64 + i * 16 + (lane & 15), kk * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        uint32_t b[4];
        ldsm_x4(b, sb + swz(wn * kWN + p * 16 + (lane & 7) + ((lane >> 4) << 3),
                            kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_s8(acc[i][2 * p], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float so = 0.0f, rs = 0.0f;
  if (kMode != kDeq) so = fmaxf(*s_out, 1e-12f);
  if (kMode == kResQ) rs = rnd<T>(fmaxf(*s_res, 1e-12f));
  const int gr = lane / 4, q = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = n0 + wn * kWN + j * 8 + q;
    const float sc[2] = {to_f32<T>(scale[col]), to_f32<T>(scale[col + 1])};
    const float sh[2] = {to_f32<T>(shift[col]), to_f32<T>(shift[col + 1])};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + i * 16 + gr + half * 8;
        if (row >= g.m) continue;
        const long long idx = static_cast<long long>(row) * g.n + col;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float u = rnd<T>(__int2float_rn(acc[i][j][2 * half + e]));
          u = rnd<T>(__fmul_rn(u, sc[e]));
          v[e] = rnd<T>(__fadd_rn(u, sh[e]));
        }
        if (kMode == kDeq) {
          store_pair<T>(static_cast<T*>(y) + idx, v[0], v[1]);
          continue;
        }
        if (kMode == kRes) {
          const T* r = static_cast<const T*>(res) + idx;
#pragma unroll
          for (int e = 0; e < 2; ++e) v[e] = rnd<T>(__fadd_rn(v[e], to_f32<T>(r[e])));
        }
        if (kMode == kResQ) {
          const char2 r = *reinterpret_cast<const char2*>(static_cast<const int8_t*>(res) + idx);
          v[0] = rnd<T>(__fadd_rn(v[0], rnd<T>(__fmul_rn(static_cast<float>(r.x), rs))));
          v[1] = rnd<T>(__fadd_rn(v[1], rnd<T>(__fmul_rn(static_cast<float>(r.y), rs))));
        }
        char2 out;
        out.x = quant(fmaxf(v[0], 0.0f), so);
        out.y = quant(fmaxf(v[1], 0.0f), so);
        *reinterpret_cast<char2*>(static_cast<int8_t*>(y) + idx) = out;
      }
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int kBN, typename T, int kMode>
cudaError_t launch(const void* x, const void* wt, const void* scale, const void* shift,
                   const void* res, const void* s_res, const void* s_out, void* y,
                   const Geometry& g, cudaStream_t stream) {
  auto kernel = qconv_kernel<kBN, T, kMode>;
  constexpr int smem = kStages * stage_bytes(kBN);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(g.m, kBM), g.n / kBN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const T*>(scale), static_cast<const T*>(shift), res,
      static_cast<const float*>(s_res), static_cast<const float*>(s_out), y, g);
  return cudaGetLastError();
}

template <int kBN, typename T>
cudaError_t launch_mode(int mode, const void* x, const void* wt, const void* scale,
                        const void* shift, const void* res, const void* s_res,
                        const void* s_out, void* y, const Geometry& g, cudaStream_t s) {
  switch (mode) {
    case kQuant:
      return launch<kBN, T, kQuant>(x, wt, scale, shift, res, s_res, s_out, y, g, s);
    case kDeq:
      return launch<kBN, T, kDeq>(x, wt, scale, shift, res, s_res, s_out, y, g, s);
    case kRes:
      return launch<kBN, T, kRes>(x, wt, scale, shift, res, s_res, s_out, y, g, s);
    default:
      return launch<kBN, T, kResQ>(x, wt, scale, shift, res, s_res, s_out, y, g, s);
  }
}

}  // namespace

extern "C" {

// Launches the conv on `stream`; returns cudaGetLastError() (0 = launched).
// Device pointers: x (b, t, h, w, ci) int8; wt (co, kt, kh, kw, ci) int8;
// scale, shift (co) T; res (b, t, ho, wo, co) T (mode 2) or int8 (mode 3),
// else unused; s_res (mode 3) and s_out (modes 0, 2, 3) one f32 each; y
// (b, t, ho, wo, co) int8, or T in mode 1.  dtype 0 = bf16, 1 = f32.
// ci and co multiples of 64, every pointer 16-byte aligned.
int shgvqa_qconv(const void* x, const void* wt, const void* scale, const void* shift,
                 const void* res, const void* s_res, const void* s_out, void* y, int b,
                 int t, int h, int w, int ci, int co, int kt, int kh, int kw, int stride,
                 int mode, int dtype, void* stream) {
  const bool kernel_ok = (kt == 1 && kh == 1 && kw == 1) || (kt == 3 && kh == 1 && kw == 1) ||
                         (kt == 1 && kh == 3 && kw == 3);
  if (b <= 0 || t <= 0 || h <= 0 || w <= 0 || ci <= 0 || ci % kBK != 0 || co <= 0 ||
      co % 64 != 0 || !kernel_ok || (stride != 1 && stride != 2) || mode < kQuant ||
      mode > kResQ || (dtype != 0 && dtype != 1) || x == nullptr || wt == nullptr ||
      scale == nullptr || shift == nullptr || y == nullptr ||
      (mode != kDeq && s_out == nullptr) || ((mode == kRes || mode == kResQ) && res == nullptr) ||
      (mode == kResQ && s_res == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  g.t = t;
  g.h = h;
  g.w = w;
  g.ci = ci;
  g.kt = kt;
  g.kh = kh;
  g.kw = kw;
  g.stride = stride;
  g.ho = (h + 2 * (kh / 2) - kh) / stride + 1;
  g.wo = (w + 2 * (kw / 2) - kw) / stride + 1;
  const long long m = static_cast<long long>(b) * t * g.ho * g.wo;
  const long long k = static_cast<long long>(kt) * kh * kw * ci;
  if (m > (1LL << 30) || k > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  g.m = static_cast<int>(m);
  g.n = co;
  g.k = static_cast<int>(k);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (co % 128 == 0) {
    err = dtype == 0 ? launch_mode<128, bf16>(mode, x, wt, scale, shift, res, s_res, s_out, y, g, s)
                     : launch_mode<128, float>(mode, x, wt, scale, shift, res, s_res, s_out, y, g, s);
  } else {
    err = dtype == 0 ? launch_mode<64, bf16>(mode, x, wt, scale, shift, res, s_res, s_out, y, g, s)
                     : launch_mode<64, float>(mode, x, wt, scale, shift, res, s_res, s_out, y, g, s);
  }
  return static_cast<int>(err);
}

const char* shgvqa_qconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
