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
// the LayerNorm).  W (1.18 MB at D = 768) does not fit in a block's 227 KB,
// so it streams from L2 for every row tile; the design cuts how often.
//
// Design: a thread-block cluster per row tile, each CTA owning a column slab.
// - D is cut into cs <= kMaxCluster slabs of BN = 64, 128 or 192 columns
//   (768 = 4 x 192, 512 = 4 x 128, 256 = 4 x 64, 128 = 2 x 64, 64 = 1 x 64;
//   cluster_of), M into row tiles of kBM = 128 or 64 rows.  The grid is
//   (cs, row tiles) in clusters of (cs, 1, 1); CTA rank r of a cluster
//   computes columns r * BN .. of its row tile, so it reads only its slab of
//   W: at M = 12576, 99 tiles x 1.18 MB from L2 in all, where a block that
//   owned whole 48-row tiles read 262 x 1.18 MB.
// - the product is the wgmma + TMA ring of wgmma_gemm.cuh (ring_mainloop):
//   one producer warp, kBM / 64 consumer warpgroups, x through kBM x 64
//   boxes, W K-major (nn.Linear's (out, in) layout, no transposed copy)
//   through 64 x 64 boxes, kStages stages, 12 k steps at D = 768.  Once the
//   ring is full the producer also lands the residual's kBM x BN tile by
//   TMA, in space of its own, so that it arrives under the products.
// - the epilogue runs on the accumulator in registers.  The bias and the
//   residual are added in f32 (the slab's bias, gamma and beta are staged
//   in shared memory, and the epilogue addresses shared memory by 32-bit
//   address: 64-bit pointers cost the registers that kept the 128 x 192
//   tile from spilling).  A row of a warpgroup's 64 x BN tile lives
//   in the 4 threads of one quad (the accumulator layout in
//   wgmma_gemm.cuh), so a slab's partial row sum is each thread's sum plus
//   two shfl_xor.  Each CTA writes its partials to its shared memory; after
//   a cluster barrier every CTA reads the cs partials of its rows from the
//   CTAs of its cluster through distributed shared memory (mapa +
//   ld.shared::cluster) and sums them in rank order: the mean.  The sums
//   of (r - mean)^2 are exchanged the same way (the two-pass variance).
//   y in bf16 is written over the residual's tile and stored by TMA (rows
//   past M are not written); a last cluster barrier keeps every CTA's
//   shared memory alive until its peers have read it.
// - every sum is taken in a fixed order and nothing is summed atomically,
//   so two calls give the same bits.
// - the row tile (rows_of): 128 rows where the clusters fill at least 3/4
//   of their waves over the SMs (D = 768, M = 12576: 396 CTAs, 3 waves of
//   132), else 64 rows and one consumer warpgroup, whose finer grain fills
//   more of the card at the small and middle sites (as the FFN chain's o
//   stage picks its width).  Rows of a tile past M are zero-filled by the
//   TMA loads.

#include "wgmma_gemm.cuh"

namespace {

constexpr int kMaxCluster = 4;                    // CTAs of a cluster: slabs of a row
constexpr int kMaxSlab = 192;                     // widest slab: one m64n192k16 wgmma
constexpr int kMaxD = kMaxCluster * kMaxSlab;     // 768
constexpr int kNarrowRows = 64;                   // the row tile when 128 rows fill the waves poorly
constexpr int kStages = 4;                        // ring stages: 40 KB (128 rows) or 32 KB (64)

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The cluster size of width d: the largest c <= kMaxCluster that cuts d
// into slabs of a multiple of 64 columns and at most kMaxSlab; 0 when there
// is none (d not a multiple of 64, above kMaxD, or 320, 448, 640, 704).
int cluster_of(int d) {
  if (d <= 0 || d % 64 != 0 || d > kMaxD) return 0;
  for (int c = kMaxCluster; c >= 1; --c) {
    if (d % (64 * c) == 0 && d / c <= kMaxSlab) return c;
  }
  return 0;
}

// Rows of a tile for m rows in clusters of c CTAs on sms SMs (one CTA an
// SM): 128 when the 128-row tiles' CTAs fill at least one wave and 3/4 of
// their waves, else kNarrowRows.
int rows_of(int m, int c, int sms) {
  const int ctas = ceil_div(m, kGemmBM) * c;
  const int waves = ceil_div(ctas, sms);
  return ctas >= sms && 4 * ctas >= 3 * waves * sms ? kGemmBM : kNarrowRows;
}

// Shared memory of a CTA, in bytes from the 1 KB-aligned base: the ring's
// stages and mbarriers (ring_mainloop), the residual's tile (1 KB aligned;
// BN / 64 column boxes of kBM rows x 128 bytes, 128-byte swizzle, y is
// written over it), the partial row sums (f32 [2][kBM]: sums, then sums of
// squares), the slab's bias, gamma and beta (f32 [3][BN]) and the
// residual's mbarrier.
template <int kBM, int BN>
struct Smem {
  static constexpr uint32_t kRing = kStages * (kBM + BN) * kGemmBK * 2 + 16 * kStages;
  static constexpr uint32_t kRes = (kRing + 1023u) & ~1023u;
  static constexpr uint32_t kPart = kRes + kBM * BN * 2;
  static constexpr uint32_t kVec = kPart + 2 * kBM * 4;
  static constexpr uint32_t kBar = kVec + 3 * BN * 4;
  static constexpr int kBytes = kBar + 8 + 1024;   // + slack to align the base
};

__device__ __forceinline__ int cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every CTA of the cluster arrives; its writes to shared
// memory before are seen by the cluster's reads after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The f32 at shared address addr of this CTA's layout, in the CTA of the
// cluster with this rank (distributed shared memory).
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Accesses to this CTA's shared memory by 32-bit address (a generic
// pointer would hold 64 bits of the epilogue's registers).
__device__ __forceinline__ uint32_t lds_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 lds_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// The threads of one warpgroup meet (named barrier id, 128 threads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Sum of the 4 threads of a quad; every thread of it gets the same bits.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The slab sums of this thread's two rows (r0 and r0 + 8) exchanged over
// the cluster: the quad's sums written to this CTA's partials at part, a
// cluster barrier, then the cs CTAs' partials of each row summed in rank
// order.
__device__ __forceinline__ void cluster_row_sums(float (&s)[2], uint32_t part, int r0,
                                                 bool writer, int cs) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] = quad_sum(s[h]);
    if (writer) sts_f32(part + 4 * (r0 + 8 * h), s[h]);
  }
  cluster_sync();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float total = 0.0f;
    for (int k = 0; k < cs; ++k) total += ld_cluster_f32(part + 4 * (r0 + 8 * h), k);
    s[h] = total;
  }
}

// One CTA: the (kBM x BN) tile at row tile blockIdx.y and column slab
// cluster rank of y, as the header says.  Every thread of the cluster takes
// part in its three cluster barriers.
template <int kBM, int BN>
__global__ void __launch_bounds__(2 * kBM + 32, 1)
out_ln_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap ymap,
              const float* __restrict__ bias, const float* __restrict__ gamma,
              const float* __restrict__ beta, int d, float eps) {
  using L = Smem<kBM, BN>;
  constexpr uint32_t kBoxBytes = kGemmBox * kGemmBK * 2;
  extern __shared__ __align__(1024) unsigned char out_ln_smem[];
  const uint32_t raw = smem_addr(out_ln_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t res = base + L::kRes, res_bar = base + L::kBar;
  const int cs = d / BN;
  const int rank = cluster_ctarank();
  const int row0 = blockIdx.y * kBM, col0 = rank * BN;
  const int nk = d / kGemmBK;

  // the slab's vectors, read by the epilogue after ring_mainloop's barrier
  float* vec = reinterpret_cast<float*>(out_ln_smem + (base - raw) + L::kVec);
  for (int i = threadIdx.x; i < BN; i += blockDim.x) {
    vec[i] = bias[col0 + i];
    vec[BN + i] = gamma[col0 + i];
    vec[2 * BN + i] = beta[col0 + i];
  }
  if (threadIdx.x == 0) mbar_init(res_bar, 1);   // fenced and met in ring_mainloop
  float acc[BN / 2];
  const bool consumer = ring_mainloop<BN, false, kStages, kBM>(
      nk,
      [&](uint32_t a, uint32_t b, int t, uint32_t bar) {
        tma_2d(a, &xmap, t * kGemmBK, row0, bar);
#pragma unroll
        for (int j = 0; j < BN / kGemmBox; ++j) {
          tma_2d(b + j * kBoxBytes, &wmap, t * kGemmBK, col0 + j * kGemmBox, bar);
        }
        if (t == min(kStages, nk) - 1) {   // the ring is full: the residual's tile
          mbar_expect_tx(res_bar, kBM * BN * 2);   // boxes past M count in full
          for (int cb = 0; cb < BN / 64; ++cb) {
            for (int rb = 0; rb < kBM / 64; ++rb) {
              tma_2d(res + (cb * kBM + rb * 64) * 128, &rmap, col0 + 64 * cb, row0 + 64 * rb,
                     res_bar);
            }
          }
        }
      },
      acc);
  if (!consumer) {   // the producer warp: the cluster's barriers only
    __syncwarp();
    for (int i = 0; i < 3; ++i) cluster_sync();
    return;
  }

  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;
  const int r0 = wg * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;   // and r0 + 8
  const int g = lane / 4;                                                // = r0 % 8
  const int q2 = 2 * (lane % 4);
  const bool writer = lane % 4 == 0;
  const uint32_t part = base + L::kPart;
  const uint32_t vecs = base + L::kVec + 4 * q2;   // + 4 (8 j) [+ 4 BN: gamma, 8 BN: beta]
  const float inv_d = 1.0f / static_cast<float>(d);
  // (row r0 + 8 h, column 8 j + q2) of the swizzled tile: chunk j % 8 of
  // the row at (j % 8) ^ (r0 % 8), in column box j / 8
  auto at = [&](int j, int h) -> uint32_t {
    return res + (j / 8) * kBM * 128 + (r0 + 8 * h) * 128 + (((j % 8) ^ g) << 4) + 2 * q2;
  };
  mbar_wait(res_bar, 0);

  // r = (acc + b) + residual, in place; the slab's sums of the two rows
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 bc = lds_f32x2(vecs + 32 * j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t rc = lds_b32(at(j, h));   // two bf16: column c low, c + 1 high
      float& v0 = acc[4 * j + 2 * h];
      float& v1 = acc[4 * j + 2 * h + 1];
      v0 = (v0 + bc.x) + __uint_as_float(rc << 16);
      v1 = (v1 + bc.y) + __uint_as_float(rc & 0xffff0000u);
      s[h] += v0;
      s[h] += v1;
    }
  }
  cluster_row_sums(s, part, r0, writer, cs);

  // two-pass variance: r - mean in place, the slab's sums of its squares
  const float mean[2] = {s[0] * inv_d, s[1] * inv_d};
  s[0] = s[1] = 0.0f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = acc[4 * j + 2 * h + e];
        v -= mean[h];
        s[h] += v * v;
      }
    }
  }
  cluster_row_sums(s, part + 4 * kBM, r0, writer, cs);
  const float rstd[2] = {rsqrtf(s[0] * inv_d + eps), rsqrtf(s[1] * inv_d + eps)};

  // y = (r - mean) * rstd * gamma + beta in bf16, over the residual's tile
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 gc = lds_f32x2(vecs + 4 * BN + 32 * j);
    const float2 be = lds_f32x2(vecs + 8 * BN + 32 * j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 y2 =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * rstd[h] * gc.x + be.x,
                                acc[4 * j + 2 * h + 1] * rstd[h] * gc.y + be.y);
      sts_b32(at(j, h), *reinterpret_cast<const uint32_t*>(&y2));
    }
  }
  fence_proxy_async();
  warpgroup_sync(1 + wg);
  if (threadIdx.x % 128 == 0) {   // the warpgroup's 64 rows, one 64 x 64 box a column box
    for (int cb = 0; cb < BN / 64; ++cb) {
      tma_store_2d(&ymap, res + (cb * kBM + wg * 64) * 128, col0 + 64 * cb, row0 + wg * 64);
    }
    tma_store_wait<0, true>();
  }
  cluster_sync();   // no CTA leaves while a peer may still read its partials
}

template <int kBM, int BN>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* res,
                   const void* gamma, const void* beta, void* y, int m, int d, float eps,
                   cudaStream_t stream) {
  CUtensorMap xmap, wmap, rmap, ymap;
  cudaError_t err = kBM == kGemmBM ? gemm_a_map(&xmap, x, m, d) : gemm_b_map(&xmap, x, m, d);
  if (err == cudaSuccess) err = gemm_b_map(&wmap, w, d, d);
  if (err == cudaSuccess) err = gemm_b_map(&rmap, res, m, d);
  if (err == cudaSuccess) err = gemm_b_map(&ymap, y, m, d);
  if (err != cudaSuccess) return err;
  constexpr int smem = Smem<kBM, BN>::kBytes;
  err = cudaFuncSetAttribute(out_ln_kernel<kBM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = d / BN;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(d / BN, ceil_div(m, kBM));
  cfg.blockDim = dim3(2 * kBM + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, out_ln_kernel<kBM, BN>, xmap, wmap, rmap, ymap,
                           static_cast<const float*>(bias), static_cast<const float*>(gamma),
                           static_cast<const float*>(beta), d, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kBM>
cudaError_t launch_rows(int slab, const void* x, const void* w, const void* bias, const void* res,
                        const void* gamma, const void* beta, void* y, int m, int d, float eps,
                        cudaStream_t stream) {
  switch (slab) {
    case 192: return launch<kBM, 192>(x, w, bias, res, gamma, beta, y, m, d, eps, stream);
    case 128: return launch<kBM, 128>(x, w, bias, res, gamma, beta, y, m, d, eps, stream);
    default: return launch<kBM, 64>(x, w, bias, res, gamma, beta, y, m, d, eps, stream);
  }
}

}  // namespace

extern "C" {

// Largest width the kernel takes (kMaxCluster slabs of kMaxSlab columns).
int shgvqa_out_ln_max_d() { return kMaxD; }

// The launch plan of an (m, d) call on sms SMs into plan[0..3]: cluster
// size, slab width, rows of a row tile, row tiles (the grid is plan[0] x
// plan[3] CTAs).  Returns 0, or cudaErrorInvalidValue for a d the kernel
// does not take.
int shgvqa_out_ln_plan(int m, int d, int sms, int* plan) {
  const int cs = cluster_of(d);
  if (m <= 0 || sms <= 0 || cs == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = rows_of(m, cs, sms);
  plan[0] = cs;
  plan[1] = d / cs;
  plan[2] = rows;
  plan[3] = ceil_div(m, rows);
  return static_cast<int>(cudaSuccess);
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
// Device pointers: x, res, y (m, d) bf16; w (d, d) bf16 in nn.Linear's
// (out, in) layout; bias, gamma, beta (d) f32; all contiguous and 16-byte
// aligned.  d is one of the widths cluster_of takes (64, 128, 192, 256,
// 384, 512, 576, 768).
int shgvqa_out_ln_bf16(const void* x, const void* w, const void* bias, const void* res,
                       const void* gamma, const void* beta, void* y, int m, int d, float eps,
                       void* stream) {
  if (m < 0 || cluster_of(d) == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int plan[4];
  shgvqa_out_ln_plan(m, d, sms, plan);
  if (plan[3] > 65535) return static_cast<int>(cudaErrorInvalidValue);   // grid.y
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = plan[2] == kGemmBM
            ? launch_rows<kGemmBM>(plan[1], x, w, bias, res, gamma, beta, y, m, d, eps, s)
            : launch_rows<kNarrowRows>(plan[1], x, w, bias, res, gamma, beta, y, m, d, eps, s);
  return static_cast<int>(err);
}

const char* shgvqa_out_ln_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
