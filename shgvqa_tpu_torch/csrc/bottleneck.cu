// Fused slow_r50 bottleneck block for Hopper (sm_90a), stride 1 and temporal
// kernel 1, on channels-last frames (N = B*T, H, W, Ci):
//
//   a = relu(BN_a(conv_a 1x1 (x)))          Ci -> Cm
//   b = relu(BN_b(conv_b 3x3, pad 1 (a)))   Cm -> Cm
//   c = BN_c(conv_c 1x1 (b))                Cm -> Co
//   y = relu(c + r),  r = x, or BN_p(conv_proj 1x1 (x))
//
// Replaces tools/proto_block_kernel.py::_make_block (the Pallas TPU prototype
// of the block); its oracle is _xla_reference there, the JAX Bottleneck3D,
// and bottleneck_reference in shgvqa_tpu_torch/kernels/bottleneck.py.
//
// Numerics (as the TPU kernel and the JAX Bottleneck3D): x and the weights
// bf16; each product accumulates in f32 and is rounded to bf16; BN is the
// folded bf16 (scale, shift), applied in bf16 (the product rounded, then the
// sum); ReLU; the residual sum is rounded to bf16 before the last ReLU.
//
// What bounds it on the card: per position 2 * (Ci*Cm + 9*Cm^2 + Cm*Co
// [+ Ci*Co]) operations against 2 * (Ci + Co) bytes, ~50-150 a byte at the
// trunk's widths, under the H100's ~295: device memory, if a and b never
// leave the chip.  That is the fusion: unfused, the block writes and reads
// back a, b, c and the residual sum, and each BN and ReLU is a pass of its own.
//
// Design: row bands with a halo.  The TPU kernel kept a whole frame in VMEM;
// a res_2 frame (56 x 56 x 256 bf16, 1.6 MB) does not fit in 227 KB.
// - One block of 8 warps takes R output rows of one frame (R <= 8, as many
//   as fit in shared memory, balanced over the frame's height).
// - conv_a runs on the R + 2 rows the 3x3 needs, recomputing the one-row
//   halo of each neighbour, and its BN + ReLU output goes into a shared tile
//   of (R + 2) x (W + 2) positions.  The padding is applied to a, not to x:
//   the tile's border columns and the halo rows outside the frame are zero.
// - conv_b is an implicit product over the 9 taps: each lane hands ldmatrix
//   the address of its own position shifted by the tap, so no tap is copied.
//   Its BN + ReLU output b stays in shared memory.
// - conv_c (and the projection) then run per 128-column chunk of Co; the
//   epilogue applies BN, adds the residual (x read from device memory, or
//   the projection kept in registers as bf16) and the ReLU, and stores y.
// - Every product is ldmatrix + mma.sync m16n8k16 (bf16 in, f32 sums) on
//   passes of 128 positions, warps 4 (M) x 2 (N).  Its B operand, the
//   weights ([n][k] rows, K contiguous), and for conv_a and the projection
//   its A operand, x, stream through a 3-stage cp.async ring of 16 KB tiles:
//   all blocks read the same weights, which stay in L2.  conv_b's weights,
//   [Cm][3][3][Cm] (295 KB at Cm = 128), stream tap by tap.
// - Shared tiles store 16-byte chunk c of row r at c ^ (r % 8) (ldmatrix
//   without bank conflicts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;                            // positions per product pass
constexpr int kBK = 64;                             // channels per K step
constexpr int kStages = 3;
constexpr int kTileBytes = kBM * kBK * 2;           // 16 KB; a B tile is at most as large
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kRingBytes = kStages * kStageBytes;   // 96 KB
constexpr int kMaxRows = 8;
constexpr int kSmemLimit = 232448;                  // what a block can have on sm_90

struct Params {
  const bf16 *x, *wa, *sa, *ba, *wb, *sb, *bb, *wc, *sc, *bc, *wp, *sp, *bp;
  bf16* y;
  int h, w, ci, co, rows, bands;
};

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

// Byte offset of 16-byte chunk c of row r in a tile of row_bytes-long rows.
__device__ __forceinline__ uint32_t swz(int r, int c, int row_bytes) {
  return static_cast<uint32_t>(r * row_bytes + ((c ^ (r & 7)) << 4));
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// BN of a product's f32 sum in bf16: the sum rounded, times the scale
// (rounded), plus the shift (rounded).
__device__ __forceinline__ float bn(float acc, float scale, float shift) {
  return round_bf16(round_bf16(round_bf16(acc) * scale) + shift);
}

// Two adjacent bf16 values of a read-only array, as floats.
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// BN scale and shift pairs of the NT n8 column tiles of a warp, columns
// n0 + 8 j and n0 + 8 j + 1 (loaded before an epilogue's stores).
template <int NT>
__device__ __forceinline__ void load_bn(float2 (&s)[NT], float2 (&t)[NT], const bf16* scale,
                                        const bf16* shift, int n0) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j] = load_pair(scale + n0 + 8 * j);
    t[j] = load_pair(shift + n0 + 8 * j);
  }
}

// The weight rows [0, rows) of w (row length ld), K columns k0..k0+63, into
// the B tile of stage st.
__device__ __forceinline__ void copy_b(uint32_t st, const bf16* w, int ld, int k0, int rows) {
  const int chunk = threadIdx.x & 7, lrow = threadIdx.x >> 3;
  for (int r = lrow; r < rows; r += kThreads / 8) {
    cp_async16(st + kTileBytes + swz(r, chunk, 128), w + static_cast<long long>(r) * ld + k0 +
                                                         chunk * 8, 16);
  }
}

// Rows of x a thread copies into the A tile of a pass: rows lrow + 32 j of
// the tile, chunk tid % 8; a row outside the frame (or the pass) reads zeros.
struct XRows {
  const bf16* ptr[4];
  bool ok[4];

  // Positions p0 + row of a band whose position 0 is image row r_first,
  // column 0; `count` positions are in the pass's range.
  __device__ XRows(const Params& p, long long frame, int r_first, int p0, int count) {
    const int chunk = threadIdx.x & 7, lrow = threadIdx.x >> 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pos = p0 + lrow + 32 * j;
      const int ir = r_first + pos / p.w;
      ok[j] = pos < count && ir >= 0 && ir < p.h;
      ptr[j] = ok[j] ? p.x + (frame + static_cast<long long>(ir) * p.w + pos % p.w) * p.ci +
                           chunk * 8
                     : p.x;
    }
  }

  __device__ void copy(uint32_t st, int k0) const {
    const int chunk = threadIdx.x & 7, lrow = threadIdx.x >> 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cp_async16(st + swz(lrow + 32 * j, chunk, 128), ok[j] ? ptr[j] + k0 : ptr[j],
                 ok[j] ? 16 : 0);
    }
  }
};

// This lane's ldmatrix row of A in the ring's A tile.
__device__ __forceinline__ uint32_t ring_a(uint32_t st, int i, int kk) {
  const int lane = threadIdx.x % 32, wm = threadIdx.x / 64;
  return st + swz(wm * 32 + i * 16 + (lane & 15), kk * 2 + (lane >> 4), 128);
}

// acc += A . B^T over `steps` K steps of 64 on a tile of 128 rows x 16 NT
// columns (warps 4 x 2, each on 32 x 8 NT).  issue(s, st) starts the copies
// of step s into stage st of the ring (every thread takes part);
// a_addr(st, s, i, kk) is this lane's ldmatrix row of A for m16 tile i and
// k16 slice kk of step s; B is the stage's second tile, [n][k] in 128-byte
// rows.  Returns with the ring drained and every thread past its last read.
template <int NT, class Issue, class AAddr>
__device__ __forceinline__ void cta_gemm(float (&acc)[2][NT][4], int steps, uint32_t ring,
                                         const Issue& issue, const AAddr& a_addr) {
  const int lane = threadIdx.x % 32, wn = (threadIdx.x / 32) % 2;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s, ring + s * kStageBytes);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();   // step s landed (this thread's copies)
    __syncthreads();                // ... everyone's; and step s-1's stage is free
    const int next = s + kStages - 1;
    if (next < steps) issue(next, ring + (next % kStages) * kStageBytes);
    cp_async_commit();
    const uint32_t st = ring + (s % kStages) * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldsm_x4(a[i], a_addr(st, s, i, kk));
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldsm_x4(b, st + kTileBytes + swz(wn * 8 * NT + p * 16 + (lane & 7) + ((lane >> 4) << 3),
                                         kk * 2 + ((lane >> 3) & 1), 128));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816(acc[i][2 * p], a[i], b[0], b[1]);
          mma16816(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }
}

size_t smem_bytes(int rows, int w, int cm) {
  return kRingBytes + static_cast<size_t>(rows + 2) * (w + 2) * cm * 2 +
         static_cast<size_t>(rows) * w * cm * 2;
}

template <int CM>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRowBytes = CM * 2;   // a row of the a and b tiles
  constexpr int NTM = CM / 16;        // n8 tiles a warp in the Cm-wide products
  constexpr int kStepsCM = CM / kBK;  // K steps over Cm
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int gr = lane / 4, q = (lane % 4) * 2;
  const int f = blockIdx.x / p.bands;
  const int r0 = (blockIdx.x % p.bands) * p.rows;
  const int rv = min(p.rows, p.h - r0);                 // output rows of this block
  const int wp2 = p.w + 2;
  const long long frame = static_cast<long long>(f) * p.h * p.w;
  const uint32_t ring = smem_addr(smem);
  unsigned char* a_tile = smem + kRingBytes;            // (R + 2) x (W + 2) x Cm
  unsigned char* b_tile = a_tile + (p.rows + 2) * wp2 * kRowBytes;   // R x W x Cm
  const uint32_t as = smem_addr(a_tile), bs = smem_addr(b_tile);

  // border columns of the a tile: the 3x3's zero padding
  for (int i = tid; i < (p.rows + 2) * 2 * (CM / 8); i += kThreads) {
    const int side = i / (CM / 8);
    const int row = (side / 2) * wp2 + (side % 2) * (p.w + 1);
    *reinterpret_cast<uint4*>(a_tile + swz(row, i % (CM / 8), kRowBytes)) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // conv_a + BN_a + ReLU on rows r0-1 .. r0+R of the frame -> the a tile
  const int pa = (p.rows + 2) * p.w;
  for (int p0 = 0; p0 < pa; p0 += kBM) {
    const XRows xr(p, frame, r0 - 1, p0, pa);
    float acc[2][NTM][4];
    zero(acc);
    cta_gemm<NTM>(
        acc, p.ci / kBK, ring,
        [&](int s, uint32_t st) {
          xr.copy(st, s * kBK);
          copy_b(st, p.wa, p.ci, s * kBK, CM);
        },
        [&](uint32_t st, int, int i, int kk) { return ring_a(st, i, kk); });
    float2 s[NTM], t[NTM];
    load_bn<NTM>(s, t, p.sa, p.ba, wn * 8 * NTM + q);
#pragma unroll
    for (int j = 0; j < NTM; ++j) {
      const int n = wn * 8 * NTM + j * 8 + q;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pos = p0 + wm * 32 + i * 16 + gr + half * 8;
          if (pos >= pa) continue;
          const int br = pos / p.w, ir = r0 - 1 + br;
          float v0 = 0.0f, v1 = 0.0f;
          if (ir >= 0 && ir < p.h) {
            v0 = fmaxf(bn(acc[i][j][2 * half], s[j].x, t[j].x), 0.0f);
            v1 = fmaxf(bn(acc[i][j][2 * half + 1], s[j].y, t[j].y), 0.0f);
          }
          const int idx = br * wp2 + pos % p.w + 1;
          *reinterpret_cast<__nv_bfloat162*>(a_tile + swz(idx, n / 8, kRowBytes) + (n % 8) * 2) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }

  // conv_b (9 taps read in place from the a tile) + BN_b + ReLU -> the b tile
  const int pb = rv * p.w;
  for (int p0 = 0; p0 < pb; p0 += kBM) {
    int idx0[2];   // this lane's A rows: a-tile position of tap (0, 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = min(p0 + wm * 32 + i * 16 + (lane & 15), pb - 1);
      idx0[i] = (pos / p.w) * wp2 + pos % p.w;
    }
    float acc[2][NTM][4];
    zero(acc);
    cta_gemm<NTM>(
        acc, 9 * kStepsCM, ring,
        [&](int s, uint32_t st) { copy_b(st, p.wb, 9 * CM, s * kBK, CM); },
        [&](uint32_t, int s, int i, int kk) {
          const int tap = s / kStepsCM, kc = s % kStepsCM;
          const int idx = idx0[i] + (tap / 3) * wp2 + tap % 3;
          return as + swz(idx, kc * 8 + kk * 2 + (lane >> 4), kRowBytes);
        });
    float2 s[NTM], t[NTM];
    load_bn<NTM>(s, t, p.sb, p.bb, wn * 8 * NTM + q);
#pragma unroll
    for (int j = 0; j < NTM; ++j) {
      const int n = wn * 8 * NTM + j * 8 + q;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pos = p0 + wm * 32 + i * 16 + gr + half * 8;
          if (pos >= pb) continue;
          *reinterpret_cast<__nv_bfloat162*>(b_tile + swz(pos, n / 8, kRowBytes) + (n % 8) * 2) =
              __floats2bfloat162_rn(fmaxf(bn(acc[i][j][2 * half], s[j].x, t[j].x), 0.0f),
                                    fmaxf(bn(acc[i][j][2 * half + 1], s[j].y, t[j].y), 0.0f));
        }
      }
    }
  }

  // conv_c + BN_c, + the residual, ReLU -> y; per pass and 128 columns of Co
  for (int p0 = 0; p0 < pb; p0 += kBM) {
    const XRows xr(p, frame, r0, p0, pb);
    int brow[2];   // this lane's A rows in the b tile
#pragma unroll
    for (int i = 0; i < 2; ++i) brow[i] = min(p0 + wm * 32 + i * 16 + (lane & 15), pb - 1);
    for (int n0 = 0; n0 < p.co; n0 += 128) {
      float acc[2][8][4];
      uint32_t res[2][8][2];   // BN_p(conv_proj(x)) as bf16 pairs
      if (p.wp != nullptr) {
        zero(acc);
        const bf16* wp = p.wp + static_cast<long long>(n0) * p.ci;
        cta_gemm<8>(
            acc, p.ci / kBK, ring,
            [&](int s, uint32_t st) {
              xr.copy(st, s * kBK);
              copy_b(st, wp, p.ci, s * kBK, 128);
            },
            [&](uint32_t st, int, int i, int kk) { return ring_a(st, i, kk); });
        float2 s[8], t[8];
        load_bn<8>(s, t, p.sp, p.bp, n0 + wn * 64 + q);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const __nv_bfloat162 v =
                  __floats2bfloat162_rn(bn(acc[i][j][2 * half], s[j].x, t[j].x),
                                        bn(acc[i][j][2 * half + 1], s[j].y, t[j].y));
              res[i][j][half] = *reinterpret_cast<const uint32_t*>(&v);
            }
          }
        }
      }
      zero(acc);
      const bf16* wc = p.wc + static_cast<long long>(n0) * CM;
      cta_gemm<8>(
          acc, kStepsCM, ring,
          [&](int s, uint32_t st) { copy_b(st, wc, CM, s * kBK, 128); },
          [&](uint32_t, int s, int i, int kk) {
            return bs + swz(brow[i], s * 8 + kk * 2 + (lane >> 4), kRowBytes);
          });
      // every load of the epilogue before its first store: y may alias x
      // for all the compiler knows, and would keep each load behind the
      // store before it
      float2 s[8], t[8];
      load_bn<8>(s, t, p.sc, p.bc, n0 + wn * 64 + q);
      long long out[2][2];   // the output position of rows (i, half)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pos = min(p0 + wm * 32 + i * 16 + gr + half * 8, pb - 1);
          out[i][half] = frame + static_cast<long long>(r0 + pos / p.w) * p.w + pos % p.w;
        }
      }
      if (p.wp == nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              res[i][j][half] = __ldg(reinterpret_cast<const unsigned int*>(
                  p.x + out[i][half] * p.ci + n0 + wn * 64 + j * 8 + q));
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + wn * 64 + j * 8 + q;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (p0 + wm * 32 + i * 16 + gr + half * 8 >= pb) continue;
            const float2 r =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[i][j][half]));
            const float c0 = bn(acc[i][j][2 * half], s[j].x, t[j].x);
            const float c1 = bn(acc[i][j][2 * half + 1], s[j].y, t[j].y);
            *reinterpret_cast<__nv_bfloat162*>(p.y + out[i][half] * p.co + n) =
                __floats2bfloat162_rn(fmaxf(c0 + r.x, 0.0f), fmaxf(c1 + r.y, 0.0f));
          }
        }
      }
    }
  }
}

// Rows a block takes: the most (up to kMaxRows) whose tiles fit, balanced
// over the height; 0 when not even one row fits.
int band_rows(int h, int w, int cm) {
  int rows = kMaxRows < h ? kMaxRows : h;
  while (rows > 0 && smem_bytes(rows, w, cm) > static_cast<size_t>(kSmemLimit)) --rows;
  if (rows == 0) return 0;
  const int bands = (h + rows - 1) / rows;
  return (h + bands - 1) / bands;
}

template <int CM>
cudaError_t launch(const Params& p, int n, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.rows, p.w, CM);
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<CM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bottleneck_kernel<CM><<<n * p.bands, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the block on `stream`; returns cudaGetLastError() (0 = launched).
// Device pointers, bf16, contiguous, 16-byte aligned: x (n, h, w, ci); wa
// (cm, ci); wb (cm, 3, 3, cm) [out][kh][kw][in]; wc (co, cm); wp (co, ci) or
// null (then ci == co); the folded BN scale and shift sa, ba, sb, bb (cm),
// sc, bc, sp, bp (co); y (n, h, w, co).  cm is 64 or 128, ci % 64 == 0,
// co % 128 == 0; frames too wide for one row band in shared memory are
// refused.
int shgvqa_bottleneck_bf16(const void* x, const void* wa, const void* sa, const void* ba,
                           const void* wb, const void* sb, const void* bb, const void* wc,
                           const void* sc, const void* bc, const void* wp, const void* sp,
                           const void* bp, void* y, int n, int h, int w, int ci, int cm, int co,
                           void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || ci <= 0 || ci % kBK != 0 || co <= 0 || co % 128 != 0 ||
      (cm != 64 && cm != 128) || (wp == nullptr && ci != co) ||
      (wp != nullptr && (sp == nullptr || bp == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.wa = static_cast<const bf16*>(wa);
  p.sa = static_cast<const bf16*>(sa);
  p.ba = static_cast<const bf16*>(ba);
  p.wb = static_cast<const bf16*>(wb);
  p.sb = static_cast<const bf16*>(sb);
  p.bb = static_cast<const bf16*>(bb);
  p.wc = static_cast<const bf16*>(wc);
  p.sc = static_cast<const bf16*>(sc);
  p.bc = static_cast<const bf16*>(bc);
  p.wp = static_cast<const bf16*>(wp);
  p.sp = static_cast<const bf16*>(sp);
  p.bp = static_cast<const bf16*>(bp);
  p.y = static_cast<bf16*>(y);
  p.h = h;
  p.w = w;
  p.ci = ci;
  p.co = co;
  p.rows = band_rows(h, w, cm);
  if (p.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.bands = (h + p.rows - 1) / p.rows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cm == 64 ? launch<64>(p, n, s) : launch<128>(p, n, s);
  return static_cast<int>(err);
}

const char* shgvqa_bottleneck_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
