// Head-sliced multi-head attention for Hopper (sm_90a), forward only, on the
// projections' own (B, L, H*64) layout:
//
//   for every head h: S = Q_h K_h^T / sqrt(64) + key_row[b] + pane   (f32)
//                     O_h = softmax(S) . V_h                          (f32 sums)
//
// where X_h is the 64-column pane h*64 .. h*64+63 of every row of X, and O
// is written into (B, Lq, H*64) directly.
//
// Replaces tools/proto_headsliced_attn.py::make_headsliced (the Pallas TPU
// prototype that slices the head panes inside the kernel instead of
// transposing to (B, H, L, 64) and back); its plain version is
// headsliced_reference in shgvqa_tpu_torch/kernels/headsliced.py.
//
// Numerics: Q, K, V bf16; the products accumulate in f32; scores, masks and
// softmax in f32; the mask is additive, split into a per-batch key row
// (B, Lk) and a shared (Lq, Lk) pane (either may be absent; the pane may
// hold -inf).  One departure from the prototype: the softmax is one online
// pass, so the probabilities rounded to bf16 for the PV product are
// exp(S - running max), and the row sum divides the f32 output at the end,
// where the prototype rounds the normalized probabilities.
//
// What bounds it on the card: per (batch, head) 4*Lq*Lk*64 operations
// against ~(Lq + Lk)*64*2*2 bytes: at most ~200 operations a byte at the
// model's lengths (Lq = Lk = 393), under the H100's ~295, so device memory
// bounds it at every main-path shape.  The (Lq, Lk) scores never leave the
// chip, and neither does any transposed copy of Q, K, V or O: each block
// reads its head's 128-byte pane of each row straight from the rows.
//
// Design (simple and right first):
// - one block of 4 warps per (64-query tile, head, batch), 16 query rows a
//   warp with their Q fragments in registers.  The prototype ran one program
//   per batch row over all 12 heads with the whole (Lq, Lk) score block
//   resident (2 programs at B=2, 618 KB of f32 scores at 393 x 393); here
//   the grid is (query tiles, 12, B) and a block keeps one 64 x 64 score
//   tile per step in registers;
// - the key tiles (64 keys of K and V) stream through two shared buffers
//   with cp.async, the next tile in flight while the current one is used;
//   ragged lengths are zero-filled on load, keys past Lk get -inf, query
//   rows past Lq are never stored;
// - online softmax per row: running max m and sum l in f32, the output
//   accumulator rescaled by exp(m_old - m_new) per tile.  A tile whose keys
//   are all -inf for a row (the situation-causal pane) leaves m at -inf: the
//   exponent then uses 0 in place of m, so no -inf - -inf is formed;
// - products are ldmatrix (.trans for V, stored [k][n]) + mma.sync
//   m16n8k16 bf16 with f32 sums; the probability tile goes from the score
//   accumulators to the PV product's A operand in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kD = 64;                 // head dim
constexpr int kTile = 64;              // rows of a query or key tile
constexpr int kWarps = 4;              // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;            // bf16 row of a shared tile: 144 bytes
constexpr int kKSteps = kD / 16;       // k16 steps over the head dim
constexpr int kNTiles = kTile / 8;     // n8 tiles across a 64-wide tile

struct Params {
  const bf16* q;                       // (B, Lq, H*64)
  const bf16* k;                       // (B, Lk, H*64)
  const bf16* v;                       // (B, Lk, H*64)
  bf16* o;                             // (B, Lq, H*64)
  const float* key_mask;               // (B, Lk) or null
  const float* pane;                   // (Lq, Lk) or null
  int heads, lq, lk;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand: rows r0..r0+15, head-dim columns k0..k0+15 of a shared tile.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile, int r0, int k0,
                                       int lane) {
  ldsm_x4(r, tile + (r0 + lane % 16) * kLd + k0 + (lane / 16) * 8);
}

// B operands of the n8 tiles n0 and n0+8 over k0..k0+15, from a tile stored
// [n][k] (rows are n): r[0..1] for n0, r[2..3] for n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const bf16* tile, int n0, int k0,
                                          int lane) {
  ldsm_x4(r, tile + (n0 + lane % 8 + (lane / 16) * 8) * kLd + k0 + ((lane / 8) % 2) * 8);
}

// The same from a tile stored [k][n] (rows are k), transposed by ldmatrix.
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const bf16* tile, int k0, int n0,
                                          int lane) {
  ldsm_x4_trans(r, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * kLd + n0 + (lane / 16) * 8);
}

// The 64-column pane at `base` of rows row0.. (row stride `ld` elements)
// into a shared tile with cp.async; rows at or past `rows` are zero.
__device__ __forceinline__ void load_pane(bf16* dst, const bf16* base, int ld, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < kTile * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    bf16* d = dst + r * kLd + c;
    if (row0 + r < rows) {
      cp_async16(d, base + static_cast<long long>(row0 + r) * ld + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(kThreads) headsliced_attn_kernel(const Params p) {
  __shared__ __align__(16) bf16 qs[kTile * kLd];
  __shared__ __align__(16) bf16 ks[2][kTile * kLd];
  __shared__ __align__(16) bf16 vs[2][kTile * kLd];
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int ld = p.heads * kD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = (lane % 4) * 2;
  const int rows[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  const bf16* kbase = p.k + static_cast<long long>(b) * p.lk * ld + h * kD;
  const bf16* vbase = p.v + static_cast<long long>(b) * p.lk * ld + h * kD;
  const float* km = p.key_mask ? p.key_mask + static_cast<long long>(b) * p.lk : nullptr;
  const float* pane[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    pane[half] = (p.pane && rows[half] < p.lq)
                     ? p.pane + static_cast<long long>(rows[half]) * p.lk
                     : nullptr;
  }

  // Q and the first key tile in one group
  load_pane(qs, p.q + static_cast<long long>(b) * p.lq * ld + h * kD, ld, q0, p.lq);
  load_pane(ks[0], kbase, ld, 0, p.lk);
  load_pane(vs[0], vbase, ld, 0, p.lk);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  }
  uint32_t qf[kKSteps][4];
  float s[kNTiles][4];
  const int tiles = (p.lk + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t % 2;
    if (t + 1 < tiles) {   // the next tile into the other buffer, freed at the end of step t-1
      load_pane(ks[buf ^ 1], kbase, ld, (t + 1) * kTile, p.lk);
      load_pane(vs[buf ^ 1], vbase, ld, (t + 1) * kTile, p.lk);
    }
    cp_async_commit();     // (an empty group on the last step)
    cp_async_wait<1>();    // tile t (and Q) landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) load_a(qf[kk], qs, warp * 16, kk * 16, lane);
    }

    // S = Q K^T over the head dim
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int pp = 0; pp < kNTiles / 2; ++pp) {
        uint32_t bb[4];
        load_b_nk(bb, ks[buf], pp * 16, kk * 16, lane);
        mma16816(s[2 * pp], qf[kk], bb[0], bb[1]);
        mma16816(s[2 * pp + 1], qf[kk], bb[2], bb[3]);
      }
    }

    // scale, masks, online softmax
    const int k0 = t * kTile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int col = k0 + j * 8 + c + x;
          float v = s[j][2 * half + x] * p.scale;
          if (col >= p.lk) {
            v = -INFINITY;
          } else {
            if (km) v += km[col];
            if (pane[half]) v += pane[half][col];
          }
          s[j][2 * half + x] = v;
          mx = fmaxf(mx, v);
        }
      }
      const float mnew = fmaxf(m[half], quad_max(mx));
      const float mu = mnew == -INFINITY ? 0.0f : mnew;   // no (-inf) - (-inf)
      const float alpha = expf(m[half] - mu);             // 0 while m was -inf
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float e = expf(s[j][2 * half + x] - mu);
          s[j][2 * half + x] = e;
          sum += e;
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) o[j][2 * half + x] *= alpha;
      }
      l[half] = l[half] * alpha + quad_sum(sum);
      m[half] = mnew;
    }

    // O += bf16(P) . V
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int pp = 0; pp < kNTiles / 2; ++pp) {
        uint32_t bb[4];
        load_b_kn(bb, vs[buf], kk * 16, pp * 16, lane);
        mma16816(o[2 * pp], a, bb[0], bb[1]);
        mma16816(o[2 * pp + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();   // buffer `buf` is free for tile t+2
  }

  bf16* obase = p.o + static_cast<long long>(b) * p.lq * ld + h * kD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (rows[half] >= p.lq) continue;
    const float inv = l[half] > 0.0f ? 1.0f / l[half] : 0.0f;
    bf16* orow = obase + static_cast<long long>(rows[half]) * ld;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c) =
          __floats2bfloat162_rn(o[j][2 * half] * inv, o[j][2 * half + 1] * inv);
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
// Device pointers: q (B, Lq, H*64), k and v (B, Lk, H*64), o (B, Lq, H*64)
// bf16, contiguous and 16-byte aligned; key_mask (B, Lk) and pane (Lq, Lk)
// f32 contiguous, or null.
int shgvqa_headsliced_attn_bf16(const void* q, const void* k, const void* v,
                                const void* key_mask, const void* pane, void* o, int batch,
                                int heads, int lq, int lk, float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 || lq <= 0 || lk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.key_mask = static_cast<const float*>(key_mask);
  p.pane = static_cast<const float*>(pane);
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.scale = scale;
  const dim3 grid((lq + kTile - 1) / kTile, heads, batch);
  headsliced_attn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* shgvqa_headsliced_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
