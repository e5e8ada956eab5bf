// Fused multi-head attention for Hopper (sm_90a), forward and backward, with
// dropout on the probabilities inside the kernels:
//
//   S = Q K^T / sqrt(64) + key_row[b] + pane      (f32)
//   P = softmax(S) (f32, normalized), lse = logsumexp(S) saved per row
//   O = bf16(dropout(P)) . V                       (f32 sums, bf16 out)
//
// Replaces shgvqa_tpu/kernels/attention.py::_make_core, the Pallas TPU
// kernels _fwd_kernel (forward) and _bwd_kernel (backward) behind the JAX
// fused_attention; the plain versions are attention_reference and
// attention_backward_reference in shgvqa_tpu_torch/kernels/attention.py.
//
// Numerics (as the TPU kernels): Q, K, V, dO bf16 with head dim 64; every
// product accumulates in f32; the mask is additive f32, split into a
// per-batch key row (B, Lk) and a shared (Lq, Lk) pane (either may be
// absent); the normalized f32 probabilities are dropped, scaled by
// 1/keep and only then rounded to bf16; dS is rounded to bf16 before the
// dQ and dK products, which are scaled by 1/sqrt(64) in f32.  One
// departure: delta = rowsum(dP * P) is taken as rowsum(dO * O) (equal in
// exact arithmetic; O is the bf16 forward output), which lets the
// backward split into blocks over keys.
//
// Dropout: keep(q, k) = bits >= threshold, threshold = round(rate * 2^32),
// where bits is a word of Philox4x32-10 keyed on the call's 64-bit seed
// (read from device memory, so drawing it costs the host no sync) with the
// counter (q / 2, k / 2, batch*head, 0): one Philox call covers a 2 x 2
// block of (query, key), word 2 * (q % 2) + k % 2.  The backward
// regenerates the forward's mask; shgvqa_attention_keep_mask writes it.
//
// What bounds it on the card: per (batch, head) 4*Lq*Lk*64 operations
// forward (10*Lq*Lk*64 backward) against ~(Lq + Lk)*64*2*2 bytes (twice
// that backward): at most ~200 operations a byte at the model's lengths
// (Lq = Lk = 393), under the H100's ~295, so device memory bounds it at
// every main-path shape.  The (Lq, Lk) scores and probabilities never
// leave the chip, which is what the fusion is for.
//
// Design (simple and right first; wgmma/TMA/warp specialisation later):
// - lengths are ragged (40, 48, 128, 177, 393): tiles are 64 rows, rows past
//   the end are zero-filled on load, masked (-inf or zero probability) in
//   the softmax and never stored;
// - forward: one block of 4 warps per (query tile, batch*head), 16 query
//   rows a warp, Q fragments held in registers.  Two passes over the key
//   tiles: the first takes the row max and sum (online, with the max
//   guarded so that a key tile masked wholly by -inf gives no NaN), the
//   second recomputes S, forms the normalized P, drops it and multiplies by
//   V.  Two passes keep the TPU kernel's rounding: the normalized
//   probabilities are what is rounded to bf16;
// - backward, two kernels on one stream:
//   dq: one block per (query tile, batch*head): delta = rowsum(dO * O) for
//       its rows (written out for the second kernel), then over the key
//       tiles S, P = exp(S - lse), dP = (dO V^T) / (1 - rate) where kept
//       and 0 where dropped, dS = P (dP - delta), dQ += dS K;
//   dkdv: one block per (key tile, batch*head), 16 keys a warp, K and V
//       fragments in registers; over the query tiles it forms S^T and P^T,
//       dV += dropout(P)^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q.
//   No atomics: every output row is written by one block.
// - products are ldmatrix (.trans where the operand is stored [k][n]) +
//   mma.sync m16n8k16 bf16 with f32 sums; a probability or dS tile goes
//   from the accumulators to the next product's A operand in registers.
// - operands are read through (batch, head, row) strides with the head dim
//   contiguous, so the model's (B, L, H, 64) projections need no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kD = 64;                 // head dim
constexpr int kTile = 64;              // rows of a query or key tile
constexpr int kWarps = 4;              // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kD + 8;            // bf16 row of a shared tile: 144 bytes
constexpr int kKSteps = kD / 16;       // k16 steps over the head dim
constexpr int kNTiles = kTile / 8;     // n8 tiles across a 64-wide tile

struct Strides {
  long long b, h, l;                   // elements; the head dim is contiguous
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const float* key_mask;               // (B, Lk) or null
  const float* pane;                   // (Lq, Lk) or null
  const long long* seed;               // 2 values on the device (dropout only)
  float* lse;                          // (B*H, Lq)
  float* delta;                        // (B*H, Lq), backward scratch
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int heads, lq, lk;
  float scale, inv_keep;
  uint32_t threshold;
  int dropout;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
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

// rows row0.. of one (batch, head) operand into a shared tile; rows at or
// past `rows` are zero.  Completes (and is visible) after the caller's
// cp_async_wait_all + __syncthreads.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long stride, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < kTile * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    bf16* d = dst + r * kLd + c;
    if (row0 + r < rows) {
      cp_async16(d, base + static_cast<long long>(row0 + r) * stride + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// acc[j] (n8 tiles j = 0..7 across 64 columns of `bt`) = a . bt^T over the
// head dim, with a in registers (kKSteps k16 fragments) and bt stored [n][k].
__device__ __forceinline__ void product_nk(float (&acc)[kNTiles][4],
                                           const uint32_t (&a)[kKSteps][4], const bf16* bt,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
    for (int p = 0; p < kNTiles / 2; ++p) {
      uint32_t b[4];
      load_b_nk(b, bt, p * 16, kk * 16, lane);
      mma16816(acc[2 * p], a[kk], b[0], b[1]);
      mma16816(acc[2 * p + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[j] (n8 tiles over the head dim) += x . t, where x (16 rows x 64) is
// given as accumulator tiles in f32 and rounded to bf16 here, and t is a
// shared tile stored [k][n] (64 rows of k).
__device__ __forceinline__ void product_kn(float (&acc)[kNTiles][4],
                                           const float (&x)[kNTiles][4], const bf16* t,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int p = 0; p < kNTiles / 2; ++p) {
      uint32_t b[4];
      load_b_kn(b, t, kk * 16, p * 16, lane);
      mma16816(acc[2 * p], a, b[0], b[1]);
      mma16816(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

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

// The words of the 2 x 2 (query, key) block holding (q, k) of problem gi.
__device__ __forceinline__ uint4 keep_words(uint2 key, int gi, int q, int k) {
  return philox(make_uint4(static_cast<uint32_t>(q) >> 1, static_cast<uint32_t>(k) >> 1,
                           static_cast<uint32_t>(gi), 0u),
                key);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
}

__device__ __forceinline__ uint2 seed_key(const Params& p) {
  return p.dropout ? make_uint2(static_cast<uint32_t>(p.seed[0]), static_cast<uint32_t>(p.seed[1]))
                   : make_uint2(0u, 0u);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Scores of a query-row layout tile: s (rows `rows[0..1]`, key columns
// k0 + 8 j + c + {0, 1}) scaled, plus the masks; keys at or past lk are -inf.
__device__ __forceinline__ void mask_scores(float (&s)[kNTiles][4], const Params& p, int b,
                                            const int (&rows)[2], int k0, int c) {
  const float* km = p.key_mask ? p.key_mask + static_cast<long long>(b) * p.lk : nullptr;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float* pane = (p.pane && rows[half] < p.lq)
                            ? p.pane + static_cast<long long>(rows[half]) * p.lk
                            : nullptr;
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
          if (pane) v += pane[col];
        }
        s[j][2 * half + x] = v;
      }
    }
  }
}

// Keep bits of a query-row layout tile as a 32-bit mask, bit 4 j + e.
__device__ __forceinline__ uint32_t keep_rows(const Params& p, uint2 key, int gi,
                                              const int (&rows)[2], int k0, int c) {
  uint32_t bits = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rows[half];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const uint4 w = keep_words(key, gi, r, k0 + j * 8 + c);
      if (word(w, 2 * (r & 1)) >= p.threshold) bits |= 1u << (4 * j + 2 * half);
      if (word(w, 2 * (r & 1) + 1) >= p.threshold) bits |= 1u << (4 * j + 2 * half + 1);
    }
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(const Params p) {
  __shared__ __align__(16) bf16 qs[kTile * kLd];
  __shared__ __align__(16) bf16 ks[kTile * kLd];
  __shared__ __align__(16) bf16 vs[kTile * kLd];
  const int gi = blockIdx.y;
  const int b = gi / p.heads, h = gi % p.heads;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = (lane % 4) * 2;
  const int rows[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  const bf16* kbase = p.k + b * p.sk.b + h * p.sk.h;
  const bf16* vbase = p.v + b * p.sv.b + h * p.sv.h;
  const uint2 key = seed_key(p);

  load_tile(qs, p.q + b * p.sq.b + h * p.sq.h, p.sq.l, q0, p.lq);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) load_a(qf[kk], qs, warp * 16, kk * 16, lane);

  // pass 1: row max and sum of exp over all keys
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float s[kNTiles][4];
  for (int k0 = 0; k0 < p.lk; k0 += kTile) {
    __syncthreads();
    load_tile(ks, kbase, p.sk.l, k0, p.lk);
    cp_async_wait_all();
    __syncthreads();
    product_nk(s, qf, ks, lane);
    mask_scores(s, p, b, rows, k0, c);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      const float mnew = fmaxf(m[half], quad_max(mx));
      const float mu = mnew == -INFINITY ? 0.0f : mnew;   // no (-inf) - (-inf)
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        sum += expf(s[j][2 * half] - mu) + expf(s[j][2 * half + 1] - mu);
      }
      l[half] = l[half] * expf(m[half] - mu) + quad_sum(sum);
      m[half] = mnew;
    }
  }
  float mu[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mu[half] = m[half] == -INFINITY ? 0.0f : m[half];
    if (lane % 4 == 0 && rows[half] < p.lq) {
      p.lse[static_cast<long long>(gi) * p.lq + rows[half]] =
          l[half] > 0.0f ? m[half] + logf(l[half]) : -INFINITY;
    }
  }

  // pass 2: O = dropout(P) . V with P normalized
  float o[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  }
  for (int k0 = 0; k0 < p.lk; k0 += kTile) {
    __syncthreads();
    load_tile(ks, kbase, p.sk.l, k0, p.lk);
    load_tile(vs, vbase, p.sv.l, k0, p.lk);
    cp_async_wait_all();
    __syncthreads();
    product_nk(s, qf, ks, lane);
    mask_scores(s, p, b, rows, k0, c);
    const uint32_t keep = p.dropout ? keep_rows(p, key, gi, rows, k0, c) : 0xffffffffu;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        float pn = l[half] > 0.0f ? expf(s[j][e] - mu[half]) / l[half] : 0.0f;
        if (p.dropout) pn = ((keep >> (4 * j + e)) & 1u) ? pn * p.inv_keep : 0.0f;
        s[j][e] = pn;
      }
    }
    product_kn(o, s, vs, lane);
  }

  bf16* obase = p.o + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (rows[half] >= p.lq) continue;
    bf16* orow = obase + static_cast<long long>(rows[half]) * p.so.l;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c) =
          __floats2bfloat162_rn(o[j][2 * half], o[j][2 * half + 1]);
    }
  }
}

// Backward, query side: delta for the block's rows, then dQ.
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(const Params p) {
  __shared__ __align__(16) bf16 qs[kTile * kLd];
  __shared__ __align__(16) bf16 dos[kTile * kLd];
  __shared__ __align__(16) bf16 ks[kTile * kLd];
  __shared__ __align__(16) bf16 vs[kTile * kLd];
  __shared__ float delta_s[kTile];
  const int gi = blockIdx.y;
  const int b = gi / p.heads, h = gi % p.heads;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = (lane % 4) * 2;
  const int rows[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  const bf16* kbase = p.k + b * p.sk.b + h * p.sk.h;
  const bf16* vbase = p.v + b * p.sv.b + h * p.sv.h;
  const uint2 key = seed_key(p);

  load_tile(qs, p.q + b * p.sq.b + h * p.sq.h, p.sq.l, q0, p.lq);
  load_tile(dos, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.l, q0, p.lq);
  load_tile(ks, p.o + b * p.so.b + h * p.so.h, p.so.l, q0, p.lq);   // O, for delta
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    float acc = 0.0f;
    for (int d = 0; d < kD; ++d) {
      acc += __bfloat162float(dos[r * kLd + d]) * __bfloat162float(ks[r * kLd + d]);
    }
    delta_s[r] = acc;
    if (q0 + r < p.lq) p.delta[static_cast<long long>(gi) * p.lq + q0 + r] = acc;
  }
  uint32_t qf[kKSteps][4], df[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    load_a(qf[kk], qs, warp * 16, kk * 16, lane);
    load_a(df[kk], dos, warp * 16, kk * 16, lane);
  }
  float lse[2], delta[2];
  __syncthreads();   // delta_s is written
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    lse[half] = rows[half] < p.lq ? p.lse[static_cast<long long>(gi) * p.lq + rows[half]] : 0.0f;
    delta[half] = delta_s[warp * 16 + lane / 4 + 8 * half];
  }

  float dq[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;
  }
  float s[kNTiles][4], dp[kNTiles][4];
  for (int k0 = 0; k0 < p.lk; k0 += kTile) {
    __syncthreads();
    load_tile(ks, kbase, p.sk.l, k0, p.lk);
    load_tile(vs, vbase, p.sv.l, k0, p.lk);
    cp_async_wait_all();
    __syncthreads();
    product_nk(s, qf, ks, lane);
    mask_scores(s, p, b, rows, k0, c);
    product_nk(dp, df, vs, lane);
    const uint32_t keep = p.dropout ? keep_rows(p, key, gi, rows, k0, c) : 0xffffffffu;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        const bool live = rows[half] < p.lq && lse[half] != -INFINITY;
        const float pr = live ? expf(s[j][e] - lse[half]) : 0.0f;
        float d = dp[j][e];
        if (p.dropout) d = ((keep >> (4 * j + e)) & 1u) ? d * p.inv_keep : 0.0f;
        s[j][e] = pr * (d - delta[half]);   // dS
      }
    }
    product_kn(dq, s, ks, lane);
  }

  bf16* qbase = p.dq + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (rows[half] >= p.lq) continue;
    bf16* row = qbase + static_cast<long long>(rows[half]) * p.sdq.l;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + c) =
          __floats2bfloat162_rn(dq[j][2 * half] * p.scale, dq[j][2 * half + 1] * p.scale);
    }
  }
}

// Backward, key side: dK and dV for the block's keys, over all query tiles.
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv_kernel(const Params p) {
  __shared__ __align__(16) bf16 ks[kTile * kLd];
  __shared__ __align__(16) bf16 vs[kTile * kLd];
  __shared__ __align__(16) bf16 qs[kTile * kLd];
  __shared__ __align__(16) bf16 dos[kTile * kLd];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  const int gi = blockIdx.y;
  const int b = gi / p.heads, h = gi % p.heads;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = (lane % 4) * 2;
  const int keys[2] = {k0 + warp * 16 + lane / 4, k0 + warp * 16 + lane / 4 + 8};
  const bf16* qbase = p.q + b * p.sq.b + h * p.sq.h;
  const bf16* dobase = p.dout + b * p.sdo.b + h * p.sdo.h;
  const uint2 key = seed_key(p);

  load_tile(ks, p.k + b * p.sk.b + h * p.sk.h, p.sk.l, k0, p.lk);
  load_tile(vs, p.v + b * p.sv.b + h * p.sv.h, p.sv.l, k0, p.lk);
  cp_async_wait_all();
  __syncthreads();
  uint32_t kf[kKSteps][4], vf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    load_a(kf[kk], ks, warp * 16, kk * 16, lane);
    load_a(vf[kk], vs, warp * 16, kk * 16, lane);
  }
  float km[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    km[half] = (p.key_mask && keys[half] < p.lk)
                   ? p.key_mask[static_cast<long long>(b) * p.lk + keys[half]]
                   : 0.0f;
  }

  float dk[kNTiles][4], dv[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[j][e] = 0.0f;
      dv[j][e] = 0.0f;
    }
  }
  float st[kNTiles][4], dpt[kNTiles][4];
  for (int q0 = 0; q0 < p.lq; q0 += kTile) {
    __syncthreads();
    load_tile(qs, qbase, p.sq.l, q0, p.lq);
    load_tile(dos, dobase, p.sdo.l, q0, p.lq);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      const long long at = static_cast<long long>(gi) * p.lq + r;
      lse_s[threadIdx.x] = r < p.lq ? p.lse[at] : 0.0f;
      delta_s[threadIdx.x] = r < p.lq ? p.delta[at] : 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();
    product_nk(st, kf, qs, lane);   // S^T: rows keys, columns queries
    product_nk(dpt, vf, dos, lane); // (dO V^T)^T
    uint32_t keep = 0xffffffffu;
    if (p.dropout) {
      keep = 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kr = keys[half];
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          const uint4 w = keep_words(key, gi, q0 + j * 8 + c, kr);   // queries c, c + 1
          if (word(w, kr & 1) >= p.threshold) keep |= 1u << (4 * j + 2 * half);
          if (word(w, 2 + (kr & 1)) >= p.threshold) keep |= 1u << (4 * j + 2 * half + 1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        const int kr = keys[half];
        const int qi = j * 8 + c + (e & 1);
        const int qr = q0 + qi;
        float pr = 0.0f;
        if (kr < p.lk && qr < p.lq && lse_s[qi] != -INFINITY) {
          float sv = st[j][e] * p.scale + km[half];
          if (p.pane) sv += p.pane[static_cast<long long>(qr) * p.lk + kr];
          pr = expf(sv - lse_s[qi]);
        }
        const bool kept = !p.dropout || ((keep >> (4 * j + e)) & 1u);
        float d = dpt[j][e];
        if (p.dropout) d = kept ? d * p.inv_keep : 0.0f;
        dpt[j][e] = pr * (d - delta_s[qi]);                 // dS^T
        st[j][e] = kept ? (p.dropout ? pr * p.inv_keep : pr) : 0.0f;   // dropout(P)^T
      }
    }
    product_kn(dv, st, dos, lane);
    product_kn(dk, dpt, qs, lane);
  }

  bf16* kout = p.dk + b * p.sdk.b + h * p.sdk.h;
  bf16* vout = p.dv + b * p.sdv.b + h * p.sdv.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (keys[half] >= p.lk) continue;
    bf16* krow = kout + static_cast<long long>(keys[half]) * p.sdk.l;
    bf16* vrow = vout + static_cast<long long>(keys[half]) * p.sdv.l;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow + j * 8 + c) =
          __floats2bfloat162_rn(dk[j][2 * half] * p.scale, dk[j][2 * half + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + j * 8 + c) =
          __floats2bfloat162_rn(dv[j][2 * half], dv[j][2 * half + 1]);
    }
  }
}

// The keep mask of a call, (B*H, Lq, Lk) uint8, one block per (row, problem).
__global__ void keep_mask_kernel(const long long* seed, uint8_t* out, int lq, int lk,
                                 uint32_t threshold) {
  const int gi = blockIdx.y, r = blockIdx.x;
  const uint2 key = make_uint2(static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(seed[1]));
  uint8_t* row = out + (static_cast<long long>(gi) * lq + r) * lk;
  for (int col = threadIdx.x * 2; col < lk; col += blockDim.x * 2) {
    const uint4 w = keep_words(key, gi, r, col);
    row[col] = word(w, 2 * (r & 1)) >= threshold;
    if (col + 1 < lk) row[col + 1] = word(w, 2 * (r & 1) + 1) >= threshold;
  }
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

Params make_params(const void* q, const void* k, const void* v, const void* key_mask,
                   const void* pane, const void* seed, int heads, int lq, int lk, float scale,
                   unsigned threshold, float inv_keep, int dropout) {
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.key_mask = static_cast<const float*>(key_mask);
  p.pane = static_cast<const float*>(pane);
  p.seed = static_cast<const long long*>(seed);
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.scale = scale;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  p.dropout = dropout;
  return p;
}

bool bad_shape(int batch, int heads, int lq, int lk, int dropout, const void* seed) {
  return batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || batch * heads > 65535 ||
         (dropout && seed == nullptr);
}

}  // namespace

extern "C" {

// Forward on `stream`; returns cudaGetLastError() (0 = launched).  q, k, v,
// o: bf16 (B, H, L, 64) through `strides` (12 values: batch, head, row
// strides in elements of q, k, v, o; the head dim contiguous; every row
// 16-byte aligned); key_mask (B, Lk) and pane (Lq, Lk) f32 or null; seed
// (2 int64 on the device, read when dropout != 0); lse (B*H, Lq) f32 out.
int shgvqa_attention_fwd_bf16(const void* q, const void* k, const void* v, const void* key_mask,
                              const void* pane, const void* seed, void* o, void* lse,
                              const long long* strides, int batch, int heads, int lq, int lk,
                              float scale, unsigned threshold, float inv_keep, int dropout,
                              void* stream) {
  if (bad_shape(batch, heads, lq, lk, dropout, seed)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, key_mask, pane, seed, heads, lq, lk, scale, threshold,
                         inv_keep, dropout);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  const dim3 grid((lq + kTile - 1) / kTile, batch * heads);
  attn_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Backward on `stream` (two kernels); returns cudaGetLastError().  As the
// forward, plus o (the forward's output) and dout, dq, dk, dv bf16 through
// `strides` (24 values: q, k, v, o, dout, dq, dk, dv); lse from the
// forward; delta (B*H, Lq) f32 scratch.
int shgvqa_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* key_mask,
                              const void* pane, const void* seed, const void* o, const void* lse,
                              const void* dout, void* delta, void* dq, void* dk, void* dv,
                              const long long* strides, int batch, int heads, int lq, int lk,
                              float scale, unsigned threshold, float inv_keep, int dropout,
                              void* stream) {
  if (bad_shape(batch, heads, lq, lk, dropout, seed)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, key_mask, pane, seed, heads, lq, lk, scale, threshold,
                         inv_keep, dropout);
  p.o = const_cast<bf16*>(static_cast<const bf16*>(o));
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.dout = static_cast<const bf16*>(dout);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  p.sdo = strides_at(strides, 4);
  p.sdq = strides_at(strides, 5);
  p.sdk = strides_at(strides, 6);
  p.sdv = strides_at(strides, 7);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  attn_bwd_dq_kernel<<<dim3((lq + kTile - 1) / kTile, batch * heads), kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<<<dim3((lk + kTile - 1) / kTile, batch * heads), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The keep mask (B*H, Lq, Lk) uint8 that a call with this seed and
// threshold draws; for holding the kernels to their plain version.
int shgvqa_attention_keep_mask(const void* seed, void* out, int groups, int lq, int lk,
                               unsigned threshold, void* stream) {
  if (groups <= 0 || groups > 65535 || lq <= 0 || lk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  keep_mask_kernel<<<dim3(lq, groups), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), static_cast<uint8_t*>(out), lq, lk, threshold);
  return static_cast<int>(cudaGetLastError());
}

const char* shgvqa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
