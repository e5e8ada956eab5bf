// Fused multi-head attention for Hopper (sm_90a), forward and backward, with
// dropout on the probabilities inside the kernels:
//
//   S = Q K^T / sqrt(64) + key_row[b] + pane      (f32)
//   P = softmax(S), lse = logsumexp(S) saved per row
//   O = dropout(P) . V                             (f32 sums, bf16 out)
//
// Replaces shgvqa_tpu/kernels/attention.py::_make_core, the Pallas TPU
// kernels _fwd_kernel (forward) and _bwd_kernel (backward) behind the JAX
// fused_attention; the plain versions are attention_reference and
// attention_backward_reference in shgvqa_tpu_torch/kernels/attention.py.
// The forward's rate-0 instance also replaces
// tools/proto_headsliced_attn.py::make_headsliced: kernels/headsliced.py
// launches it on the (B, L, H*64) projections' own strides (batch L*H*64,
// head 64, row H*64), so the head panes are read in place
// (headsliced_reference is that plain version).
//
// What bounds it on the card: per (batch, head) 4*Lq*Lk*64 operations
// forward (10*Lq*Lk*64 backward) against ~(Lq + Lk)*64*2*2 bytes (twice
// that backward): at most ~200 operations a byte at the model's lengths
// (Lq = Lk = 393), under the H100's ~295, so device memory bounds it at
// every main-path shape.  The (Lq, Lk) scores and probabilities never
// leave the chip.  Below the bound the kernels are issue-bound, so the
// design does each product and each exponential once, keeps the next tile
// in flight while the current one is used, and draws the dropout bits
// with a quarter of a Philox call per element.
//
// Design:
// - ragged lengths (40, 48, 128, 177, 393): tiles are 64 rows, rows past
//   the end are zero-filled on load, keys past Lk get -inf, rows past the
//   end are never stored;
// - products are ldmatrix (.trans where the operand is stored [k][n], or
//   for an A operand stored [k][m]) + mma.sync m16n8k16 bf16 with f32 sums;
//   a probability or dS tile goes from the accumulators to the next
//   product's A operand in registers;
// - operands are read through (batch, head, row) strides with the head dim
//   contiguous, so the model's (B, L, H, 64) projections need no copy;
// - forward (attn_fwd_kernel): one block of 4 warps per (64-query tile,
//   batch*head), 16 query rows a warp, the Q tile read from shared memory
//   at each key tile, 3 blocks an SM with no register spill (4 blocks at
//   128 registers spill and read no faster; 128-query blocks of 8 warps
//   were slower at the model's shapes).  One pass over the key tiles: K, V and the key row's
//   mask (-inf past Lk, so the score loop reads no device memory and tests
//   no bounds) stream through two shared buffers with cp.async, the next
//   tile in flight while the current one is used.  Online softmax: running
//   max m and sum l in f32, the output accumulator rescaled by
//   exp(m_old - m_new) per tile, exponentials as one ex2 each; each lane
//   sums its own columns into l and the quad adds its four sums at the
//   end.  A tile whose keys are all -inf for a row (the situation-causal
//   pane) leaves m at -inf, and the exponent then uses 0 in place of m.
//   l sums exp(S - m) before dropout; the dropped tile is rounded to bf16
//   for the PV product, and O is scaled by (1/keep) / l at the end.
//   lse = m + log(l) (+inf for a row with every key masked, so that the
//   backward's exp(S - lse) is 0 there).  The rate-0 instance is compiled
//   without any Philox work;
// - backward, three launches on one stream:
//   attn_bwd_prep_kernel: delta = rowsum(dO * O) per query row, and the f32
//       dQ accumulator (B*H, Lq, 64) zeroed;
//   attn_bwd_kernel: one block of 4 warps per (64-key tile, batch*head), 16
//       keys a warp with their K and V fragments in registers and dK, dV
//       summed in registers; the query tiles (Q, dO, lse, delta) stream
//       through two shared buffers with cp.async.  For each it forms S^T,
//       P^T = exp(S^T - lse) and the keep bits once, then dV += bf16(
//       dropout(P))^T dO, dP^T = V dO^T, dS^T = P^T (dropout(dP)^T - delta),
//       dK += bf16(dS)^T Q; dS^T goes to shared memory as bf16 and each warp
//       takes 16 query rows of dQ += dS K, added into the accumulator with
//       sm_90's vector f32 atomics (atomicAdd on float2 pairs);
//   attn_bwd_dq_kernel: dQ = bf16(accumulator / sqrt(64)) into the strided
//       output.
//
// Numerics.  Q, K, V, dO bf16 with head dim 64; every product accumulates
// in f32; the mask is additive f32, split into a per-batch key row (B, Lk)
// and a shared (Lq, Lk) pane (either may be absent; the pane may hold
// -inf); the backward takes the normalized P from the saved lse, rounds dS
// to bf16 before the dQ and dK products and scales them by 1/sqrt(64) in
// f32.  Departures from the TPU kernels:
// - the forward rounds the unnormalized exp(S - m) to bf16 for the PV
//   product and divides by l at the end; the TPU kernel rounds the
//   normalized, dropped probabilities (as the head-sliced kernel does);
// - delta = rowsum(dP * P) is taken as rowsum(dO * O) (equal in exact
//   arithmetic; O is the bf16 forward output), which lets the backward
//   walk blocks of keys;
// - dQ is summed over the key tiles with f32 atomics, so its summation
//   order, and its last bits, vary from run to run (dK, dV and the forward
//   are deterministic).
//
// Dropout: keep(q, k) = bits >= threshold, threshold = round(rate * 2^32),
// where bits is a word of Philox4x32-10 keyed on the call's 64-bit seed
// (read from device memory, so drawing it costs the host no sync).  One
// call covers the queries {q, q + 8} x keys {k, k + 8} with q and k at an
// offset < 8 in their 16-block: counter (8 * (q / 16) + q % 8,
// 8 * (k / 16) + k % 8, group, 0), word 2 * ((q / 8) % 2) +
// (k / 8) % 2.  In the m16n8k16 accumulator layout one lane owns exactly
// such a 2 x 2 block, in the forward's query-row tiles and in the
// backward's key-row S^T tiles alike, so each call is made once, by one
// lane, and all four of its words are used.  The backward regenerates the
// forward's mask; shgvqa_attention_keep_mask writes it
// (keep_mask_reference is its plain version).  The group of (batch b, head
// h) of a call is group0 + b * heads_global + head0 + h: in one process
// group0 = 0, heads_global = heads and head0 = 0, so the group is the
// call's b * H + h.  A data-parallel rank passes its first global batch row
// times the global heads as group0; a tensor-parallel rank, holding heads
// head0 .. head0 + heads - 1 of heads_global, passes those, so each rank
// draws its rows and heads of the one-process mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kD = 64;                 // head dim
constexpr int kTile = 64;              // keys a tile (forward, backward); queries a backward tile
constexpr int kLd = kD + 8;            // bf16 row of a shared tile: 144 bytes
constexpr int kTileElems = kTile * kLd;
constexpr int kKSteps = kD / 16;       // k16 steps over the head dim (or over 64 keys)
constexpr int kNTiles = kTile / 8;     // n8 tiles across a 64-wide tile
constexpr int kFwdWarps = 4;           // 16 queries each: 64 a block
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdQRows = kFwdWarps * 16;
constexpr int kBwdThreads = 128;       // 4 warps, 16 keys each
constexpr int kRowThreads = 256;       // the row passes: 8 threads a 64-wide row

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
  float* dq_acc;                       // (B*H, Lq, 64) f32, backward scratch
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int heads, lq, lk;
  int group0;                          // the dropout counter's group offset
  int heads_global, head0;             // the group's heads and this call's first
  float scale, inv_keep;
  uint32_t threshold;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem)
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

// A operand: rows r0..r0+15, columns k0..k0+15 of a shared tile.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile, int r0, int k0,
                                       int lane) {
  ldsm_x4(r, tile + (r0 + lane % 16) * kLd + k0 + (lane / 16) * 8);
}

// The same from a tile stored [k][m] (rows are k), transposed by ldmatrix.
__device__ __forceinline__ void load_a_km(uint32_t (&r)[4], const bf16* tile, int m0, int k0,
                                          int lane) {
  ldsm_x4_trans(r, tile + (k0 + lane % 8 + (lane / 16) * 8) * kLd + m0 + ((lane / 8) % 2) * 8);
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

// `n` rows row0.. of one (batch, head) operand into a shared tile with
// cp.async; rows at or past `rows` are zero.  The caller commits the group.
template <int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, long long stride, int row0,
                                          int n, int rows) {
  for (int i = threadIdx.x; i < n * (kD / 8); i += kThreads) {
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

// The same with a read from rows r0..r0+15 of a shared tile, one k16 step
// at a time.
__device__ __forceinline__ void product_nk(float (&acc)[kNTiles][4], const bf16* at, int r0,
                                           const bf16* bt, int lane) {
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    uint32_t a[4];
    load_a(a, at, r0, kk * 16, lane);
#pragma unroll
    for (int p = 0; p < kNTiles / 2; ++p) {
      uint32_t b[4];
      load_b_nk(b, bt, p * 16, kk * 16, lane);
      mma16816(acc[2 * p], a, b[0], b[1]);
      mma16816(acc[2 * p + 1], a, b[2], b[3]);
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
  for (int i = 0; i < 10; ++i) {   // one wide multiply (IMAD.WIDE) gives each hi, lo pair
    const uint64_t p0 = static_cast<uint64_t>(0xD2511F53u) * c.x;
    const uint64_t p1 = static_cast<uint64_t>(0xCD9E8D57u) * c.z;
    const uint32_t hi0 = static_cast<uint32_t>(p0 >> 32), lo0 = static_cast<uint32_t>(p0);
    const uint32_t hi1 = static_cast<uint32_t>(p1 >> 32), lo1 = static_cast<uint32_t>(p1);
    c = make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return c;
}

// Keep bits of the (query, key) pairs of one Philox call, bit i for word i
// (word 2 * (q / 8 % 2) + k / 8 % 2); cq, ck are the counter's first words.
__device__ __forceinline__ uint32_t keep_bits(uint2 key, int gi, uint32_t cq, uint32_t ck,
                                              uint32_t threshold) {
  const uint4 w = philox(make_uint4(cq, ck, static_cast<uint32_t>(gi), 0u), key);
  return static_cast<uint32_t>(w.x >= threshold) | (static_cast<uint32_t>(w.y >= threshold) << 1) |
         (static_cast<uint32_t>(w.z >= threshold) << 2) |
         (static_cast<uint32_t>(w.w >= threshold) << 3);
}

// The counter word of index i in a 16-block starting at base (i < 8).
__device__ __forceinline__ uint32_t counter_word(int base, int i) {
  return (static_cast<uint32_t>(base) >> 4 << 3) | static_cast<uint32_t>(i);
}

__device__ __forceinline__ uint2 seed_key(const Params& p) {
  return make_uint2(static_cast<uint32_t>(p.seed[0]), static_cast<uint32_t>(p.seed[1]));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU.EX2 (2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kFwdSmemBytes = (kFwdQRows + 4 * kTile) * kLd * static_cast<int>(sizeof(bf16)) +
                               2 * kTile * static_cast<int>(sizeof(float));

// The key row's mask of keys k0..k0+63 into shared memory: the batch's key
// mask (or 0), -inf past Lk.  The caller commits the group.
__device__ __forceinline__ void load_key_row(float* dst, const float* km, int k0, int lk) {
  if (threadIdx.x < kTile) {
    const int col = k0 + threadIdx.x;
    if (col < lk && km) {
      cp_async4(dst + threadIdx.x, km + col);
    } else {
      dst[threadIdx.x] = col < lk ? 0.0f : -INFINITY;
    }
  }
}

// Shared memory: the Q tile (16 rows a warp), then K, V and the key row's
// mask, two buffers each.
// (at most 168 registers, which the kernel fits without spilling: 3 blocks
// of 4 warps an SM)
template <bool kDropout>
__global__ void __launch_bounds__(kFwdThreads, 3) attn_fwd_kernel(const Params p) {
  constexpr int kThreads = kFwdThreads, kQRows = kFwdQRows;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kQRows * kLd;
  bf16* vs = ks + 2 * kTileElems;
  float* kms = reinterpret_cast<float*>(vs + 2 * kTileElems);
  const int gi = blockIdx.y;
  const int b = gi / p.heads, h = gi % p.heads;
  const int group = p.group0 + b * p.heads_global + p.head0 + h;   // its dropout counter group
  const int q0 = blockIdx.x * kQRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = (lane % 4) * 2;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bf16* kbase = p.k + b * p.sk.b + h * p.sk.h;
  const bf16* vbase = p.v + b * p.sv.b + h * p.sv.h;
  const float* km = p.key_mask ? p.key_mask + static_cast<long long>(b) * p.lk : nullptr;
  const float* pane[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    pane[half] = (p.pane && rows[half] < p.lq)
                     ? p.pane + static_cast<long long>(rows[half]) * p.lk
                     : nullptr;
  }
  uint2 key = make_uint2(0u, 0u);
  if (kDropout) key = seed_key(p);
  const uint32_t cq = counter_word(q0 + warp * 16, g);   // the lane's rows {g, g + 8}

  // Q and the first key tile in one group
  load_rows<kThreads>(qs, p.q + b * p.sq.b + h * p.sq.h, p.sq.l, q0, kQRows, p.lq);
  load_rows<kThreads>(ks, kbase, p.sk.l, 0, kTile, p.lk);
  load_rows<kThreads>(vs, vbase, p.sv.l, 0, kTile, p.lk);
  load_key_row(kms, km, 0, p.lk);
  cp_async_commit();

  // l: this lane's share of the row sums, summed over the quad at the end
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  }
  float s[kNTiles][4];
  const int tiles = (p.lk + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t % 2;
    const bf16* kt = ks + buf * kTileElems;
    const bf16* vt = vs + buf * kTileElems;
    const float* kmt = kms + buf * kTile;
    if (t + 1 < tiles) {   // the next tile into the other buffer, freed at the end of step t-1
      load_rows<kThreads>(ks + (buf ^ 1) * kTileElems, kbase, p.sk.l, (t + 1) * kTile, kTile,
                          p.lk);
      load_rows<kThreads>(vs + (buf ^ 1) * kTileElems, vbase, p.sv.l, (t + 1) * kTile, kTile,
                          p.lk);
      load_key_row(kms + (buf ^ 1) * kTile, km, (t + 1) * kTile, p.lk);
    }
    cp_async_commit();     // (an empty group on the last step)
    cp_async_wait<1>();    // tile t (and Q) landed
    __syncthreads();
    product_nk(s, qs, warp * 16, kt, lane);   // S = Q K^T

    // scale, masks, online softmax; s becomes exp(S - m)
    const int k0 = t * kTile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float v = fmaf(s[j][2 * half + x], p.scale, kmt[j * 8 + c + x]);   // -inf past Lk
          if (pane[half]) v += pane[half][min(k0 + j * 8 + c + x, p.lk - 1)];
          s[j][2 * half + x] = v;
          mx = fmaxf(mx, v);
        }
      }
      const float mnew = fmaxf(m[half], quad_max(mx));
      const float mu = mnew == -INFINITY ? 0.0f : mnew;   // no (-inf) - (-inf)
      const float alpha = exp2_approx((m[half] - mu) * kLog2e);   // 0 while m was -inf
      const float mu2 = mu * kLog2e;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float e = exp2_approx(fmaf(s[j][2 * half + x], kLog2e, -mu2));
          s[j][2 * half + x] = e;
          sum += e;
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) o[j][2 * half + x] *= alpha;
      }
      l[half] = l[half] * alpha + sum;
      m[half] = mnew;
    }

    if (kDropout) {   // one Philox call per (n8 pair jp, column offset x): rows {g, g+8} x keys {col, col+8}
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const uint32_t bits =
              keep_bits(key, group, cq, counter_word(k0 + jp * 16, c + x), p.threshold);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              float& e = s[2 * jp + jj][2 * half + x];
              e = ((bits >> (2 * half + jj)) & 1u) ? e : 0.0f;
            }
          }
        }
      }
    }

    // O += bf16(dropout(exp(S - m))) . V
    product_kn(o, s, vt, lane);
    __syncthreads();   // buffer `buf` is free for tile t+2
  }

  bf16* obase = p.o + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) l[half] = quad_sum(l[half]);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (rows[half] >= p.lq) continue;
    if (lane % 4 == 0) {
      p.lse[static_cast<long long>(gi) * p.lq + rows[half]] =
          l[half] > 0.0f ? m[half] + logf(l[half]) : INFINITY;
    }
    const float inv = l[half] > 0.0f ? (kDropout ? p.inv_keep : 1.0f) / l[half] : 0.0f;
    bf16* orow = obase + static_cast<long long>(rows[half]) * p.so.l;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c) =
          __floats2bfloat162_rn(o[j][2 * half] * inv, o[j][2 * half + 1] * inv);
    }
  }
}

// Backward, first launch: delta = rowsum(dO * O) of every query row, and the
// row's f32 dQ accumulator zeroed.  8 threads a row, 8 head-dim values each.
__global__ void __launch_bounds__(kRowThreads) attn_bwd_prep_kernel(const Params p, int rows) {
  const int row = blockIdx.x * (kRowThreads / 8) + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  float acc = 0.0f;
  if (row < rows) {
    const int gi = row / p.lq, qi = row % p.lq;
    const int b = gi / p.heads, h = gi % p.heads;
    const uint4 ov = *reinterpret_cast<const uint4*>(p.o + b * p.so.b + h * p.so.h +
                                                     qi * p.so.l + part * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(p.dout + b * p.sdo.b + h * p.sdo.h +
                                                     qi * p.sdo.l + part * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), d = __bfloat1622float2(d2[i]);
      acc += a.x * d.x + a.y * d.y;
    }
    float4* z = reinterpret_cast<float4*>(p.dq_acc + static_cast<long long>(row) * kD + part * 8);
    z[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    z[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < rows && part == 0) p.delta[row] = acc;
}

constexpr int kBwdSmemBytes =
    6 * kTileElems * static_cast<int>(sizeof(bf16)) + 4 * kTile * static_cast<int>(sizeof(float));

// Backward, the fused kernel: dK and dV of the block's keys, and their share
// of dQ.  Shared memory (55 KB): the K tile (kept for dQ), the dS^T tile
// (holding V until its fragments are taken), two buffers each of Q, dO,
// lse and delta.  K and V fragments, dK and dV stay in registers (up to
// 255 a thread, no spill: 2 blocks of 4 warps an SM).
template <bool kDropout>
__global__ void __launch_bounds__(kBwdThreads) attn_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* dss = ks + kTileElems;
  bf16* qs = dss + kTileElems;          // 2 buffers
  bf16* dos = qs + 2 * kTileElems;      // 2 buffers
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTileElems);   // 2 x kTile
  float* delta_s = lse_s + 2 * kTile;                               // 2 x kTile
  const int gi = blockIdx.y;
  const int b = gi / p.heads, h = gi % p.heads;
  const int group = p.group0 + b * p.heads_global + p.head0 + h;   // its dropout counter group
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = (lane % 4) * 2;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const bf16* qbase = p.q + b * p.sq.b + h * p.sq.h;
  const bf16* dobase = p.dout + b * p.sdo.b + h * p.sdo.h;
  const long long lbase = static_cast<long long>(gi) * p.lq;
  uint2 key = make_uint2(0u, 0u);
  if (kDropout) key = seed_key(p);
  const uint32_t ck = counter_word(k0 + warp * 16, g);   // the lane's keys {g, g + 8}

  // the query tile q0's Q, dO, lse (+inf past Lq: P = 0 there) and delta
  auto load_query_tile = [&](int q0, int buf) {
    load_rows<kBwdThreads>(qs + buf * kTileElems, qbase, p.sq.l, q0, kTile, p.lq);
    load_rows<kBwdThreads>(dos + buf * kTileElems, dobase, p.sdo.l, q0, kTile, p.lq);
    const int r = threadIdx.x % kTile;
    float* dst = (threadIdx.x < kTile ? lse_s : delta_s) + buf * kTile + r;
    const float* src = (threadIdx.x < kTile ? p.lse : p.delta) + lbase + q0 + r;
    if (q0 + r < p.lq) {
      cp_async4(dst, src);
    } else {
      *dst = threadIdx.x < kTile ? INFINITY : 0.0f;
    }
  };

  load_rows<kBwdThreads>(ks, p.k + b * p.sk.b + h * p.sk.h, p.sk.l, k0, kTile, p.lk);
  load_rows<kBwdThreads>(dss, p.v + b * p.sv.b + h * p.sv.h, p.sv.l, k0, kTile, p.lk);
  load_query_tile(0, 0);
  cp_async_commit();

  // the key row's mask; -inf past Lk, so that P^T = 0 there
  float km[2];
  const float* pane[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bool live = keys[half] < p.lk;
    km[half] = !live ? -INFINITY
                     : (p.key_mask ? p.key_mask[static_cast<long long>(b) * p.lk + keys[half]]
                                   : 0.0f);
    pane[half] = p.pane ? p.pane + (live ? keys[half] : p.lk - 1) : nullptr;   // column
  }

  uint32_t kf[kKSteps][4], vf[kKSteps][4];
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
  const int tiles = (p.lq + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t % 2;
    const int q0 = t * kTile;
    const bf16* qt = qs + buf * kTileElems;
    const bf16* dot = dos + buf * kTileElems;
    const float* lse_t = lse_s + buf * kTile;
    const float* delta_t = delta_s + buf * kTile;
    if (t + 1 < tiles) load_query_tile(q0 + kTile, buf ^ 1);   // buffer freed in step t-1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        load_a(kf[kk], ks, warp * 16, kk * 16, lane);
        load_a(vf[kk], dss, warp * 16, kk * 16, lane);
      }
      __syncthreads();   // V is read: dss takes dS^T from here on
    }

    // S^T (rows keys, columns queries) and P^T = exp(S^T - lse)
    product_nk(st, kf, qt, lane);
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + c + (e & 1);
        float sv = fmaf(st[j][e], p.scale, km[e / 2]);
        if (p.pane) sv += pane[e / 2][static_cast<long long>(min(q0 + qi, p.lq - 1)) * p.lk];
        st[j][e] = exp2_approx((sv - lse_t[qi]) * kLog2e);
      }
    }
    // keep bits, bit 4 j + e: one Philox call per (n8 pair jp, column offset x)
    uint32_t keep = 0xffffffffu;
    if (kDropout) {
      keep = 0u;
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const uint32_t bits =
              keep_bits(key, group, counter_word(q0 + jp * 16, c + x), ck, p.threshold);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              keep |= ((bits >> (2 * jj + half)) & 1u) << (4 * (2 * jp + jj) + 2 * half + x);
            }
          }
        }
      }
    }
    // dV += bf16(dropout(P))^T dO, with dropout(P)^T in dpt for now
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpt[j][e] = !kDropout ? st[j][e]
                              : (((keep >> (4 * j + e)) & 1u) ? st[j][e] * p.inv_keep : 0.0f);
      }
    }
    product_kn(dv, dpt, dot, lane);
    // dP^T = V dO^T; dS^T = P^T (dropout(dP)^T - delta)
    product_nk(dpt, vf, dot, lane);
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float d = dpt[j][e];
        if (kDropout) d = ((keep >> (4 * j + e)) & 1u) ? d * p.inv_keep : 0.0f;
        dpt[j][e] = st[j][e] * (d - delta_t[j * 8 + c + (e & 1)]);
      }
    }
    // dK += bf16(dS)^T Q; bf16(dS^T) into shared memory for dQ
    product_kn(dk, dpt, qt, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      bf16* row = dss + (warp * 16 + g + 8 * half) * kLd + c;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(row + j * 8) =
            __floats2bfloat162_rn(dpt[j][2 * half], dpt[j][2 * half + 1]);
      }
    }
    __syncthreads();   // dS^T is whole; the buffer `buf` is read for the last time above

    // dQ += dS K over the block's 64 keys: warp w takes query rows 16 w..16 w+15
    float dq[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t a[4];
      load_a_km(a, dss, warp * 16, kk * 16, lane);
#pragma unroll
      for (int pp = 0; pp < kNTiles / 2; ++pp) {
        uint32_t bb[4];
        load_b_kn(bb, ks, kk * 16, pp * 16, lane);
        mma16816(dq[2 * pp], a, bb[0], bb[1]);
        mma16816(dq[2 * pp + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qr = q0 + warp * 16 + g + 8 * half;
      if (qr >= p.lq) continue;
      float* row = p.dq_acc + (lbase + qr) * kD + c;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        atomicAdd(reinterpret_cast<float2*>(row + j * 8),
                  make_float2(dq[j][2 * half], dq[j][2 * half + 1]));
      }
    }
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

// Backward, last launch: dQ = bf16(accumulator * scale) into the strided
// output.  8 threads a row, 8 head-dim values each.
__global__ void __launch_bounds__(kRowThreads) attn_bwd_dq_kernel(const Params p, int rows) {
  const int row = blockIdx.x * (kRowThreads / 8) + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  if (row >= rows) return;
  const int gi = row / p.lq, qi = row % p.lq;
  const int b = gi / p.heads, h = gi % p.heads;
  const float4* src =
      reinterpret_cast<const float4*>(p.dq_acc + static_cast<long long>(row) * kD + part * 8);
  const float4 x = src[0], y = src[1];
  uint4 out;
  out.x = pack_bf16(x.x * p.scale, x.y * p.scale);
  out.y = pack_bf16(x.z * p.scale, x.w * p.scale);
  out.z = pack_bf16(y.x * p.scale, y.y * p.scale);
  out.w = pack_bf16(y.z * p.scale, y.w * p.scale);
  *reinterpret_cast<uint4*>(p.dq + b * p.sdq.b + h * p.sdq.h + qi * p.sdq.l + part * 8) = out;
}

// The keep mask of a call, (B*H, Lq, Lk) uint8: one thread per Philox call,
// which decides the four (query, key) pairs of its counter.
__global__ void keep_mask_kernel(const long long* seed, uint8_t* out, int lq, int lk,
                                 uint32_t threshold, int group0, int heads,
                                 int heads_global, int head0) {
  const int gi = blockIdx.y;
  const int group = group0 + gi / heads * heads_global + head0 + gi % heads;
  const uint2 key = make_uint2(static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(seed[1]));
  const int ny = (lk + 15) / 16 * 8;
  const int calls = (lq + 15) / 16 * 8 * ny;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < calls; i += gridDim.x * blockDim.x) {
    const int cq = i / ny, ck = i % ny;
    const uint32_t bits = keep_bits(key, group, static_cast<uint32_t>(cq),
                                    static_cast<uint32_t>(ck), threshold);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int q = (cq >> 3) * 16 + (w >> 1) * 8 + (cq & 7);
      const int k = (ck >> 3) * 16 + (w & 1) * 8 + (ck & 7);
      if (q < lq && k < lk) {
        out[(static_cast<long long>(gi) * lq + q) * lk + k] = static_cast<uint8_t>((bits >> w) & 1u);
      }
    }
  }
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

Params make_params(const void* q, const void* k, const void* v, const void* key_mask,
                   const void* pane, const void* seed, int heads, int lq, int lk, float scale,
                   unsigned threshold, float inv_keep) {
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
  return p;
}

bool bad_shape(int batch, int heads, int lq, int lk, int dropout, const void* seed) {
  return batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || batch * heads > 65535 ||
         static_cast<long long>(batch) * heads * lq > (1LL << 30) || (dropout && seed == nullptr);
}

template <typename Kernel>
cudaError_t launch_dynamic(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                           const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward on `stream`; returns cudaGetLastError() (0 = launched).  q, k, v,
// o: bf16 (B, H, L, 64) through `strides` (12 values: batch, head, row
// strides in elements of q, k, v, o; the head dim contiguous; every row
// 16-byte aligned); key_mask (B, Lk) and pane (Lq, Lk) f32 or null; seed
// (2 int64 on the device, read when dropout != 0); group0, heads_global and
// head0 place the call's (batch, head) groups in the counter (group0 + b *
// heads_global + head0 + h; 0, heads, 0 in one process); lse (B*H, Lq) f32
// out.
int shgvqa_attention_fwd_bf16(const void* q, const void* k, const void* v, const void* key_mask,
                              const void* pane, const void* seed, void* o, void* lse,
                              const long long* strides, int batch, int heads, int lq, int lk,
                              float scale, unsigned threshold, float inv_keep, int dropout,
                              int group0, int heads_global, int head0, void* stream) {
  if (bad_shape(batch, heads, lq, lk, dropout, seed)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, key_mask, pane, seed, heads, lq, lk, scale, threshold, inv_keep);
  p.group0 = group0;
  p.heads_global = heads_global;
  p.head0 = head0;
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((lq + kFwdQRows - 1) / kFwdQRows, batch * heads);
  const cudaError_t err =
      dropout ? launch_dynamic(attn_fwd_kernel<true>, grid, kFwdThreads, kFwdSmemBytes, s, p)
              : launch_dynamic(attn_fwd_kernel<false>, grid, kFwdThreads, kFwdSmemBytes, s, p);
  return static_cast<int>(err);
}

// Backward on `stream` (three launches); returns cudaGetLastError().  As the
// forward, plus o (the forward's output) and dout, dq, dk, dv bf16 through
// `strides` (24 values: q, k, v, o, dout, dq, dk, dv); lse from the
// forward; delta (B*H, Lq) and dq_acc (B*H, Lq, 64) f32 scratch, dq_acc
// 16-byte aligned.
int shgvqa_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* key_mask,
                              const void* pane, const void* seed, const void* o, const void* lse,
                              const void* dout, void* delta, void* dq_acc, void* dq, void* dk,
                              void* dv, const long long* strides, int batch, int heads, int lq,
                              int lk, float scale, unsigned threshold, float inv_keep,
                              int dropout, int group0, int heads_global, int head0,
                              void* stream) {
  if (bad_shape(batch, heads, lq, lk, dropout, seed)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, key_mask, pane, seed, heads, lq, lk, scale, threshold, inv_keep);
  p.group0 = group0;
  p.heads_global = heads_global;
  p.head0 = head0;
  p.o = const_cast<bf16*>(static_cast<const bf16*>(o));
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.dout = static_cast<const bf16*>(dout);
  p.delta = static_cast<float*>(delta);
  p.dq_acc = static_cast<float*>(dq_acc);
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
  const int rows = batch * heads * lq;
  const int row_blocks = (rows + kRowThreads / 8 - 1) / (kRowThreads / 8);
  attn_bwd_prep_kernel<<<row_blocks, kRowThreads, 0, s>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lk + kTile - 1) / kTile, batch * heads);
  err = dropout ? launch_dynamic(attn_bwd_kernel<true>, grid, kBwdThreads, kBwdSmemBytes, s, p)
                : launch_dynamic(attn_bwd_kernel<false>, grid, kBwdThreads, kBwdSmemBytes, s, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<<<row_blocks, kRowThreads, 0, s>>>(p, rows);
  return static_cast<int>(cudaGetLastError());
}

// The keep mask (B*H, Lq, Lk) uint8 that a call with this seed and
// threshold draws, its groups `heads` heads a batch row placed as the
// forward's (group0, heads_global, head0); for holding the kernels to their
// plain version.
int shgvqa_attention_keep_mask(const void* seed, void* out, int groups, int lq, int lk,
                               unsigned threshold, int group0, int heads, int heads_global,
                               int head0, void* stream) {
  if (groups <= 0 || groups > 65535 || lq <= 0 || lk <= 0 || heads <= 0 || groups % heads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int calls = (lq + 15) / 16 * 8 * ((lk + 15) / 16 * 8);
  const int blocks = min((calls + 255) / 256, 64);
  keep_mask_kernel<<<dim3(blocks, groups), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), static_cast<uint8_t*>(out), lq, lk, threshold, group0,
      heads, heads_global, head0);
  return static_cast<int>(cudaGetLastError());
}

const char* shgvqa_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
