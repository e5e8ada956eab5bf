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
// shgvqa_tpu_torch/kernels/qconv.py; the kernel is bit-equal to it.  The
// integer sums are exact in any order (the largest K, 4,608 at res_5's
// conv_b, times 127^2 stays below 2^31).  The epilogue keeps the plain
// version's rounding points: int32 -> f32 -> T by round to nearest even (as
// torch's acc.to(T)), each product and sum rounded to T once, quant() with
// the IEEE division and round half to even.  The wrapper reads no scale on
// the host: s_out and s_res are device pointers, scale and shift device
// vectors.
//
// What bounds it on the card: M = B*T*Ho*Wo output positions by N = Co over
// K = kT*kH*kW*Ci.  At the trunk's shapes the 1x1 convs have ~40-120 int8
// operations per byte moved, below the ~590 of the card's int8 rate (1,979
// TOP/s) over its 3.35 TB/s, so most launches are bound by bytes (3.68 of
// the 5.33 ms bound of a B=32 trunk forward); the 3x3 and deep convs by
// operations.
//
// It replaces the first design of this kernel (mma.sync m16n8k32 tiles fed
// by cp.async, one 128 x 128 tile a block, K steps of 64 channels, an
// epilogue of 2-byte stores), which ran at 6.3x its bound on an H100: mma.sync does not
// reach the int8 rate, a 1x1 conv of res_2 ran 1-4 K steps a block so the
// ring never filled, and no tile's loads overlapped another's epilogue.
// Design (an implicit GEMM on wgmma .s8 fed by TMA, warp-specialized and
// persistent):
// - Tiles of 256 output positions (128 in f32) by BN = 128 channels (64
//   where Co is not a multiple of 128).  One block an SM walks the tiles
//   (row-major over (row tile, column tile), block b takes tiles b, b +
//   grid, ...), so the producer loads the next tile while the consumers run
//   this tile's epilogue.  The tall tile halves, against 128 rows, the
//   weight loads, the TMA operations and the per-tile waits of each output.
// - A block is one producer warp and two consumer warpgroups.  The
//   producer's lane 0 keeps a ring of kStages stages (2 to 6, as shared
//   memory allows) in flight on full and empty mbarriers; each consumer
//   warpgroup issues wgmma m64nBNk32 .s32.s8.s8 on its rows (two m64
//   products a 32-byte K slice in bf16), A and B both K-major in shared
//   memory (8-bit wgmma takes only K-major), s32 sums in registers.
// - A stage is 128 bytes of K.  Where Ci is a multiple of 128 it is one
//   K step of 128 channels of one tap, landed with the 128-byte swizzle;
//   else (Ci = 64, or an odd multiple of 64) two K steps of 64 channels,
//   each a sub-tile of 64-byte rows with the 64-byte swizzle (a step past
//   K is a box out of range, which the TMA fills with zeros).
// - A tiles by TMA: the 1x1 stride-1 convs through a 2-D tiled map over
//   (M, Ci); the taps (3,1,1) and (1,3,3) and stride 2 through an im2col
//   map over (B, T, H, W, Ci): the tile's first output position gives the
//   coordinates (x*s - kW/2, y*s - kH/2, t - kT/2, b), the tap the offsets
//   (dx, dy, dt), and the hardware walks the tile's positions through the bounding
//   box of the filter origins (corners -k/2 and k/2 - (k - 1) in each of W,
//   H, T) with traversal stride s in W and H, zero-filling the taps in the
//   padding and the positions past the last clip.  B (the weight, (Co, kT,
//   kH, kW, Ci), [n][k] with K contiguous) by 2-D TMA boxes of BN x 128 or
//   BN x 64 bytes.
// - The epilogue moves whole tiles.  The residual (int8 or T) arrives by TMA
//   into shared memory while the products run: one thread of each
//   warpgroup loads its rows; the int8 residual (conv_c of 12 of the 16
//   blocks) a tile ahead, into one of two buffers in which each thread then
//   writes its int8 outputs over the bytes it has read.  The output tile is
//   staged in shared memory (slabs of a warpgroup's rows x 128 or 64 bytes, swizzled so
//   that the accumulator layout's writes are free of bank conflicts) and
//   written by TMA stores, rows past M clipped by the hardware.
// - The epilogue's arithmetic is the issue-bound part of the 1x1 convs, so
//   it avoids the conversion unit and the division.  In bf16 it runs on
//   bf16x2 pairs (cvt.rn.bf16x2.f32, mul.rn / add.rn / max .bf16x2): f32
//   carries 24 >= 2 x 8 + 2 bits, so an f32 operation on bf16 values
//   rounded to bf16 equals the correctly rounded bf16 operation, and the
//   bits are the plain version's.  int8 -> f32 is exact ALU arithmetic.
//   quant() in bf16 is a per-launch table, made with __fdiv_rn at the
//   block's start, of its value at every bf16 pattern between the foot of
//   its ramp (the least bf16 it takes to 1) and 1,279 patterns on (past its
//   last step to 127): exact by construction (quant_lut below).  In f32,
//   quant() is __fdiv_rn itself.  (__fdiv_rn takes its slow path at a zero
//   dividend, and the ReLU zeroes about half the values.)

#include <cstring>

#include "wgmma_gemm.cuh"

namespace {

constexpr int kBM = 128;                  // output positions of a tile (2 kBM: tile_rows)
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreads = kConsumers + 32; // + one producer warp
constexpr int kStageK = 128;              // bytes of K a stage holds
constexpr int kChannelMultiple = 64;      // Ci and Co are multiples of it
constexpr int kMaxStages = 6;
constexpr int kSmemOptin = 232448;        // an H100's opt-in shared memory a block
constexpr int kBarBytes = 128;            // the mbarriers: 2 x kMaxStages + 2 x 2
constexpr int kLut = 1280;                // quant()'s table: bf16 patterns from the ramp's foot
constexpr int kTableBytes = kLut;

enum Mode { kQuant = 0, kDeq = 1, kRes = 2, kResQ = 3 };

// Bytes of an element of the output and of the residual in mode kMode.
template <typename T, int kMode>
__host__ __device__ constexpr int out_bytes() {
  return kMode == kDeq ? static_cast<int>(sizeof(T)) : 1;
}
template <typename T, int kMode>
__host__ __device__ constexpr int res_bytes() {
  return kMode == kRes ? static_cast<int>(sizeof(T)) : (kMode == kResQ ? 1 : 0);
}

// Width of a staging slab (its rows' bytes, and its swizzle) for rows of
// `row` bytes: 128, or 64 for a 64-byte row.
__host__ __device__ constexpr int slab_width(int row) { return row < 128 ? row : 128; }

// Rows of a tile: 2 kBM in bf16 (each warpgroup 128 rows: two m64 products a
// K slice, 128 s32 registers at BN = 128), so that each weight tile and each
// TMA operation serves twice the outputs; kBM in f32, whose epilogue tiles
// would leave the ring too few stages.
template <int BN, typename T>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(T) == 2 ? 2 * kBM : kBM;
}

// The ring's stage: the tile_rows x 128-byte A tile, then the BN x 128-byte
// B tile.
template <int BN, typename T>
__host__ __device__ constexpr int stage_bytes() {
  return (tile_rows<BN, T>() + BN) * kStageK;
}

// Shared memory a block uses besides the ring: the output tile and the
// residual tile, staged.
template <int BN, typename T, int kMode>
__host__ __device__ constexpr int epilogue_bytes() {
  return tile_rows<BN, T>() * BN * (out_bytes<T, kMode>() + res_bytes<T, kMode>());
}

// Stages of the ring: as many as fit beside the epilogue's tiles, the
// mbarriers, quant()'s table and 1 KB of alignment slack, at most kMaxStages.
template <int BN, typename T, int kMode>
__host__ __device__ constexpr int stages() {
  const int fit =
      (kSmemOptin - 1024 - kBarBytes - kTableBytes - epilogue_bytes<BN, T, kMode>()) /
      stage_bytes<BN, T>();
  return fit < kMaxStages ? fit : kMaxStages;
}

template <int BN, typename T, int kMode>
__host__ __device__ constexpr int smem_bytes() {
  return stages<BN, T, kMode>() * stage_bytes<BN, T>() + epilogue_bytes<BN, T, kMode>() + kBarBytes +
         kTableBytes + 1024;
}

// Byte offset of byte `byte` of row r in a tile of w-byte rows (w = 64 or
// 128) as the TMA lands it with the w-byte swizzle: 16-byte chunk c of row
// r at chunk c ^ ((r * w / 128) % (w / 16)).
__device__ __forceinline__ uint32_t swz(int r, int byte, int w) {
  return static_cast<uint32_t>(r * w + ((((byte >> 4) ^ ((r * w >> 7) & (w / 16 - 1)))) << 4) +
                               (byte & 15));
}

// A wgmma descriptor of a K-major operand at shared address addr, rows of
// `row` bytes (128: the 128-byte swizzle, layout 1; 64: the 64-byte
// swizzle, layout 2); the stride byte offset is 8 rows.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int row) {
  const uint64_t layout = row == 128 ? 1ull : 2ull;
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * row) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128) : "memory");
}

// TMA in im2col mode: the A tile of `map` whose first output position has
// the filter-origin coordinates (w, h, t, b), channels c.., each position
// shifted by the tap's offsets (dx, dy, dt), into shared memory at dst.
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

// d += a . b on a warpgroup's 64 x N tile over a depth of 32 bytes, a and b
// K-major s8, s32 sums.
__device__ __forceinline__ void wgmma_s8_m64n64k32(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 128) {
    wgmma_s8_m64n128k32(d, a, b);
  } else {
    static_assert(BN == 64, "tiles are 64 or 128 channels wide");
    wgmma_s8_m64n64k32(d, a, b);
  }
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// bf16 pairs in one 32-bit register (the first in the low half):
// pack_bf16 rounds two f32 to nearest even (cvt.rn.bf16x2.f32, as
// __float2bfloat16_rn does each); the products and sums round the exact
// result to nearest even once.  f32 carries 24 >= 2 x 8 + 2 bits, so an f32
// operation on bf16 values rounded to bf16 gives these same bits (a double
// rounding through it is innocuous): the plain version's rounding points.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t bits;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(bits) : "f"(hi), "f"(lo));
  return bits;
}
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// An int8 value r as f32, exactly and on the ALU (not the conversion
// unit): the bits of 2^23 + 2^22 plus r are that float for |r| < 2^22.
__device__ __forceinline__ float i8_to_f32(int r) {
  return __fsub_rn(__int_as_float(0x4B400000 + r), 12582912.0f);
}

// Two neighbouring f32 values (__ldg).
__device__ __forceinline__ float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// quant(u, s) for u >= 0 (after the ReLU): clamp(rint(u / s), -127, 127) with
// the IEEE division, as the plain version computes it.
__device__ __forceinline__ int quant_exact(float u, float s) {
  float q = rintf(__fdiv_rn(u, s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int>(q);
}

// quant() in bf16 as a table.  quant_exact(u, s) is non-decreasing in u >= 0,
// 0 up to the ramp's foot (the least bf16 u it takes to 1, found here by
// bisection over the ordered bf16 patterns) and 127 from about 126.5 s on,
// so it takes values other than 0 and 127 only on the bf16 patterns of
// (0.5 s, 126.5 s], which span less than a factor 2^8: at most 1,152 of
// them.  Entry i of the table is quant_exact of the pattern foot + i - 1
// (entry 0 is 0), made with the IEEE division, so a lookup at the clamped
// index is exact for every u.
__device__ __forceinline__ int ramp_foot(float s) {
  int lo = 0, hi = 0x7f80;   // +inf: quant_exact(inf, s) = 127
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (quant_exact(__uint_as_float(static_cast<uint32_t>(mid) << 16), s) >= 1) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// quant() of the bf16 value with pattern `bits` (u >= 0; the sign bit of a
// -0 is dropped) through the table at `lut`.
__device__ __forceinline__ uint32_t quant_lut(uint32_t bits, int foot, const uint8_t* lut) {
  const int i = static_cast<int>(bits & 0x7fffu) - foot + 1;
  return lut[min(max(i, 0), kLut - 1)];
}

struct Params {
  const void* scale;       // (co) T
  const void* shift;       // (co) T
  const float* s_res;      // mode 3
  const float* s_out;      // modes 0, 2, 3
  int m, ci, k;            // GEMM rows, input channels, depth
  int nk;                  // stages a tile: ceil(K / 128)
  int rb;                  // bytes of a K step: 128, or 64 (two a stage)
  int im2col;              // A through the im2col map (else the tiled one)
  int t, ho, wo;           // frames and output sides
  int kh, kw, stride;      // the taps of a frame, the spatial stride
  int pt, ph, pw;          // padding: kt / 2, kh / 2, kw / 2
  int col_tiles, tiles;    // co / BN; row tiles x col_tiles
};

template <int BN, typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
qconv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
             const __grid_constant__ CUtensorMap ymap, const __grid_constant__ CUtensorMap rmap,
             const Params p) {
  constexpr int kStages = stages<BN, T, kMode>();
  constexpr int kStage = stage_bytes<BN, T>();
  constexpr int kBM = tile_rows<BN, T>();              // rows of a tile
  constexpr int kWgRows = kBM / 2;                     // a warpgroup's rows
  constexpr int kHalves = kWgRows / 64;                // its m64 products a K slice
  constexpr int kOutE = out_bytes<T, kMode>(), kResE = res_bytes<T, kMode>();
  constexpr int kOutW = slab_width(BN * kOutE), kResW = slab_width(BN * (kResE ? kResE : 1));
  constexpr int kResCols = kResE ? kResW / kResE : 0;   // channels of a residual slab
  // With the int8 residual the output is int8 in the same slabs, so each
  // thread writes its outputs over the residual bytes it has read and the
  // store leaves from there: two such buffers a warpgroup, the residual of
  // the next tile loading into one while this tile's epilogue runs.
  constexpr bool kInPlace = kMode == kResQ;
  static_assert(kStages >= 2, "the ring needs two stages");
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t out_buf = base + kStages * kStage;
  const uint32_t res_buf = out_buf + (kInPlace ? 0 : kBM * BN * kOutE);
  const uint32_t bars = out_buf + epilogue_bytes<BN, T, kMode>();
  // res_full + 8 (2 w + b): warpgroup w's residual buffer b has landed
  const uint32_t full = bars, empty = bars + 8 * kMaxStages, res_full = bars + 16 * kMaxStages;
  const uint32_t table_buf = bars + kBarBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    for (int b = 0; b < 4; ++b) mbar_init(res_full + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {   // the producer warp: lane 0 loads
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.col_tiles) * kBM, n0 = (tile % p.col_tiles) * BN;
        // the filter origin of the tile's first output position
        const int xo = m0 % p.wo, yo = (m0 / p.wo) % p.ho;
        const int frame = m0 / (p.wo * p.ho), to = frame % p.t, b = frame / p.t;
        const int w0 = xo * p.stride - p.pw, h0 = yo * p.stride - p.ph, d0 = to - p.pt;
        for (int ks = 0; ks < p.nk; ++ks, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);   // round 0 passes at once
          const uint32_t a = base + s * kStage, bar = full + 8 * s;
          mbar_expect_tx(bar, (kBM + BN) * kStageK);   // boxes past the edge count in full
          for (int sub = 0; sub < kStageK / p.rb; ++sub) {
            const int k0 = ks * kStageK + sub * p.rb;
            const uint32_t as = a + sub * kBM * p.rb, bs = a + kBM * kStageK + sub * BN * p.rb;
            if (p.im2col) {
              // a step past K reads channels past Ci: zeros
              const int tap = k0 < p.k ? k0 / p.ci : 0;
              const int c = k0 < p.k ? k0 - tap * p.ci : p.ci;
              tma_im2col_5d(as, &xmap, c, w0, h0, d0, b, static_cast<uint16_t>(tap % p.kw),
                            static_cast<uint16_t>((tap / p.kw) % p.kh),
                            static_cast<uint16_t>(tap / (p.kw * p.kh)), bar);
            } else {
              tma_2d(as, &xmap, k0, m0, bar);
            }
            tma_2d(bs, &wmap, k0, n0, bar);
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  const uint32_t out_mine = out_buf + wg * kWgRows * BN * kOutE;
  // this warpgroup's residual rows of round r: buffer r % 2 in place, else one
  auto res_rows = [&](int r) {
    return res_buf + ((kInPlace ? 2 * (r & 1) : 0) + wg) * kWgRows * BN * kResE;
  };
  auto res_bar = [&](int r) { return res_full + 8 * (2 * wg + (kInPlace ? (r & 1) : 0)); };
  // the residual rows of the tile at `m0`, `n0` into round r's buffer
  auto load_residual = [&](int tile, int r) {
    const int m0 = (tile / p.col_tiles) * kBM, n0 = (tile % p.col_tiles) * BN;
    mbar_expect_tx(res_bar(r), kWgRows * BN * kResE);
#pragma unroll
    for (int slab = 0; slab < BN * kResE / kResW; ++slab) {
      tma_2d(res_rows(r) + slab * kWgRows * kResW, &rmap, n0 + slab * kResCols,
             m0 + wg * kWgRows, res_bar(r));
    }
  };
  // generic pointers into shared memory (loads and stores the compiler may
  // schedule freely between the barriers)
  unsigned char* const at = smem - smem_addr(smem);
  uint8_t* const lut = at + table_buf;
  float so = 0.0f, rs = 0.0f;
  int foot = 0;
  if (kMode != kDeq) {
    so = fmaxf(*p.s_out, 1e-12f);
    if constexpr (sizeof(T) == 2) {
      // quant()'s table, made by the 256 consumer threads together
      foot = ramp_foot(so);
      for (int i = threadIdx.x; i < kLut; i += kConsumers) {
        const uint32_t bits = min(foot + i - 1, 0x7f80);
        lut[i] = i == 0 ? 0 : static_cast<uint8_t>(quant_exact(__uint_as_float(bits << 16), so));
      }
      asm volatile("bar.sync 3, %0;\n" ::"n"(kConsumers) : "memory");
    }
  }
  uint32_t rs2 = 0;   // bf16: T(max(s_res, 1e-12)) in both halves
  if (kMode == kResQ) {
    rs = fmaxf(*p.s_res, 1e-12f);
    rs2 = pack_bf16(rs, rs);
  }
  const T* scale = static_cast<const T*>(p.scale);
  const T* shift = static_cast<const T*>(p.shift);
  int acc[kHalves][BN / 2];
  int it = 0, round = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++round) {
    const int m0 = (tile / p.col_tiles) * kBM, n0 = (tile % p.col_tiles) * BN;
    const int row0 = m0 + wg * kWgRows;                // the warpgroup's first row
    if (kResE != 0 && tid == 0) {
      if (!kInPlace) {
        load_residual(tile, round);   // lands during the products
      } else {
        if (round == 0) load_residual(tile, 0);
        if (tile + static_cast<int>(gridDim.x) < p.tiles) {
          // the next tile's residual, into the buffer the last tile's store
          // leaves from: once that store has read it
          tma_store_wait<0, true>();
          load_residual(tile + gridDim.x, round + 1);
        }
      }
    }

#pragma unroll
    for (int mh = 0; mh < kHalves; ++mh) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mh][i] = 0;
      fence_acc(acc[mh]);
    }
    for (int ks = 0; ks < p.nk; ++ks, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      __syncwarp();   // the warp is converged for the .aligned wgmma instructions
      const uint32_t a = base + s * kStage, b = a + kBM * kStageK;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStageK / 32; ++kk) {
        // K step `sub` of the stage, its 32-byte slice `off`
        const int sub = (kk * 32) / p.rb, off = kk * 32 - sub * p.rb;
        const uint64_t db = kmajor_desc(b + sub * BN * p.rb + off, p.rb);
#pragma unroll
        for (int mh = 0; mh < kHalves; ++mh) {
          const uint32_t ak = a + sub * kBM * p.rb + (wg * kWgRows + 64 * mh) * p.rb + off;
          wgmma_s8<BN>(acc[mh], kmajor_desc(ak, p.rb), db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();                                   // the products of stage it-1 are done,
      if (ks > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));   // so it takes a new tile
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mh = 0; mh < kHalves; ++mh) fence_acc(acc[mh]);
    mbar_arrive(empty + 8 * ((it - 1) % kStages));

    // The epilogue: this warpgroup's kWgRows x BN outputs into the staging slabs.
    if (kResE != 0) mbar_wait(res_bar(round), kInPlace ? (round >> 1) & 1 : round & 1);
    const uint32_t res_mine = res_rows(round);
    const uint32_t out_here = kInPlace ? res_mine : out_mine;
    if (!kInPlace) {
      if (tid == 0) tma_store_wait<0, true>();   // the last tile's stores have read the slabs
      named_barrier(1 + wg);
    }
#pragma unroll
    for (int mh = 0; mh < kHalves; ++mh) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * q;                       // column in the tile
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * mh + 16 * warp + lane / 4 + 8 * h;   // row of the warpgroup's
          const int ob = c * kOutE;                        // byte of the column in a row
          unsigned char* const out = at + out_here + (ob / kOutW) * kWgRows * kOutW +
                                     swz(r, ob % kOutW, kOutW);
          const int rbyte = c * (kResE ? kResE : 1);
          const unsigned char* rp =
              at + res_mine + (rbyte / kResW) * kWgRows * kResW + swz(r, rbyte % kResW, kResW);
          if constexpr (sizeof(T) == 2) {
            // bf16 pairs: each product and sum rounded once, in bf16x2 (the
            // same bits as f32 then rounding: 24 >= 2 x 8 + 2)
            uint32_t v = pack_bf16(__int2float_rn(acc[mh][4 * j + 2 * h]),
                                   __int2float_rn(acc[mh][4 * j + 2 * h + 1]));
            v = add_bf16x2(mul_bf16x2(v, ldg_u32(scale + n0 + c)), ldg_u32(shift + n0 + c));
            if (kMode == kRes) {
              v = add_bf16x2(v, *reinterpret_cast<const uint32_t*>(rp));
            } else if (kMode == kResQ) {
              const char2 rq = *reinterpret_cast<const char2*>(rp);
              v = add_bf16x2(v, mul_bf16x2(pack_bf16(i8_to_f32(rq.x), i8_to_f32(rq.y)), rs2));
            }
            if (kMode == kDeq) {
              *reinterpret_cast<uint32_t*>(out) = v;
              continue;
            }
            v = max_bf16x2(v, 0u);
            *reinterpret_cast<uint16_t*>(out) = static_cast<uint16_t>(
                quant_lut(v & 0xffffu, foot, lut) | (quant_lut(v >> 16, foot, lut) << 8));
          } else {
            const float2 sc = load_pair(scale + n0 + c), sh = load_pair(shift + n0 + c);
            float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mh][4 * j + 2 * h]), sc.x), sh.x);
            float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mh][4 * j + 2 * h + 1]), sc.y), sh.y);
            if (kMode == kRes) {
              const float2 rv = *reinterpret_cast<const float2*>(rp);
              v0 = __fadd_rn(v0, rv.x);
              v1 = __fadd_rn(v1, rv.y);
            } else if (kMode == kResQ) {
              const char2 rq = *reinterpret_cast<const char2*>(rp);
              v0 = __fadd_rn(v0, __fmul_rn(i8_to_f32(rq.x), rs));
              v1 = __fadd_rn(v1, __fmul_rn(i8_to_f32(rq.y), rs));
            }
            if (kMode == kDeq) {
              *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
              continue;
            }
            *reinterpret_cast<uint16_t*>(out) = static_cast<uint16_t>(
                (quant_exact(fmaxf(v0, 0.0f), so) & 0xff) |
                ((quant_exact(fmaxf(v1, 0.0f), so) & 0xff) << 8));
          }
        }
      }
    }
    fence_proxy_async();   // the slabs' writes before the TMA store reads them
    named_barrier(1 + wg); // ... and every read of the residual before its next load
    if (tid == 0 && row0 < p.m) {
#pragma unroll
      for (int slab = 0; slab < BN * kOutE / kOutW; ++slab) {
        tma_store_2d(&ymap, out_here + slab * kWgRows * kOutW, n0 + slab * (kOutW / kOutE), row0);
      }
    }
  }
  if (tid == 0) tma_store_wait<0, false>();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

CUtensorMapSwizzle swizzle_of(int row) {
  return row == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// A TMA map of a row-major (rows, cols) tensor of `type` in boxes of
// (box_rows, box_cols) with the swizzle of box_cols * elem bytes (64 or 128).
cudaError_t map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
                   long long rows, long long cols, int box_rows, int box_cols) {
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
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
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(box_cols * elem),
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Geometry {
  int b, t, h, w, ci;     // input (B, T, H, W, Ci)
  int ho, wo;             // output sides (T is kept)
  int kt, kh, kw, stride;
  int m, n, k;            // GEMM: M = B*T*Ho*Wo, N = Co, K = kT*kH*kW*Ci
};

// The im2col TMA map of the (B, T, H, W, Ci) int8 input: the bounding box of
// the filter origins (corners -k/2 and k/2 - (k - 1) in W, H, T), traversal
// stride `stride` in W and H, boxes of 128 positions x rb channels with the
// rb-byte swizzle.
cudaError_t im2col_map(CUtensorMap* map, const void* x, const Geometry& g, int rb, int pixels) {
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
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(g.ci), static_cast<cuuint64_t>(g.w),
                              static_cast<cuuint64_t>(g.h), static_cast<cuuint64_t>(g.t),
                              static_cast<cuuint64_t>(g.b)};
  const cuuint64_t row = static_cast<cuuint64_t>(g.ci);
  const cuuint64_t strides[4] = {row, row * g.w, row * g.w * g.h, row * g.w * g.h * g.t};
  const int lower[3] = {-(g.kw / 2), -(g.kh / 2), -(g.kt / 2)};   // (W, H, T)
  const int upper[3] = {g.kw / 2 - (g.kw - 1), g.kh / 2 - (g.kh - 1), g.kt / 2 - (g.kt - 1)};
  const cuuint32_t traversal[5] = {1, static_cast<cuuint32_t>(g.stride),
                                   static_cast<cuuint32_t>(g.stride), 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(x), dims, strides, lower,
             upper, static_cast<cuuint32_t>(rb), static_cast<cuuint32_t>(pixels), traversal,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle_of(rb), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  // Drivers up to 13.1 mis-handle an im2col map of a tensor under 128 KB
  // unless bit 21 of its second word is cleared (as csrc/tok_conv.cu does).
  int driver = 0;
  if (cudaDriverGetVersion(&driver) == cudaSuccess && driver <= 13010 &&
      static_cast<unsigned long long>(g.b) * g.t * g.h * g.w * row < 131072ull) {
    reinterpret_cast<uint64_t*>(map)[1] &= ~(1ull << 21);
  }
  return cudaSuccess;
}

template <typename T>
CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  return sms;
}

template <int BN, typename T, int kMode>
cudaError_t launch(const void* x, const void* wt, const void* scale, const void* shift,
                   const void* res, const void* s_res, const void* s_out, void* y,
                   const Geometry& g, cudaStream_t stream) {
  constexpr int kOutE = out_bytes<T, kMode>(), kResE = res_bytes<T, kMode>();
  Params p{};
  p.scale = scale;
  p.shift = shift;
  p.s_res = static_cast<const float*>(s_res);
  p.s_out = static_cast<const float*>(s_out);
  p.m = g.m;
  p.ci = g.ci;
  p.k = g.k;
  p.nk = ceil_div(g.k, kStageK);
  p.rb = g.ci % 128 == 0 ? 128 : 64;
  p.im2col = !(g.kt == 1 && g.kh == 1 && g.kw == 1 && g.stride == 1);
  p.t = g.t;
  p.ho = g.ho;
  p.wo = g.wo;
  p.kh = g.kh;
  p.kw = g.kw;
  p.stride = g.stride;
  p.pt = g.kt / 2;
  p.ph = g.kh / 2;
  p.pw = g.kw / 2;
  p.col_tiles = g.n / BN;
  constexpr int kTileRows = tile_rows<BN, T>(), kWgRows = kTileRows / 2;
  p.tiles = ceil_div(g.m, kTileRows) * p.col_tiles;
  CUtensorMap xmap, wmap, ymap, rmap;
  memset(&rmap, 0, sizeof(rmap));
  cudaError_t err =
      p.im2col ? im2col_map(&xmap, x, g, p.rb, kTileRows)
               : map_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.m, g.ci, kTileRows, p.rb);
  if (err == cudaSuccess) {
    err = map_2d(&wmap, wt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.n, g.k, BN, p.rb);
  }
  if (err == cudaSuccess) {
    constexpr int kOutW = slab_width(BN * kOutE);
    err = kMode == kDeq
              ? map_2d(&ymap, y, map_type<T>(), kOutE, g.m, g.n, kWgRows, kOutW / kOutE)
              : map_2d(&ymap, y, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.m, g.n, kWgRows, kOutW);
  }
  if (err == cudaSuccess && kResE != 0) {
    constexpr int kResW = slab_width(BN * (kResE ? kResE : 1));
    constexpr int kResCols = kResE ? kResW / kResE : 0;
    err = kMode == kRes
              ? map_2d(&rmap, res, map_type<T>(), kResE, g.m, g.n, kWgRows, kResCols)
              : map_2d(&rmap, res, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.m, g.n, kWgRows, kResW);
  }
  if (err != cudaSuccess) return err;
  auto kernel = qconv_kernel<BN, T, kMode>;
  constexpr int smem = smem_bytes<BN, T, kMode>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = p.tiles < sms ? p.tiles : sms;
  kernel<<<grid, kThreads, smem, stream>>>(xmap, wmap, ymap, rmap, p);
  return cudaGetLastError();
}

template <int BN, typename T>
cudaError_t launch_mode(int mode, const void* x, const void* wt, const void* scale,
                        const void* shift, const void* res, const void* s_res,
                        const void* s_out, void* y, const Geometry& g, cudaStream_t s) {
  switch (mode) {
    case kQuant:
      return launch<BN, T, kQuant>(x, wt, scale, shift, res, s_res, s_out, y, g, s);
    case kDeq:
      return launch<BN, T, kDeq>(x, wt, scale, shift, res, s_res, s_out, y, g, s);
    case kRes:
      return launch<BN, T, kRes>(x, wt, scale, shift, res, s_res, s_out, y, g, s);
    default:
      return launch<BN, T, kResQ>(x, wt, scale, shift, res, s_res, s_out, y, g, s);
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
  if (b <= 0 || t <= 0 || h <= 0 || w <= 0 || ci <= 0 || ci % kChannelMultiple != 0 ||
      co <= 0 || co % kChannelMultiple != 0 || !kernel_ok || (stride != 1 && stride != 2) ||
      mode < kQuant || mode > kResQ || (dtype != 0 && dtype != 1) || x == nullptr ||
      wt == nullptr || scale == nullptr || shift == nullptr || y == nullptr ||
      (mode != kDeq && s_out == nullptr) || ((mode == kRes || mode == kResQ) && res == nullptr) ||
      (mode == kResQ && s_res == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g;
  g.b = b;
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
  if (co % 128 == 0) {   // the widest tile that divides Co
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
