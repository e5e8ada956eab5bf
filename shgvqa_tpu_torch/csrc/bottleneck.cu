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
// sum); ReLU; the residual sum is rounded to bf16 before the last ReLU.  The
// epilogues apply BN and the residual sum as paired bf16 instructions with
// round-to-nearest (mul.rn / add.rn .bf16x2, which are never contracted into
// an fma): each is the f32 operation rounded once to bf16, as in the plain
// version, since an f32 product or sum of two bf16 values rounded to bf16
// equals the correctly rounded bf16 result.
//
// What bounds it on the card: per position 2 * (Ci*Cm + 9*Cm^2 + Cm*Co
// [+ Ci*Co]) operations against 2 * (Ci + Co) bytes, ~50-150 a byte at the
// trunk's widths, under the H100's ~295: device memory, if a and b never
// leave the chip.  That is the fusion: unfused, the block writes and reads
// back a, b, c and the residual sum, and each BN and ReLU is a pass of its own.
//
// Design: spans of positions with a halo, warp-specialized wgmma.
// - The frames are one sequence of N*H*W positions; a work item is a span
//   of S consecutive output positions (S a multiple of 64, as large as
//   shared memory allows and chosen so that the items spread evenly over
//   the SMs).  One persistent block an SM walks over items.
// - A block is a producer warp and two consumer warpgroups.  The producer's
//   lane 0 keeps a ring of 5 stages of 32 KB in flight, each landed by TMA
//   with the 128-byte swizzle on a "full" mbarrier and freed by an arrival
//   of every consumer thread on an "empty" one: a 128-position box of x
//   and/or a weight tile (64 channels of depth, up to 128 rows).  All blocks
//   read the same weights, which stay in L2.  No block-wide barrier stands
//   in the products' way: the consumers meet on a named barrier twice an
//   item.
// - conv_a runs on the span's window, the S + 2W + 2 positions its 3x3
//   taps reach (the one-row halo above and below, recomputed by each item:
//   keeping it would tie an item to its neighbour's block), in passes of 128
//   positions, 64 a warpgroup: wgmma with A (x) and B (wa) from the stage.
//   Its BN + ReLU output goes into the shared a tile, one row of Cm a
//   position, 16-byte chunk c of row r at c ^ (r % 8).  Window rows outside
//   the tensor read zeros from the TMA; their values are never used.
// - conv_b is an implicit product over the 9 taps, 64 output positions a
//   warpgroup: A is loaded from the a tile into registers by ldmatrix, each
//   lane giving the row of its own position shifted by the tap, or a zero
//   row where the tap falls outside the frame (the 3x3's padding: the
//   frame's edges, the first and last rows, and positions past the end);
//   B, the tap's Cm x 64 slice of wb, comes from the stage.  wgmma with A in
//   registers (RS): the shifted rows are not the 8-row groups a shared-
//   memory descriptor can address.
// - conv_b's BN + ReLU output never leaves the registers: the f32
//   accumulator's pairs, rounded to bf16, are the A fragments of conv_c.
// - conv_c (and the projection, wgmma with A = the positions' x from the
//   stage) run in chunks of 64 output channels.  Without a projection the
//   producer lands the residual, the chunk's 128 x 64 box of x, in the x
//   place of the chunk's first stage; the epilogue applies BN_c, adds the
//   residual (that box, or the projection's accumulator through BN_p,
//   rounded) and the ReLU, writes y over the box in shared memory, and one
//   thread of each warpgroup stores its 64 x 64 by TMA before the stage is
//   freed: no residual load waits in the epilogue and y leaves in whole
//   boxes.
// - Each stage's wgmma group is waited for before the stage is freed; the
//   two warpgroups' groups interleave on the tensor cores, and one
//   warpgroup's epilogue runs beside the other's products.  At Cm = 64 a y
//   box's stage is freed a chunk late, once its store has read it, so that
//   no thread waits on the store; at Cm = 128 a chunk holds two stages and
//   the store is waited for.
// - What the card showed (bottleneck_floor): no one part dominates: the
//   products, the x loads and the y stores each take 10-20% of the time,
//   the weights' loads from L2 ~2%.  Keeping one stage's products in
//   flight (freeing each stage a stage later), or a second conv_c chunk's
//   products in flight during the first one's epilogue, measured slower:
//   a deeper ring of stages counts for more here.

#include "wgmma_gemm.cuh"

namespace {

constexpr int kConsumers = 256;                     // two warpgroups
constexpr int kThreads = kConsumers + 32;           // + the producer warp
constexpr int kPass = 128;                          // positions of a pass, 64 a warpgroup
constexpr int kBK = 64;                             // depth of a stage: 128-byte rows of bf16
constexpr int kNC = 64;                             // output channels of a conv_c chunk
constexpr int kStages = 5;
constexpr int kXBytes = kPass * kBK * 2;            // a 128 x 64 box of x: 16 KB
constexpr int kBoxBytes = 64 * kBK * 2;             // a 64 x 64 weight box: 8 KB
constexpr int kStageBytes = kXBytes + 128 * kBK * 2;   // + a weight tile of <= 128 rows
constexpr int kSmemLimit = 232448;                  // what a block can have on sm_90

struct Params {
  const bf16* x;
  const bf16* bn[8];       // sa, ba, sb, bb (Cm); sc, bc, sp, bp (Co; sp, bp may be null)
  bf16* y;
  int h, w, ci, co;
  int total;               // positions, N * H * W
  int span;                // output positions of a work item
  int items;
};

// Byte offsets of the shared-memory regions from the 1 KB aligned base:
// the ring, the a tile (window rows and a zero row), the BN vectors (bf16),
// the mbarriers.
struct Layout {
  size_t a, bn, bars, total;
  __host__ __device__ Layout(int span, int w, int cm, int co) {
    a = static_cast<size_t>(kStages) * kStageBytes;
    bn = a + static_cast<size_t>(span + 2 * w + 3) * cm * 2;
    bars = (bn + static_cast<size_t>(4 * cm + 4 * co) * 2 + 7) / 8 * 8;
    total = bars + 16 * kStages;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The consumers' named barrier (the producer warp takes no part), and a
// warpgroup's own.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t a) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}

// BN of the f32 sums of columns col and col + 1 (col even): the sums
// rounded to bf16, times the scale, plus the shift, each rounded; scale and
// shift hold the vectors as bf16 pairs.
__device__ __forceinline__ uint32_t bn2(float a0, float a1, const uint32_t* scale,
                                        const uint32_t* shift, int col) {
  return add_bf16x2(mul_bf16x2(pack_bf16(a0, a1), scale[col / 2]), shift[col / 2]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
}

// One stage's products of a warpgroup, waited for: acc += A . B over 64 of
// depth, A K-major at a (64 rows of 128 bytes, swizzled) and B K-major at b
// (N rows of 128 bytes, swizzled), both in shared memory.
template <int N>
__device__ __forceinline__ void ss_group(float (&acc)[N / 2], uint32_t a, uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    wgmma_k16<N, false>(acc, sw128_desc(a + 32 * kk, 16, 1024), sw128_desc(b + 32 * kk, 16, 1024));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// The same stage's products with A from registers, issued after a fence
// and neither committed nor waited for: frag[s0 + kk] is the k16 slice kk
// (s0 known at compile time once inlined in an unrolled loop).
template <int N, int S>
__device__ __forceinline__ void rs_issue(float (&acc)[N / 2], const uint32_t (&frag)[S][4], int s0,
                                         uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    wgmma_k16_rs<N>(acc, frag[s0 + kk], sw128_desc(b + 32 * kk, 16, 1024));
  }
}

// One conv_b stage of a warpgroup, waited for: the 64 channels kc of this
// lane's tap row (row_addr, at a-tile row `row`) by ldmatrix, then their
// products.
template <int CM>
__device__ __forceinline__ void conv_b_stage(float (&acc)[CM / 2], uint32_t row_addr, int row,
                                             int kc, uint32_t b) {
  const int lane = threadIdx.x % 32;
  uint32_t frag[4][4];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const int chunk = kc * 8 + kk * 2 + (lane >> 4);
    ldsm_x4(frag[kk], row_addr + ((chunk ^ (row & 7)) << 4));
  }
  rs_issue<CM>(acc, frag, 0, b);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// The ring as one thread of the producer or of the consumers walks it:
// stage t % kStages in round t / kStages.
struct Ring {
  uint32_t base, full, empty;
  int t = 0;

  __device__ uint32_t stage() const { return base + (t % kStages) * kStageBytes; }
  __device__ uint32_t full_bar() const { return full + 8 * (t % kStages); }

  // producer: wait until the stage is free, then expect `bytes` on it
  __device__ uint32_t acquire(uint32_t bytes) {
    mbar_wait(empty + 8 * (t % kStages), ((t / kStages) & 1) ^ 1);   // round 0 passes at once
    mbar_expect_tx(full_bar(), bytes);
    return stage();
  }

  // consumer: wait until the stage has landed
  __device__ uint32_t wait() {
    mbar_wait(full_bar(), (t / kStages) & 1);
    __syncwarp();   // the warp is converged for the .aligned instructions
    return stage();
  }

  __device__ void release() { release_at(t); }
  __device__ void release_at(int at) { mbar_arrive(empty + 8 * (at % kStages)); }
  __device__ void next() { ++t; }
};

struct Item {
  int q0, len, win, w0;   // first output position, output positions, window rows, position of row 0
  __device__ Item(const Params& p, int item) {
    q0 = item * p.span;
    len = min(p.span, p.total - q0);
    win = len + 2 * p.w + 2;
    w0 = q0 - p.w - 1;
  }
};

// The producer's lane 0: every stage the consumers take, in their order.
template <int CM, bool kProj>
__device__ __forceinline__ void produce(const Params& p, const CUtensorMap* xmap, const CUtensorMap* wamap,
                        const CUtensorMap* wbmap, const CUtensorMap* wcmap,
                        const CUtensorMap* wpmap, Ring& r) {
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const Item it(p, item);
    for (int r0 = 0; r0 < it.win; r0 += kPass) {           // conv_a: x, wa
      for (int k = 0; k < p.ci; k += kBK) {
        const uint32_t st = r.acquire(kXBytes + CM * kBK * 2);
        tma_2d(st, xmap, k, it.w0 + r0, r.full_bar());
#pragma unroll
        for (int j = 0; j < CM / 64; ++j) {
          tma_2d(st + kXBytes + j * kBoxBytes, wamap, k, 64 * j, r.full_bar());
        }
        r.next();
      }
    }
    for (int o0 = 0; o0 < it.len; o0 += kPass) {
      for (int tap = 0; tap < 9; ++tap) {                  // conv_b: wb
        for (int k = 0; k < CM; k += kBK) {
          const uint32_t st = r.acquire(CM * kBK * 2);
#pragma unroll
          for (int j = 0; j < CM / 64; ++j) {
            tma_2d(st + kXBytes + j * kBoxBytes, wbmap, tap * CM + k, 64 * j, r.full_bar());
          }
          r.next();
        }
      }
      for (int n0 = 0; n0 < p.co; n0 += kNC) {
        if (kProj) {                                       // projection: x, wp
          for (int k = 0; k < p.ci; k += kBK) {
            const uint32_t st = r.acquire(kXBytes + kBoxBytes);
            tma_2d(st, xmap, k, it.q0 + o0, r.full_bar());
            tma_2d(st + kXBytes, wpmap, k, n0, r.full_bar());
            r.next();
          }
        }
        for (int k = 0; k < CM; k += kBK) {                // conv_c: wc, and with the
          const bool res = !kProj && k == 0;               // first, the residual x
          const uint32_t st = r.acquire(kBoxBytes + (res ? kXBytes : 0));
          if (res) tma_2d(st, xmap, n0, it.q0 + o0, r.full_bar());
          tma_2d(st + kXBytes, wcmap, k, n0, r.full_bar());
          r.next();
        }
      }
    }
  }
}

// A consumer thread.  smem is the block's 1 KB aligned shared memory at
// shared address smem_base; bn the BN vectors there as bf16 pairs.
template <int CM, bool kProj>
__device__ __forceinline__ void consume(const Params& p, const CUtensorMap* ymap, Ring& r,
                                        unsigned char* smem, uint32_t smem_base, const Layout& lay,
                                        const uint32_t* bn) {
  const uint32_t a_tile = smem_base + static_cast<uint32_t>(lay.a);
  unsigned char* a_ptr = smem + lay.a;
  constexpr int kRow = CM * 2;                     // bytes of an a-tile row
  // free a y box's stage a chunk late (Cm = 64: one stage a chunk; at
  // Cm = 128 a chunk holds two and the ring has no room to spare)
  constexpr bool kDeferFree = CM == 64;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = 2 * (lane % 4);
  const int zero_row = p.span + 2 * p.w + 2;
  const int frame = p.h * p.w;
  const uint32_t* sa = bn;
  const uint32_t* ba = sa + CM / 2;
  const uint32_t* sb = ba + CM / 2;
  const uint32_t* bb = sb + CM / 2;
  const uint32_t* sc = bb + CM / 2;
  const uint32_t* bc = sc + p.co / 2;
  const uint32_t* sp = bc + p.co / 2;
  const uint32_t* bp = sp + p.co / 2;
  int held = -1;   // the stage of the elected thread's last y store

  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const Item it(p, item);
    consumer_sync();   // the last item's conv_b has read the a tile

    // conv_a + BN_a + ReLU on the window -> the a tile
    for (int r0 = 0; r0 < it.win; r0 += kPass) {
      const int rows0 = r0 + 64 * wg;              // this warpgroup's first window row
      const bool on = rows0 < it.win;
      float acc[CM / 2];
      zero(acc);
      for (int k = 0; k < p.ci; k += kBK) {
        const uint32_t st = r.wait();
        if (on) ss_group<CM>(acc, st + wg * 64 * 128, st + kXBytes);
        r.release();
        r.next();
      }
      if (on) {
#pragma unroll
        for (int j = 0; j < CM / 8; ++j) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = rows0 + 16 * warp + g + 8 * hh;
            if (row < it.win) {
              *reinterpret_cast<uint32_t*>(a_ptr + row * kRow + ((j ^ (row & 7)) << 4) + 2 * qd) =
                  relu_bf16x2(bn2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1], sa, ba, 8 * j + qd));
            }
          }
        }
      }
    }
    consumer_sync();   // the a tile is complete

    for (int o0 = 0; o0 < it.len; o0 += kPass) {
      const int m0 = o0 + 64 * wg;                 // this warpgroup's first output (of the item)
      const bool on = m0 < it.len;
      // conv_b + BN_b + ReLU -> the A fragments of conv_c.  This lane's
      // ldmatrix row is output m of the item, at (fh, fw) of its frame.
      const int m = m0 + 16 * warp + (lane & 15);
      int fh = -2, fw = 0;                         // past the item: every tap reads zeros
      if (m < it.len) {
        const int f = (it.q0 + m) % frame;
        fh = f / p.w;
        fw = f % p.w;
      }
      float acc[CM / 2];
      zero(acc);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dr = tap / 3 - 1, dc = tap % 3 - 1;
        const bool inside = fh + dr >= 0 && fh + dr < p.h && fw + dc >= 0 && fw + dc < p.w;
        const int row = inside ? m + (dr + 1) * p.w + dc + 1 : zero_row;
        const uint32_t row_addr = a_tile + row * kRow;
#pragma unroll
        for (int kc = 0; kc < CM / kBK; ++kc) {
          const uint32_t st = r.wait();
          if (on) conv_b_stage<CM>(acc, row_addr, row, kc, st + kXBytes);
          r.release();
          r.next();
        }
      }
      uint32_t bfrag[CM / 16][4];                  // k16 slice s: columns 16 s..
#pragma unroll
      for (int s = 0; s < CM / 16; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * s + i / 2, hh = i % 2;
          bfrag[s][i] = relu_bf16x2(bn2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1], sb, bb,
                                        8 * j + qd));
        }
      }

      for (int n0 = 0; n0 < p.co; n0 += kNC) {
        uint32_t res[kNC / 8][2];                  // the projection's BN_p, bf16 pairs
        if constexpr (kProj) {
          float accp[kNC / 2];
          zero(accp);
          for (int k = 0; k < p.ci; k += kBK) {
            const uint32_t st = r.wait();
            if (on) ss_group<kNC>(accp, st + wg * 64 * 128, st + kXBytes);
            r.release();
            r.next();
          }
#pragma unroll
          for (int j = 0; j < kNC / 8; ++j) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              res[j][hh] = bn2(accp[4 * j + 2 * hh], accp[4 * j + 2 * hh + 1], sp, bp,
                               n0 + 8 * j + qd);
            }
          }
        }
        // conv_c; the chunk's first stage holds the residual x (without a
        // projection) and takes y on its way out, so it is freed last
        float accc[kNC / 2];
        zero(accc);
        const int t0 = r.t;
        const uint32_t slot = r.wait();            // the first stage's x box
#pragma unroll
        for (int kc = 0; kc < CM / kBK; ++kc) {
          const uint32_t st = kc == 0 ? slot : r.wait();
          if (on) {
            rs_issue<kNC>(accc, bfrag, 4 * kc, st + kXBytes);
            wgmma_commit();
            wgmma_wait<0>();
            fence_acc(accc);
          }
          if (kc > 0) r.release();
          r.next();
        }
        if (on) {
          // y = relu(BN_c(c) + r) over the residual's place in the box (row
          // 64 wg + i, 16-byte chunk c at c ^ (row % 8)), then one TMA store
          // of the warpgroup's 64 x 64
          unsigned char* box = smem + (slot - smem_base);
#pragma unroll
          for (int j = 0; j < kNC / 8; ++j) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = 64 * wg + 16 * warp + g + 8 * hh;
              uint32_t* at = reinterpret_cast<uint32_t*>(box + row * 128 + ((j ^ (row & 7)) << 4) + 2 * qd);
              const uint32_t c = bn2(accc[4 * j + 2 * hh], accc[4 * j + 2 * hh + 1], sc, bc,
                                     n0 + 8 * j + qd);
              uint32_t resid;
              if constexpr (kProj) {
                resid = res[j][hh];
              } else {
                resid = *at;
              }
              *at = relu_bf16x2(add_bf16x2(c, resid));
            }
          }
          fence_proxy_async();
          warpgroup_sync(wg);
        }
        if (on && threadIdx.x % 128 == 0) {
          // the warpgroup's elected thread stores y and frees the stage
          // once the store has read it: at Cm = 64 the last chunk's now and
          // this one's at the next chunk or at the end of the pass, at
          // Cm = 128 (two stages a chunk) this one's now
          tma_store_2d(ymap, slot + wg * 64 * 128, n0, it.q0 + m0);
          if (kDeferFree) {
            if (held >= 0) {
              tma_store_wait<1, true>();
              r.release_at(held);
            }
            held = t0;
          } else {
            tma_store_wait<0, true>();
            r.release_at(t0);
          }
        } else {
          r.release_at(t0);
        }
      }
      if (held >= 0) {   // before conv_b's stages come round to it
        tma_store_wait<0, true>();
        r.release_at(held);
        held = -1;
      }
    }
  }
  if (threadIdx.x % 128 == 0) tma_store_wait<0, false>();   // y is written
}

template <int CM, bool kProj>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wamap,
                  const __grid_constant__ CUtensorMap wbmap, const __grid_constant__ CUtensorMap wcmap,
                  const __grid_constant__ CUtensorMap wpmap, const __grid_constant__ CUtensorMap ymap,
                  const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Layout lay(p.span, p.w, CM, p.co);
  const uint32_t base = smem_addr(smem);
  Ring ring{base, static_cast<uint32_t>(base + lay.bars),
            static_cast<uint32_t>(base + lay.bars + 8 * kStages)};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  bf16* bn = reinterpret_cast<bf16*>(smem + lay.bn);
  if (threadIdx.x < kConsumers) {
    // the zero row of the a tile, and the BN vectors
    uint4* zrow = reinterpret_cast<uint4*>(smem + lay.a + static_cast<size_t>(p.span + 2 * p.w + 2) * CM * 2);
    for (int i = threadIdx.x; i < CM / 8; i += kConsumers) zrow[i] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      for (int i = threadIdx.x; i < CM; i += kConsumers) bn[v * CM + i] = p.bn[v][i];
    }
#pragma unroll
    for (int v = 4; v < 8; ++v) {
      if (p.bn[v] == nullptr) continue;
      for (int i = threadIdx.x; i < p.co; i += kConsumers) bn[4 * CM + (v - 4) * p.co + i] = p.bn[v][i];
    }
  }
  __syncthreads();   // the mbarriers, the zero row and the BN vectors are ready

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce<CM, kProj>(p, &xmap, &wamap, &wbmap, &wcmap, &wpmap, ring);
    return;
  }
  consume<CM, kProj>(p, &ymap, ring, smem, base, lay, reinterpret_cast<const uint32_t*>(bn));
}

// The span of an item: a multiple of 64 whose shared memory fits, chosen
// to spread the items evenly over the SMs (fewest rounds of items a block
// times the span, its window's halo weighed at a quarter); 0 when not even
// 64 positions fit.
int choose_span(int total, int w, int cm, int co, int sms) {
  int best = 0;
  double best_cost = 0.0;
  for (int span = 64; span <= total + 63; span += 64) {
    if (Layout(span, w, cm, co).total + 1024 > static_cast<size_t>(kSmemLimit)) break;
    const int items = (total + span - 1) / span;
    const int rounds = (items + sms - 1) / sms;
    const double cost = rounds * (span + 0.25 * (2 * w + 2));
    if (best == 0 || cost < best_cost) {
      best = span;
      best_cost = cost;
    }
  }
  return best;
}

template <int CM, bool kProj>
cudaError_t launch(const Params& p, const CUtensorMap (&maps)[6], int grid, cudaStream_t stream) {
  const size_t smem = Layout(p.span, p.w, CM, p.co).total + 1024;   // slack to align the base
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<CM, kProj>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bottleneck_kernel<CM, kProj><<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                                 maps[4], maps[5], p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the block on `stream`; returns cudaGetLastError() (0 = launched).
// Device pointers, bf16, contiguous, 16-byte aligned: x (n, h, w, ci); wa
// (cm, ci); wb (cm, 3, 3, cm) [out][kh][kw][in]; wc (co, cm); wp (co, ci) or
// null (then ci == co); the folded BN scale and shift sa, ba, sb, bb (cm),
// sc, bc, sp, bp (co); y (n, h, w, co).  cm is 64 or 128, ci % 64 == 0,
// co % 128 == 0; frames too wide for a span of 64 positions and its halo
// in shared memory are refused.
int shgvqa_bottleneck_bf16(const void* x, const void* wa, const void* sa, const void* ba,
                           const void* wb, const void* sb, const void* bb, const void* wc,
                           const void* sc, const void* bc, const void* wp, const void* sp,
                           const void* bp, void* y, int n, int h, int w, int ci, int cm, int co,
                           void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || ci <= 0 || ci % kBK != 0 || co <= 0 || co % 128 != 0 ||
      (cm != 64 && cm != 128) || (wp == nullptr && ci != co) ||
      (wp != nullptr && (sp == nullptr || bp == nullptr)) ||
      static_cast<long long>(n) * h * w > 0x7fffffffLL - 2 * kPass) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{};
  p.x = static_cast<const bf16*>(x);
  const void* vectors[8] = {sa, ba, sb, bb, sc, bc, sp, bp};
  for (int v = 0; v < 8; ++v) p.bn[v] = static_cast<const bf16*>(vectors[v]);
  p.y = static_cast<bf16*>(y);
  p.h = h;
  p.w = w;
  p.ci = ci;
  p.co = co;
  p.total = n * h * w;
  p.span = choose_span(p.total, w, cm, co, sms);
  if (p.span == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.items = (p.total + p.span - 1) / p.span;
  CUtensorMap maps[6];   // x, wa, wb, wc, wp (wc again without a projection), y
  err = gemm_a_map(&maps[0], x, p.total, ci);
  if (err == cudaSuccess) err = gemm_b_map(&maps[1], wa, cm, ci);
  if (err == cudaSuccess) err = gemm_b_map(&maps[2], wb, cm, 9 * cm);
  if (err == cudaSuccess) err = gemm_b_map(&maps[3], wc, co, cm);
  if (err == cudaSuccess) err = wp ? gemm_b_map(&maps[4], wp, co, ci) : gemm_b_map(&maps[4], wc, co, cm);
  if (err == cudaSuccess) err = tensor_map(&maps[5], y, p.total, co, 64, kNC, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.items < sms ? p.items : sms;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cm == 64) {
    err = wp ? launch<64, true>(p, maps, grid, s) : launch<64, false>(p, maps, grid, s);
  } else {
    err = wp ? launch<128, true>(p, maps, grid, s) : launch<128, false>(p, maps, grid, s);
  }
  return static_cast<int>(err);
}

const char* shgvqa_bottleneck_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
