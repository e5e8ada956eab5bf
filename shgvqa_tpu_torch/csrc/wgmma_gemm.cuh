// A wgmma + TMA matrix-product mainloop for Hopper (sm_90a), shared by the
// kernels that include it, and the PTX helpers it is built from.
//
// One block computes one 128 x BN tile of C = A . B in f32 registers:
//   A (M, K) bf16, row-major (K contiguous), read through a TMA map whose
//     box is 64 columns x 128 rows;
//   B bf16, read through a TMA map whose box is 64 x 64, either K-major
//     (stored (N, K), K contiguous: an nn.Linear weight used as W^T) or
//     MN-major (stored (K, N), N contiguous: the same weight used as W), so
//     that no weight needs a transposed copy.
// Threads: two consumer warpgroups (rows 0-63 and 64-127 of the tile) and
// one producer warp (ring_mainloop also takes 64-row tiles: one consumer
// warpgroup, A in 64 x 64 boxes).  The producer's lane 0 keeps a ring of kStages stages
// in flight: each stage is a 128 x 64 A tile and a BN x 64 B tile,
// landed by TMA with the 128-byte swizzle and guarded by a "full" mbarrier
// (the TMA's bytes) and an "empty" one (an arrival from every consumer
// thread).  Each consumer warpgroup issues 4 wgmma.mma_async m64nBNk16 a
// stage, keeps one stage's products in flight (wait_group 1) and then frees
// the stage before it.  Rows of A past M are zero-filled by the TMA; the
// caller's epilogue stores only rows < M.
//
// Shared-memory layout of a stage (1024-byte aligned, as the swizzle repeats
// every 1 KB): the A tile, 128-byte rows, row r at 128 r; then the B tile as
// BN / 64 boxes of 8 KB.  K-major: box j holds N rows 64 j.., 128-byte rows
// of 64 K values.  MN-major: box j holds N columns 64 j.., one 128-byte row
// per K value.  The 128-byte swizzle puts 16-byte chunk c of row r at
// chunk c ^ (r % 8).
//
// wgmma descriptors (bits 0-13 start >> 4, 16-29 leading byte offset >> 4,
// 32-45 stride byte offset >> 4, 62-63 layout: 1 = 128-byte swizzle):
// - K-major (A, and B of the products against W^T): stride byte offset
//   1024 (8 rows of 128 bytes); the leading offset is unused; the k16 step
//   kk starts 32 kk bytes into the rows;
// - MN-major (B of the products against W, transposed by the wgmma):
//   leading byte offset 8192 (from one 64-wide N box to the next), stride
//   byte offset 1024 (8 K rows); the k16 step kk starts 16 kk rows in, at
//   2048 kk bytes.
// Accumulator layout (m64nN f32): register 4 j + 2 h + e of thread t of a
// warpgroup is row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4)
// + e of the warpgroup's 64 x BN tile.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kGemmBM = 128;                      // rows of a block's tile
constexpr int kGemmBK = 64;                       // depth of a stage: 128-byte rows of bf16
constexpr int kGemmConsumers = 256;               // two warpgroups
constexpr int kGemmThreads = kGemmConsumers + 32; // + one producer warp
constexpr int kGemmBox = 64;                      // B box: 64 x 64 bf16, 8 KB

// Dynamic shared memory of a block: the stages, the 2 x kStages mbarriers,
// and 1 KB of slack to align the base to 1 KB.
template <int BN, int kStages>
constexpr int gemm_smem_bytes() {
  return kStages * (kGemmBM + BN) * kGemmBK * 2 + 2 * kStages * 8 + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of `bar` with this parity to complete; trap after a
// second instead of hanging on a copy that never lands.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (start == 0) start = now;
    if (now - start > 1000000000ull) __trap();
  }
}

// TMA: the box of `map` at (column c0, row c1) into shared memory at dst.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// TMA store: the box of `map` at (column c0, row c1) from shared memory at
// src, as a bulk async-group of this thread (rows and columns past the
// tensor are not written).  The threads that wrote src issue
// fence_proxy_async() and meet on a barrier first.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's TMA stores have yet to
// read their shared memory (kRead) or to complete.
template <int kPending, bool kRead>
__device__ __forceinline__ void tma_store_wait() {
  if (kRead) {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(kPending) : "memory");
  }
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma descriptor of a 128-byte-swizzled operand at shared address addr.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Ties every accumulator register to this point, so that no read or write
// of them moves across a wgmma wait or fence.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a . b on the warpgroup's 64 x N tile, over a depth of 16; a K-major,
// b K-major (kTransB 0) or MN-major (kTransB 1).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, 0, %99;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
}

template <int BN, bool kBMN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 256) {
    wgmma_m64n256k16<kBMN ? 1 : 0>(d, a, b, 1);
  } else if constexpr (BN == 192) {
    wgmma_m64n192k16<kBMN ? 1 : 0>(d, a, b, 1);
  } else if constexpr (BN == 128) {
    wgmma_m64n128k16<kBMN ? 1 : 0>(d, a, b, 1);
  } else {
    static_assert(BN == 64, "tiles are 64, 128, 192 or 256 columns wide");
    wgmma_m64n64k16<kBMN ? 1 : 0>(d, a, b, 1);
  }
}

// d += a . b on the warpgroup's 64 x N tile over a depth of 16, with A from
// registers and b K-major in shared memory.  Each warp of the warpgroup
// holds its 16 rows of A as the A fragment of mma.sync m16n8k16, which is
// also what ldmatrix.x4 gives lanes addressing rows lane % 16, 16-byte
// chunk lane / 16: a[0] (row g, k 2q..2q+1), a[1] (row g + 8), a[2] (k + 8),
// a[3] (row g + 8, k + 8), g = lane / 4, q = lane % 4.  The registers of a
// must stay unchanged until the group's wgmma_wait.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k16_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (BN == 128) {
    wgmma_m64n128k16_rs(d, a, b);
  } else {
    static_assert(BN == 64, "tiles are 64 or 128 columns wide");
    wgmma_m64n64k16_rs(d, a, b);
  }
}

// The ring of a block's kBM x BN tile over nk steps of depth 64: every
// thread of the block calls it.  The producer warp's lane 0 waits for each
// step's stage to be free, arms its "full" barrier with the stage's bytes
// and calls issue(a, b, t, bar), which starts the TMA copies of step t: the
// kBM x 64 A tile at shared address a, the BN x 64 B tile at b (BN / 64
// boxes of 8 KB; MN-major when kBMN), completing on bar.  It returns true
// in the consumer threads, with this thread's part of the tile in acc
// (layout above), and false in the producer warp, which has nothing more
// to do.  kBM is 128 (two consumer warpgroups, threads 0-255, producer
// 256-287) or 64 (one, threads 0-127, producer 128-159).
template <int BN, bool kBMN, int kStages, int kBM = kGemmBM, typename Issue>
__device__ __forceinline__ bool ring_mainloop(int nk, Issue issue, float (&acc)[BN / 2]) {
  static_assert(kBM == 64 || kBM == 128, "a tile is one or two warpgroups of 64 rows");
  constexpr int kConsumers = 2 * kBM;   // 128 threads a warpgroup of 64 rows
  constexpr uint32_t kABytes = kBM * kGemmBK * 2;
  constexpr uint32_t kStageBytes = kABytes + BN * kGemmBK * 2;
  constexpr uint32_t kBoxBytes = kGemmBox * kGemmBK * 2;
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  const uint32_t base = (smem_addr(gemm_smem) + 1023u) & ~1023u;
  const uint32_t full = base + kStages * kStageBytes;
  const uint32_t empty = full + 8 * kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {   // the producer warp: lane 0 loads
    if (threadIdx.x == kConsumers) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);   // round 0 passes at once
        const uint32_t a = base + s * kStageBytes, bar = full + 8 * s;
        mbar_expect_tx(bar, kStageBytes);   // boxes past the edge count in full
        issue(a, a + kABytes, t, bar);
      }
    }
    return false;
  }

  const uint32_t a_rows = (threadIdx.x / 128) * 64 * 128;   // this warpgroup's 64 rows of A
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  for (int t = 0; t < nk; ++t) {
    const int s = t % kStages;
    mbar_wait(full + 8 * s, (t / kStages) & 1);
    __syncwarp();   // the warp is converged for the .aligned wgmma instructions
    const uint32_t a = base + s * kStageBytes + a_rows, b = base + s * kStageBytes + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk) {
      const uint64_t da = sw128_desc(a + 32 * kk, 16, 1024);
      const uint64_t db = kBMN ? sw128_desc(b + 2048 * kk, kBoxBytes, 1024)
                               : sw128_desc(b + 32 * kk, 16, 1024);
      wgmma_k16<BN, kBMN>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();                                     // the products of stage t-1 are done,
    if (t > 0) mbar_arrive(empty + 8 * ((t - 1) % kStages));   // so it takes a new tile
  }
  wgmma_wait<0>();
  fence_acc(acc);
  return true;
}

// The block's 128 x BN tile of A . B over a depth of k (a multiple of 64):
// row tile blockIdx.y, column tile blockIdx.x, A and B read through TMA
// maps in 128 x 64 and 64 x 64 boxes.  As ring_mainloop.
template <int BN, bool kBMN, int kStages>
__device__ __forceinline__ bool gemm_mainloop(const CUtensorMap* amap, const CUtensorMap* bmap,
                                              int k, float (&acc)[BN / 2]) {
  constexpr uint32_t kBoxBytes = kGemmBox * kGemmBK * 2;
  const int row0 = blockIdx.y * kGemmBM, col0 = blockIdx.x * BN;
  return ring_mainloop<BN, kBMN, kStages>(
      k / kGemmBK,
      [&](uint32_t a, uint32_t b, int t, uint32_t bar) {
        tma_2d(a, amap, t * kGemmBK, row0, bar);
#pragma unroll
        for (int j = 0; j < BN / kGemmBox; ++j) {
          if (kBMN) {
            tma_2d(b + j * kBoxBytes, bmap, col0 + j * kGemmBox, t * kGemmBK, bar);
          } else {
            tma_2d(b + j * kBoxBytes, bmap, t * kGemmBK, col0 + j * kGemmBox, bar);
          }
        }
      },
      acc);
}

// The epilogue of a consumer thread's part of the 128 x BN tile at (row0,
// col0): for each pair of neighbouring columns it holds in a row < m,
// x = load(row, col) (a float2) and then store(row, col, v0, v1, x), with
// v0 at (row, col) and v1 at (row, col + 1) of C.  The loads of 4 n8
// column blocks are issued before their stores, so that their latencies
// overlap (a load could otherwise wait for every store before it, which
// the compiler cannot tell apart).
template <int BN, typename Load, typename Store>
__device__ __forceinline__ void gemm_epilogue_at(const float (&acc)[BN / 2], int m, int row0,
                                                 int col0, Load load, Store store) {
  constexpr int kGroup = 4;
  const int lane = threadIdx.x % 32;
  const int row = row0 + (threadIdx.x / 32) * 16 + lane / 4;
  const int col = col0 + 2 * (lane % 4);
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += kGroup) {
    float2 x[kGroup][2];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row + 8 * h < m) x[j][h] = load(row + 8 * h, col + 8 * (j0 + j));
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (j0 + j) + 2 * h;
        if (row + 8 * h < m) store(row + 8 * h, col + 8 * (j0 + j), acc[i], acc[i + 1], x[j][h]);
      }
    }
  }
}

// gemm_epilogue_at for the tile at row tile blockIdx.y, column tile
// blockIdx.x.
template <int BN, typename Load, typename Store>
__device__ __forceinline__ void gemm_epilogue(const float (&acc)[BN / 2], int m, Load load,
                                              Store store) {
  gemm_epilogue_at<BN>(acc, m, blockIdx.y * kGemmBM, blockIdx.x * BN, load, store);
}

// Makes the device's context current on the calling thread, once per
// thread.  A driver call (cuTensorMapEncode*) fails on a thread with no
// current context, as a thread that has made no runtime call yet
// (autograd's backward thread, when the device index already matches).
// cudaFree(nullptr) binds it, but cudaFree is not permitted while a stream
// is being captured into a CUDA graph, so a thread makes it only on its
// first map: the first steps of a captured run are eager, and autograd's
// device thread lives for the whole process.
cudaError_t bind_context() {
  static thread_local bool bound = false;
  if (!bound) {
    const cudaError_t err = cudaFree(nullptr);
    if (err != cudaSuccess) return err;
    bound = true;
  }
  return cudaSuccess;
}

// A TMA map of a row-major (rows, cols) bf16 matrix in boxes of
// (box_rows, box_cols).  cuTensorMapEncodeTiled is a driver function: it is
// found through the runtime, so the library needs no -lcuda.  It is a host
// call: the map goes into the launch's parameters, so a captured graph
// keeps it, which holds because the graph's pool gives every replay the
// same addresses.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                       int box_cols, CUtensorMapSwizzle swizzle) {
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
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The TMA maps the mainloop reads: an A operand (rows, cols) in 128 x 64
// boxes, a B operand in 64 x 64 boxes, both with the 128-byte swizzle.
cudaError_t gemm_a_map(CUtensorMap* map, const void* base, int rows, int cols) {
  return tensor_map(map, base, rows, cols, kGemmBM, kGemmBK, CU_TENSOR_MAP_SWIZZLE_128B);
}

cudaError_t gemm_b_map(CUtensorMap* map, const void* base, int rows, int cols) {
  return tensor_map(map, base, rows, cols, kGemmBox, kGemmBox, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launch kernel(args...) over the (ceil(m / 128), n / BN) tiles of an
// (m, n) product on `stream`; returns cudaGetLastError().
template <int BN, int kStages, typename... Params, typename... Args>
cudaError_t gemm_launch(void (*kernel)(Params...), int m, int n, cudaStream_t stream,
                        Args... args) {
  const int smem = gemm_smem_bytes<BN, kStages>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n / BN, (m + kGemmBM - 1) / kGemmBM), kGemmThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
