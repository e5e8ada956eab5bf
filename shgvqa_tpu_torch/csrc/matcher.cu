// Exact n x n linear assignment (minimum total cost) for a batch of problems,
// one problem per block: the global Hungarian matching of the set losses
// (loss_hg_per_frame=False), 128 x 128 for the relations and 48 x 48 for the
// actions of a flagship clip.
//
// Replaces no Pallas kernel: it is the port of the JAX package's
// shgvqa_tpu/ops/matcher.py::hungarian_square, a shortest-augmenting-path
// (Jonker-Volgenant) solver written in jax.lax with fixed trip counts.  In
// eager PyTorch each of its n * (n + 1) dependent steps would be ~15
// launches; here the whole solve is one launch.  Its plain version, step for
// step the same arithmetic, is hungarian_square_reference in
// shgvqa_tpu_torch/ops/matcher.py.
//
// What bounds it on the card: neither bytes (a 128 x 128 f32 cost is 64 KB)
// nor operations, but the chain of dependent search steps: each step's
// column j1 = argmin over the n + 1 columns decides the next step's row.  A
// step is one reduction over n + 1 values; the problems of a batch run side
// by side on their own SMs.
//
// Design: one warp a problem (a block of 32 threads), so that a step's
// argmin is a warp reduction of 5 shuffle rounds and no block barrier.
// - Column j (1-indexed, column 0 the path sentinel) belongs to lane j % 32
//   as its slot j / 32: v, minv and used live in that lane's registers.
// - The (n+1)^2 f32 cost (row 0 and column 0 zero), u (by row), p (the row
//   matched to each column) and way live in dynamic shared memory:
//   4 (n + 1)(n + 4) bytes, 68,112 at n = 128.
// - The argmin: each lane scans its slots in increasing j with a strict <,
//   then the (value, index) pairs meet in a butterfly of shuffles where the
//   smaller value, or on a tie the smaller index, wins: the first minimum,
//   as jnp.argmin and torch.argmin take it.
//
// Numerics, bit for bit as the JAX solver and the plain version:
// - INF = 1e9 marks used columns and column 0 in the argmin, as in JAX;
// - cur = (cx[i0] - u[i0]) - v, two subtractions rounded separately;
// - the potentials move by delta times 0 or 1: u[r] + delta for the rows of
//   the used columns (the scatter u.at[p].add(used_f) adds exactly one 1 to
//   each such row, since used columns hold distinct rows), v - delta on the
//   used columns, minv - delta on the others.  A product by 1 is exact, so
//   fused or separate rounding agree; the updates are written with
//   __fadd_rn / __fsub_rn, which nvcc does not contract.  A product by 0
//   adds +-0, which changes no value (at most the sign of a zero, which no
//   comparison sees), so those updates are skipped;
// - the fixed trip counts of JAX end here as soon as the augmenting path
//   reaches a free column (p[j0] == 0): from then on every JAX trip is
//   masked (delta 0, used_f 0), so u, v, minv and way keep their values.
//   The path walk likewise ends at the sentinel.
//
// Above the shared-memory limit (n > shgvqa_hungarian_max_n(): the
// (n+1)^2 cost no longer fits a block, n = 239 on an H100) the large path
// takes the problem, with the same warp, the same arithmetic and the same
// order of visits and ties:
// - the cost stays where the caller put it, in global memory, and each
//   step reads row i0's n floats from it, 32 consecutive columns a load
//   (the L2 holds a problem of n = 480, 0.9 MB);
// - u, v, minv, p, way and used live in one state block of
//   kStateWords * 4 bytes a column: in dynamic shared memory up to
//   shgvqa_hungarian_large_smem_max_n() (n = 9,684 on an H100), in a
//   global workspace the caller gives above it;
// - the warp walks the columns in chunks of 32, column j in lane j % 32,
//   so there is no fixed column cap; a lane scans its columns in
//   increasing j with a strict <, and the butterfly keeps the smaller
//   value, on a tie the smaller index: the first minimum again.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxSlots = 8;            // n + 1 <= 256 columns
constexpr float kInf = 1e9f;            // the JAX solver's _INF
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t smem_bytes(int m) {
  return sizeof(float) * static_cast<size_t>(m) * (m + 1) + 2 * sizeof(int) * static_cast<size_t>(m);
}

template <int kSlots>
__global__ void __launch_bounds__(kWarp) hungarian_kernel(const float* __restrict__ cost,
                                                          int64_t* __restrict__ row_to_col,
                                                          int32_t* __restrict__ steps_out, int n) {
  extern __shared__ float smem[];
  const int m = n + 1;
  float* cx = smem;                                   // (m, m)
  float* u = cx + m * m;                              // (m,) by row
  int* p = reinterpret_cast<int*>(u + m);             // (m,) row of each column
  int* way = p + m;                                   // (m,)
  const int lane = threadIdx.x;
  const float* c = cost + static_cast<size_t>(blockIdx.x) * n * n;
  for (int idx = lane; idx < m * m; idx += kWarp) {
    const int r = idx / m, col = idx - r * m;
    cx[idx] = (r == 0 || col == 0) ? 0.0f : c[(r - 1) * n + (col - 1)];
  }
  for (int j = lane; j < m; j += kWarp) {
    u[j] = 0.0f;
    p[j] = 0;
    way[j] = 0;
  }
  float v[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) v[k] = 0.0f;
  int steps = 0;
  __syncwarp();

  for (int i = 1; i <= n; ++i) {
    if (lane == 0) p[0] = i;
    float minv[kSlots];
    bool used[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      minv[k] = kInf;
      used[k] = false;
    }
    int j0 = 0;
    __syncwarp();
    for (int trip = 0; trip <= n; ++trip) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (lane + kWarp * k == j0) used[k] = true;
      const int i0 = p[j0];
      const float ui0 = u[i0];
      const float* row = cx + i0 * m;
      float best = __int_as_float(0x7f800000);        // +inf: any column wins
      int best_j = m;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = lane + kWarp * k;
        if (j < m) {
          const float cur = __fsub_rn(__fsub_rn(row[j], ui0), v[k]);
          if (cur < minv[k] && !used[k]) {
            minv[k] = cur;
            way[j] = j0;
          }
          const float masked = (used[k] || j == 0) ? kInf : minv[k];
          if (masked < best) {
            best = masked;
            best_j = j;
          }
        }
      }
#pragma unroll
      for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
        const float other = __shfl_xor_sync(kFull, best, offset);
        const int other_j = __shfl_xor_sync(kFull, best_j, offset);
        if (other < best || (other == best && other_j < best_j)) {
          best = other;
          best_j = other_j;
        }
      }
      const float delta = best;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = lane + kWarp * k;
        if (j < m) {
          if (used[k]) {
            u[p[j]] = __fadd_rn(u[p[j]], delta);
            v[k] = __fsub_rn(v[k], delta);
          } else {
            minv[k] = __fsub_rn(minv[k], delta);
          }
        }
      }
      j0 = best_j;
      ++steps;
      __syncwarp();
      if (p[j0] == 0) break;                            // a free column: done
    }
    // the augmenting path: walk `way` back to the sentinel
    if (lane == 0) {
      for (int trip = 0; trip <= n && j0 != 0; ++trip) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncwarp();
  }
  int64_t* out = row_to_col + static_cast<size_t>(blockIdx.x) * n;
  for (int j = 1 + lane; j < m; j += kWarp) out[p[j] - 1] = j - 1;
  if (lane == 0) steps_out[blockIdx.x] = steps;
}

// the large path's state: u, v, minv (f32) and p, way, used (i32) a column
constexpr int kStateWords = 6;

__host__ __device__ constexpr size_t large_state_bytes(int m) {
  return sizeof(float) * kStateWords * static_cast<size_t>(m);
}

__global__ void __launch_bounds__(kWarp) hungarian_large_kernel(
    const float* __restrict__ cost, int64_t* __restrict__ row_to_col,
    int32_t* __restrict__ steps_out, int n, char* workspace, size_t stride) {
  extern __shared__ float smem[];
  const int m = n + 1;
  // six disjoint arrays of the state block
  float* __restrict__ u =
      workspace != nullptr ? reinterpret_cast<float*>(workspace + stride * blockIdx.x) : smem;
  float* __restrict__ v = u + m;
  float* __restrict__ minv = v + m;
  int* __restrict__ p = reinterpret_cast<int*>(minv + m);
  int* __restrict__ way = p + m;
  int* __restrict__ used = way + m;
  const int lane = threadIdx.x;
  const float* c = cost + static_cast<size_t>(blockIdx.x) * n * n;
  for (int j = lane; j < m; j += kWarp) {
    u[j] = 0.0f;
    v[j] = 0.0f;
    p[j] = 0;
    way[j] = 0;
  }
  int steps = 0;
  __threadfence_block();
  __syncwarp();

  for (int i = 1; i <= n; ++i) {
    if (lane == 0) p[0] = i;
    for (int j = lane; j < m; j += kWarp) {
      minv[j] = kInf;
      used[j] = 0;
    }
    int j0 = 0;
    __threadfence_block();
    __syncwarp();
    for (int trip = 0; trip <= n; ++trip) {
      if (lane == (j0 & (kWarp - 1))) used[j0] = 1;   // column j0's lane
      const int i0 = p[j0];
      const float ui0 = u[i0];
      const float* row = c + static_cast<size_t>(i0 - 1) * n - 1;   // row[j], j >= 1
      float best = __int_as_float(0x7f800000);        // +inf: any column wins
      int best_j = m;
#pragma unroll 4
      for (int jb = 0; jb < m; jb += kWarp) {
        const int j = jb + lane;
        if (j < m) {
          const bool uj = used[j] != 0;
          float mv = minv[j];
          // loaded whether or not the column is used, so that the
          // unrolled chunks' loads are in flight together
          const float cij = j == 0 ? 0.0f : __ldg(row + j);
          if (!uj) {
            const float cur = __fsub_rn(__fsub_rn(cij, ui0), v[j]);
            if (cur < mv) {
              mv = cur;
              minv[j] = cur;
              way[j] = j0;
            }
          }
          const float masked = (uj || j == 0) ? kInf : mv;
          if (masked < best) {
            best = masked;
            best_j = j;
          }
        }
      }
#pragma unroll
      for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
        const float other = __shfl_xor_sync(kFull, best, offset);
        const int other_j = __shfl_xor_sync(kFull, best_j, offset);
        if (other < best || (other == best && other_j < best_j)) {
          best = other;
          best_j = other_j;
        }
      }
      const float delta = best;
#pragma unroll 4
      for (int j = lane; j < m; j += kWarp) {
        if (used[j]) {
          u[p[j]] = __fadd_rn(u[p[j]], delta);
          v[j] = __fsub_rn(v[j], delta);
        } else {
          minv[j] = __fsub_rn(minv[j], delta);
        }
      }
      j0 = best_j;
      ++steps;
      __threadfence_block();
      __syncwarp();
      if (p[j0] == 0) break;                            // a free column: done
    }
    if (lane == 0) {
      for (int trip = 0; trip <= n && j0 != 0; ++trip) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __threadfence_block();
    __syncwarp();
  }
  int64_t* out = row_to_col + static_cast<size_t>(blockIdx.x) * n;
  for (int j = 1 + lane; j < m; j += kWarp) out[p[j] - 1] = j - 1;
  if (lane == 0) steps_out[blockIdx.x] = steps;
}

int optin_smem() {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess) {
    return 0;
  }
  return optin;
}

template <int kSlots>
cudaError_t launch(const float* cost, int64_t* row_to_col, int32_t* steps, int batch, int n,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(n + 1);
  cudaError_t err = cudaFuncSetAttribute(hungarian_kernel<kSlots>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  hungarian_kernel<kSlots><<<batch, kWarp, bytes, stream>>>(cost, row_to_col, steps, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest n the kernel takes on the current device: its (n+1)^2 cost,
// u, p and way in the shared memory a block may opt into, and n + 1 <=
// 32 * kMaxSlots columns.  0 when the device cannot be queried.
int shgvqa_hungarian_max_n(void) {
  const int optin = optin_smem();
  if (optin == 0) return 0;
  int n = kWarp * kMaxSlots - 1;
  while (n > 0 && smem_bytes(n + 1) > static_cast<size_t>(optin)) --n;
  return n;
}

// Solves `batch` problems on `stream`; returns cudaGetLastError() (0 =
// launched).  Device pointers: cost (batch, n, n) f32 contiguous;
// row_to_col (batch, n) int64, a permutation each; steps (batch,) int32, the
// search steps each problem took.  1 <= n <= shgvqa_hungarian_max_n().
int shgvqa_hungarian(const float* cost, int64_t* row_to_col, int32_t* steps, int batch, int n,
                     void* stream) {
  if (batch <= 0 || n <= 0 || n >= kWarp * kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((n + kWarp) / kWarp) {                       // slots = ceil((n + 1) / 32)
    case 1: err = launch<1>(cost, row_to_col, steps, batch, n, s); break;
    case 2: err = launch<2>(cost, row_to_col, steps, batch, n, s); break;
    case 3: err = launch<3>(cost, row_to_col, steps, batch, n, s); break;
    case 4: err = launch<4>(cost, row_to_col, steps, batch, n, s); break;
    case 5: err = launch<5>(cost, row_to_col, steps, batch, n, s); break;
    case 6: err = launch<6>(cost, row_to_col, steps, batch, n, s); break;
    case 7: err = launch<7>(cost, row_to_col, steps, batch, n, s); break;
    default: err = launch<8>(cost, row_to_col, steps, batch, n, s); break;
  }
  return static_cast<int>(err);
}

// The largest n whose large-path state fits the shared memory a block may
// opt into; above it the state needs a global workspace.  0 when the device
// cannot be queried.
int shgvqa_hungarian_large_smem_max_n(void) {
  const int optin = optin_smem();
  if (optin == 0) return 0;
  return static_cast<int>(optin / large_state_bytes(1)) - 1;
}

// Bytes of one problem's state block in a workspace: kStateWords * 4 bytes
// a column, rounded up to 256.
size_t shgvqa_hungarian_large_stride(int n) {
  return (large_state_bytes(n + 1) + 255) / 256 * 256;
}

// The large path on `stream`, for any n >= 1: cost as shgvqa_hungarian.
// With workspace == NULL the state lives in shared memory (n <=
// shgvqa_hungarian_large_smem_max_n()); else in the workspace, batch blocks
// of shgvqa_hungarian_large_stride(n) bytes.  Returns cudaGetLastError().
int shgvqa_hungarian_large(const float* cost, int64_t* row_to_col, int32_t* steps, void* workspace,
                           int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t bytes = 0;
  if (workspace == nullptr) {
    bytes = large_state_bytes(n + 1);
    if (bytes > static_cast<size_t>(optin_smem())) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(hungarian_large_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hungarian_large_kernel<<<batch, kWarp, bytes, s>>>(cost, row_to_col, steps, n,
                                                    static_cast<char*>(workspace),
                                                    shgvqa_hungarian_large_stride(n));
  return static_cast<int>(cudaGetLastError());
}

const char* shgvqa_matcher_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
