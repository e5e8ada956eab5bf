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
// step is at least one reduction over n + 1 values (ceil(log2(n + 1))
// dependent compares); the problems of a batch run side by side on their
// own SMs.
//
// It replaces the first design of this kernel, whose search step was one
// long dependent chain of ~1,380 cycles on an H100: a warp barrier, p[j0] and then
// u[p[j0]] from shared memory, an argmin of five butterfly rounds of two
// shuffles (value and index) each, a shared read-modify-write of u[p[j]] for
// every used column, a barrier and p[j0] again; and whose large path walked
// the n / 32 column chunks of a cost row one after another with one warp
// (~650 cycles a chunk).
//
// The shared path (n <= shgvqa_hungarian_max_n(), 238 on an H100): one warp
// a problem.
// - The (n+1)^2 f32 cost (row 0 and column 0 zero), u (by row), p (the row
//   matched to each column) and way live in dynamic shared memory:
//   4 (n + 1)(n + 4) bytes, 68,112 at n = 128.
// - Column j (1-indexed, column 0 the path sentinel) belongs to lane j % 32
//   as its slot j / 32, and the lane keeps the column's whole search state
//   in registers: v, minv, used, p[j] and u[p[j]], the potential of the
//   column's row.  So one pair of shuffles from column j0's lane gives the
//   step's row i0 = p[j0] and u[i0], and the "free column" test p[j0] == 0
//   is the same value.
// - The potentials of the used columns' rows move in those registers, with
//   the same __fadd_rn in the same order, so their bits are the plain
//   version's; they are written back to shared u only where u is read
//   again, once a row's search ends (the path walk and the next row read
//   p and u from shared memory).  way[j] = j0 stays a shared store, off the
//   chain.
// - The argmin is two redux.sync reductions: the minimum of an
//   order-preserving 32-bit key of each lane's candidate value (its first
//   minimum over its slots, scanned in increasing j with a strict <), then
//   the minimum column index over the lanes that hold that key: the first
//   minimum, as jnp.argmin and torch.argmin take it.  The key maps -0.0 and
//   +0.0 to one key (< treats them as equal) and keeps INF = 1e9 below the
//   +inf that starts a lane without columns.  delta is read back from the
//   key, so a -0.0 minimum becomes +0.0: the sign of a zero changes no
//   comparison and no nonzero sum, so no decision of the solve.
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
// The large path (above shgvqa_hungarian_max_n(), any n): one block of up to
// 32 warps a problem (a warp per 32 columns), the cost where the caller put
// it, in global memory.
// - Thread t owns a run of ceil((n + 1) / T) consecutive columns (T the
//   block's threads; one column each up to n = 1,023), so a warp loads 32
//   consecutive columns of the cost row a load and the loads of every chunk
//   of row i0 are in flight at once (the L2 holds a problem of n = 480,
//   0.9 MB), and lane order is column order.
// - u, v, minv, p, way and used live in one state block of kStateWords * 4
//   bytes a column: in dynamic shared memory up to
//   shgvqa_hungarian_large_smem_max_n(), in a global workspace the caller
//   gives above it; a column's v, minv, used and way are its owner's alone.
// - A step's argmin: each thread's first minimum over its run; in each warp
//   one redux.sync of the key and a ballot give the first lane that holds
//   the least key, which is the warp's first minimum (lane order is column
//   order); that lane's column, its row p[j] and u[p[j]] (read beside the
//   reduction: a column that is not used keeps its row, and that row's u,
//   for the whole search) go to shared memory; one block barrier; then
//   every warp reduces the warps' candidates the same way, so the next row
//   and its u arrive with the column.  The candidate buffers alternate
//   between steps, so one barrier a step suffices.  The owner of a used
//   column updates its row's u (rows are distinct).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxSlots = 8;            // n + 1 <= 256 columns
constexpr int kMaxWarps = 32;           // the large path's block
constexpr float kInf = 1e9f;            // the JAX solver's _INF
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t smem_bytes(int m) {
  return sizeof(float) * static_cast<size_t>(m) * (m + 1) + 2 * sizeof(int) * static_cast<size_t>(m);
}

// An order-preserving unsigned key of a float (no NaN): a < b exactly when
// key(a) < key(b); -0.0 and +0.0 share the key of +0.0.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(__fadd_rn(x, 0.0f));   // -0.0 + 0.0 = +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The first minimum over the warp of each lane's (value, column): the least
// key, then the least column among the lanes that hold it.
__device__ __forceinline__ void warp_argmin(uint32_t key, int col, uint32_t& kmin, int& jmin) {
  kmin = __reduce_min_sync(kFull, key);
  jmin = __reduce_min_sync(kFull, key == kmin ? col : INT_MAX);
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
    // the state of the lane's columns: p[j] (column 0: the row i being
    // placed) and its row's u, then minv and used
    int pj[kSlots];
    float up[kSlots], minv[kSlots];
    bool used[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int j = lane + kWarp * k;
      pj[k] = j == 0 ? i : (j < m ? p[j] : 0);
      up[k] = u[pj[k]];
      minv[k] = kInf;
      used[k] = false;
    }
    int j0 = 0, i0 = i;
    float ui0 = u[i];
    // The step is branch-free over the slots (selects and a predicated
    // store), so that the slots' work interleaves; a slot past the last
    // column takes part as +inf, which never wins.
    for (int trip = 0; trip <= n; ++trip) {
      // every slot's cost first: the stores to `way` below share the shared
      // array with the cost, so a load after one could not start before it
      const float* row = cx + i0 * m;
      float cij[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = lane + kWarp * k;
        used[k] = used[k] || j == j0;
        cij[k] = j < m ? row[j] : 0.0f;
      }
      float best = __int_as_float(0x7f800000);        // +inf: any column wins
      int best_j = m;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = lane + kWarp * k;
        const float cur = __fsub_rn(__fsub_rn(cij[k], ui0), v[k]);
        const bool better = j < m && !used[k] && cur < minv[k];
        minv[k] = better ? cur : minv[k];
        if (better) way[j] = j0;
        const float masked =
            j >= m ? __int_as_float(0x7f800000) : ((used[k] || j == 0) ? kInf : minv[k]);
        best_j = masked < best ? j : best_j;
        best = masked < best ? masked : best;
      }
      uint32_t kmin;
      int j1;
      warp_argmin(order_key(best), best_j, kmin, j1);
      const float delta = key_value(kmin);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {   // (a slot past the last column is never used)
        up[k] = used[k] ? __fadd_rn(up[k], delta) : up[k];
        v[k] = used[k] ? __fsub_rn(v[k], delta) : v[k];
        minv[k] = used[k] ? minv[k] : __fsub_rn(minv[k], delta);
      }
      j0 = j1;
      ++steps;
      // column j0's row and that row's u, from the column's lane
      const int k0 = j0 / kWarp;
      int pk = 0;
      float uk = 0.0f;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (k == k0) {
          pk = pj[k];
          uk = up[k];
        }
      }
      i0 = __shfl_sync(kFull, pk, j0 % kWarp);
      ui0 = __shfl_sync(kFull, uk, j0 % kWarp);
      if (i0 == 0) break;                               // a free column: done
    }
    // the rows of the used columns have moved their u: write it back, then
    // walk the augmenting path along `way` to the sentinel
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (used[k]) u[pj[k]] = up[k];
    }
    __syncwarp();
    if (lane == 0) {
      p[0] = i;
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

// The warp's first minimum when lane order is column order (each lane's
// columns follow the previous lane's): the least key, then the first lane
// that holds it.
__device__ __forceinline__ int first_lane_min(uint32_t key, uint32_t& kmin) {
  kmin = __reduce_min_sync(kFull, key);
  return __ffs(__ballot_sync(kFull, key == kmin)) - 1;
}

// the large path's state: u, v, minv (f32) and p, way, used (i32) a column
constexpr int kStateWords = 6;
// and, in shared memory, each warp's first minimum: 2 steps x kMaxWarps x
// (key, column, p[column], u[p[column]])
constexpr int kCandidateBytes = 2 * kMaxWarps * 4 * 4;

__host__ __device__ constexpr size_t large_state_bytes(int m) {
  return sizeof(float) * kStateWords * static_cast<size_t>(m);
}

// Warps of the large path's block for n: one per 32 columns, at most
// kMaxWarps.
__host__ __device__ constexpr int large_warps(int n) {
  return (n + kWarp) / kWarp < kMaxWarps ? (n + kWarp) / kWarp : kMaxWarps;
}

__global__ void __launch_bounds__(kMaxWarps * kWarp) hungarian_large_kernel(
    const float* __restrict__ cost, int64_t* __restrict__ row_to_col,
    int32_t* __restrict__ steps_out, int n, char* workspace, size_t stride) {
  extern __shared__ float smem[];
  const int m = n + 1;
  const int threads = blockDim.x, warps = threads / kWarp;
  const int t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  // thread t owns columns first..first + per - 1: lane order is column order
  const int per = (m + threads - 1) / threads, first = t * per;
  const int last = min(first + per, m);
  // the warps' candidates, then (without a workspace) the state
  uint32_t* cand = reinterpret_cast<uint32_t*>(smem);   // [2][kMaxWarps][4]
  float* state = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + kCandidateBytes);
  // six disjoint arrays of the state block
  float* __restrict__ u =
      workspace != nullptr ? reinterpret_cast<float*>(workspace + stride * blockIdx.x) : state;
  float* __restrict__ v = u + m;
  float* __restrict__ minv = v + m;
  int* __restrict__ p = reinterpret_cast<int*>(minv + m);
  int* __restrict__ way = p + m;
  int* __restrict__ used = way + m;
  const float* c = cost + static_cast<size_t>(blockIdx.x) * n * n;
  for (int j = t; j < m; j += threads) {
    u[j] = 0.0f;
    v[j] = 0.0f;
    p[j] = 0;
    way[j] = 0;
  }
  int steps = 0, parity = 0;
  __syncthreads();

  for (int i = 1; i <= n; ++i) {
    // (each thread its own columns, so no barrier)
    for (int j = first; j < last; ++j) {
      minv[j] = kInf;
      used[j] = j == 0;                                // column 0 is j0 of the first step
      if (j == 0) p[0] = i;
    }
    int j0 = 0, i0 = i;
    float ui0 = u[i];
    for (int trip = 0; trip <= n; ++trip) {
      const float* row = c + static_cast<size_t>(i0 - 1) * n - 1;   // row[j], j >= 1
      float best = __int_as_float(0x7f800000);        // +inf: any column wins
      int best_j = m;
      // branch-free over the columns, as the shared path
      for (int j = first; j < last; ++j) {
        const bool uj = used[j] != 0;
        const float cij = j == 0 ? 0.0f : __ldg(row + j);
        const float cur = __fsub_rn(__fsub_rn(cij, ui0), v[j]);
        const bool better = !uj && cur < minv[j];
        const float mv = better ? cur : minv[j];
        if (better) {
          minv[j] = cur;
          way[j] = j0;
        }
        const float masked = (uj || j == 0) ? kInf : mv;
        best_j = masked < best ? j : best_j;
        best = masked < best ? masked : best;
      }
      // the candidate column's row and that row's u (constant through the
      // search while the column is not used), beside the reduction
      const int pc = best_j < m ? p[best_j] : 0;
      const float uc = u[pc];
      uint32_t kmin;
      int win = first_lane_min(order_key(best), kmin);
      uint32_t* slot = cand + parity * 4 * kMaxWarps;
      const int jw = __shfl_sync(kFull, best_j, win);
      const int pw = __shfl_sync(kFull, pc, win);
      const float uw = __shfl_sync(kFull, uc, win);
      if (lane == 0) {
        slot[4 * warp] = kmin;
        slot[4 * warp + 1] = static_cast<uint32_t>(jw);
        slot[4 * warp + 2] = static_cast<uint32_t>(pw);
        slot[4 * warp + 3] = __float_as_uint(uw);
      }
      __syncthreads();
      // the warps' first minima, in column order too, reduced by every warp
      const uint32_t* mine = slot + 4 * (lane < warps ? lane : 0);
      win = first_lane_min(lane < warps ? mine[0] : 0xffffffffu, kmin);
      const int j1 = __shfl_sync(kFull, static_cast<int>(mine[1]), win);
      i0 = __shfl_sync(kFull, static_cast<int>(mine[2]), win);
      ui0 = __shfl_sync(kFull, __uint_as_float(mine[3]), win);
      parity ^= 1;
      const float delta = key_value(kmin);
      for (int j = first; j < last; ++j) {
        if (used[j]) {
          u[p[j]] = __fadd_rn(u[p[j]], delta);
          v[j] = __fsub_rn(v[j], delta);
        } else {
          minv[j] = __fsub_rn(minv[j], delta);
        }
      }
      j0 = j1;
      ++steps;
      if (i0 == 0) break;                               // a free column: done
      if (j0 >= first && j0 < last) used[j0] = 1;       // its owner marks it
    }
    __syncthreads();   // every update of u and way before the path walk
    if (t == 0) {
      for (int trip = 0; trip <= n && j0 != 0; ++trip) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }
  int64_t* out = row_to_col + static_cast<size_t>(blockIdx.x) * n;
  for (int j = 1 + t; j < m; j += threads) out[p[j] - 1] = j - 1;
  if (t == 0) steps_out[blockIdx.x] = steps;
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
// opt into beside the warps' candidates; above it the state needs a global
// workspace.  0 when the device cannot be queried.
int shgvqa_hungarian_large_smem_max_n(void) {
  const int optin = optin_smem();
  if (optin <= kCandidateBytes) return 0;
  return static_cast<int>((optin - kCandidateBytes) / large_state_bytes(1)) - 1;
}

// Bytes of one problem's state block in a workspace: kStateWords * 4 bytes
// a column, rounded up to 256.
size_t shgvqa_hungarian_large_stride(int n) {
  return (large_state_bytes(n + 1) + 255) / 256 * 256;
}

// The large path on `stream`, for any n >= 1: cost as shgvqa_hungarian; a
// block of min(32, ceil((n + 1) / 32)) warps a problem.  With workspace ==
// NULL the state lives in shared memory (n <=
// shgvqa_hungarian_large_smem_max_n()); else in the workspace, batch blocks
// of shgvqa_hungarian_large_stride(n) bytes.  Returns cudaGetLastError().
int shgvqa_hungarian_large(const float* cost, int64_t* row_to_col, int32_t* steps, void* workspace,
                           int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t bytes = kCandidateBytes;
  if (workspace == nullptr) {
    bytes += large_state_bytes(n + 1);
    if (bytes > static_cast<size_t>(optin_smem())) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(hungarian_large_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  hungarian_large_kernel<<<batch, large_warps(n) * kWarp, bytes, s>>>(
      cost, row_to_col, steps, n, static_cast<char*>(workspace), shgvqa_hungarian_large_stride(n));
  return static_cast<int>(cudaGetLastError());
}

const char* shgvqa_matcher_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
