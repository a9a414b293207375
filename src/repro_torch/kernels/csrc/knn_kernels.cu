// The NN-Descent build's three kernels, and the online store's compaction
// and row forms, for Hopper (sm_90a), fp32 CUDA C++.
//
// Built by kernels/_lib.py, together with search_kernels.cu, into one
// shared library with a plain C interface, loaded with ctypes:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
//        -fPIC -c <each source>; nvcc -shared -o libknn_kernels_<hash>.so
// Each launcher takes raw device pointers, sizes and a stream, launches on
// that stream without synchronising, allocates nothing, and returns
// cudaGetLastError(). The Python wrappers (kernels/knn_join.py,
// kernels/knn_merge.py) check shapes, dtypes and contiguity and allocate
// the outputs; kernels/ref.py holds the plain PyTorch version of each.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <climits>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// knn_join_dists: replaces knn_join_dists_blocked / _join_dists_kernel
// (src/repro/kernels/knn_join.py:49,82).
//
// Per row of candidate ids (C <= 64), the C x C squared-l2 pair tensor with
// the join mask folded in, plus the count of valid unordered pairs.
// Bound: operations. At the default build (C = 20, dp = 896) each row does
// 190 dot products of length 896 against 20 gathered rows of 3.5 KB, about
// 10 FMA per byte read, so the fp32 pipe (no tensor cores: fp32 is the exact
// stage) is the limit once the gathered rows sit in L2.
// Design: one block per row gathers its candidates' rows itself (no (n, C,
// dp) gathered copy in device memory), 64 features at a time, into shared
// memory with a padded row stride so that the threads of a warp, which read
// different rows at the same feature, hit different banks. Each thread owns
// up to 8 of the row's upper-triangle pairs and keeps their sums in
// registers across the feature tiles.
// ---------------------------------------------------------------------------

constexpr int kJoinThreads = 256;
constexpr int kJoinTile = 64;
constexpr int kJoinStride = kJoinTile + 1;
constexpr int kJoinMaxC = 64;
constexpr int kJoinPairsPerThread =
    (kJoinMaxC * (kJoinMaxC - 1) / 2 + kJoinThreads - 1) / kJoinThreads;

__global__ void __launch_bounds__(kJoinThreads) knn_join_dists_kernel(
    const float* __restrict__ x, const float* __restrict__ x2,
    const int* __restrict__ ids, float* __restrict__ od,
    int* __restrict__ ev, int N, int C, int dp, int cn) {
  extern __shared__ float smem[];
  float* tile = smem;                                     // C x kJoinStride
  int* sid = reinterpret_cast<int*>(tile + C * kJoinStride);   // C
  float* sx2 = reinterpret_cast<float*>(sid + C);              // C
  __shared__ int s_evals;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  for (int s = tid; s < C; s += kJoinThreads) {
    int id = ids[(int64_t)row * C + s];
    if (id >= N) id = -1;             // out of range: an invalid slot
    sid[s] = id;
    sx2[s] = id >= 0 ? x2[id] : 0.0f;
  }
  if (tid == 0) s_evals = 0;

  // this thread's pairs p = tid + j * kJoinThreads, as (s, t) with s < t
  // in row-major upper-triangle order
  const int P = C * (C - 1) / 2;
  int ps[kJoinPairsPerThread], pt[kJoinPairsPerThread];
  float acc[kJoinPairsPerThread];
#pragma unroll
  for (int j = 0; j < kJoinPairsPerThread; ++j) {
    const int p = tid + j * kJoinThreads;
    int s = 0, t = 0;
    if (p < P) {
      int rem = p;
      while (rem >= C - 1 - s) {
        rem -= C - 1 - s;
        ++s;
      }
      t = s + 1 + rem;
    }
    ps[j] = s;
    pt[j] = t;
    acc[j] = 0.0f;
  }
  __syncthreads();

  for (int d0 = 0; d0 < dp; d0 += kJoinTile) {
    const int width = min(kJoinTile, dp - d0);
    for (int e = tid; e < C * kJoinTile; e += kJoinThreads) {
      const int s = e / kJoinTile;
      const int dd = e - s * kJoinTile;
      const int id = sid[s];
      float v = 0.0f;
      if (id >= 0 && dd < width) v = x[(int64_t)id * dp + d0 + dd];
      tile[s * kJoinStride + dd] = v;   // zero beyond dp: adds exactly 0
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kJoinPairsPerThread; ++j) {
      if (tid + j * kJoinThreads < P) {
        const float* a = tile + ps[j] * kJoinStride;
        const float* b = tile + pt[j] * kJoinStride;
        float sum = acc[j];
#pragma unroll 16
        for (int dd = 0; dd < kJoinTile; ++dd) sum = fmaf(a[dd], b[dd], sum);
        acc[j] = sum;
      }
    }
    __syncthreads();
  }

  // epilogue: norm expansion, clamp, join mask; both (s, t) and (t, s)
  float* out = od + (int64_t)row * C * C;
  int local = 0;
#pragma unroll
  for (int j = 0; j < kJoinPairsPerThread; ++j) {
    if (tid + j * kJoinThreads < P) {
      const int s = ps[j], t = pt[j];
      const int a = sid[s], b = sid[t];
      const bool ok = (s < cn || t < cn) && a >= 0 && b >= 0 && a != b;
      float d = __fsub_rn(__fadd_rn(sx2[s], sx2[t]), __fmul_rn(2.0f, acc[j]));
      d = fmaxf(d, 0.0f);
      const float v = ok ? d : INFINITY;
      out[s * C + t] = v;
      out[t * C + s] = v;
      local += ok ? 1 : 0;
    }
  }
  for (int s = tid; s < C; s += kJoinThreads) out[s * C + s] = INFINITY;

  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((tid & 31) == 0) atomicAdd(&s_evals, local);
  __syncthreads();
  if (tid == 0) ev[row] = s_evals;
}

// ---------------------------------------------------------------------------
// knn_join_select: replaces knn_join_select_blocked / _join_select_kernel
// (src/repro/kernels/knn_join.py:125,152).
//
// Per row of W (dist, id) pairs: keep id >= 0 and dist < kth, return the c
// best ascending with ties to the lowest input position, (+inf, -1) fill.
// Bound: bytes. It reads 8 bytes per entry and writes 8 per output, with a
// handful of compares per entry.
// Design: one block per row. Each entry becomes one 64-bit key, (order-
// preserving bits of the distance, input position), so the lexicographic
// order that makes ties stable is a plain integer order; entries that fail
// the prefilter carry the FLT_MAX sentinel. A bitonic sort of the keys,
// padded to a power of two, runs in shared memory; the first c keys name
// the winners, whose values are read back from the input.
// ---------------------------------------------------------------------------

constexpr int kSelectThreads = 256;
constexpr int kSelectMaxPadded = 8192;   // 64 KB of keys

__device__ __forceinline__ uint32_t order_bits(float v) {
  if (v == 0.0f) v = 0.0f;               // -0 ties with +0, as in a sort
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kSelectThreads) knn_join_select_kernel(
    const float* __restrict__ gd, const int* __restrict__ gi,
    const float* __restrict__ kth, float* __restrict__ od,
    int* __restrict__ oi, int W, int padded, int c) {
  extern __shared__ unsigned long long keys[];
  const int row = blockIdx.x;
  const float th = kth[row];
  const float* rd = gd + (int64_t)row * W;
  const int* ri = gi + (int64_t)row * W;
  const uint32_t big = order_bits(FLT_MAX);

  for (int p = threadIdx.x; p < padded; p += kSelectThreads) {
    uint32_t kb = big;
    if (p < W) {
      const float d = rd[p];
      if (ri[p] >= 0 && d < th) kb = order_bits(d);
    }
    keys[p] = ((unsigned long long)kb << 32) | (unsigned)p;
  }
  __syncthreads();

  for (int size = 2; size <= padded; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < padded; i += kSelectThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = keys[i], b = keys[j];
          const bool ascending = (i & size) == 0;
          if ((a > b) == ascending) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int j = threadIdx.x; j < c; j += kSelectThreads) {
    float d = INFINITY;
    int id = -1;
    if (j < padded) {
      const unsigned long long key = keys[j];
      if ((uint32_t)(key >> 32) < big) {
        const int p = (int)(key & 0xffffffffu);
        d = rd[p];
        id = ri[p];
      }
    }
    od[(int64_t)row * c + j] = d;
    oi[(int64_t)row * c + j] = id;
  }
}

// ---------------------------------------------------------------------------
// The list kernels: knn_merge and knn_compact, each dense and in a row form.
//
// knn_merge replaces knn_merge_blocked / _merge_kernel
// (src/repro/kernels/knn_merge.py:30,156). Per row: drop candidates with
// id < 0, already in the list, or repeating an earlier candidate; then k
// rounds of argmin over [current k | candidates c], ties to the lowest pool
// position; count the candidate picks below the FLT_MAX sentinel. Sentinel
// slots come out (+inf, -1).
//
// knn_compact replaces knn_compact_blocked / _compact_kernel (:72,108), the
// tombstone purge. Per row: the survivors (not dropped, id >= 0, finite
// distance, so valid entries at the 3e38 placeholder survive) come out
// ascending, ties in input order, whatever the order of the input row;
// freed slots are (+inf, -1); `removed` counts dropped entries with id >= 0.
//
// knn_merge_rows / knn_compact_rows replace knn_merge_rows_blocked /
// knn_compact_rows_blocked (:210,237), the online store's frontier forms:
// slot s of the (f, .) candidates or drop mask applies to list row
// rows[s] (-1: padding, count 0, nothing written). The row indirection is
// in the kernel: it reads row rows[s] of the input lists and writes the
// same row of the output lists, which the wrapper made as a copy of the
// input, so no gather or scatter runs around it. Rows must be unique.
//
// Bound: bytes. They read and write 8 bytes per list and candidate entry
// (plus 1 per drop flag); the merge's dedup (k*c + c*c/2 compares) and
// the extraction rounds run on shared memory.
// Design: one warp per row stages its pool in shared memory. Each round is
// a strided scan plus a butterfly shuffle reduction over (dist, position),
// so every lane ends the round with the same winner and no block barrier
// is needed; the round loop stops at the first sentinel. The merge and the
// compaction share this extraction (`extract_rounds`): the merge stages
// [list | deduped candidates] with FLT_MAX as its sentinel, the compaction
// stages the row with +inf on every entry that does not survive. The dense
// and row kernels share `merge_row` / `compact_row`, which take the list
// row and the slot apart.
// ---------------------------------------------------------------------------

constexpr int kMergeWarps = 4;
constexpr int kMergeMaxPool = 1536;      // k + c: 4 warps x 1536 x 8 B = 48 KB

// Rounds of argmin over pd[0, m), ties to the lowest position, until k
// entries are out or the best is >= stop. Writes them to rod / roi, fills
// the rest with (+inf, -1), and returns (on every lane) how many of the
// picks came from positions >= first_cand.
__device__ __forceinline__ int extract_rounds(float* pd, const int* pi, int m,
                                              int k, float stop,
                                              int first_cand, float* rod,
                                              int* roi, int lane) {
  int picked = 0;
  int r = 0;
  for (; r < k; ++r) {
    float best = INFINITY;
    int bpos = INT_MAX;
    for (int p = lane; p < m; p += 32) {
      const float d = pd[p];
      if (d < best) {
        best = d;
        bpos = p;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int op = __shfl_xor_sync(0xffffffffu, bpos, off);
      if (ob < best || (ob == best && op < bpos)) {
        best = ob;
        bpos = op;
      }
    }
    if (best >= stop) break;             // only sentinels are left
    if (lane == 0) {
      rod[r] = best;
      roi[r] = pi[bpos];
      pd[bpos] = INFINITY;               // taken: above every live entry
    }
    picked += bpos >= first_cand ? 1 : 0;
    __syncwarp();
  }
  for (int j = r + lane; j < k; j += 32) {
    rod[j] = INFINITY;
    roi[j] = -1;
  }
  return picked;
}

// One warp merges candidate slot `slot` into list row `row`.
__device__ __forceinline__ void merge_row(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const float* __restrict__ qd, const int* __restrict__ qi,
    float* __restrict__ od, int* __restrict__ oi, int* __restrict__ upd,
    int slot, int row, int k, int c, float* pd, int* pi, int lane) {
  const int m = k + c;
  const float* rcd = cd + (int64_t)row * k;
  const int* rci = ci + (int64_t)row * k;
  const float* rqd = qd + (int64_t)slot * c;
  const int* rqi = qi + (int64_t)slot * c;
  for (int j = lane; j < k; j += 32) {
    const float d = rcd[j];
    pd[j] = fabsf(d) == INFINITY ? FLT_MAX : d;
    pi[j] = rci[j];
  }
  for (int j = lane; j < c; j += 32) pi[k + j] = rqi[j];
  __syncwarp();
  for (int j = lane; j < c; j += 32) {
    const int id = pi[k + j];
    bool dup = id < 0;
    for (int q = 0; q < k && !dup; ++q) dup = pi[q] == id;
    for (int q = 0; q < j && !dup; ++q) dup = pi[k + q] == id;
    pd[k + j] = dup ? FLT_MAX : rqd[j];
  }
  __syncwarp();
  const int accepted =
      extract_rounds(pd, pi, m, k, FLT_MAX, k, od + (int64_t)row * k,
                     oi + (int64_t)row * k, lane);
  if (lane == 0) upd[slot] = accepted;
}

// One warp compacts list row `row` under drop mask slot `slot`.
__device__ __forceinline__ void compact_row(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const unsigned char* __restrict__ drop, float* __restrict__ od,
    int* __restrict__ oi, int* __restrict__ removed, int slot, int row, int k,
    float* pd, int* pi, int lane) {
  const float* rcd = cd + (int64_t)row * k;
  const int* rci = ci + (int64_t)row * k;
  const unsigned char* rdr = drop + (int64_t)slot * k;
  int rm = 0;
  for (int j = lane; j < k; j += 32) {
    const float d = rcd[j];
    const int id = rci[j];
    const bool dr = rdr[j] != 0;
    rm += (dr && id >= 0) ? 1 : 0;
    pd[j] = (!dr && id >= 0 && isfinite(d)) ? d : INFINITY;
    pi[j] = id;
  }
  for (int off = 16; off > 0; off >>= 1)
    rm += __shfl_xor_sync(0xffffffffu, rm, off);
  __syncwarp();
  extract_rounds(pd, pi, k, k, INFINITY, k, od + (int64_t)row * k,
                 oi + (int64_t)row * k, lane);
  if (lane == 0) removed[slot] = rm;
}

__global__ void __launch_bounds__(kMergeWarps * 32) knn_merge_kernel(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const float* __restrict__ qd, const int* __restrict__ qi,
    float* __restrict__ od, int* __restrict__ oi, int* __restrict__ upd,
    int n, int k, int c) {
  extern __shared__ float msm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  float* pd = msm + (int64_t)warp * 2 * (k + c);
  int* pi = reinterpret_cast<int*>(pd + k + c);
  if (row >= n) return;                  // no block barrier below
  merge_row(cd, ci, qd, qi, od, oi, upd, row, row, k, c, pd, pi, lane);
}

__global__ void __launch_bounds__(kMergeWarps * 32) knn_merge_rows_kernel(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const int* __restrict__ rows, const float* __restrict__ qd,
    const int* __restrict__ qi, float* __restrict__ od, int* __restrict__ oi,
    int* __restrict__ upd, int n, int f, int k, int c) {
  extern __shared__ float msm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kMergeWarps + warp;
  float* pd = msm + (int64_t)warp * 2 * (k + c);
  int* pi = reinterpret_cast<int*>(pd + k + c);
  if (slot >= f) return;
  const int row = rows[slot];
  if (row < 0 || row >= n) {             // padding: count 0, write nothing
    if (lane == 0) upd[slot] = 0;
    return;
  }
  merge_row(cd, ci, qd, qi, od, oi, upd, slot, row, k, c, pd, pi, lane);
}

__global__ void __launch_bounds__(kMergeWarps * 32) knn_compact_kernel(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const unsigned char* __restrict__ drop, float* __restrict__ od,
    int* __restrict__ oi, int* __restrict__ removed, int n, int k) {
  extern __shared__ float msm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  float* pd = msm + (int64_t)warp * 2 * k;
  int* pi = reinterpret_cast<int*>(pd + k);
  if (row >= n) return;
  compact_row(cd, ci, drop, od, oi, removed, row, row, k, pd, pi, lane);
}

__global__ void __launch_bounds__(kMergeWarps * 32) knn_compact_rows_kernel(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const int* __restrict__ rows, const unsigned char* __restrict__ drop,
    float* __restrict__ od, int* __restrict__ oi, int* __restrict__ removed,
    int n, int f, int k) {
  extern __shared__ float msm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kMergeWarps + warp;
  float* pd = msm + (int64_t)warp * 2 * k;
  int* pi = reinterpret_cast<int*>(pd + k);
  if (slot >= f) return;
  const int row = rows[slot];
  if (row < 0 || row >= n) {
    if (lane == 0) removed[slot] = 0;
    return;
  }
  compact_row(cd, ci, drop, od, oi, removed, slot, row, k, pd, pi, lane);
}

}  // namespace

extern "C" {

const char* knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int knn_join_dists_launch(const float* x, const float* x2, const int* ids,
                          float* od, int* ev, int N, int n, int C, int dp,
                          int cn, cudaStream_t stream) {
  if (n <= 0 || C < 1 || C > kJoinMaxC) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)C * kJoinStride * sizeof(float) +
                      (size_t)C * (sizeof(int) + sizeof(float));
  knn_join_dists_kernel<<<n, kJoinThreads, smem, stream>>>(x, x2, ids, od, ev,
                                                            N, C, dp, cn);
  return (int)cudaGetLastError();
}

int knn_join_select_launch(const float* gd, const int* gi, const float* kth,
                           float* od, int* oi, int n, int W, int c,
                           cudaStream_t stream) {
  if (n <= 0 || W < 0 || c < 1) return (int)cudaErrorInvalidValue;
  int padded = 1;
  while (padded < W) padded <<= 1;
  if (padded > kSelectMaxPadded) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)padded * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      knn_join_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  knn_join_select_kernel<<<n, kSelectThreads, smem, stream>>>(
      gd, gi, kth, od, oi, W, padded, c);
  return (int)cudaGetLastError();
}

int knn_merge_launch(const float* cd, const int* ci, const float* qd,
                     const int* qi, float* od, int* oi, int* upd, int n, int k,
                     int c, cudaStream_t stream) {
  if (n <= 0 || k < 1 || c < 0 || k + c > kMergeMaxPool)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kMergeWarps * (k + c) * 2 * sizeof(float);
  const int blocks = (n + kMergeWarps - 1) / kMergeWarps;
  knn_merge_kernel<<<blocks, kMergeWarps * 32, smem, stream>>>(
      cd, ci, qd, qi, od, oi, upd, n, k, c);
  return (int)cudaGetLastError();
}

int knn_merge_rows_launch(const float* cd, const int* ci, const int* rows,
                          const float* qd, const int* qi, float* od, int* oi,
                          int* upd, int n, int f, int k, int c,
                          cudaStream_t stream) {
  if (f <= 0 || k < 1 || c < 0 || k + c > kMergeMaxPool)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kMergeWarps * (k + c) * 2 * sizeof(float);
  const int blocks = (f + kMergeWarps - 1) / kMergeWarps;
  knn_merge_rows_kernel<<<blocks, kMergeWarps * 32, smem, stream>>>(
      cd, ci, rows, qd, qi, od, oi, upd, n, f, k, c);
  return (int)cudaGetLastError();
}

int knn_compact_launch(const float* cd, const int* ci,
                       const unsigned char* drop, float* od, int* oi,
                       int* removed, int n, int k, cudaStream_t stream) {
  if (n <= 0 || k < 1 || k > kMergeMaxPool) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kMergeWarps * k * 2 * sizeof(float);
  const int blocks = (n + kMergeWarps - 1) / kMergeWarps;
  knn_compact_kernel<<<blocks, kMergeWarps * 32, smem, stream>>>(
      cd, ci, drop, od, oi, removed, n, k);
  return (int)cudaGetLastError();
}

int knn_compact_rows_launch(const float* cd, const int* ci, const int* rows,
                            const unsigned char* drop, float* od, int* oi,
                            int* removed, int n, int f, int k,
                            cudaStream_t stream) {
  if (f <= 0 || k < 1 || k > kMergeMaxPool) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kMergeWarps * k * 2 * sizeof(float);
  const int blocks = (f + kMergeWarps - 1) / kMergeWarps;
  knn_compact_rows_kernel<<<blocks, kMergeWarps * 32, smem, stream>>>(
      cd, ci, rows, drop, od, oi, removed, n, f, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
