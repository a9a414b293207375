// The query path's two kernels for Hopper (sm_90a), fp32 CUDA C++.
//
// Built by kernels/_lib.py together with knn_kernels.cu into one shared
// library with a plain C interface (each source compiled by its own nvcc,
// all started together, then linked) and loaded with ctypes. Each launcher
// takes raw device pointers, sizes and a stream, launches on that stream
// without synchronising, allocates nothing, and returns cudaGetLastError().
// The Python wrappers (kernels/l2_blocked.py, kernels/knn_search.py) check
// shapes, dtypes and contiguity and allocate the outputs; kernels/ref.py
// holds the plain PyTorch version of each.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// pairwise_sq_l2: replaces pairwise_sq_l2_blocked / _l2_kernel
// (src/repro/kernels/l2_blocked.py:38,63).
//
// (M, D) x (N, D) f32 -> (M, N) f32 squared l2 by the norm expansion,
// |a|^2 + |b|^2 - 2 a.b, clamped at 0. The norms are accumulated alongside
// the cross term from the same shared-memory tiles, as the TPU kernel does.
// Bound: operations. 2*M*N*D fp32 FMAs against M*N*4 bytes out; at the
// brute-force shape (4096 x 70000 x 784) that is about 400 operations per
// byte written, so the fp32 pipe (no TF32 or bf16: fp32 means fp32, this
// is the repository's ground truth) sets the floor.
// Design: a classic SIMT tile. A block of 256 threads owns a 128 x 128
// output tile and walks D in chunks of 16; each chunk of A and B is staged
// in shared memory transposed (k-major), and the next chunk is loaded into
// registers while the current one is multiplied. Each thread keeps an
// 8 x 8 micro-tile of sums in registers: rows {4ty..4ty+3, 64+4ty..}, cols
// {4tx..4tx+3, 64+4tx..}, so a warp's float4 reads of a B row hit 16
// distinct, consecutive addresses and those of an A row are broadcasts.
// Ragged M, N and D edges are masked in the loads (zero rows and features
// add exactly 0) and in the stores.
// ---------------------------------------------------------------------------

constexpr int kL2Threads = 256;
constexpr int kL2BM = 128;
constexpr int kL2BN = 128;
constexpr int kL2BK = 16;
// float4 slots of one staged chunk per thread: 128 rows x 16 k / 4 / 256
constexpr int kL2Loads = kL2BM * kL2BK / 4 / kL2Threads;

__device__ __forceinline__ float4 load_chunk4(const float* __restrict__ p,
                                              int64_t row, int rows, int k,
                                              int D, bool vec) {
  // four consecutive features k..k+3 of one row, zero outside the matrix
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return v;
  const float* r = p + row * (int64_t)D;
  if (vec) {
    // D % 4 == 0 and 16-byte aligned rows: k < D implies k + 3 < D
    if (k < D) v = __ldg(reinterpret_cast<const float4*>(r + k));
  } else {
    if (k < D) v.x = __ldg(r + k);
    if (k + 1 < D) v.y = __ldg(r + k + 1);
    if (k + 2 < D) v.z = __ldg(r + k + 2);
    if (k + 3 < D) v.w = __ldg(r + k + 3);
  }
  return v;
}

__global__ void __launch_bounds__(kL2Threads) pairwise_sq_l2_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int M, int N, int D, bool vec) {
  __shared__ __align__(16) float as[kL2BK][kL2BM];
  __shared__ __align__(16) float bs[kL2BK][kL2BN];
  __shared__ float a2s[kL2BM];
  __shared__ float b2s[kL2BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t m0 = (int64_t)blockIdx.y * kL2BM;
  const int64_t n0 = (int64_t)blockIdx.x * kL2BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float nrm = 0.0f;   // tid < 128: |a|^2 of tile row tid; else |b|^2

  // loader slot s = tid + l * 256: tile row s / 4, features 4 * (s % 4)
  float4 ra[kL2Loads], rb[kL2Loads];
#pragma unroll
  for (int l = 0; l < kL2Loads; ++l) {
    const int s = tid + l * kL2Threads;
    ra[l] = load_chunk4(a, m0 + (s >> 2), M, (s & 3) * 4, D, vec);
    rb[l] = load_chunk4(b, n0 + (s >> 2), N, (s & 3) * 4, D, vec);
  }

  for (int k0 = 0; k0 < D; k0 += kL2BK) {
#pragma unroll
    for (int l = 0; l < kL2Loads; ++l) {
      const int s = tid + l * kL2Threads;
      const int r = s >> 2;
      const int kq = (s & 3) * 4;
      as[kq][r] = ra[l].x;
      as[kq + 1][r] = ra[l].y;
      as[kq + 2][r] = ra[l].z;
      as[kq + 3][r] = ra[l].w;
      bs[kq][r] = rb[l].x;
      bs[kq + 1][r] = rb[l].y;
      bs[kq + 2][r] = rb[l].z;
      bs[kq + 3][r] = rb[l].w;
    }
    __syncthreads();

    // the next chunk travels from device memory while this one is used
    if (k0 + kL2BK < D) {
#pragma unroll
      for (int l = 0; l < kL2Loads; ++l) {
        const int s = tid + l * kL2Threads;
        const int k = k0 + kL2BK + (s & 3) * 4;
        ra[l] = load_chunk4(a, m0 + (s >> 2), M, k, D, vec);
        rb[l] = load_chunk4(b, n0 + (s >> 2), N, k, D, vec);
      }
    }

    if (tid < kL2BM) {
#pragma unroll
      for (int kk = 0; kk < kL2BK; ++kk) {
        const float v = as[kk][tid];
        nrm = fmaf(v, v, nrm);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kL2BK; ++kk) {
        const float v = bs[kk][tid - kL2BM];
        nrm = fmaf(v, v, nrm);
      }
    }

#pragma unroll
    for (int kk = 0; kk < kL2BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[kk][64 + 4 * tx]);
      const float af[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bf[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < kL2BM) {
    a2s[tid] = nrm;
  } else {
    b2s[tid - kL2BM] = nrm;
  }
  __syncthreads();

  // epilogue: (|a|^2 + |b|^2) - 2 a.b, clamped, in the plain version's
  // order of operations (no fused multiply-add)
  const bool vec_out = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ri = (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
    const int64_t m = m0 + ri;
    if (m >= M) continue;
    float* orow = out + m * (int64_t)N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cj = h * 64 + 4 * tx;
      const int64_t n = n0 + cj;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = __fsub_rn(__fadd_rn(a2s[ri], b2s[cj + j]),
                                  __fmul_rn(2.0f, acc[i][4 * h + j]));
        v[j] = fmaxf(d, 0.0f);
      }
      if (vec_out && n + 3 < N) {
        *reinterpret_cast<float4*>(orow + n) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) orow[n + j] = v[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// knn_search_dists: replaces knn_search_dists_blocked / _search_dists_kernel
// (src/repro/kernels/knn_search.py:47,66).
//
// Per query, the squared l2 to each of its W candidates, q2 + c2 - 2 q.c,
// clamped at 0; a candidate id outside [0, N) (-1: an empty slot, a dead
// or filtered row) comes out +inf.
// Input form: the TPU kernel takes the candidate rows gathered beforehand,
// (nq, W, dp). At the search's shape (q_block 512, W = expand * k = 120,
// dp 784) that copy is about 190 MB per round, so this kernel takes the
// ids and the base rows and gathers them itself.
// Bound: bytes. Each valid candidate costs one row of dp floats read for
// 2*dp operations, a quarter of an operation per byte.
// Design: one block per query keeps the query row in shared memory; each of
// its 8 warps takes every 8th candidate and streams that row with 16-byte
// loads (4-byte loads where dp % 4 != 0 or a row is not 16-byte aligned),
// then reduces the dot product with shuffles. No row is read for an
// invalid id.
// ---------------------------------------------------------------------------

constexpr int kSearchThreads = 256;
constexpr int kSearchWarps = kSearchThreads / 32;
constexpr int kSearchMaxDp = 12288;   // 48 KB of query row in shared memory

__global__ void __launch_bounds__(kSearchThreads) knn_search_dists_kernel(
    const float* __restrict__ q, const float* __restrict__ q2,
    const float* __restrict__ x, const float* __restrict__ x2,
    const int* __restrict__ ids, float* __restrict__ od, int N, int W,
    int dp, bool vec) {
  extern __shared__ __align__(16) float sq[];
  const int row = blockIdx.x;
  const float* qr = q + (int64_t)row * dp;
  for (int j = threadIdx.x; j < dp; j += kSearchThreads) sq[j] = qr[j];
  __syncthreads();

  const float q2r = q2[row];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* rid = ids + (int64_t)row * W;
  float* out = od + (int64_t)row * W;
  for (int w = warp; w < W; w += kSearchWarps) {
    const int id = rid[w];          // the same for the whole warp
    if (id < 0 || id >= N) {
      if (lane == 0) out[w] = INFINITY;
      continue;
    }
    const float* xr = x + (int64_t)id * dp;
    float acc = 0.0f;
    if (vec) {
      const float4* xv = reinterpret_cast<const float4*>(xr);
      const float4* qv = reinterpret_cast<const float4*>(sq);
      const int n4 = dp >> 2;
#pragma unroll 4
      for (int j = lane; j < n4; j += 32) {
        const float4 c = __ldg(xv + j);
        const float4 s = qv[j];
        acc = fmaf(c.x, s.x, acc);
        acc = fmaf(c.y, s.y, acc);
        acc = fmaf(c.z, s.z, acc);
        acc = fmaf(c.w, s.w, acc);
      }
    } else {
#pragma unroll 4
      for (int j = lane; j < dp; j += 32) acc = fmaf(__ldg(xr + j), sq[j], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const float d = __fsub_rn(__fadd_rn(q2r, x2[id]), __fmul_rn(2.0f, acc));
      out[w] = fmaxf(d, 0.0f);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

int pairwise_sq_l2_launch(const float* a, const float* b, float* out, int M,
                          int N, int D, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || D < 0) return (int)cudaErrorInvalidValue;
  const int gy = (M + kL2BM - 1) / kL2BM;
  const int gx = (N + kL2BN - 1) / kL2BN;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = (D & 3) == 0 && aligned16(a) && aligned16(b);
  pairwise_sq_l2_kernel<<<dim3(gx, gy), kL2Threads, 0, stream>>>(a, b, out,
                                                                  M, N, D,
                                                                  vec);
  return (int)cudaGetLastError();
}

int knn_search_dists_launch(const float* q, const float* q2, const float* x,
                            const float* x2, const int* ids, float* od, int N,
                            int nq, int W, int dp, cudaStream_t stream) {
  if (nq <= 0 || W <= 0 || dp < 0 || dp > kSearchMaxDp)
    return (int)cudaErrorInvalidValue;
  const bool vec = (dp & 3) == 0 && aligned16(q) && aligned16(x);
  const size_t smem = (size_t)dp * sizeof(float);
  knn_search_dists_kernel<<<nq, kSearchThreads, smem, stream>>>(
      q, q2, x, x2, ids, od, N, W, dp, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
