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

#include "common.cuh"
#include "search_tile.cuh"

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
// Input form: the tile reads both operands k-major, (D, M) and (D, N),
// each row padded to a multiple of 4 floats, into scratch the wrapper
// allocates; pairwise_sq_l2_kernel_k_major makes those copies first (32 x
// 32 tiles through shared memory, coalesced on both sides), which also
// takes any 4-byte offset or D. They move 8 bytes per input float, about
// 2% of the call at the brute-force shape.
// Design: a SIMT tile fed by asynchronous copies. A block of 256 threads
// owns a 128 x 128 output tile and walks D in chunks of 32 through a ring
// of 3 shared-memory stages: 16-byte cp.async copies (zero-filled past D
// and past the padded rows) fill stage s + 2 while stage s is multiplied,
// with one barrier per stage. A stage holds each operand as 32 feature
// rows of 128 floats, as the copies land, and the micro-kernel reads them
// without conflicts: per feature a thread reads two float4 of a (a
// broadcast within the warp) and two of b (16 consecutive float4 across a
// half-warp) for the 64 FMAs of its 8 x 8 micro-tile, rows {4ty..4ty+3,
// 64+4ty..} and columns {4tx..4tx+3, 64+4tx..}. The norms come from the
// same stages: each thread sums the squares of four columns over eight of
// the chunk's features, and the four partial sums of a column are added
// after the loop. Output tiles run in groups of 16 row tiles, the row tile
// fastest, so the blocks resident at one time share a few tiles of a and
// of b in L2 and b streams from device memory about once per group instead
// of once per row tile. The output is written once, with streaming stores.
// A grid of at most one tile per SM (centroid_assign: N is the router's
// 16-1024 centroids) would leave SMs idle, so there D is split among up
// to nk blocks per tile (pairwise_sq_l2_splits), each writing partial sums
// to scratch, and pairwise_sq_l2_kernel_split_sum adds them in split order
// and applies the epilogue.
// ---------------------------------------------------------------------------

constexpr int kL2Threads = 256;
constexpr int kL2BM = 128;
constexpr int kL2BN = 128;
constexpr int kL2BK = 32;
constexpr int kL2Stages = 3;
constexpr int kL2GroupM = 16;             // row tiles per raster group
constexpr int kL2Tile = kL2BK * kL2BM;    // floats of one operand's stage
constexpr size_t kL2Smem = (size_t)kL2Stages * 2 * kL2Tile * sizeof(float);
static_assert(kL2BM == kL2BN, "one loader and one norm layout for both");

// Features [k0, k0 + 32) of columns [c0, c0 + 128) of one k-major operand
// (D rows of ld floats) into a stage: 1024 16-byte pieces, four per
// thread; 32 threads cover one feature row.
__device__ __forceinline__ void l2_load_tile(float* st,
                                             const float* __restrict__ g,
                                             int64_t c0, int ld, int k0,
                                             int D, int tid) {
#pragma unroll
  for (int l = 0; l < kL2BK * kL2BM / 4 / kL2Threads; ++l) {
    const int e = tid + l * kL2Threads;
    const int kk = e >> 5;
    const int c = (e & 31) * 4;
    const bool ok = k0 + kk < D && c0 + c < ld;
    cp_async<16>(st + kk * kL2BM + c,
               ok ? g + (int64_t)(k0 + kk) * ld + c0 + c : g, ok);
  }
}

// out[d * ld + r] = in[r * D + d] for r < R, d < D: one 32 x 32 tile per
// block, read along D and written along R
__global__ void __launch_bounds__(kL2Threads) pairwise_sq_l2_kernel_k_major(
    const float* __restrict__ in, float* __restrict__ out, int R, int D,
    int ld) {
  __shared__ float tile[32][33];
  const int64_t r0 = (int64_t)blockIdx.x * 32;
  const int d0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int j = ty; j < 32; j += kL2Threads / 32) {
    if (r0 + j < R && d0 + tx < D)
      tile[j][tx] = __ldg(in + (r0 + j) * D + d0 + tx);
  }
  __syncthreads();
#pragma unroll
  for (int j = ty; j < 32; j += kL2Threads / 32) {
    if (d0 + j < D && r0 + tx < R)
      out[(int64_t)(d0 + j) * ld + r0 + tx] = tile[tx][j];
  }
}

// splits == 1: block b owns output tile b and writes the distances.
// Else block b owns chunks [split * cps, (split + 1) * cps) of tile b /
// splits, split = b % splits, and writes its partial a.b to ws[split] (M x
// N) and its partial norms to wa2[split] (M) / wb2[split] (N) (from the
// first tile column / row); pairwise_sq_l2_kernel_split_sum adds them.
__global__ void __launch_bounds__(kL2Threads, 2) pairwise_sq_l2_kernel(
    const float* __restrict__ at, const float* __restrict__ bt,
    float* __restrict__ out, float* __restrict__ ws, float* __restrict__ wa2,
    float* __restrict__ wb2, int M, int N, int D, int lda, int ldb,
    int tiles_m, int tiles_n, int splits, int cps) {
  extern __shared__ __align__(16) float l2_smem[];
  __shared__ __align__(16) float part[2][4][kL2BM];   // norm partial sums
  __shared__ float a2s[kL2BM];
  __shared__ float b2s[kL2BN];

  // grouped raster: kL2GroupM row tiles, the row tile fastest
  const int tile = blockIdx.x / splits;
  const int split = blockIdx.x - tile * splits;
  const int per_group = kL2GroupM * tiles_n;
  const int group = tile / per_group;
  const int first_m = group * kL2GroupM;
  const int gm = min(tiles_m - first_m, kL2GroupM);
  const int in_group = tile - group * per_group;
  const int64_t m0 = (int64_t)(first_m + in_group % gm) * kL2BM;
  const int64_t n0 = (int64_t)(in_group / gm) * kL2BN;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // the norms: operand tid / 128, columns 4 * (tid % 32) + 0..3, features
  // 8 * ((tid / 32) % 4) + 0..7 of each chunk
  const int n_op = tid >> 7;
  const int n_col = (tid & 31) * 4;
  const int n_k = ((tid >> 5) & 3) * 8;
  // this block's chunks [c0, c0 + nk) of D's 32-feature chunks
  const int c0 = split * cps;
  const int nk = min(cps, (D + kL2BK - 1) / kL2BK - c0);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float4 nrm = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
  for (int s = 0; s < kL2Stages - 1; ++s) {
    if (s < nk) {
      float* st = l2_smem + s * 2 * kL2Tile;
      l2_load_tile(st, at, m0, lda, (c0 + s) * kL2BK, D, tid);
      l2_load_tile(st + kL2Tile, bt, n0, ldb, (c0 + s) * kL2BK, D, tid);
    }
    cp_async_commit();
  }

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kL2Stages - 2>();    // this thread's copies of chunk kc
    __syncthreads();                   // everyone's; stage kc - 1 is free
    const int nxt = kc + kL2Stages - 1;
    if (nxt < nk) {
      float* st = l2_smem + (nxt % kL2Stages) * 2 * kL2Tile;
      l2_load_tile(st, at, m0, lda, (c0 + nxt) * kL2BK, D, tid);
      l2_load_tile(st + kL2Tile, bt, n0, ldb, (c0 + nxt) * kL2BK, D, tid);
    }
    cp_async_commit();

    const float* as = l2_smem + (kc % kL2Stages) * 2 * kL2Tile;
    const float* bs = as + kL2Tile;
    {
      const float* ns = (n_op ? bs : as) + n_k * kL2BM + n_col;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float4 v = *reinterpret_cast<const float4*>(ns + kk * kL2BM);
        nrm.x = fmaf(v.x, v.x, nrm.x);
        nrm.y = fmaf(v.y, v.y, nrm.y);
        nrm.z = fmaf(v.z, v.z, nrm.z);
        nrm.w = fmaf(v.w, v.w, nrm.w);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kL2BK; ++kk) {
      const float* ar = as + kk * kL2BM;
      const float* br = bs + kk * kL2BM;
      const float4 a0 = *reinterpret_cast<const float4*>(ar + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(ar + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(br + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(br + 64 + 4 * tx);
      const float af[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bf[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();                  // only empty groups are left

  *reinterpret_cast<float4*>(&part[n_op][n_k >> 3][n_col]) = nrm;
  __syncthreads();
  {
    const int c = tid & (kL2BM - 1);
    const float v = ((part[n_op][0][c] + part[n_op][1][c]) +
                     part[n_op][2][c]) + part[n_op][3][c];
    if (n_op) {
      b2s[c] = v;
    } else {
      a2s[c] = v;
    }
  }
  __syncthreads();

  const bool vec_out = (N & 3) == 0;
  if (splits > 1) {
    // partial sums: the split-sum kernel finishes them
    if (tid < kL2BM && in_group / gm == 0 && m0 + tid < M)
      wa2[(int64_t)split * M + m0 + tid] = a2s[tid];
    if (tid >= kL2BM && in_group % gm + first_m == 0 &&
        n0 + tid - kL2BM < N)
      wb2[(int64_t)split * N + n0 + tid - kL2BM] = b2s[tid - kL2BM];
    float* wsp = ws + (int64_t)split * M * N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t m = m0 + (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t n = n0 + h * 64 + 4 * tx;
        float* w = wsp + m * (int64_t)N + n;
        if (vec_out && n + 3 < N) {
          *reinterpret_cast<float4*>(w) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N) w[j] = acc[i][4 * h + j];
        }
      }
    }
    return;
  }

  // epilogue: (|a|^2 + |b|^2) - 2 a.b, clamped, in the plain version's
  // order of operations (no fused multiply-add)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ri = (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
    const int64_t m = m0 + ri;
    if (m >= M) continue;
    float* orow = out + m * (int64_t)N;
    const float a2 = a2s[ri];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cj = h * 64 + 4 * tx;
      const int64_t n = n0 + cj;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = __fsub_rn(__fadd_rn(a2, b2s[cj + j]),
                                  __fmul_rn(2.0f, acc[i][4 * h + j]));
        v[j] = fmaxf(d, 0.0f);
      }
      if (vec_out && n + 3 < N) {
        __stcs(reinterpret_cast<float4*>(orow + n),
               make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) __stcs(orow + n + j, v[j]);
      }
    }
  }
}

// The splits' partial sums, added in split order, then the tile's
// epilogue; one output element per thread.
__global__ void __launch_bounds__(kL2Threads) pairwise_sq_l2_kernel_split_sum(
    const float* __restrict__ ws, const float* __restrict__ wa2,
    const float* __restrict__ wb2, float* __restrict__ out, int M, int N,
    int splits) {
  const int64_t mn = (int64_t)M * N;
  const int64_t e = (int64_t)blockIdx.x * kL2Threads + threadIdx.x;
  if (e >= mn) return;
  const int m = (int)(e / N);
  const int n = (int)(e - (int64_t)m * N);
  float a2 = wa2[m], b2 = wb2[n], ab = ws[e];
  for (int p = 1; p < splits; ++p) {
    a2 += wa2[(int64_t)p * M + m];
    b2 += wb2[(int64_t)p * N + n];
    ab += ws[p * mn + e];
  }
  const float d = __fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.0f, ab));
  out[e] = fmaxf(d, 0.0f);
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
// Bound and design: search_tile.cuh, the body it shares with the bf16
// and int8 tiles: a block per query, its row in registers a 2 KB piece at
// a time, each warp's candidate ids and norms loaded before its first row,
// rows streamed with 16-byte loads (kVec 1; the instance kVec 0 takes
// 4-byte loads where dp % 4 != 0 or a row is not 16-byte aligned), fp32
// fmaf on the CUDA cores. dp is at most 12288 (rows of 48 KB,
// kSearchMaxRowBytes).
// ---------------------------------------------------------------------------

template <int kVec>
__global__ void __launch_bounds__(kSearchThreads, kSearchMinBlocks)
    knn_search_dists_kernel(const float* __restrict__ q,
                            const float* __restrict__ qs,
                            const float* __restrict__ q2,
                            const float* __restrict__ x,
                            const float* __restrict__ xs,
                            const float* __restrict__ x2,
                            const int* __restrict__ ids,
                            float* __restrict__ od, SearchTile t) {
  extern __shared__ __align__(16) unsigned char search_smem[];
  search_tile<float, kVec != 0>(q, qs, q2, x, xs, x2, ids, od, t,
                                search_smem);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

int pairwise_sq_l2_splits(int M, int N, int D) {
  // a grid of at most one tile per SM splits D among more blocks, as many
  // as one wave of two blocks per SM holds
  const int tiles = ((M + kL2BM - 1) / kL2BM) * ((N + kL2BN - 1) / kL2BN);
  const int nk = (D + kL2BK - 1) / kL2BK;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  const int want = min(nk, 2 * sms / tiles);
  if (want < 2) return 1;
  const int cps = (nk + want - 1) / want;
  return (nk + cps - 1) / cps;        // no split is left without a chunk
}

int pairwise_sq_l2_launch(const float* a, const float* b, float* at,
                          float* bt, float* out, float* ws, int M, int N,
                          int D, int lda, int ldb, int splits,
                          cudaStream_t stream) {
  const int nk = (D + kL2BK - 1) / kL2BK;
  if (M <= 0 || N <= 0 || D < 0 || lda < M || ldb < N || (lda & 3) ||
      (ldb & 3) || !aligned16(at) || !aligned16(bt) ||
      (D + 31) / 32 > 65535 || splits < 1 || (splits > 1 && splits > nk))
    return (int)cudaErrorInvalidValue;
  const int tiles_m = (M + kL2BM - 1) / kL2BM;
  const int tiles_n = (N + kL2BN - 1) / kL2BN;
  if ((int64_t)tiles_m * tiles_n * splits > INT32_MAX ||
      (int64_t)M * N / kL2Threads >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int cps = (nk + splits - 1) / splits;
  if (D > 0) {    // with no features there is nothing to copy
    pairwise_sq_l2_kernel_k_major<<<dim3((M + 31) / 32, (D + 31) / 32),
                                    kL2Threads, 0, stream>>>(a, at, M, D,
                                                             lda);
    pairwise_sq_l2_kernel_k_major<<<dim3((N + 31) / 32, (D + 31) / 32),
                                    kL2Threads, 0, stream>>>(b, bt, N, D,
                                                             ldb);
  }
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_sq_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kL2Smem);
  if (err != cudaSuccess) return (int)err;
  // the workspace: splits x (M x N partial products, M and N norms)
  float* wa2 = ws + (int64_t)splits * M * N;
  float* wb2 = wa2 + (int64_t)splits * M;
  pairwise_sq_l2_kernel<<<tiles_m * tiles_n * splits, kL2Threads, kL2Smem,
                          stream>>>(at, bt, out, ws, wa2, wb2, M, N, D, lda,
                                    ldb, tiles_m, tiles_n, splits, cps);
  if (splits > 1) {
    const int64_t mn = (int64_t)M * N;
    pairwise_sq_l2_kernel_split_sum<<<(int)((mn + kL2Threads - 1) /
                                            kL2Threads),
                                      kL2Threads, 0, stream>>>(
        ws, wa2, wb2, out, M, N, splits);
  }
  return (int)cudaGetLastError();
}

int knn_search_dists_launch(const float* q, const float* q2, const float* x,
                            const float* x2, const int* ids, float* od, int N,
                            int nq, int W, int dp, cudaStream_t stream) {
  if ((dp & 3) == 0 && aligned16(q) && aligned16(x))
    return launch_search_tile<float>(knn_search_dists_kernel<1>, q, nullptr,
                                     q2, x, nullptr, x2, ids, od, N, nq, W,
                                     dp, stream);
  return launch_search_tile<float>(knn_search_dists_kernel<0>, q, nullptr,
                                   q2, x, nullptr, x2, ids, od, N, nq, W, dp,
                                   stream);
}

}  // extern "C"
