// The query-time candidate distance tile for Hopper (sm_90a): one
// templated body behind knn_search_dists_kernel (fp32,
// search_kernels.cu), knn_search_dists_bf16_kernel (bf16 rows) and
// knn_search_dists_q8_kernel (int8 rows with per-row scales, both in
// quant_kernels.cu).
//
// Per query, the squared l2 to each of its W candidates, (q2 + c2) -
// 2 q.c, clamped at 0 (int8: (q2 + c2) - (2 (s_q s_c)) ab); a candidate id
// outside [0, N) comes out +inf and no row is read for it.
// Bound: bytes. A candidate costs one row (4 dp bytes fp32, 2 w bf16, w
// int8) for 2 dp operations, at most two operations per byte, so no
// tensor core: the products are fp32 fmaf on the CUDA cores (bf16 values
// widened to fp32, where their products are exact) or __dp4a on int8
// (exact int32 sums, in any order).
// Design: a row's latency is the cost, so nothing waits on a load that
// another load could have hidden.
//  * One block of 8 warps per query, at most 64 registers a thread so
//    that 4 blocks (32 warps) share an SM. The query row goes to shared
//    memory by cp.async while the warps load their candidates' ids.
//  * Warp w takes the candidates w, w + 8, ...: lane l holds the id, the
//    norm (and the int8 scale) of its l-th one, all loaded before the
//    first row (32 at a time), so no row waits on its id and no epilogue
//    waits on a norm or a scale.
//  * Rows go in pieces of kVpl 16-byte vectors a lane (fp32 and bf16: 4,
//    a 2 KB piece; int8: 2, a 1 KB piece, so that MNIST's 784-byte row
//    keeps most lanes busy): for each piece the warp keeps the query's
//    piece in registers and streams its candidates' pieces through them,
//    all the loads of kRows rows at once (one fp32, two bf16 or four int8
//    rows: 4, 8 or 8 vectors a lane), summing across the warp (a shuffle
//    butterfly on floats, one redux.sync on int32); the lane that holds
//    the candidate keeps its dot, and writes the epilogue at the end with
//    __fadd_rn / __fmul_rn, in the plain version's order of operations.
//  * Rows and queries are read with 16-byte loads (kVec); an fp32 row that
//    is not 16-byte aligned or whose dp is not a multiple of 4 takes the
//    4-byte path, its own instance of the kernel.
// A tile that reads a row once per group of 16 queries (a shared-memory
// hash dedup of their ids) was built and measured slower: the queries of
// a search block share too few rows for the dedup to pay (PERF.md
// section 6).
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kSearchWarps = 8;
constexpr int kSearchThreads = 32 * kSearchWarps;
constexpr int kSearchMinBlocks = 4;     // blocks an SM holds: 64 registers
constexpr int kSearchMaxRowBytes = 48 * 1024;   // the query row in smem

// The launch's shape, computed on the host (launch_search_tile).
struct SearchTile {
  int N, W;
  int elems;         // values per row
  int row_vecs;      // 16-byte vectors per row, the last one zero-padded
  int pieces;        // ceil(row_vecs / (32 kVpl)), at least 1
};

// The element type's traits: one 16-byte vector of a row (kPerVec
// values), the vectors of a piece a lane (kVpl), the rows a warp loads at
// once (kRows), the dot's accumulator, its sum across the warp, and the
// epilogue. kScaled: the rows carry per-row scales (int8).
template <typename T>
struct SearchElem;

// the fp32 and bf16 tiles' sum and epilogue: (q2 + c2) - 2 ab
struct FloatSum {
  using Acc = float;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    return acc;
  }
  static __device__ __forceinline__ float dist(float q2, float c2, float,
                                               float, float ab) {
    return fmaxf(__fsub_rn(__fadd_rn(q2, c2), __fmul_rn(2.0f, ab)), 0.0f);
  }
};

template <>
struct SearchElem<float> : FloatSum {
  static constexpr int kPerVec = 4;
  static constexpr int kVpl = 4;
  static constexpr int kRows = 1;
  using Vec = float4;
  static __device__ __forceinline__ float dot(float4 a, float4 b,
                                              float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
  }
  // values e0 .. e0 + 3 of a row of `elems`, zero past its end, from
  // 4-byte loads (a row that is not 16-byte aligned)
  static __device__ __forceinline__ float4 load4(const float* row, int e0,
                                                 int elems) {
    float4 v;
    v.x = e0 < elems ? __ldg(row + e0) : 0.0f;
    v.y = e0 + 1 < elems ? __ldg(row + e0 + 1) : 0.0f;
    v.z = e0 + 2 < elems ? __ldg(row + e0 + 2) : 0.0f;
    v.w = e0 + 3 < elems ? __ldg(row + e0 + 3) : 0.0f;
    return v;
  }
};

// bf16 values as their bits; a bf16 value is the high half of the f32
// with the same bits
template <>
struct SearchElem<uint16_t> : FloatSum {
  static constexpr int kPerVec = 8;
  static constexpr int kVpl = 4;
  static constexpr int kRows = 2;     // half the bytes of an fp32 row each
  using Vec = uint4;
  static __device__ __forceinline__ float dot2(uint32_t a, uint32_t b,
                                               float acc) {
    acc = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), acc);
    return fmaf(__uint_as_float(a & 0xffff0000u),
                __uint_as_float(b & 0xffff0000u), acc);
  }
  static __device__ __forceinline__ float dot(uint4 a, uint4 b, float acc) {
    acc = dot2(a.x, b.x, acc);
    acc = dot2(a.y, b.y, acc);
    acc = dot2(a.z, b.z, acc);
    return dot2(a.w, b.w, acc);
  }
};

// int8 values, four to a 32-bit word; exact int32 sums
template <>
struct SearchElem<int8_t> {
  static constexpr int kPerVec = 16;
  static constexpr int kVpl = 2;      // 8 + 32 registers of query and rows
  static constexpr int kRows = 4;     // 8 vectors a lane, as bf16's two
  static constexpr bool kScaled = true;
  using Vec = uint4;
  using Acc = int;
  static __device__ __forceinline__ int dot(uint4 a, uint4 b, int acc) {
    acc = __dp4a(static_cast<int>(a.x), static_cast<int>(b.x), acc);
    acc = __dp4a(static_cast<int>(a.y), static_cast<int>(b.y), acc);
    acc = __dp4a(static_cast<int>(a.z), static_cast<int>(b.z), acc);
    return __dp4a(static_cast<int>(a.w), static_cast<int>(b.w), acc);
  }
  static __device__ __forceinline__ int warp_sum(int acc) {
    return __reduce_add_sync(0xffffffffu, acc);
  }
  // (q2 + c2) - (2 (s_q s_c)) (float)ab, the plain version's order
  static __device__ __forceinline__ float dist(float q2, float c2, float qs,
                                               float cs, int ab) {
    const float f = __fmul_rn(2.0f, __fmul_rn(qs, cs));
    const float d =
        __fsub_rn(__fadd_rn(q2, c2), __fmul_rn(f, __int2float_rn(ab)));
    return fmaxf(d, 0.0f);
  }
};

// qs / xs: the queries' and the rows' scales (read only where kScaled)
template <typename T, bool kVec>
__device__ __forceinline__ void search_tile(
    const T* __restrict__ q, const float* __restrict__ qs,
    const float* __restrict__ q2, const T* __restrict__ x,
    const float* __restrict__ xs, const float* __restrict__ x2,
    const int* __restrict__ ids, float* __restrict__ od, const SearchTile& t,
    unsigned char* smem) {
  using E = SearchElem<T>;
  using Vec = typename E::Vec;
  using Acc = typename E::Acc;
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kVpl = E::kVpl;
  constexpr int kPieceVecs = 32 * kVpl;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row = blockIdx.x;

  // the query row in shared memory, zero-padded to whole vectors
  Vec* sq = reinterpret_cast<Vec*>(smem);
  const T* qr = q + (int64_t)row * t.elems;
  if constexpr (kVec) {
    for (int i = tid; i < t.row_vecs; i += kSearchThreads)
      cp_async<16>(sq + i, reinterpret_cast<const Vec*>(qr) + i, true);
  } else {
    T* sf = reinterpret_cast<T*>(smem);
    for (int i = tid; i < E::kPerVec * t.row_vecs; i += kSearchThreads)
      cp_async<4>(sf + i, qr + (i < t.elems ? i : 0), i < t.elems);
  }
  cp_async_commit();

  const int per = (t.W + kSearchWarps - 1) / kSearchWarps;
  const float q2r = q2[row];
  const float qsr = E::kScaled ? qs[row] : 1.0f;
  const int* rid = ids + (int64_t)row * t.W;
  float* out = od + (int64_t)row * t.W;
  for (int c0 = 0; c0 < per; c0 += 32) {
    // lane l: candidate w of the warp's (c0 + l)-th, its id, norm, scale
    const int w = warp + kSearchWarps * (c0 + lane);
    const bool mine = c0 + lane < per && w < t.W;
    int id = -1;
    if (mine) {
      const int v = rid[w];
      id = v >= 0 && v < t.N ? v : -1;
    }
    const float n2 = id >= 0 ? __ldg(x2 + id) : 0.0f;
    const float cs = E::kScaled && id >= 0 ? __ldg(xs + id) : 1.0f;
    if (c0 == 0) {
      cp_async_wait<0>();
      __syncthreads();        // the query is in
    }
    const int kn = min(32, per - c0);
    Acc ab = 0;
    for (int piece = 0; piece < t.pieces; ++piece) {
      const int v0 = piece * kPieceVecs;
      const int nv = min(kPieceVecs, t.row_vecs - v0);
      Vec qv[kVpl];
#pragma unroll
      for (int jj = 0; jj < kVpl; ++jj) {
        const int j = jj * 32 + lane;
        qv[jj] = j < nv ? sq[v0 + j] : Vec{};
      }
      for (int k = 0; k < kn; k += E::kRows) {
        // rows k .. k + kRows - 1 of the chunk, all their loads at once
        Vec c[E::kRows][kVpl];
#pragma unroll
        for (int r = 0; r < E::kRows; ++r) {
          const int held = __shfl_sync(kFull, id, min(k + r, 31));
          const int cid = k + r < kn ? held : -1;
          const T* xr = x + (int64_t)max(cid, 0) * t.elems;
#pragma unroll
          for (int jj = 0; jj < kVpl; ++jj) {
            const int j = jj * 32 + lane;
            c[r][jj] = Vec{};
            if (cid >= 0 && j < nv) {
              if constexpr (kVec)
                c[r][jj] = __ldg(reinterpret_cast<const Vec*>(xr) + v0 + j);
              else
                c[r][jj] = E::load4(xr, (v0 + j) * E::kPerVec, t.elems);
            }
          }
        }
        Acc acc[E::kRows];
#pragma unroll
        for (int r = 0; r < E::kRows; ++r) {
          acc[r] = 0;
#pragma unroll
          for (int jj = 0; jj < kVpl; ++jj)
            acc[r] = E::dot(c[r][jj], qv[jj], acc[r]);
        }
#pragma unroll
        for (int r = 0; r < E::kRows; ++r) acc[r] = E::warp_sum(acc[r]);
#pragma unroll
        for (int r = 0; r < E::kRows; ++r)
          if (lane == k + r) ab = piece ? ab + acc[r] : acc[r];
      }
    }
    if (mine) out[w] = id < 0 ? INFINITY : E::dist(q2r, n2, qsr, cs, ab);
  }
}

// The launch of a search tile kernel (rows of `elems` values of type T);
// qs / xs are null but for the int8 tile.
template <typename T, typename Kernel>
int launch_search_tile(Kernel kernel, const T* q, const float* qs,
                       const float* q2, const T* x, const float* xs,
                       const float* x2, const int* ids, float* od, int N,
                       int nq, int W, int elems, cudaStream_t stream) {
  constexpr int kPieceVecs = 32 * SearchElem<T>::kVpl;
  if (nq <= 0 || W <= 0 || elems < 0 ||
      (int64_t)elems * (int64_t)sizeof(T) > kSearchMaxRowBytes)
    return (int)cudaErrorInvalidValue;
  SearchTile t;
  t.N = N;
  t.W = W;
  t.elems = elems;
  t.row_vecs = (elems * (int)sizeof(T) + 15) / 16;
  t.pieces = max(1, (t.row_vecs + kPieceVecs - 1) / kPieceVecs);
  kernel<<<nq, kSearchThreads, (size_t)16 * max(t.row_vecs, 1), stream>>>(
      q, qs, q2, x, xs, x2, ids, od, t);
  return (int)cudaGetLastError();
}

}  // namespace
