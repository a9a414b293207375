// The quantized scoring tiles of the two-stage distance path for Hopper
// (sm_90a), CUDA C++: int8 and bf16 twins of knn_join_dists
// (knn_kernels.cu) and knn_search_dists (search_kernels.cu).
//
// Built by kernels/_lib.py with the other sources into one shared library
// with a plain C interface, loaded with ctypes. Each launcher takes raw
// device pointers, sizes and a stream, launches on that stream without
// synchronising, allocates nothing, and returns cudaGetLastError(). The
// Python wrappers (kernels/l2_quant.py) check shapes, dtypes, contiguity
// and 16-byte row alignment and allocate the outputs; kernels/ref.py holds
// the plain PyTorch version of each.
//
// Rows come from the quantized mirror of core/quantize.py: int8 rows with
// per-row f32 scales, or bf16 rows. Both kernels of a pair take the ids
// and the base mirror and gather the rows themselves (the TPU kernels take
// (n, C, w) / (nq, W, w) copies gathered beforehand). An id outside
// [0, N) is an invalid slot: +inf, and no row is read for it.
//
// Arithmetic. int8 cross terms are summed exactly in int32 with __dp4a
// (signed bytes), so an int8 kernel agrees with its plain version bit for
// bit: the epilogue keeps the plain version's order of operations,
//   (q2 + c2) - (2 * (s_q * s_c)) * (float)ab,
// with __fadd_rn / __fmul_rn so that no multiply-add is contracted. bf16
// products are exact in f32 and are summed in f32 (fmaf), so a bf16
// kernel differs from its plain version by the order of the sums only.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// One 32-bit word of two rows: four int8 or two bf16 values.
// ---------------------------------------------------------------------------

template <bool kQ8>
struct Word;

template <>
struct Word<true> {
  using Acc = int;
  static __device__ __forceinline__ int dot(uint32_t a, uint32_t b, int acc) {
    return __dp4a(static_cast<int>(a), static_cast<int>(b), acc);
  }
  static __device__ __forceinline__ int sum(int acc) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    return acc;
  }
  // (c2 + q2) - (2 * (s_a * s_b)) * ab
  static __device__ __forceinline__ float dist(float n2a, float n2b, float sa,
                                               float sb, int ab) {
    const float f = __fmul_rn(2.0f, __fmul_rn(sa, sb));
    return __fsub_rn(__fadd_rn(n2a, n2b), __fmul_rn(f, __int2float_rn(ab)));
  }
};

template <>
struct Word<false> {
  using Acc = float;
  // a bf16 value is the high half of the f32 with the same bits
  static __device__ __forceinline__ float dot(uint32_t a, uint32_t b,
                                              float acc) {
    acc = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), acc);
    return fmaf(__uint_as_float(a & 0xffff0000u),
                __uint_as_float(b & 0xffff0000u), acc);
  }
  static __device__ __forceinline__ float sum(float acc) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    return acc;
  }
  static __device__ __forceinline__ float dist(float n2a, float n2b, float,
                                               float, float ab) {
    return __fsub_rn(__fadd_rn(n2a, n2b), __fmul_rn(2.0f, ab));
  }
};

template <bool kQ8>
__device__ __forceinline__ typename Word<kQ8>::Acc dot16(
    uint4 a, uint4 b, typename Word<kQ8>::Acc acc) {
  acc = Word<kQ8>::dot(a.x, b.x, acc);
  acc = Word<kQ8>::dot(a.y, b.y, acc);
  acc = Word<kQ8>::dot(a.z, b.z, acc);
  return Word<kQ8>::dot(a.w, b.w, acc);
}

// ---------------------------------------------------------------------------
// knn_search_dists_q8 / _bf16: replace knn_search_dists_q8_blocked and
// knn_search_dists_bf16_blocked (src/repro/kernels/l2_quant.py:92,137;
// bodies _search_dists_q8_kernel :53, _search_dists_bf16_kernel :74).
//
// Per query, the quantized squared l2 to each of its W candidates.
// Bound: bytes. Each valid candidate costs one mirror row (w bytes int8,
// 2w bf16) for 2w operations.
// Design: knn_search_dists's, on 16-byte chunks of quantized rows: one
// block per query keeps the query row in shared memory; each of its 8
// warps takes every 8th candidate, its lanes stream the row's 16-byte
// chunks (16 int8 or 8 bf16 values each) and the warp sums with shuffles.
// ---------------------------------------------------------------------------

constexpr int kQSearchThreads = 256;
constexpr int kQSearchWarps = kQSearchThreads / 32;
constexpr int kQSearchMaxBytes = 48 * 1024;   // the query row in shared mem

template <bool kQ8>
__device__ __forceinline__ void quant_search_row(
    uint4* sq, const uint4* __restrict__ qrow, float qs, float q2r,
    const uint4* __restrict__ data, const float* __restrict__ scale,
    const float* __restrict__ x2, const int* __restrict__ rid,
    float* __restrict__ out, int N, int W, int chunks) {
  for (int j = threadIdx.x; j < chunks; j += kQSearchThreads) sq[j] = qrow[j];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int w = warp; w < W; w += kQSearchWarps) {
    const int id = rid[w];            // the same for the whole warp
    if (id < 0 || id >= N) {
      if (lane == 0) out[w] = INFINITY;
      continue;
    }
    const uint4* xr = data + (int64_t)id * chunks;
    typename Word<kQ8>::Acc acc = 0;
#pragma unroll 2
    for (int j = lane; j < chunks; j += 32)
      acc = dot16<kQ8>(__ldg(xr + j), sq[j], acc);
    acc = Word<kQ8>::sum(acc);
    if (lane == 0) {
      const float cs = kQ8 ? scale[id] : 1.0f;
      out[w] = fmaxf(Word<kQ8>::dist(q2r, x2[id], qs, cs, acc), 0.0f);
    }
  }
}

__global__ void __launch_bounds__(kQSearchThreads) knn_search_dists_q8_kernel(
    const uint4* __restrict__ qq, const float* __restrict__ qscale,
    const float* __restrict__ q2, const uint4* __restrict__ data,
    const float* __restrict__ scale, const float* __restrict__ x2,
    const int* __restrict__ ids, float* __restrict__ od, int N, int W,
    int chunks) {
  extern __shared__ uint4 sq8[];
  const int row = blockIdx.x;
  quant_search_row<true>(sq8, qq + (int64_t)row * chunks, qscale[row],
                         q2[row], data, scale, x2, ids + (int64_t)row * W,
                         od + (int64_t)row * W, N, W, chunks);
}

__global__ void __launch_bounds__(kQSearchThreads)
    knn_search_dists_bf16_kernel(const uint4* __restrict__ q,
                                 const float* __restrict__ q2,
                                 const uint4* __restrict__ data,
                                 const float* __restrict__ x2,
                                 const int* __restrict__ ids,
                                 float* __restrict__ od, int N, int W,
                                 int chunks) {
  extern __shared__ uint4 sqb[];
  const int row = blockIdx.x;
  quant_search_row<false>(sqb, q + (int64_t)row * chunks, 1.0f, q2[row],
                          data, nullptr, x2, ids + (int64_t)row * W,
                          od + (int64_t)row * W, N, W, chunks);
}

// ---------------------------------------------------------------------------
// knn_join_dists_q8 / _bf16: replace knn_join_dists_q8_blocked and
// knn_join_dists_bf16_blocked (src/repro/kernels/l2_quant.py:241,279;
// bodies _join_dists_q8_kernel :211, _join_dists_bf16_kernel :233).
//
// Per row of candidate ids (C <= 64), the C x C quantized squared-l2 pair
// tensor with the join mask folded in (at least one slot in the "new"
// prefix cn, distinct slots, both ids valid and distinct), +inf on the
// diagonal and on refused pairs, plus the count of valid unordered pairs.
// Bound: bytes at the build's shapes (about a third of the C*(C-1)/2 pairs
// are valid, so the int8 tensor-core peak is far away); operations count
// only on dense candidate sets.
// Design: knn_join_dists's. One block per row gathers its candidates' rows
// itself, 64 words (256 bytes: 256 int8 or 128 bf16 values) of each row
// at a time, with 16-byte loads into shared memory at a padded row stride
// of 65 words, so that threads reading different rows at one word hit
// different banks. Each thread owns up to 8 upper-triangle pairs and keeps
// their sums (int32 or f32) in registers across the tiles; the epilogue
// writes (s, t) and (t, s) and warp-reduces the evals.
// ---------------------------------------------------------------------------

constexpr int kQJoinThreads = 256;
constexpr int kQJoinTile = 64;                   // words of a row per tile
constexpr int kQJoinStride = kQJoinTile + 1;
constexpr int kQJoinMaxC = 64;
constexpr int kQJoinPairsPerThread =
    (kQJoinMaxC * (kQJoinMaxC - 1) / 2 + kQJoinThreads - 1) / kQJoinThreads;

template <bool kQ8>
__device__ __forceinline__ void quant_join_row(
    uint32_t* tile, const uint32_t* __restrict__ data,
    const float* __restrict__ scale, const float* __restrict__ x2,
    const int* __restrict__ rids, float* __restrict__ out,
    int* __restrict__ ev_out, int N, int C, int row_words, int cn) {
  __shared__ int sid[kQJoinMaxC];
  __shared__ float sx2[kQJoinMaxC];
  __shared__ float ssc[kQJoinMaxC];
  __shared__ int s_evals;
  const int tid = threadIdx.x;
  for (int s = tid; s < C; s += kQJoinThreads) {
    int id = rids[s];
    if (id >= N) id = -1;             // out of range: an invalid slot
    sid[s] = id;
    sx2[s] = id >= 0 ? x2[id] : 0.0f;
    ssc[s] = (kQ8 && id >= 0) ? scale[id] : 0.0f;
  }
  if (tid == 0) s_evals = 0;

  const int P = C * (C - 1) / 2;
  int ps[kQJoinPairsPerThread], pt[kQJoinPairsPerThread];
  typename Word<kQ8>::Acc acc[kQJoinPairsPerThread];
#pragma unroll
  for (int j = 0; j < kQJoinPairsPerThread; ++j) {
    const int p = tid + j * kQJoinThreads;
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
    acc[j] = 0;
  }
  __syncthreads();

  constexpr int kChunks = kQJoinTile / 4;         // 16-byte chunks per tile
  for (int d0 = 0; d0 < row_words; d0 += kQJoinTile) {
    const int width = min(kQJoinTile, row_words - d0);   // a multiple of 4
    for (int e = tid; e < C * kChunks; e += kQJoinThreads) {
      const int s = e / kChunks;
      const int w = (e - s * kChunks) * 4;
      const int id = sid[s];
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (id >= 0 && w < width)
        v = __ldg(reinterpret_cast<const uint4*>(
            data + (int64_t)id * row_words + d0 + w));
      uint32_t* dst = tile + s * kQJoinStride + w;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kQJoinPairsPerThread; ++j) {
      if (tid + j * kQJoinThreads < P) {
        const uint32_t* a = tile + ps[j] * kQJoinStride;
        const uint32_t* b = tile + pt[j] * kQJoinStride;
        typename Word<kQ8>::Acc sum = acc[j];
#pragma unroll 4
        for (int w = 0; w < width; w += 4) {
          sum = Word<kQ8>::dot(a[w], b[w], sum);
          sum = Word<kQ8>::dot(a[w + 1], b[w + 1], sum);
          sum = Word<kQ8>::dot(a[w + 2], b[w + 2], sum);
          sum = Word<kQ8>::dot(a[w + 3], b[w + 3], sum);
        }
        acc[j] = sum;
      }
    }
    __syncthreads();
  }

  int local = 0;
#pragma unroll
  for (int j = 0; j < kQJoinPairsPerThread; ++j) {
    if (tid + j * kQJoinThreads < P) {
      const int s = ps[j], t = pt[j];
      const int a = sid[s], b = sid[t];
      const bool ok = (s < cn || t < cn) && a >= 0 && b >= 0 && a != b;
      const float d = fmaxf(
          Word<kQ8>::dist(sx2[s], sx2[t], ssc[s], ssc[t], acc[j]), 0.0f);
      const float v = ok ? d : INFINITY;
      out[s * C + t] = v;
      out[t * C + s] = v;
      local += ok ? 1 : 0;
    }
  }
  for (int s = tid; s < C; s += kQJoinThreads) out[s * C + s] = INFINITY;

  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((tid & 31) == 0) atomicAdd(&s_evals, local);
  __syncthreads();
  if (tid == 0) *ev_out = s_evals;
}

__global__ void __launch_bounds__(kQJoinThreads) knn_join_dists_q8_kernel(
    const uint32_t* __restrict__ data, const float* __restrict__ scale,
    const float* __restrict__ x2, const int* __restrict__ ids,
    float* __restrict__ od, int* __restrict__ ev, int N, int C,
    int row_words, int cn) {
  __shared__ uint32_t tile[kQJoinMaxC * kQJoinStride];
  const int row = blockIdx.x;
  quant_join_row<true>(tile, data, scale, x2, ids + (int64_t)row * C,
                       od + (int64_t)row * C * C, ev + row, N, C, row_words,
                       cn);
}

__global__ void __launch_bounds__(kQJoinThreads) knn_join_dists_bf16_kernel(
    const uint32_t* __restrict__ data, const float* __restrict__ x2,
    const int* __restrict__ ids, float* __restrict__ od,
    int* __restrict__ ev, int N, int C, int row_words, int cn) {
  __shared__ uint32_t tile[kQJoinMaxC * kQJoinStride];
  const int row = blockIdx.x;
  quant_join_row<false>(tile, data, nullptr, x2, ids + (int64_t)row * C,
                        od + (int64_t)row * C * C, ev + row, N, C,
                        row_words, cn);
}

bool rows_ok(const void* p, int row_bytes) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && row_bytes % 16 == 0;
}

}  // namespace

extern "C" {

int knn_search_dists_q8_launch(const int8_t* qq, const float* qscale,
                               const float* q2, const int8_t* data,
                               const float* scale, const float* x2,
                               const int* ids, float* od, int N, int nq,
                               int W, int w, cudaStream_t stream) {
  if (nq <= 0 || W <= 0 || w < 0 || w > kQSearchMaxBytes ||
      !rows_ok(qq, w) || !rows_ok(data, w))
    return (int)cudaErrorInvalidValue;
  const int chunks = w / 16;
  knn_search_dists_q8_kernel<<<nq, kQSearchThreads, (size_t)w, stream>>>(
      reinterpret_cast<const uint4*>(qq), qscale, q2,
      reinterpret_cast<const uint4*>(data), scale, x2, ids, od, N, W, chunks);
  return (int)cudaGetLastError();
}

int knn_search_dists_bf16_launch(const uint16_t* q, const float* q2,
                                 const uint16_t* data, const float* x2,
                                 const int* ids, float* od, int N, int nq,
                                 int W, int w, cudaStream_t stream) {
  const int row_bytes = 2 * w;
  if (nq <= 0 || W <= 0 || w < 0 || row_bytes > kQSearchMaxBytes ||
      !rows_ok(q, row_bytes) || !rows_ok(data, row_bytes))
    return (int)cudaErrorInvalidValue;
  const int chunks = row_bytes / 16;
  knn_search_dists_bf16_kernel<<<nq, kQSearchThreads, (size_t)row_bytes,
                                 stream>>>(
      reinterpret_cast<const uint4*>(q), q2,
      reinterpret_cast<const uint4*>(data), x2, ids, od, N, W, chunks);
  return (int)cudaGetLastError();
}

int knn_join_dists_q8_launch(const int8_t* data, const float* scale,
                             const float* x2, const int* ids, float* od,
                             int* ev, int N, int n, int C, int w, int cn,
                             cudaStream_t stream) {
  if (n <= 0 || C < 1 || C > kQJoinMaxC || w < 0 || !rows_ok(data, w))
    return (int)cudaErrorInvalidValue;
  knn_join_dists_q8_kernel<<<n, kQJoinThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(data), scale, x2, ids, od, ev, N, C,
      w / 4, cn);
  return (int)cudaGetLastError();
}

int knn_join_dists_bf16_launch(const uint16_t* data, const float* x2,
                               const int* ids, float* od, int* ev, int N,
                               int n, int C, int w, int cn,
                               cudaStream_t stream) {
  if (n <= 0 || C < 1 || C > kQJoinMaxC || w < 0 || !rows_ok(data, 2 * w))
    return (int)cudaErrorInvalidValue;
  knn_join_dists_bf16_kernel<<<n, kQJoinThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(data), x2, ids, od, ev, N, C,
      w / 2, cn);
  return (int)cudaGetLastError();
}

}  // extern "C"
