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
// products are exact in f32 and are summed in f32 (fmaf in the search
// tile; in the join, 16 at a time on the tensor cores, the 16-value sums
// added in order with __fadd_rn), so a bf16 kernel differs from its plain
// version by the order of the sums only.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

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
// knn_join_dists_q8: replaces knn_join_dists_q8_blocked
// (src/repro/kernels/l2_quant.py:241; body _join_dists_q8_kernel :194).
//
// Per row of candidate ids (C <= 64), the C x C quantized squared-l2 pair
// tensor with the join mask folded in (at least one slot in the "new"
// prefix cn, distinct slots, both ids valid and distinct), +inf on the
// diagonal and on refused pairs, plus the count of valid unordered pairs.
// Bound: bytes at the build's shapes (about a third of the C*(C-1)/2 pairs
// are valid, so the int8 tensor-core peak is far away); operations count
// only on dense candidate sets.
// Design: one block per row gathers its candidates' rows itself, 64 words
// (256 int8 values) of each row at a time, with 16-byte loads into shared
// memory at a padded row stride of 65 words, so that threads reading
// different rows at one word hit different banks. Each thread owns up to 8
// upper-triangle pairs and keeps their int32 sums in registers across the
// tiles; the epilogue writes (s, t) and (t, s) and warp-reduces the evals.
// ---------------------------------------------------------------------------

constexpr int kQJoinThreads = 256;
constexpr int kQJoinTile = 64;                   // words of a row per tile
constexpr int kQJoinStride = kQJoinTile + 1;
constexpr int kQJoinMaxC = 64;
constexpr int kQJoinPairsPerThread =
    (kQJoinMaxC * (kQJoinMaxC - 1) / 2 + kQJoinThreads - 1) / kQJoinThreads;

__device__ __forceinline__ void q8_join_row(
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
    ssc[s] = id >= 0 ? scale[id] : 0.0f;
  }
  if (tid == 0) s_evals = 0;

  const int P = C * (C - 1) / 2;
  int ps[kQJoinPairsPerThread], pt[kQJoinPairsPerThread];
  int acc[kQJoinPairsPerThread];
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
        int sum = acc[j];
#pragma unroll 4
        for (int w = 0; w < width; w += 4) {
          sum = Word<true>::dot(a[w], b[w], sum);
          sum = Word<true>::dot(a[w + 1], b[w + 1], sum);
          sum = Word<true>::dot(a[w + 2], b[w + 2], sum);
          sum = Word<true>::dot(a[w + 3], b[w + 3], sum);
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
          Word<true>::dist(sx2[s], sx2[t], ssc[s], ssc[t], acc[j]), 0.0f);
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
  q8_join_row(tile, data, scale, x2, ids + (int64_t)row * C,
              od + (int64_t)row * C * C, ev + row, N, C, row_words, cn);
}

// ---------------------------------------------------------------------------
// knn_join_dists_bf16: replaces knn_join_dists_bf16_blocked
// (src/repro/kernels/l2_quant.py:279; body _join_dists_bf16_kernel :215).
//
// The same pair tensor from bf16 rows, with f32 sums.
// Bound: the gather. At the build's call (70000 x 20 candidates, w 800) a
// row reads 20 mirror rows of 1600 bytes for 190 products of 800: about
// 4 operations per byte, far below the tensor cores' 295 per byte of
// device memory, so the rows' bytes (from L2 or device memory) set the
// time, not the multiply-adds.
// Design: the row's Gram G = X X^T (X: C x w bf16) on the tensor cores
// with mma.sync.m16n8k16 (bf16 in, f32 out). Not wgmma: its 64-row tiles
// would waste most of their work on C 20 (a row's product is at most 64 x
// 64 x w) and the kernel waits on its gather, not on the tensor rate. One
// warp per row, 4 rows per block, no block barrier: the warp gathers its
// candidates' rows itself with 16-byte cp.async (the mirror's rows are
// 16-byte aligned), 64 values of each row per stage, into its own ring of
// 3 stages, rows padded to 16 kMB with zero rows and to a stride of 72
// values (144 bytes), so that the 8 rows an ldmatrix reads hit distinct
// banks. An invalid slot and the values past w are zero-filled, not read.
// Per 16 values, ldmatrix.x4 loads each 16-row block of X once as an A
// fragment; since both operands are the same rows, the fragment's halves
// are also the B fragments of the two 8-column blocks of those rows (no
// transpose), and only the 16 x 8 blocks that touch the upper triangle
// and the first C columns are multiplied. Each mma starts from zero, and
// its 16-value sum is added to the block's f32 running sums with
// __fadd_rn: the tensor core's f32 accumulate does not round to nearest
// at each add, so chunks are added in order with rounding to nearest, and
// the result differs from the plain version by the order of the sums
// only. The Gram goes through the ring's shared memory to the epilogue
// (common.cuh), which writes the row's C x C tensor in order.
// ---------------------------------------------------------------------------

constexpr int kBJoinWarps = 4;                  // rows per block
constexpr int kBJoinChunk = 64;                 // values of a row per stage
constexpr int kBJoinStride = kBJoinChunk + 8;   // 144 bytes per staged row
constexpr int kBJoinStages = 3;

template <int kMB>
constexpr size_t bjoin_smem() {
  return (size_t)kBJoinWarps * kBJoinStages * 16 * kMB * kBJoinStride *
         sizeof(uint16_t);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint16_t* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d = A B for one 16 x 8 block: A 16 x 16 (a), B 16 x 8 (b0, b1), from 0
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// values [k0, k0 + kBJoinChunk) of the row's C candidates into a stage
__device__ __forceinline__ void bjoin_load_chunk(
    uint16_t* st, const uint16_t* __restrict__ data, const int* sid, int C,
    int w, int k0, int lane) {
  constexpr int kPieces = kBJoinChunk / 8;
  for (int e = lane; e < C * kPieces; e += 32) {
    const int s = e / kPieces;
    const int v = (e - s * kPieces) * 8;
    const int id = sid[s];
    const bool ok = id >= 0 && k0 + v < w;
    cp_async<16>(st + s * kBJoinStride + v,
                 ok ? data + (int64_t)id * w + k0 + v : data, ok);
  }
}

// kMB 16-row blocks: C <= 16 kMB
template <int kMB>
__global__ void __launch_bounds__(kBJoinWarps * 32, 1)
    knn_join_dists_bf16_kernel(const uint16_t* __restrict__ data,
                               const float* __restrict__ x2,
                               const int* __restrict__ ids,
                               float* __restrict__ od, int* __restrict__ ev,
                               int N, int n, int C, int w, int cn) {
  constexpr int kRows = 16 * kMB;
  constexpr int kStage = kRows * kBJoinStride;
  // the k-steps of a stage unrolled up to 32 rows; wider, the hoisted
  // fragments of four steps beside 60-80 sums would spill
  constexpr int kUnroll = kMB <= 2 ? kBJoinChunk / 16 : 1;
  extern __shared__ __align__(16) uint16_t bsm[];
  __shared__ int sid_all[kBJoinWarps][kQJoinMaxC];
  __shared__ float sx2_all[kBJoinWarps][kQJoinMaxC];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kBJoinWarps + warp;
  if (row >= n) return;               // the block never synchronises
  uint16_t* ring = bsm + warp * kBJoinStages * kStage;
  int* sid = sid_all[warp];
  float* sx2 = sx2_all[warp];
  for (int s = lane; s < C; s += 32) {
    int id = ids[(int64_t)row * C + s];
    if (id < 0 || id >= N) id = -1;   // out of range: an invalid slot
    sid[s] = id;
    sx2[s] = id >= 0 ? x2[id] : 0.0f;
  }
  // the padding rows [C, kRows) of every stage stay zero
  const int pad = (kRows - C) * kBJoinStride / 8;       // 16-byte words
  for (int e = lane; e < kBJoinStages * pad; e += 32) {
    const int st = e / pad;
    reinterpret_cast<uint4*>(ring + st * kStage + C * kBJoinStride)
        [e - st * pad] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncwarp();

  float acc[kMB][2 * kMB][4];
#pragma unroll
  for (int mi = 0; mi < kMB; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2 * kMB; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.0f;

  // ldmatrix.x4: lane l addresses row l % 8 of matrix l / 8, the matrices
  // being (rows 0-7, 8-15) x (values 0-7, 8-15) of a 16 x 16 block
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  const int chunks = (w + kBJoinChunk - 1) / kBJoinChunk;
#pragma unroll
  for (int s = 0; s < kBJoinStages - 1; ++s) {
    if (s < chunks)
      bjoin_load_chunk(ring + s * kStage, data, sid, C, w, s * kBJoinChunk,
                       lane);
    cp_async_commit();
  }
  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<kBJoinStages - 2>();   // this lane's copies of chunk kc
    __syncwarp();                        // the warp's; stage kc - 1 is free
    const int nxt = kc + kBJoinStages - 1;
    if (nxt < chunks)
      bjoin_load_chunk(ring + (nxt % kBJoinStages) * kStage, data, sid, C, w,
                       nxt * kBJoinChunk, lane);
    cp_async_commit();

    const uint16_t* st = ring + (kc % kBJoinStages) * kStage;
#pragma unroll kUnroll
    for (int kk = 0; kk < kBJoinChunk; kk += 16) {
      uint32_t fa[kMB][4];
#pragma unroll
      for (int mi = 0; mi < kMB; ++mi)
        ldmatrix_x4(fa[mi], st + (mi * 16 + lrow) * kBJoinStride + kk + lcol);
#pragma unroll
      for (int mi = 0; mi < kMB; ++mi)
#pragma unroll
        for (int nj = 2 * mi; nj < 2 * kMB; ++nj) {
          if (nj * 8 >= C) continue;
          // B's 8 columns are rows 8 nj.. of X: half nj % 2 of block nj / 2
          float d[4];
          mma_bf16(d, fa[mi], fa[nj >> 1][nj & 1], fa[nj >> 1][2 + (nj & 1)]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mi][nj][i] = __fadd_rn(acc[mi][nj][i], d[i]);
        }
    }
  }
  cp_async_wait<0>();                    // only empty groups are left
  __syncwarp();                          // the ring now holds the Gram

  // accumulator i of lane l: row l / 4 + 8 (i / 2), column 2 (l % 4) + i % 2
  float* gram = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int mi = 0; mi < kMB; ++mi)
#pragma unroll
    for (int nj = 2 * mi; nj < 2 * kMB; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = mi * 16 + (lane >> 2) + (i >> 1) * 8;
        const int t = nj * 8 + 2 * (lane & 3) + (i & 1);
        if (s < t && t < C) gram[s * C + t] = acc[mi][nj][i];
      }
  __syncwarp();

  int local = join_epilogue(gram, sid, sx2, od + (int64_t)row * C * C, C,
                            cn, lane, 32);
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_xor_sync(0xffffffffu, local, off);
  if (lane == 0) ev[row] = local;
}

template <int kMB>
int launch_bjoin(const uint16_t* data, const float* x2, const int* ids,
                 float* od, int* ev, int N, int n, int C, int w, int cn,
                 cudaStream_t stream) {
  constexpr size_t smem = bjoin_smem<kMB>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_join_dists_bf16_kernel<kMB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  knn_join_dists_bf16_kernel<kMB>
      <<<(n + kBJoinWarps - 1) / kBJoinWarps, kBJoinWarps * 32, smem,
         stream>>>(data, x2, ids, od, ev, N, n, C, w, cn);
  return (int)cudaGetLastError();
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
  switch ((C + 15) / 16) {
    case 1:
      return launch_bjoin<1>(data, x2, ids, od, ev, N, n, C, w, cn, stream);
    case 2:
      return launch_bjoin<2>(data, x2, ids, od, ev, N, n, C, w, cn, stream);
    case 3:
      return launch_bjoin<3>(data, x2, ids, od, ev, N, n, C, w, cn, stream);
    default:
      return launch_bjoin<4>(data, x2, ids, od, ev, N, n, C, w, cn, stream);
  }
}

}  // extern "C"
