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
// Arithmetic. int8 cross terms are summed exactly in int32 (__dp4a on
// signed bytes in the search tile, search_tile.cuh; s8 mma.sync in the
// join), so an int8 kernel agrees with its plain version bit for bit: the
// epilogue keeps the plain version's order of operations,
//   (q2 + c2) - (2 * (s_q * s_c)) * (float)ab,
// with __fadd_rn / __fmul_rn so that no multiply-add is contracted. bf16
// products are exact in f32 and are summed in f32 (fmaf in the search
// tile, search_tile.cuh; in the join, 16 at a time on the tensor cores,
// the 16-value sums added in order with __fadd_rn), so a bf16 kernel
// differs from its plain version by the order of the sums only.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "search_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// knn_search_dists_q8 / knn_search_dists_bf16: replace
// knn_search_dists_q8_blocked and knn_search_dists_bf16_blocked
// (src/repro/kernels/l2_quant.py:92,137; bodies _search_dists_q8_kernel
// :53, _search_dists_bf16_kernel :74).
//
// Per query, the int8 (bf16) squared l2 to each of its W candidates.
// Bound and design: search_tile.cuh, the body both share with the fp32
// tile (knn_search_dists, search_kernels.cu): a block per query, its row
// in registers, each warp's candidate ids, norms and (int8) scales loaded
// before its first row, mirror rows streamed with 16-byte loads. int8:
// four rows in flight a warp, 1 KB pieces, __dp4a int32 sums added across
// the warp by one redux.sync, the scales in the epilogue; bf16: two rows,
// 2 KB pieces, values widened to f32 and multiplied with fmaf (their
// products are exact).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kSearchThreads, kSearchMinBlocks)
    knn_search_dists_q8_kernel(const int8_t* __restrict__ q,
                               const float* __restrict__ qs,
                               const float* __restrict__ q2,
                               const int8_t* __restrict__ data,
                               const float* __restrict__ scale,
                               const float* __restrict__ x2,
                               const int* __restrict__ ids,
                               float* __restrict__ od, SearchTile t) {
  extern __shared__ __align__(16) unsigned char search_smem[];
  search_tile<int8_t, true>(q, qs, q2, data, scale, x2, ids, od, t,
                            search_smem);
}

__global__ void __launch_bounds__(kSearchThreads, kSearchMinBlocks)
    knn_search_dists_bf16_kernel(const uint16_t* __restrict__ q,
                                 const float* __restrict__ qs,
                                 const float* __restrict__ q2,
                                 const uint16_t* __restrict__ data,
                                 const float* __restrict__ xs,
                                 const float* __restrict__ x2,
                                 const int* __restrict__ ids,
                                 float* __restrict__ od, SearchTile t) {
  extern __shared__ __align__(16) unsigned char search_smem[];
  search_tile<uint16_t, true>(q, qs, q2, data, xs, x2, ids, od, t,
                              search_smem);
}

// ---------------------------------------------------------------------------
// knn_join_dists_q8 / knn_join_dists_bf16: replace knn_join_dists_q8_blocked
// and knn_join_dists_bf16_blocked (src/repro/kernels/l2_quant.py:241,279;
// bodies _join_dists_q8_kernel :194, _join_dists_bf16_kernel :215).
//
// Per row of candidate ids (C <= 64 here; above it the wide kernels
// below), the C x C quantized squared-l2 pair tensor with the join mask
// folded in (at least one slot in the "new" prefix cn, distinct slots,
// both ids valid and distinct), +inf on the diagonal and on refused
// pairs, plus the count of valid unordered pairs.
// Bound: the gather. At the build's call (70000 x 20 candidates, w 800) a
// row reads 20 mirror rows (800 bytes int8, 1600 bf16) for 190 products of
// w: at most 4 operations per byte, far below the tensor cores' 295 (bf16)
// or 590 (int8) per byte of device memory, so the rows' bytes (from L2 or
// device memory) set the time, not the multiply-adds.
// Design: the row's Gram G = X X^T (X: C x w) on the tensor cores with
// mma.sync, 32 bytes of each row per k-step: m16n8k32 s8 x s8 -> s32 for
// int8, m16n8k16 bf16 x bf16 -> f32 for bf16. Not wgmma: its 64-row tiles
// would waste most of their work on C 20 (a row's product is at most 64 x
// 64 x w) and the kernel waits on its gather, not on the tensor rate. One
// warp per row, 4 rows per block, no block barrier: the warp gathers its
// candidates' rows itself with 16-byte cp.async (the mirror's rows are
// 16-byte aligned), 128 bytes of each row per stage, into its own ring of
// 3 stages of C rows at a stride of 144 bytes, so that the 8 rows an
// ldmatrix reads hit distinct banks. An invalid slot and the bytes past the
// row are zero-filled, not read. The rows [C, 16 kMB) that complete the
// last 16-row block are not staged: their lanes read one zero row of the
// block, so the ring holds only real rows and more rows are in flight on
// an SM. Per k-step, ldmatrix.x4 loads each 16-row block of X once as an
// A fragment:
// its quarters are rows 0-7 / 8-15 by bytes 0-15 / 16-31 of the block,
// which is the A layout of both instructions. Since both operands are the
// same rows, the two quarters of rows 8j..8j+7 are also the B fragment of
// the 8-column block j (no transpose), and only the 16 x 8 blocks that
// touch the upper triangle and the first C columns are multiplied.
// Arithmetic. int8: the int32 sums accumulate inside the mma and are exact,
// and the epilogue keeps the plain version's order of operations, (x2[s] +
// x2[t]) - (2 (s_s s_t)) (float)ab with __fadd_rn / __fmul_rn, so the
// kernel agrees with it bit for bit. bf16: each mma starts from zero and
// its 16-value sum is added to the block's f32 running sums with __fadd_rn
// (the tensor core's f32 accumulate does not round to nearest at each
// add), so the result differs from the plain version by the order of the
// sums only. The Gram goes through the ring's shared memory to the
// epilogue (common.cuh), which writes the row's C x C tensor in order.
// ---------------------------------------------------------------------------

constexpr int kJoinMaxC = 64;
constexpr int kMJoinWarps = 4;                  // rows per block
constexpr int kMJoinChunk = 128;                // bytes of a row per stage
constexpr int kMJoinStride = kMJoinChunk + 16;  // 144 bytes per staged row
constexpr int kMJoinStages = 3;

// the block's zero row, then each warp's ring of C-row stages
size_t mjoin_smem(int C) {
  return kMJoinChunk + (size_t)kMJoinWarps * kMJoinStages * C * kMJoinStride;
}

// a: the shared-memory address of this lane's 16-byte row
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One k-step of a 16 x 8 block: acc += A B, A 16 x 32 bytes (a), B 32
// bytes x 8 (b0, b1).
template <bool kQ8>
struct MmaStep;

template <>
struct MmaStep<true> {        // s8: the s32 sums accumulate in the mma
  using Acc = int;
  static __device__ __forceinline__ void run(int (&acc)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ float cross(int acc) {
    return __int2float_rn(acc);
  }
};

template <>
struct MmaStep<false> {       // bf16: from zero, then added with __fadd_rn
  using Acc = float;
  static __device__ __forceinline__ void run(float (&acc)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    float d[4];
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
  }
  static __device__ __forceinline__ float cross(float acc) { return acc; }
};

// bytes [k0, k0 + kMJoinChunk) of the row's C candidates into a stage
__device__ __forceinline__ void mjoin_load_chunk(
    uint8_t* st, const uint8_t* __restrict__ data, const int* sid, int C,
    int row_bytes, int k0, int lane) {
  constexpr int kPieces = kMJoinChunk / 16;
  for (int e = lane; e < C * kPieces; e += 32) {
    const int s = e / kPieces;
    const int v = (e - s * kPieces) * 16;
    const int id = sid[s];
    const bool ok = id >= 0 && k0 + v < row_bytes;
    cp_async<16>(st + s * kMJoinStride + v,
                 ok ? data + (int64_t)id * row_bytes + k0 + v : data, ok);
  }
}

// One row's join on its warp: ring is the warp's kMJoinStages stages of C
// rows, zrow a zero row that stands in for the rows [C, 16 kMB) of the
// 16-row blocks, sid / sx2 / ssc the C slots' ids, norms and scales
// (int8; nullptr for bf16). kMB 16-row blocks: C <= 16 kMB.
template <bool kQ8, int kMB>
__device__ __forceinline__ void mma_join_row(
    uint8_t* ring, const uint8_t* zrow, int* sid, float* sx2, float* ssc,
    const uint8_t* __restrict__ data, const float* __restrict__ scale,
    const float* __restrict__ x2, const int* __restrict__ rids,
    float* __restrict__ out, int* __restrict__ ev_out, int N, int C,
    int row_bytes, int cn) {
  const int stage = C * kMJoinStride;       // bytes per ring stage
  // the k-steps of a stage unrolled up to 32 rows; wider, the hoisted
  // fragments of four steps beside 60-80 sums would spill
  constexpr int kUnroll = kMB <= 2 ? kMJoinChunk / 32 : 1;
  using Acc = typename MmaStep<kQ8>::Acc;
  const int lane = threadIdx.x & 31;
  for (int s = lane; s < C; s += 32) {
    int id = rids[s];
    if (id < 0 || id >= N) id = -1;   // out of range: an invalid slot
    sid[s] = id;
    sx2[s] = id >= 0 ? x2[id] : 0.0f;
    if constexpr (kQ8) ssc[s] = id >= 0 ? scale[id] : 0.0f;
  }
  __syncwarp();

  Acc acc[kMB][2 * kMB][4];
#pragma unroll
  for (int mi = 0; mi < kMB; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2 * kMB; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0;

  // ldmatrix.x4: lane l addresses row l % 8 of matrix l / 8, the matrices
  // being (rows 0-7, 8-15) x (bytes 0-15, 16-31) of a 16 x 32-byte block
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 16;
  const unsigned ring_a = (unsigned)__cvta_generic_to_shared(ring);
  const unsigned zrow_a = (unsigned)__cvta_generic_to_shared(zrow);
  const int chunks = (row_bytes + kMJoinChunk - 1) / kMJoinChunk;
#pragma unroll
  for (int s = 0; s < kMJoinStages - 1; ++s) {
    if (s < chunks)
      mjoin_load_chunk(ring + s * stage, data, sid, C, row_bytes,
                       s * kMJoinChunk, lane);
    cp_async_commit();
  }
  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<kMJoinStages - 2>();   // this lane's copies of chunk kc
    __syncwarp();                        // the warp's; stage kc - 1 is free
    const int nxt = kc + kMJoinStages - 1;
    if (nxt < chunks)
      mjoin_load_chunk(ring + (nxt % kMJoinStages) * stage, data, sid, C,
                       row_bytes, nxt * kMJoinChunk, lane);
    cp_async_commit();

    // lane l's row of each 16-row block, or the zero row past C
    const unsigned st = ring_a + (kc % kMJoinStages) * stage;
    unsigned rp[kMB];
#pragma unroll
    for (int mi = 0; mi < kMB; ++mi) {
      const int r = mi * 16 + lrow;
      rp[mi] = (r < C ? st + r * kMJoinStride : zrow_a) + lcol;
    }
#pragma unroll kUnroll
    for (int kk = 0; kk < kMJoinChunk; kk += 32) {
      uint32_t fa[kMB][4];
#pragma unroll
      for (int mi = 0; mi < kMB; ++mi)
        ldmatrix_x4(fa[mi], rp[mi] + kk);
#pragma unroll
      for (int mi = 0; mi < kMB; ++mi)
#pragma unroll
        for (int nj = 2 * mi; nj < 2 * kMB; ++nj) {
          if (nj * 8 >= C) continue;
          // B's 8 columns are rows 8 nj.. of X: half nj % 2 of block nj / 2
          MmaStep<kQ8>::run(acc[mi][nj], fa[mi], fa[nj >> 1][nj & 1],
                            fa[nj >> 1][2 + (nj & 1)]);
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
        if (s < t && t < C)
          gram[s * C + t] = MmaStep<kQ8>::cross(acc[mi][nj][i]);
      }
  __syncwarp();

  int local = join_epilogue(gram, sid, sx2, out, C, cn, lane, 32, ssc);
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_xor_sync(0xffffffffu, local, off);
  if (lane == 0) *ev_out = local;
}

// A block of either kernel: kMJoinWarps rows of ids, one per warp. It
// zeroes its zero row, synchronises once, and never again.
template <bool kQ8, int kMB>
__device__ __forceinline__ void mjoin_block(
    const uint8_t* __restrict__ data, const float* __restrict__ scale,
    const float* __restrict__ x2, const int* __restrict__ ids,
    float* __restrict__ od, int* __restrict__ ev, int N, int n, int C,
    int row_bytes, int cn) {
  extern __shared__ __align__(16) uint8_t mjoin_sm[];
  __shared__ int sid[kMJoinWarps][kJoinMaxC];
  __shared__ float sx2[kMJoinWarps][kJoinMaxC];
  __shared__ float ssc[kQ8 ? kMJoinWarps : 1][kJoinMaxC];
  if (threadIdx.x < kMJoinChunk / 16)
    reinterpret_cast<uint4*>(mjoin_sm)[threadIdx.x] =
        make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kMJoinWarps + warp;
  if (row >= n) return;
  float* sc = nullptr;
  if constexpr (kQ8) sc = ssc[warp];
  mma_join_row<kQ8, kMB>(
      mjoin_sm + kMJoinChunk + warp * kMJoinStages * C * kMJoinStride,
      mjoin_sm, sid[warp], sx2[warp], sc, data, scale, x2,
      ids + (int64_t)row * C, od + (int64_t)row * C * C, ev + row, N, C,
      row_bytes, cn);
}

// The two kernels, one signature (the bf16 one ignores scale).
template <int kMB>
__global__ void __launch_bounds__(kMJoinWarps * 32, 1)
    knn_join_dists_q8_kernel(const uint8_t* __restrict__ data,
                             const float* __restrict__ scale,
                             const float* __restrict__ x2,
                             const int* __restrict__ ids,
                             float* __restrict__ od, int* __restrict__ ev,
                             int N, int n, int C, int row_bytes, int cn) {
  mjoin_block<true, kMB>(data, scale, x2, ids, od, ev, N, n, C, row_bytes,
                         cn);
}

template <int kMB>
__global__ void __launch_bounds__(kMJoinWarps * 32, 1)
    knn_join_dists_bf16_kernel(const uint8_t* __restrict__ data,
                               const float* __restrict__ scale,
                               const float* __restrict__ x2,
                               const int* __restrict__ ids,
                               float* __restrict__ od, int* __restrict__ ev,
                               int N, int n, int C, int row_bytes, int cn) {
  mjoin_block<false, kMB>(data, scale, x2, ids, od, ev, N, n, C, row_bytes,
                          cn);
}

// ---------------------------------------------------------------------------
// knn_join_dists_q8 / _bf16 above C 64 (knn_join_dists_q8_kernel_wide,
// knn_join_dists_bf16_kernel_wide), the same functions at any C: k = 91 at
// rho 0.5 gives C = 92. The row's C slots are cut into `sets` sets of at
// most kMJoinSet (32) slots, R = ceil(C / sets) each (the last shorter),
// and one warp computes one piece (I, J), I <= J, of the C x C tensor: a
// diagonal piece is the kernel above on set I's rows (the 16 x 8 blocks
// that touch its upper triangle), an off-diagonal piece every 16 x 8 block
// between set I's rows (the A fragments) and set J's (the B fragments),
// set I staged first. So a warp's ring is 3 stages of at most 2 R = 64 rows
// (27 KB) whatever C is, its sums 2 x 4 blocks (32 a lane), its Gram
// piece at most 32 x 32, and the row's candidates are gathered `sets`
// times. The arithmetic is the kernel above's (int8 bitwise equal to the
// plain version, bf16 differing by the order of the sums only); the
// piece's epilogue (common.cuh) writes both orientations and adds the
// piece's valid pairs to the row's count, which the launcher zeroes first.
// Warps take the (row, piece) items in row-major order, four a block.
// ---------------------------------------------------------------------------

constexpr int kMJoinSet = 32;                   // two 16-row blocks

// One piece of one row on its warp: ring is the warp's kMJoinStages stages
// of the piece's staged rows (set I's, then set J's off the diagonal),
// zrow a zero row, sid / sx2 / ssc the staged slots' ids, norms and scales
// (int8; nullptr for bf16), rids the row's C ids, out its C x C output.
template <bool kQ8>
__device__ __forceinline__ void mma_join_piece(
    uint8_t* ring, const uint8_t* zrow, int* sid, float* sx2, float* ssc,
    const uint8_t* __restrict__ data, const float* __restrict__ scale,
    const float* __restrict__ x2, const int* __restrict__ rids,
    float* __restrict__ out, int* __restrict__ ev_row, int N, int C,
    int row_bytes, int cn, int i0, int ri, int j0, int rj) {
  constexpr int kMB = kMJoinSet / 16;
  using Acc = typename MmaStep<kQ8>::Acc;
  const bool diag = i0 == j0;
  const int jb = diag ? 0 : ri;             // first staged row of set J
  const int srows = diag ? ri : ri + rj;
  const int stage = srows * kMJoinStride;   // bytes per ring stage
  const int lane = threadIdx.x & 31;
  for (int s = lane; s < srows; s += 32) {
    int id = rids[s < ri ? i0 + s : j0 + s - ri];
    if (id < 0 || id >= N) id = -1;   // out of range: an invalid slot
    sid[s] = id;
    sx2[s] = id >= 0 ? x2[id] : 0.0f;
    if constexpr (kQ8) ssc[s] = id >= 0 ? scale[id] : 0.0f;
  }
  __syncwarp();

  Acc acc[kMB][2 * kMB][4];
#pragma unroll
  for (int mi = 0; mi < kMB; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2 * kMB; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0;

  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 16;
  const unsigned ring_a = (unsigned)__cvta_generic_to_shared(ring);
  const unsigned zrow_a = (unsigned)__cvta_generic_to_shared(zrow);
  const int chunks = (row_bytes + kMJoinChunk - 1) / kMJoinChunk;
#pragma unroll
  for (int s = 0; s < kMJoinStages - 1; ++s) {
    if (s < chunks)
      mjoin_load_chunk(ring + s * stage, data, sid, srows, row_bytes,
                       s * kMJoinChunk, lane);
    cp_async_commit();
  }
  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<kMJoinStages - 2>();   // this lane's copies of chunk kc
    __syncwarp();                        // the warp's; stage kc - 1 is free
    const int nxt = kc + kMJoinStages - 1;
    if (nxt < chunks)
      mjoin_load_chunk(ring + (nxt % kMJoinStages) * stage, data, sid, srows,
                       row_bytes, nxt * kMJoinChunk, lane);
    cp_async_commit();

    // lane l's row of each 16-row block of both sets (on a diagonal piece
    // the same rows), or the zero row past the set
    const unsigned st = ring_a + (kc % kMJoinStages) * stage;
    unsigned pa[kMB], pb[kMB];
#pragma unroll
    for (int mi = 0; mi < kMB; ++mi) {
      const int r = mi * 16 + lrow;
      pa[mi] = (r < ri ? st + r * kMJoinStride : zrow_a) + lcol;
      pb[mi] = (r < rj ? st + (jb + r) * kMJoinStride : zrow_a) + lcol;
    }
#pragma unroll
    for (int kk = 0; kk < kMJoinChunk; kk += 32) {
      uint32_t fa[kMB][4], fb[kMB][4];
#pragma unroll
      for (int mi = 0; mi < kMB; ++mi) {
        ldmatrix_x4(fa[mi], pa[mi] + kk);
        ldmatrix_x4(fb[mi], pb[mi] + kk);
      }
#pragma unroll
      for (int mi = 0; mi < kMB; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2 * kMB; ++nj) {
          if (mi * 16 >= ri || nj * 8 >= rj || (diag && nj < 2 * mi))
            continue;
          // B's 8 columns are set J's rows 8 nj..: half nj % 2 of block
          // nj / 2
          MmaStep<kQ8>::run(acc[mi][nj], fa[mi], fb[nj >> 1][nj & 1],
                            fb[nj >> 1][2 + (nj & 1)]);
        }
    }
  }
  cp_async_wait<0>();                    // only empty groups are left
  __syncwarp();                          // the ring now holds the Gram

  // accumulator i of lane l: row l / 4 + 8 (i / 2), column 2 (l % 4) + i % 2
  float* gram = reinterpret_cast<float*>(ring);   // ri x rj, row-major
#pragma unroll
  for (int mi = 0; mi < kMB; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2 * kMB; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = mi * 16 + (lane >> 2) + (i >> 1) * 8;
        const int t = nj * 8 + 2 * (lane & 3) + (i & 1);
        if (s < ri && t < rj && (!diag || s < t))
          gram[s * rj + t] = MmaStep<kQ8>::cross(acc[mi][nj][i]);
      }
  __syncwarp();

  int local = join_epilogue_piece(gram, sid, sx2, ssc, sid + jb, sx2 + jb,
                                  kQ8 ? ssc + jb : nullptr, out, C, cn, i0,
                                  ri, j0, rj, lane, 32);
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_xor_sync(0xffffffffu, local, off);
  if (lane == 0) atomicAdd(ev_row, local);
}

// A block of either wide kernel: kMJoinWarps (row, piece) items, one per
// warp. It zeroes its zero row, synchronises once, and never again.
template <bool kQ8>
__device__ __forceinline__ void mjoin_block_wide(
    const uint8_t* __restrict__ data, const float* __restrict__ scale,
    const float* __restrict__ x2, const int* __restrict__ ids,
    float* __restrict__ od, int* __restrict__ ev, int N, int C,
    int row_bytes, int cn, int R, int sets, int64_t items, int64_t item0) {
  extern __shared__ __align__(16) uint8_t mjoin_sm[];
  __shared__ int sid[kMJoinWarps][2 * kMJoinSet];
  __shared__ float sx2[kMJoinWarps][2 * kMJoinSet];
  __shared__ float ssc[kQ8 ? kMJoinWarps : 1][2 * kMJoinSet];
  if (threadIdx.x < kMJoinChunk / 16)
    reinterpret_cast<uint4*>(mjoin_sm)[threadIdx.x] =
        make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int64_t item = item0 + (int64_t)blockIdx.x * kMJoinWarps + warp;
  if (item >= items) return;
  const int pieces = sets * (sets + 1) / 2;
  const int row = (int)(item / pieces);
  int piece = (int)(item - (int64_t)row * pieces);
  int I = 0;                               // row-major over I <= J
  while (piece >= sets - I) {
    piece -= sets - I;
    ++I;
  }
  const int J = I + piece;
  float* sc = nullptr;
  if constexpr (kQ8) sc = ssc[warp];
  mma_join_piece<kQ8>(
      mjoin_sm + kMJoinChunk +
          (size_t)warp * kMJoinStages * 2 * R * kMJoinStride,
      mjoin_sm, sid[warp], sx2[warp], sc, data, scale, x2,
      ids + (int64_t)row * C, od + (int64_t)row * C * C, ev + row, N, C,
      row_bytes, cn, I * R, min(R, C - I * R), J * R, min(R, C - J * R));
}

__global__ void __launch_bounds__(kMJoinWarps * 32, 1)
    knn_join_dists_q8_kernel_wide(
        const uint8_t* __restrict__ data, const float* __restrict__ scale,
        const float* __restrict__ x2, const int* __restrict__ ids,
        float* __restrict__ od, int* __restrict__ ev, int N, int C,
        int row_bytes, int cn, int R, int sets, int64_t items,
        int64_t item0) {
  mjoin_block_wide<true>(data, scale, x2, ids, od, ev, N, C, row_bytes, cn,
                         R, sets, items, item0);
}

__global__ void __launch_bounds__(kMJoinWarps * 32, 1)
    knn_join_dists_bf16_kernel_wide(
        const uint8_t* __restrict__ data, const float* __restrict__ scale,
        const float* __restrict__ x2, const int* __restrict__ ids,
        float* __restrict__ od, int* __restrict__ ev, int N, int C,
        int row_bytes, int cn, int R, int sets, int64_t items,
        int64_t item0) {
  mjoin_block_wide<false>(data, scale, x2, ids, od, ev, N, C, row_bytes, cn,
                          R, sets, items, item0);
}

template <bool kQ8>
int launch_mjoin_wide(const uint8_t* data, const float* scale,
                      const float* x2, const int* ids, float* od, int* ev,
                      int N, int n, int C, int row_bytes, int cn,
                      cudaStream_t stream) {
  int sets = (C + kMJoinSet - 1) / kMJoinSet;
  const int R = (C + sets - 1) / sets;
  sets = (C + R - 1) / R;
  const int64_t items = (int64_t)n * (sets * (sets + 1) / 2);
  const size_t smem = kMJoinChunk + (size_t)kMJoinWarps * kMJoinStages * 2 *
                                        R * kMJoinStride;
  auto kernel = kQ8 ? knn_join_dists_q8_kernel_wide
                    : knn_join_dists_bf16_kernel_wide;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(ev, 0, (size_t)n * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (items + kMJoinWarps - 1) / kMJoinWarps;
  constexpr int64_t kMaxGrid = 0x7fffffff;
  for (int64_t b0 = 0; b0 < blocks; b0 += kMaxGrid) {
    const unsigned grid =
        (unsigned)(blocks - b0 < kMaxGrid ? blocks - b0 : kMaxGrid);
    kernel<<<grid, kMJoinWarps * 32, smem, stream>>>(
        data, scale, x2, ids, od, ev, N, C, row_bytes, cn, R, sets, items,
        b0 * kMJoinWarps);
  }
  return (int)cudaGetLastError();
}

template <bool kQ8, int kMB>
int launch_mjoin(const uint8_t* data, const float* scale, const float* x2,
                 const int* ids, float* od, int* ev, int N, int n, int C,
                 int row_bytes, int cn, cudaStream_t stream) {
  const size_t smem = mjoin_smem(C);
  auto kernel = kQ8 ? knn_join_dists_q8_kernel<kMB>
                    : knn_join_dists_bf16_kernel<kMB>;
  // always opted in: without it the dynamic part may not pass 48 KB less
  // the kernel's static arrays (sid, sx2, ssc), which C 27-28 already does
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + kMJoinWarps - 1) / kMJoinWarps, kMJoinWarps * 32, smem,
           stream>>>(data, scale, x2, ids, od, ev, N, n, C, row_bytes, cn);
  return (int)cudaGetLastError();
}

template <bool kQ8>
int dispatch_mjoin(const void* data, const float* scale, const float* x2,
                   const int* ids, float* od, int* ev, int N, int n, int C,
                   int row_bytes, int cn, cudaStream_t stream) {
  const uint8_t* d = static_cast<const uint8_t*>(data);
  if (C > kJoinMaxC)
    return launch_mjoin_wide<kQ8>(d, scale, x2, ids, od, ev, N, n, C,
                                  row_bytes, cn, stream);
  switch ((C + 15) / 16) {
    case 1:
      return launch_mjoin<kQ8, 1>(d, scale, x2, ids, od, ev, N, n, C,
                                  row_bytes, cn, stream);
    case 2:
      return launch_mjoin<kQ8, 2>(d, scale, x2, ids, od, ev, N, n, C,
                                  row_bytes, cn, stream);
    case 3:
      return launch_mjoin<kQ8, 3>(d, scale, x2, ids, od, ev, N, n, C,
                                  row_bytes, cn, stream);
    default:
      return launch_mjoin<kQ8, 4>(d, scale, x2, ids, od, ev, N, n, C,
                                  row_bytes, cn, stream);
  }
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
  if (!rows_ok(qq, w) || !rows_ok(data, w))
    return (int)cudaErrorInvalidValue;
  return launch_search_tile<int8_t>(knn_search_dists_q8_kernel, qq, qscale,
                                    q2, data, scale, x2, ids, od, N, nq, W,
                                    w, stream);
}

int knn_search_dists_bf16_launch(const uint16_t* q, const float* q2,
                                 const uint16_t* data, const float* x2,
                                 const int* ids, float* od, int N, int nq,
                                 int W, int w, cudaStream_t stream) {
  if (!rows_ok(q, 2 * w) || !rows_ok(data, 2 * w))
    return (int)cudaErrorInvalidValue;
  return launch_search_tile<uint16_t>(knn_search_dists_bf16_kernel, q,
                                      nullptr, q2, data, nullptr, x2, ids,
                                      od, N, nq, W, w, stream);
}

int knn_join_dists_q8_launch(const int8_t* data, const float* scale,
                             const float* x2, const int* ids, float* od,
                             int* ev, int N, int n, int C, int w, int cn,
                             cudaStream_t stream) {
  if (n <= 0 || C < 1 || w < 0 || !rows_ok(data, w))
    return (int)cudaErrorInvalidValue;
  return dispatch_mjoin<true>(data, scale, x2, ids, od, ev, N, n, C, w, cn,
                              stream);
}

int knn_join_dists_bf16_launch(const uint16_t* data, const float* x2,
                               const int* ids, float* od, int* ev, int N,
                               int n, int C, int w, int cn,
                               cudaStream_t stream) {
  if (n <= 0 || C < 1 || w < 0 || !rows_ok(data, 2 * w))
    return (int)cudaErrorInvalidValue;
  return dispatch_mjoin<false>(data, nullptr, x2, ids, od, ev, N, n, C,
                               2 * w, cn, stream);
}

}  // extern "C"
