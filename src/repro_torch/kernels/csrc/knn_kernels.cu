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
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// knn_join_dists: replaces knn_join_dists_blocked / _join_dists_kernel
// (src/repro/kernels/knn_join.py:49,82).
//
// Per row of candidate ids, the C x C squared-l2 pair tensor with the join
// mask folded in, plus the count of valid unordered pairs. This kernel
// takes C <= 64; above it, knn_join_dists_kernel_wide (below).
// Bound: fp32 operations, fed from shared memory. At the build's call (C =
// 20, dp = 896) a row needs 190 dot products of 896; the fp32 pipe (no
// TF32 or tensor cores: fp32 is the exact stage) is the limit once the
// gathered rows sit in L2, and a design that reads two shared-memory
// operands per multiply-add is held to a quarter of that by the SM's 128
// bytes of shared memory per clock.
// Design: a register-tiled Gram (a SYRK) of the row's gathered candidates
// X (C x dp). One block per row. The rows, padded to 4 nb (nb = ceil(C /
// 4)), form nb blocks of 4, and G = X X^T is cut into the nb (nb + 1) / 2
// 4 x 4 tiles on or above the diagonal. A thread owns one tile and one of
// kS feature slices: per 32-feature chunk it reads float4 q = slice,
// slice + kS, ... (features 4q..4q+3) of the tile's 4 + 4 rows, eight
// 16-byte loads, for 64 multiply-adds kept in 16 registers; 8 lanes (kS =
// 8) read one row's 128 contiguous bytes, so a warp's loads are free of
// bank conflicts. After the last chunk a butterfly of shuffles adds the kS
// partial tiles. kS is 8 up to C 40 and drops to 4 and 2 so that a block
// stays at most 512 threads (C 64: 136 tiles x 2). The block gathers its
// candidates' rows itself (no (n, C, dp) gathered copy in device memory)
// with cp.async into a ring of 3 stages, 16-byte copies where the rows
// are 16-byte aligned (dp a multiple of 4) and 4-byte copies for any other
// dp; an invalid slot and the features past dp are zero-filled, not read.
// The next chunks' copies are in flight while a chunk is multiplied. The
// Gram goes through the ring's shared memory to the epilogue (common.cuh),
// which writes the row's C x C tensor in order.
// ---------------------------------------------------------------------------

constexpr int kJoinMaxC = 64;
constexpr int kJoinChunk = 32;                  // features per stage
constexpr int kJoinStride = kJoinChunk + 4;     // floats per staged row
constexpr int kJoinStages = 3;
constexpr int kJoinMaxThreads = 512;

// features [d0, d0 + kJoinChunk) of the row's C candidates into a stage,
// kVec floats per copy
template <int kVec>
__device__ __forceinline__ void join_load_chunk(float* st,
                                                const float* __restrict__ x,
                                                const int* sid, int C, int dp,
                                                int d0, int tid,
                                                int nthreads) {
  constexpr int kPieces = kJoinChunk / kVec;
  for (int e = tid; e < C * kPieces; e += nthreads) {
    const int s = e / kPieces;
    const int f = (e - s * kPieces) * kVec;
    const int id = sid[s];
    const bool ok = id >= 0 && d0 + f < dp;
    cp_async<4 * kVec>(st + s * kJoinStride + f,
                       ok ? x + (int64_t)id * dp + d0 + f : x, ok);
  }
}

// kS feature slices per tile; kVec floats per copy (4, or 1 for any dp).
// One block per SM in the bounds: without it ptxas held the 512-thread
// instances to 64 registers and spilled.
template <int kS, int kVec>
__global__ void __launch_bounds__(kJoinMaxThreads, 1) knn_join_dists_kernel(
    const float* __restrict__ x, const float* __restrict__ x2,
    const int* __restrict__ ids, float* __restrict__ od,
    int* __restrict__ ev, int N, int C, int dp, int cn) {
  // kJoinStages x (4 nb rows of kJoinStride); then the C x C Gram
  extern __shared__ __align__(16) float jsm[];
  __shared__ int sid[kJoinMaxC];
  __shared__ float sx2[kJoinMaxC];
  __shared__ int s_evals;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nb = (C + 3) >> 2;
  const int stage = 4 * nb * kJoinStride;
  for (int s = tid; s < C; s += nthreads) {
    int id = ids[(int64_t)row * C + s];
    if (id >= N) id = -1;             // out of range: an invalid slot
    sid[s] = id;
    sx2[s] = id >= 0 ? x2[id] : 0.0f;
  }
  // the padding rows [C, 4 nb) of every stage stay zero
  const int pad = (4 * nb - C) * kJoinStride;
  for (int e = tid; e < kJoinStages * pad; e += nthreads) {
    const int st = e / pad;
    jsm[st * stage + C * kJoinStride + e - st * pad] = 0.0f;
  }
  if (tid == 0) s_evals = 0;
  __syncthreads();

  // this thread's tile (bi, bj), bi <= bj, in row-major upper-triangle
  // order, and its slice; threads past the last tile compute tile (0, 0)
  // and write nothing
  const int tiles = nb * (nb + 1) / 2;
  const int slice = tid % kS;
  int tile = tid / kS;
  const bool owner = tile < tiles;
  if (!owner) tile = 0;
  int bi = 0;
  while (tile >= nb - bi) {
    tile -= nb - bi;
    ++bi;
  }
  const int bj = bi + tile;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  const int chunks = (dp + kJoinChunk - 1) / kJoinChunk;
#pragma unroll
  for (int s = 0; s < kJoinStages - 1; ++s) {
    if (s < chunks)
      join_load_chunk<kVec>(jsm + s * stage, x, sid, C, dp, s * kJoinChunk,
                            tid, nthreads);
    cp_async_commit();
  }
  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<kJoinStages - 2>();   // this thread's copies of chunk kc
    __syncthreads();                    // everyone's; stage kc - 1 is free
    const int nxt = kc + kJoinStages - 1;
    if (nxt < chunks)
      join_load_chunk<kVec>(jsm + (nxt % kJoinStages) * stage, x, sid, C, dp,
                            nxt * kJoinChunk, tid, nthreads);
    cp_async_commit();

    const float* st = jsm + (kc % kJoinStages) * stage;
    const float* ra = st + 4 * bi * kJoinStride;
    const float* rb = st + 4 * bj * kJoinStride;
#pragma unroll
    for (int j = 0; j < kJoinChunk / 4 / kS; ++j) {
      const int q = 4 * (slice + j * kS);
      float4 b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(rb + c * kJoinStride + q);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(ra + r * kJoinStride
                                                          + q);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = fmaf(a.x, b[c].x, acc[r][c]);
          v = fmaf(a.y, b[c].y, v);
          v = fmaf(a.z, b[c].z, v);
          acc[r][c] = fmaf(a.w, b[c].w, v);
        }
      }
    }
  }
  cp_async_wait<0>();                   // only empty groups are left
  __syncthreads();                      // the ring now holds the Gram

  // the slices' partial tiles: a butterfly over kS neighbouring lanes
#pragma unroll
  for (int off = 1; off < kS; off <<= 1)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
  float* gram = jsm;
  if (owner) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int s = 4 * bi + e / 4;
      const int t = 4 * bj + e % 4;
      if (e % kS == slice && s < t && t < C)
        gram[s * C + t] = acc[e / 4][e % 4];
    }
  }
  __syncthreads();

  int local = join_epilogue(gram, sid, sx2, od + (int64_t)row * C * C, C,
                            cn, tid, nthreads);
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((tid & 31) == 0) atomicAdd(&s_evals, local);
  __syncthreads();
  if (tid == 0) ev[row] = s_evals;
}

// ---------------------------------------------------------------------------
// knn_join_dists above C 64 (knn_join_dists_kernel_wide), the same function
// at any C: t-SNE's k = 91 neighbour graph gives C = 92 at rho 0.5.
// Design: the row's C slots are cut into `sets` sets of at most kJoinMaxC
// (R = 4 ceil(ceil(C / sets) / 4) each, the last shorter), and each of the
// sets (sets + 1) / 2 pieces (I, J), I <= J, of the C x C tensor is one
// block. A diagonal piece is the kernel above on set I's rows (the upper
// triangle of its 4 x 4 tiles); an off-diagonal piece is the whole
// rectangle of tiles between set I's rows, staged first, and set J's. So a
// block stages at most 2 R <= 128 rows whatever C is (its ring at most 3 x
// 128 x 144 B = 54 KB, its Gram piece at most 64 x 64 floats), and the
// row's candidates are gathered `sets` times, not C / 4. Two feature
// slices a tile (a rectangle of 16 x 16 tiles is 512 threads), summed by
// one shuffle. The piece's epilogue (common.cuh) writes both orientations
// and adds the piece's valid pairs to the row's count, which the launcher
// zeroes first. Blocks are numbered (row, piece) row-major, so a row's
// pieces run together and share its candidates' rows in L2.
// ---------------------------------------------------------------------------

constexpr int kJoinWideSlices = 2;

template <int kVec>
__global__ void __launch_bounds__(kJoinMaxThreads, 1)
    knn_join_dists_kernel_wide(const float* __restrict__ x,
                               const float* __restrict__ x2,
                               const int* __restrict__ ids,
                               float* __restrict__ od, int* __restrict__ ev,
                               int N, int C, int dp, int cn, int R, int sets,
                               int64_t block0) {
  constexpr int kS = kJoinWideSlices;
  // kJoinStages x (the staged rows of kJoinStride); then the Gram piece
  extern __shared__ __align__(16) float jsm[];
  __shared__ int sid[2 * kJoinMaxC];
  __shared__ float sx2[2 * kJoinMaxC];
  __shared__ int s_evals;

  const int pieces = sets * (sets + 1) / 2;
  const int64_t blk = block0 + blockIdx.x;
  const int row = (int)(blk / pieces);
  int piece = (int)(blk - (int64_t)row * pieces);
  int I = 0;                            // row-major over I <= J
  while (piece >= sets - I) {
    piece -= sets - I;
    ++I;
  }
  const int J = I + piece;
  const bool diag = I == J;
  const int i0 = I * R;
  const int j0 = J * R;
  const int ri = min(R, C - i0);
  const int rj = min(R, C - j0);
  const int nbi = (ri + 3) >> 2;
  const int nbj = (rj + 3) >> 2;
  const int jb = diag ? 0 : 4 * nbi;    // first staged row of set J
  const int srows = diag ? 4 * nbi : 4 * (nbi + nbj);
  const int stage = srows * kJoinStride;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // staged slot s: set I's slot i0 + s, or set J's j0 + s - jb; the
  // padding slots of each set's last 4-row block are invalid (zero rows)
  for (int s = tid; s < srows; s += nthreads) {
    const bool in_i = s < 4 * nbi;
    const int loc = in_i ? s : s - jb;
    int id = -1;
    if (loc < (in_i ? ri : rj)) {
      id = ids[(int64_t)row * C + (in_i ? i0 : j0) + loc];
      if (id >= N) id = -1;             // out of range: an invalid slot
    }
    sid[s] = id;
    sx2[s] = id >= 0 ? x2[id] : 0.0f;
  }
  if (tid == 0) s_evals = 0;
  __syncthreads();

  // this thread's tile: a diagonal piece's upper triangle in row-major
  // order, or an off-diagonal piece's rectangle; threads past the last
  // tile compute tile (0, 0) and write nothing
  const int tiles = diag ? nbi * (nbi + 1) / 2 : nbi * nbj;
  const int slice = tid % kS;
  int tile = tid / kS;
  const bool owner = tile < tiles;
  if (!owner) tile = 0;
  int bi = 0;
  int bj = 0;
  if (diag) {
    while (tile >= nbi - bi) {
      tile -= nbi - bi;
      ++bi;
    }
    bj = bi + tile;
  } else {
    bi = tile / nbj;
    bj = tile - bi * nbj;
  }

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  const int chunks = (dp + kJoinChunk - 1) / kJoinChunk;
#pragma unroll
  for (int s = 0; s < kJoinStages - 1; ++s) {
    if (s < chunks)
      join_load_chunk<kVec>(jsm + s * stage, x, sid, srows, dp,
                            s * kJoinChunk, tid, nthreads);
    cp_async_commit();
  }
  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<kJoinStages - 2>();   // this thread's copies of chunk kc
    __syncthreads();                    // everyone's; stage kc - 1 is free
    const int nxt = kc + kJoinStages - 1;
    if (nxt < chunks)
      join_load_chunk<kVec>(jsm + (nxt % kJoinStages) * stage, x, sid, srows,
                            dp, nxt * kJoinChunk, tid, nthreads);
    cp_async_commit();

    const float* st = jsm + (kc % kJoinStages) * stage;
    const float* ra = st + 4 * bi * kJoinStride;
    const float* rb = st + (jb + 4 * bj) * kJoinStride;
#pragma unroll
    for (int j = 0; j < kJoinChunk / 4 / kS; ++j) {
      const int q = 4 * (slice + j * kS);
      float4 b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(rb + c * kJoinStride + q);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(ra + r * kJoinStride
                                                          + q);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = fmaf(a.x, b[c].x, acc[r][c]);
          v = fmaf(a.y, b[c].y, v);
          v = fmaf(a.z, b[c].z, v);
          acc[r][c] = fmaf(a.w, b[c].w, v);
        }
      }
    }
  }
  cp_async_wait<0>();                   // only empty groups are left
  __syncthreads();                      // the ring now holds the Gram piece

#pragma unroll
  for (int off = 1; off < kS; off <<= 1)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
  float* gram = jsm;                    // ri x rj, row-major
  if (owner) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int s = 4 * bi + e / 4;
      const int t = 4 * bj + e % 4;
      if (e % kS == slice && s < ri && t < rj && (!diag || s < t))
        gram[s * rj + t] = acc[e / 4][e % 4];
    }
  }
  __syncthreads();

  int local = join_epilogue_piece(
      gram, sid, sx2, nullptr, sid + jb, sx2 + jb, nullptr,
      od + (int64_t)row * C * C, C, cn, i0, ri, j0, rj, tid, nthreads);
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((tid & 31) == 0) atomicAdd(&s_evals, local);
  __syncthreads();
  if (tid == 0) atomicAdd(ev + row, s_evals);
}

int launch_join_wide(const float* x, const float* x2, const int* ids,
                     float* od, int* ev, int N, int n, int C, int dp, int cn,
                     bool vec, cudaStream_t stream) {
  int sets = (C + kJoinMaxC - 1) / kJoinMaxC;
  const int R = ((C + sets - 1) / sets + 3) / 4 * 4;
  sets = (C + R - 1) / R;
  const int pieces = sets * (sets + 1) / 2;
  const int threads =
      ((R / 4) * (R / 4) * kJoinWideSlices + 31) / 32 * 32;
  const size_t smem =
      (size_t)kJoinStages * 2 * R * kJoinStride * sizeof(float);
  auto kernel = vec ? knn_join_dists_kernel_wide<4>
                    : knn_join_dists_kernel_wide<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(ev, 0, (size_t)n * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)n * pieces;
  constexpr int64_t kMaxGrid = 0x7fffffff;
  for (int64_t b0 = 0; b0 < blocks; b0 += kMaxGrid) {
    const unsigned grid =
        (unsigned)(blocks - b0 < kMaxGrid ? blocks - b0 : kMaxGrid);
    kernel<<<grid, threads, smem, stream>>>(x, x2, ids, od, ev, N, C, dp, cn,
                                            R, sets, b0);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// knn_join_select: replaces knn_join_select_blocked / _join_select_kernel
// (src/repro/kernels/knn_join.py:125,152).
//
// Per row of W (dist, id) pairs: keep id >= 0 and dist < kth, return the c
// best ascending with ties to the lowest input position, (+inf, -1) fill.
// Bound: bytes. It reads 8 bytes per entry and writes 8 per output, with a
// handful of compares per entry.
// Design: a radix select, not a sort of the row. An entry's key is the
// order-preserving bits of its distance (-0 as +0; entries that fail the
// prefilter, and survivors at FLT_MAX, carry the FLT_MAX sentinel), its
// input position the tie-break. A row belongs to one warp where W pads to
// at most 1024 (eight rows per block, so the search's 32-wide rows fill a
// warp, not a block), else to a block of 256 threads (above a padded 8192,
// to knn_join_select_kernel_stream, below). The row is read once,
// coalesced, into registers: thread t of the T in its group holds
// positions t, t + T, ..., so position order is item-major, then thread
// order, and a prefix in position order is one ballot per item plus a scan
// of the (item, warp) counts. Then:
//  1. count the survivors s; if s <= c every survivor wins;
//  2. else four passes over 8 bits of the key, each a 256-bin shared
//     histogram of the keys that match the digits found so far (atomics
//     aggregated per warp by __match_any_sync) and a scan, find the c-th
//     smallest key T and how many keys equal to T win (need);
//  3. the winners (keys below T, then the first `need` keys equal to T in
//     position order) are compacted in position order as 64-bit (key,
//     position) words; up to 4 T of them each takes the slot its rank
//     among the winners names (one barrier, not one per sorting stage),
//     more are bitonic-sorted over the next power of two of their count
//     (at most c), not of W;
//  4. their distances and ids are read back from the input (so -0.0 keeps
//     its sign), the rest of the c slots filled with (+inf, -1).
// Where a warp owns the row, its only barriers are warp barriers.
// The core (select_winners) is also the merges' and the compaction's
// selection, below.
// ---------------------------------------------------------------------------

constexpr int kSelectThreads = 256;
constexpr int kSelectMaxPadded = 8192;
constexpr int kSelectWarpMaxPadded = 1024;   // one warp per row up to here
constexpr int kSelectBins = 256;

__device__ __forceinline__ uint32_t order_bits(float v) {
  if (v == 0.0f) v = 0.0f;               // -0 ties with +0, as in a sort
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// ints of one (item, warp) scan: IPL * G counts and the total, kept even
template <int G, int IPL>
__host__ __device__ constexpr int select_scan_ints() {
  return (IPL * G + 2) & ~1;
}

// shared bytes of one row group: the winners' words (at least two, so the
// histograms after them are 16-byte aligned), two histograms, two scans
// and the warps' counts
template <int G, int IPL>
__host__ __device__ constexpr size_t select_group_bytes(int cap) {
  return (size_t)(cap < 2 ? 2 : cap) * sizeof(unsigned long long) +
         (2 * kSelectBins + 2 * select_scan_ints<G, IPL>() + 8) * sizeof(int);
}

template <int G>
__device__ __forceinline__ void group_sync() {
  if (G == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// The row's count of the items where pred(i) holds, in every thread.
template <int G, int IPL, class Pred>
__device__ __forceinline__ int group_count(Pred pred, int* cnt, int warp,
                                           int lane) {
  int s = 0;
#pragma unroll
  for (int i = 0; i < IPL; ++i)
    s += __popc(__ballot_sync(0xffffffffu, pred(i)));
  if constexpr (G == 1) {
    return s;
  } else {
    if (lane == 0) cnt[warp] = s;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < G; ++w) total += cnt[w];
    return total;                      // cnt is written once per row
  }
}

// Exclusive offsets, in position order, of the items where pred(i) holds:
// afterwards item i's offset is scan[i * G + warp] + the count of lanes
// below this one whose pred(i) holds. Returns the row's count. Every thread
// of the row group calls it.
template <int G, int IPL, class Pred>
__device__ __forceinline__ int position_scan(Pred pred, int* scan, int warp,
                                             int lane) {
  constexpr int E = IPL * G;
  constexpr int PER = (E + 31) / 32;
#pragma unroll
  for (int i = 0; i < IPL; ++i) {
    const unsigned b = __ballot_sync(0xffffffffu, pred(i));
    if (lane == 0) scan[i * G + warp] = __popc(b);
  }
  group_sync<G>();
  if (warp == 0) {
    int v[PER];
    int sum = 0;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = lane * PER + e;
      v[e] = idx < E ? scan[idx] : 0;
      sum += v[e];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int idx = lane * PER + e;
      if (idx < E) scan[idx] = run;
      run += v[e];
    }
    if (lane == 31) scan[E] = incl;
  }
  group_sync<G>();
  return scan[E];
}

// the bin of the histogram that holds rank r (0-based), and r within it;
// every warp of the row group computes the same answer
__device__ __forceinline__ void find_bin(const int* hist, int r, int lane,
                                         int& bin, int& rin) {
  const int4 lo = *reinterpret_cast<const int4*>(hist + lane * 8);
  const int4 hi = *reinterpret_cast<const int4*>(hist + lane * 8 + 4);
  const int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  int sum = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) sum += v[e];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  const int excl = incl - sum;
  const bool mine = excl <= r && r < incl;
  int b = 0;
  int rr = r - excl;
  bool found = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (!found) {
      if (rr < v[e]) {
        b = lane * 8 + e;
        found = true;
      } else {
        rr -= v[e];
      }
    }
  }
  const int src = __ffs(__ballot_sync(0xffffffffu, mine)) - 1;
  bin = __shfl_sync(0xffffffffu, b, src);
  rin = __shfl_sync(0xffffffffu, rr, src);
}

// The select's core, shared by knn_join_select, the merges and the
// compaction. The row group's keys are in registers (item i of thread t
// is position i * T + t); keys below `big` survive. Finds the c smallest
// (key, position) winners and calls put(slot, position) once for each,
// from one thread of the group; returns (on every thread) how many there
// are. Every thread of the row group calls it. `sm` holds
// select_group_bytes<G, IPL>(cap) bytes.
template <int G, int IPL, class Put>
__device__ __forceinline__ int select_winners(const uint32_t (&key)[IPL],
                                              uint32_t big, int c, int cap,
                                              char* sm, int t, Put put) {
  constexpr int T = 32 * G;
  constexpr int kScan = select_scan_ints<G, IPL>();
  constexpr int kRankMax = 4 * T;      // winners placed by rank up to here
  const int warp = t >> 5;
  const int lane = t & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned long long* words = reinterpret_cast<unsigned long long*>(sm);
  int* hist = reinterpret_cast<int*>(words + (cap < 2 ? 2 : cap));  // [2]
  int* scan_e = hist + 2 * kSelectBins;  // keys equal to T
  int* scan_w = scan_e + kScan;          // winners
  int* cnt = scan_w + kScan;             // survivors per warp

  const int s = group_count<G, IPL>([&](int i) { return key[i] < big; },
                                    cnt, warp, lane);

  // the winners: every key below thr, then the first `need` equal to it
  uint32_t thr = big;
  int need = 0;
  if (s > c) {
    for (int b = t; b < kSelectBins; b += T) hist[b] = 0;
    group_sync<G>();
    uint32_t prefix = 0;
    uint32_t pmask = 0;
    int r = c - 1;                     // rank of the c-th smallest key
#pragma unroll 1
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      int* h = hist + (pass & 1) * kSelectBins;
      int* h_next = hist + ((pass + 1) & 1) * kSelectBins;
#pragma unroll
      for (int i = 0; i < IPL; ++i) {
        const bool cand = key[i] < big && (key[i] & pmask) == prefix;
        if (__any_sync(0xffffffffu, cand)) {
          const int dig = (key[i] >> shift) & 0xff;
          const unsigned peers =
              __match_any_sync(0xffffffffu, cand ? dig : 0x100 + lane);
          if (cand && lane == __ffs(peers) - 1)
            atomicAdd(&h[dig], __popc(peers));
        }
      }
      group_sync<G>();
      // h_next was last read before the barrier above
      for (int b = t; b < kSelectBins; b += T) h_next[b] = 0;
      int bin, rin;
      find_bin(h, r, lane, bin, rin);
      prefix |= (uint32_t)bin << shift;
      pmask |= 0xffu << shift;
      r = rin;
      group_sync<G>();                 // h read, h_next clear
    }
    thr = prefix;
    need = r + 1;
    position_scan<G, IPL>([&](int i) { return key[i] == thr; }, scan_e, warp,
                          lane);
  }
  auto winner = [&](int i) {
    bool w = key[i] < thr;
    if (need > 0) {
      const bool eq = key[i] == thr;
      const unsigned eb = __ballot_sync(0xffffffffu, eq);
      w = w || (eq && scan_e[i * G + warp] + __popc(eb & below) < need);
    }
    return w;
  };
  const int nwin = position_scan<G, IPL>(winner, scan_w, warp, lane);
#pragma unroll
  for (int i = 0; i < IPL; ++i) {
    const bool w = winner(i);
    const unsigned wb = __ballot_sync(0xffffffffu, w);
    if (w)
      words[scan_w[i * G + warp] + __popc(wb & below)] =
          ((unsigned long long)key[i] << 32) | (unsigned)(i * T + t);
  }
  if (nwin <= kRankMax) {
    // a winner's slot is the count of winners below it
    group_sync<G>();
    for (int j = t; j < nwin; j += T) {
      const unsigned long long w = words[j];
      int rank = 0;
#pragma unroll 4
      for (int x = 0; x < nwin; ++x) rank += words[x] < w;
      put(rank, (int)(w & 0xffffffffu));
    }
  } else {
    // a bitonic sort over the next power of two of the winners' count
    int size = 1;
    while (size < nwin) size <<= 1;
    for (int j = nwin + t; j < size; j += T) words[j] = ~0ull;
    group_sync<G>();
    for (int k = 2; k <= size; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < (size >> 1); i += T) {
          const int lo = 2 * i - (i & (j - 1));
          const int hi = lo + j;
          const unsigned long long a = words[lo], b = words[hi];
          if ((a > b) == ((lo & k) == 0)) {
            words[lo] = b;
            words[hi] = a;
          }
        }
        group_sync<G>();
      }
    }
    for (int j = t; j < nwin; j += T) put(j, (int)(words[j] & 0xffffffffu));
  }
  return nwin;
}

// G warps per row (1: eight rows per block; 8: one), IPL keys per thread
template <int G, int IPL>
__global__ void __launch_bounds__(kSelectThreads) knn_join_select_kernel(
    const float* __restrict__ gd, const int* __restrict__ gi,
    const float* __restrict__ kth, float* __restrict__ od,
    int* __restrict__ oi, int n, int W, int c, int cap) {
  constexpr int T = 32 * G;
  constexpr int kRows = kSelectThreads / T;
  extern __shared__ __align__(16) unsigned long long select_smem[];
  const int grp = threadIdx.x / T;
  const int t = threadIdx.x - grp * T;
  const int row = blockIdx.x * kRows + grp;
  if (row >= n) return;          // a whole warp (kRows > 1 only for G 1)
  char* sm = reinterpret_cast<char*>(select_smem) +
             grp * select_group_bytes<G, IPL>(cap);

  const float th = kth[row];
  const float* rd = gd + (int64_t)row * W;
  const int* ri = gi + (int64_t)row * W;
  const uint32_t big = order_bits(FLT_MAX);
  uint32_t key[IPL];
#pragma unroll
  for (int i = 0; i < IPL; ++i) {
    const int p = i * T + t;
    uint32_t kb = big;
    if (p < W) {
      const float d = rd[p];
      if (ri[p] >= 0 && d < th) kb = order_bits(d);
    }
    key[i] = kb;
  }
  float* rod = od + (int64_t)row * c;
  int* roi = oi + (int64_t)row * c;
  // distances and ids are read back from the input, so -0.0 keeps its sign
  const int nwin = select_winners<G, IPL>(key, big, c, cap, sm, t,
                                          [&](int slot, int p) {
                                            rod[slot] = rd[p];
                                            roi[slot] = ri[p];
                                          });
  for (int j = nwin + t; j < c; j += T) {
    rod[j] = INFINITY;
    roi[j] = -1;
  }
}

template <int G, int IPL>
int launch_select(const float* gd, const int* gi, const float* kth,
                  float* od, int* oi, int n, int W, int c, int cap,
                  cudaStream_t stream) {
  constexpr int kRows = kSelectThreads / (32 * G);
  const size_t smem = kRows * select_group_bytes<G, IPL>(cap);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_join_select_kernel<G, IPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  knn_join_select_kernel<G, IPL>
      <<<(n + kRows - 1) / kRows, kSelectThreads, smem, stream>>>(
          gd, gi, kth, od, oi, n, W, c, cap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// knn_join_select above a padded W of kSelectMaxPadded
// (knn_join_select_kernel_stream), the same selection at any W: k = 91
// gives a receiver select of 2 C x C = 16928 and a polish select of k^2 =
// 8281. A row no longer fits in a block's registers, so it is streamed
// from device memory (or L2): one block of 256 threads per row reads it
// once to count the survivors; if more than c survive, once per 8-bit
// pass to build that pass's histogram (select_winners' shared
// histograms, warp-aggregated atomics and find_bin) of the keys that
// match the digits found so far; and once more, in tiles of 256
// consecutive positions, to compact the winners in position order (a
// ballot and a scan of the eight warps' counts a tile, the counts of keys
// equal to T and of winners carried from tile to tile). The winners are
// then ranked as in select_winners: by rank up to 4 T of them, else by a
// bitonic sort over the next power of two of their count. Their words sit
// in shared memory up to kStreamSmemWords (64 KB), beyond it in the row's
// slice of a scratch the wrapper allocates. Keys, the prefilter, -0 as +0,
// the sentinel and the (key, position) order are select_winners', so the
// result is the register instances' bit for bit.
// Bound: bytes. A row is read 2 to 6 times (from L2 where the rows in
// flight fit), where the bound counts it once.
// ---------------------------------------------------------------------------

constexpr int kStreamSmemWords = 8192;

__global__ void __launch_bounds__(kSelectThreads)
    knn_join_select_kernel_stream(const float* __restrict__ gd,
                                  const int* __restrict__ gi,
                                  const float* __restrict__ kth,
                                  float* __restrict__ od,
                                  int* __restrict__ oi,
                                  unsigned long long* __restrict__ scratch,
                                  int W, int c, int cap) {
  constexpr int T = kSelectThreads;
  constexpr int G = T / 32;
  extern __shared__ __align__(16) unsigned long long stream_smem[];
  __shared__ __align__(16) int hist[2 * kSelectBins];
  __shared__ int cnt_e[G];
  __shared__ int cnt_w[G];
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned long long* words =
      scratch != nullptr ? scratch + (int64_t)row * cap : stream_smem;
  const float th = kth[row];
  const float* rd = gd + (int64_t)row * W;
  const int* ri = gi + (int64_t)row * W;
  const uint32_t big = order_bits(FLT_MAX);
  auto key_at = [&](int p) {
    uint32_t kb = big;
    if (p < W) {
      const float d = rd[p];
      if (ri[p] >= 0 && d < th) kb = order_bits(d);
    }
    return kb;
  };

  // 1. the survivors
  int mine = 0;
  for (int p = t; p < W; p += T) mine += key_at(p) < big ? 1 : 0;
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) cnt_w[warp] = mine;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < G; ++w) s += cnt_w[w];
  __syncthreads();                     // cnt_w is read: free again

  // 2. the c-th smallest key T and how many keys equal to it win
  uint32_t thr = big;
  int need = 0;
  if (s > c) {
    for (int b = t; b < kSelectBins; b += T) hist[b] = 0;
    __syncthreads();
    uint32_t prefix = 0;
    uint32_t pmask = 0;
    int r = c - 1;
#pragma unroll 1
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      int* h = hist + (pass & 1) * kSelectBins;
      int* h_next = hist + ((pass + 1) & 1) * kSelectBins;
      for (int base = 0; base < W; base += T) {
        const uint32_t key = key_at(base + t);
        const bool cand = key < big && (key & pmask) == prefix;
        if (__any_sync(0xffffffffu, cand)) {
          const int dig = (key >> shift) & 0xff;
          const unsigned peers =
              __match_any_sync(0xffffffffu, cand ? dig : 0x100 + lane);
          if (cand && lane == __ffs(peers) - 1)
            atomicAdd(&h[dig], __popc(peers));
        }
      }
      __syncthreads();
      // h_next was last read before the barrier above
      for (int b = t; b < kSelectBins; b += T) h_next[b] = 0;
      int bin, rin;
      find_bin(h, r, lane, bin, rin);
      prefix |= (uint32_t)bin << shift;
      pmask |= 0xffu << shift;
      r = rin;
      __syncthreads();                 // h read, h_next clear
    }
    thr = prefix;
    need = r + 1;
  }

  // 3. the winners in position order: keys below T, then the first
  // `need` keys equal to it
  int run_e = 0;
  int run_w = 0;
  for (int base = 0; base < W; base += T) {
    const int p = base + t;
    const uint32_t key = key_at(p);
    bool win = key < thr;
    if (need > 0) {                    // the same branch in every thread
      const bool eq = key == thr;
      const unsigned eb = __ballot_sync(0xffffffffu, eq);
      if (lane == 0) cnt_e[warp] = __popc(eb);
      __syncthreads();
      int before = run_e;
#pragma unroll
      for (int w = 0; w < G; ++w) {
        before += w < warp ? cnt_e[w] : 0;
        run_e += cnt_e[w];
      }
      win = win || (eq && before + __popc(eb & below) < need);
    }
    const unsigned wb = __ballot_sync(0xffffffffu, win);
    if (lane == 0) cnt_w[warp] = __popc(wb);
    __syncthreads();
    int before = run_w;
#pragma unroll
    for (int w = 0; w < G; ++w) {
      before += w < warp ? cnt_w[w] : 0;
      run_w += cnt_w[w];
    }
    if (win)
      words[before + __popc(wb & below)] =
          ((unsigned long long)key << 32) | (unsigned)p;
    __syncthreads();                   // the counts are read: free again
  }
  const int nwin = run_w;

  // 4. each winner to its slot, read back from the input (so -0.0 keeps
  // its sign); the rest of the c slots (+inf, -1)
  float* rod = od + (int64_t)row * c;
  int* roi = oi + (int64_t)row * c;
  if (nwin <= 4 * T) {
    for (int j = t; j < nwin; j += T) {
      const unsigned long long w = words[j];
      int rank = 0;
#pragma unroll 4
      for (int x = 0; x < nwin; ++x) rank += words[x] < w;
      const int p = (int)(w & 0xffffffffu);
      rod[rank] = rd[p];
      roi[rank] = ri[p];
    }
  } else {
    int size = 1;
    while (size < nwin) size <<= 1;
    for (int j = nwin + t; j < size; j += T) words[j] = ~0ull;
    __syncthreads();
    for (int k = 2; k <= size; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < (size >> 1); i += T) {
          const int lo = 2 * i - (i & (j - 1));
          const int hi = lo + j;
          const unsigned long long a = words[lo], b = words[hi];
          if ((a > b) == ((lo & k) == 0)) {
            words[lo] = b;
            words[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int j = t; j < nwin; j += T) {
      const int p = (int)(words[j] & 0xffffffffu);
      rod[j] = rd[p];
      roi[j] = ri[p];
    }
  }
  for (int j = nwin + t; j < c; j += T) {
    rod[j] = INFINITY;
    roi[j] = -1;
  }
}

int launch_select_stream(const float* gd, const int* gi, const float* kth,
                         float* od, int* oi, unsigned long long* scratch,
                         int n, int W, int c, int cap, cudaStream_t stream) {
  if (scratch == nullptr && cap > kStreamSmemWords)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      scratch != nullptr ? 0 : (size_t)cap * sizeof(unsigned long long);
  // always opted in: the dynamic part may pass 48 KB less the histograms
  cudaError_t err = cudaFuncSetAttribute(
      knn_join_select_kernel_stream,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  knn_join_select_kernel_stream<<<n, kSelectThreads, smem, stream>>>(
      gd, gi, kth, od, oi, scratch, W, c, cap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// knn_merge replaces knn_merge_blocked / _merge_kernel
// (src/repro/kernels/knn_merge.py:30,156); knn_merge_rows replaces
// knn_merge_rows_blocked (:210), the online store's frontier form: slot s
// of the (f, c) candidates merges into list row rows[s] (-1: padding,
// count 0, nothing written). The row form reads row rows[s] of the input
// lists and writes the same row of the output lists, which the wrapper made
// as a copy of the input, so no gather or scatter runs around it. Rows
// must be unique.
//
// Per row the pool is [list k | candidates c]. A candidate is dropped if
// its id is < 0, sits in the list, or repeats an earlier candidate (the
// list itself is never deduped). The k smallest of the rest come out
// ascending, ties to the lowest pool position, stopping at the FLT_MAX
// sentinel (list entries at +-inf count as it); empty slots are (+inf,
// -1); the count is the picks that came from the candidates.
// Bound: bytes. 8 bytes per list and candidate entry in, 8 per list entry
// out; the dedup and the selection stay in shared memory and registers.
// Design: the pool is one row of the radix select above (select_winners),
// its keys in registers, with "below FLT_MAX and not a dropped candidate"
// as the prefilter, so the order and the tie rule are the select's. A row
// belongs to a warp where the pool pads to at most 128 (eight rows per
// block: the build's, the search's and the online reverse merges), else to
// a block of 256 threads, so the online store's wide merges (c = k^2 and
// the batch width over a few hundred rows) fill the card. The dedup has no dependent chain: every id
// >= 0 of the pool goes into a shared-memory hash table (open addressing,
// twice the padded pool) as a 64-bit (id, position) word that keeps the
// lowest position seen (atomicCAS claims a slot, atomicMin lowers a
// claimed one; of the lanes of a warp that hold one id only the lowest,
// the lowest position, sends it). A candidate at position p is a
// duplicate iff its id is < 0 or its id's lowest position is below p.
// The table shares its memory with the select's words and histograms,
// which are written only after the last lookup.
// ---------------------------------------------------------------------------

constexpr int kMergeMaxPool = 8192;  // k + c: the widest row in registers
// one warp per row up to a pool of 128. Above it a block per row fills the
// card where the rows are few (the online store's few hundred) and costs a
// little where they are many
constexpr int kMergeWarpMaxPadded = 128;

__host__ __device__ constexpr int log2_pow2(int v) {
  return v <= 1 ? 0 : 1 + log2_pow2(v >> 1);
}

template <int G, int IPL>
__host__ __device__ constexpr int merge_hash_slots() {
  return 2 * 32 * G * IPL;
}

// shared bytes of one row group: the hash table, then the select's share
// of the same memory
template <int G, int IPL>
__host__ __device__ constexpr size_t merge_group_bytes(int cap) {
  return merge_hash_slots<G, IPL>() * sizeof(unsigned long long) >
                 select_group_bytes<G, IPL>(cap)
             ? merge_hash_slots<G, IPL>() * sizeof(unsigned long long)
             : select_group_bytes<G, IPL>(cap);
}

// One row group merges candidate slot `slot` into list row rows[slot];
// rows == nullptr is the dense form (slot s is list row s). G warps per
// row (1: eight rows per block; 8: one), IPL pool entries per thread.
template <int G, int IPL>
__device__ __forceinline__ void merge_row(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const int* __restrict__ rows, const float* __restrict__ qd,
    const int* __restrict__ qi, float* __restrict__ od, int* __restrict__ oi,
    int* __restrict__ upd, int n, int f, int k, int c, int cap,
    unsigned long long* merge_smem, int* s_picks) {
  constexpr int T = 32 * G;
  constexpr int kRows = kSelectThreads / T;
  constexpr int kSlots = merge_hash_slots<G, IPL>();
  constexpr int kShift = 32 - log2_pow2(kSlots);
  constexpr unsigned long long kEmpty = ~0ull;
  const int grp = threadIdx.x / T;
  const int t = threadIdx.x - grp * T;
  const int lane = t & 31;
  const int slot = blockIdx.x * kRows + grp;
  if (slot >= f) return;                 // a whole row group
  const int row = rows == nullptr ? slot : rows[slot];
  if (row < 0 || row >= n) {             // padding: count 0, write nothing
    if (t == 0) upd[slot] = 0;
    return;
  }
  char* sm = reinterpret_cast<char*>(merge_smem) +
             grp * merge_group_bytes<G, IPL>(cap);
  unsigned long long* table = reinterpret_cast<unsigned long long*>(sm);
  const int m = k + c;
  const float* rcd = cd + (int64_t)row * k;
  const int* rci = ci + (int64_t)row * k;
  const float* rqd = qd + (int64_t)slot * c;
  const int* rqi = qi + (int64_t)slot * c;

  for (int j = t; j < kSlots; j += T) table[j] = kEmpty;
  if (G > 1 && t == 0) *s_picks = 0;
  // every id is read before the first atomic: loads do not move past them
  int id[IPL];
#pragma unroll
  for (int i = 0; i < IPL; ++i) {
    const int p = i * T + t;
    id[i] = p < k ? rci[p] : (p < m ? rqi[p - k] : -1);
  }
  group_sync<G>();
#pragma unroll
  for (int i = 0; i < IPL; ++i) {
    const unsigned peers = __match_any_sync(0xffffffffu, id[i]);
    if (id[i] >= 0 && lane == __ffs(peers) - 1) {
      const unsigned long long w =
          ((unsigned long long)(unsigned)id[i] << 32) | (unsigned)(i * T + t);
      uint32_t h = ((uint32_t)id[i] * 0x9E3779B1u) >> kShift;
      while (true) {
        const unsigned long long prev = atomicCAS(&table[h], kEmpty, w);
        if (prev == kEmpty) break;
        if ((uint32_t)(prev >> 32) == (uint32_t)id[i]) {
          atomicMin(&table[h], w);
          break;
        }
        h = (h + 1) & (kSlots - 1);
      }
    }
  }
  group_sync<G>();

  const uint32_t big = order_bits(FLT_MAX);
  uint32_t key[IPL];
#pragma unroll
  for (int i = 0; i < IPL; ++i) {
    const int p = i * T + t;
    uint32_t kb = big;
    if (p < k) {
      const float d = rcd[p];
      if (d != -INFINITY && d < FLT_MAX) kb = order_bits(d);
    } else if (p < m && id[i] >= 0) {
      uint32_t h = ((uint32_t)id[i] * 0x9E3779B1u) >> kShift;
      unsigned long long v = table[h];
      while ((uint32_t)(v >> 32) != (uint32_t)id[i]) {
        h = (h + 1) & (kSlots - 1);
        v = table[h];
      }
      const float d = rqd[p - k];
      if ((int)(v & 0xffffffffu) == p && d < FLT_MAX) kb = order_bits(d);
    }
    key[i] = kb;
  }
  group_sync<G>();                       // the table is read: free for reuse

  float* rod = od + (int64_t)row * k;
  int* roi = oi + (int64_t)row * k;
  int picked = 0;
  const int nwin = select_winners<G, IPL>(key, big, k, cap, sm, t,
                                          [&](int s, int p) {
                                            if (p < k) {
                                              rod[s] = rcd[p];
                                              roi[s] = rci[p];
                                            } else {
                                              rod[s] = rqd[p - k];
                                              roi[s] = rqi[p - k];
                                              ++picked;
                                            }
                                          });
  for (int j = nwin + t; j < k; j += T) {
    rod[j] = INFINITY;
    roi[j] = -1;
  }
  picked = __reduce_add_sync(0xffffffffu, picked);
  if (G == 1) {
    if (lane == 0) upd[slot] = picked;
  } else {
    if (lane == 0) atomicAdd(s_picks, picked);
    __syncthreads();
    if (t == 0) upd[slot] = *s_picks;
  }
}

// (a minimum of one block per SM: without it ptxas held the row form's
// <8, 8> instance to 48 registers and spilled)
template <int G, int IPL>
__global__ void __launch_bounds__(kSelectThreads, 1) knn_merge_kernel(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const float* __restrict__ qd, const int* __restrict__ qi,
    float* __restrict__ od, int* __restrict__ oi, int* __restrict__ upd,
    int n, int k, int c, int cap) {
  extern __shared__ __align__(16) unsigned long long merge_smem[];
  __shared__ int s_picks;
  merge_row<G, IPL>(cd, ci, nullptr, qd, qi, od, oi, upd, n, n, k, c, cap,
                    merge_smem, &s_picks);
}

template <int G, int IPL>
__global__ void __launch_bounds__(kSelectThreads, 1) knn_merge_rows_kernel(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const int* __restrict__ rows, const float* __restrict__ qd,
    const int* __restrict__ qi, float* __restrict__ od, int* __restrict__ oi,
    int* __restrict__ upd, int n, int f, int k, int c, int cap) {
  extern __shared__ __align__(16) unsigned long long merge_smem[];
  __shared__ int s_picks;
  merge_row<G, IPL>(cd, ci, rows, qd, qi, od, oi, upd, n, f, k, c, cap,
                    merge_smem, &s_picks);
}

template <int G, int IPL>
int launch_merge(const float* cd, const int* ci, const int* rows,
                 const float* qd, const int* qi, float* od, int* oi, int* upd,
                 int n, int f, int k, int c, int cap, cudaStream_t stream) {
  constexpr int kRows = kSelectThreads / (32 * G);
  const size_t smem = kRows * merge_group_bytes<G, IPL>(cap);
  const int blocks = (f + kRows - 1) / kRows;
  if (rows == nullptr) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          knn_merge_kernel<G, IPL>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    knn_merge_kernel<G, IPL><<<blocks, kSelectThreads, smem, stream>>>(
        cd, ci, qd, qi, od, oi, upd, n, k, c, cap);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          knn_merge_rows_kernel<G, IPL>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    knn_merge_rows_kernel<G, IPL><<<blocks, kSelectThreads, smem, stream>>>(
        cd, ci, rows, qd, qi, od, oi, upd, n, f, k, c, cap);
  }
  return (int)cudaGetLastError();
}

// The row group of a padded row of `padded` entries (a power of two, 32
// to 8192): launch(G, IPL), as std::integral_constant values, with a warp
// per row up to kMergeWarpMaxPadded and a block of kSelectThreads above.
// The merges and the compaction dispatch through it.
template <class Launch>
int row_group_dispatch(int padded, Launch launch) {
  using W = std::integral_constant<int, 1>;
  using B = std::integral_constant<int, 8>;
  if (padded <= kMergeWarpMaxPadded) {
    switch (padded) {
      case 32: return launch(W{}, std::integral_constant<int, 1>{});
      case 64: return launch(W{}, std::integral_constant<int, 2>{});
      default: return launch(W{}, std::integral_constant<int, 4>{});
    }
  }
  switch (padded / kSelectThreads) {
    case 1: return launch(B{}, std::integral_constant<int, 1>{});
    case 2: return launch(B{}, std::integral_constant<int, 2>{});
    case 4: return launch(B{}, std::integral_constant<int, 4>{});
    case 8: return launch(B{}, std::integral_constant<int, 8>{});
    case 16: return launch(B{}, std::integral_constant<int, 16>{});
    default: return launch(B{}, std::integral_constant<int, 32>{});
  }
}

// the instance for a pool of k + c (1 <= k, k + c <= kMergeMaxPool)
int merge_dispatch(const float* cd, const int* ci, const int* rows,
                   const float* qd, const int* qi, float* od, int* oi,
                   int* upd, int n, int f, int k, int c,
                   cudaStream_t stream) {
  int padded = 32;
  while (padded < k + c) padded <<= 1;
  int cap = 1;                      // the winners' sort: at most k
  while (cap < k) cap <<= 1;
  return row_group_dispatch(padded, [&](auto g, auto ipl) {
    return launch_merge<decltype(g)::value, decltype(ipl)::value>(
        cd, ci, rows, qd, qi, od, oi, upd, n, f, k, c, cap, stream);
  });
}

// ---------------------------------------------------------------------------
// knn_compact replaces knn_compact_blocked / _compact_kernel
// (src/repro/kernels/knn_merge.py:72,108), the tombstone purge, and
// knn_compact_rows replaces knn_compact_rows_blocked (:237), its frontier
// form (the row indirection of knn_merge_rows: slot s compacts list row
// rows[s] under drop row s into the copy of the lists the wrapper made; -1
// is padding: removed 0, nothing written). Per row: the survivors (not
// dropped, id >= 0, finite distance, so valid entries at the 3e38
// placeholder and at FLT_MAX survive) come out ascending, ties to the
// lowest position (-0 tied with +0, each read back with its stored sign),
// whatever the order of the input row; freed slots are (+inf, -1);
// `removed` counts dropped entries with id >= 0.
// Bound: bytes (8 per list entry in and out, 1 per drop flag).
// Design: a row is one row of the radix select (select_winners) with c = k
// and the keep mask as its prefilter. A survivor's key is its distance's
// order bits, which lie below +inf's because it is finite; every other
// entry (dropped, id < 0, -inf, +inf, NaN) carries +inf's bits, the
// sentinel `big`, so "key < big" is exactly the keep mask. With c = k every
// survivor wins (the select's step 1): no histogram pass runs, and the
// survivors are ranked in one step, by rank up to 4 T of them, by the
// bitonic sort above. Rows go through the merges' dispatch: a warp per row
// up to a padded k of 128 (eight rows a block), a block of 256 threads
// above, up to the widest row a block holds in registers (8192).
// ---------------------------------------------------------------------------

// One row group compacts list row rows[slot] under drop row `slot`; rows
// == nullptr is the dense form (slot s is list row s).
template <int G, int IPL>
__device__ __forceinline__ void compact_row(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const int* __restrict__ rows, const unsigned char* __restrict__ drop,
    float* __restrict__ od, int* __restrict__ oi, int* __restrict__ removed,
    int n, int f, int k, int cap, unsigned long long* compact_smem,
    int* s_removed) {
  constexpr int T = 32 * G;
  constexpr int kRows = kSelectThreads / T;
  const int grp = threadIdx.x / T;
  const int t = threadIdx.x - grp * T;
  const int lane = t & 31;
  const int slot = blockIdx.x * kRows + grp;
  if (slot >= f) return;                 // a whole row group
  const int row = rows == nullptr ? slot : rows[slot];
  if (row < 0 || row >= n) {             // padding: removed 0, no write
    if (t == 0) removed[slot] = 0;
    return;
  }
  char* sm = reinterpret_cast<char*>(compact_smem) +
             grp * select_group_bytes<G, IPL>(cap);
  const float* rcd = cd + (int64_t)row * k;
  const int* rci = ci + (int64_t)row * k;
  const unsigned char* rdr = drop + (int64_t)slot * k;
  if (G > 1 && t == 0) *s_removed = 0;   // the select's barriers follow

  const uint32_t big = order_bits(INFINITY);
  uint32_t key[IPL];
  int rm = 0;
#pragma unroll
  for (int i = 0; i < IPL; ++i) {
    const int p = i * T + t;
    uint32_t kb = big;
    if (p < k) {
      const float d = rcd[p];
      const int id = rci[p];
      const bool dr = rdr[p] != 0;
      rm += dr && id >= 0 ? 1 : 0;
      if (!dr && id >= 0 && isfinite(d)) kb = order_bits(d);
    }
    key[i] = kb;
  }
  float* rod = od + (int64_t)row * k;
  int* roi = oi + (int64_t)row * k;
  // distances and ids are read back from the input, so -0.0 keeps its sign
  const int nwin = select_winners<G, IPL>(key, big, k, cap, sm, t,
                                          [&](int s, int p) {
                                            rod[s] = rcd[p];
                                            roi[s] = rci[p];
                                          });
  for (int j = nwin + t; j < k; j += T) {
    rod[j] = INFINITY;
    roi[j] = -1;
  }
  rm = __reduce_add_sync(0xffffffffu, rm);
  if (G == 1) {
    if (lane == 0) removed[slot] = rm;
  } else {
    if (lane == 0) atomicAdd(s_removed, rm);
    __syncthreads();
    if (t == 0) removed[slot] = *s_removed;
  }
}

template <int G, int IPL>
__global__ void __launch_bounds__(kSelectThreads) knn_compact_kernel(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const unsigned char* __restrict__ drop, float* __restrict__ od,
    int* __restrict__ oi, int* __restrict__ removed, int n, int k, int cap) {
  extern __shared__ __align__(16) unsigned long long compact_smem[];
  __shared__ int s_removed;
  compact_row<G, IPL>(cd, ci, nullptr, drop, od, oi, removed, n, n, k, cap,
                      compact_smem, &s_removed);
}

template <int G, int IPL>
__global__ void __launch_bounds__(kSelectThreads) knn_compact_rows_kernel(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const int* __restrict__ rows, const unsigned char* __restrict__ drop,
    float* __restrict__ od, int* __restrict__ oi, int* __restrict__ removed,
    int n, int f, int k, int cap) {
  extern __shared__ __align__(16) unsigned long long compact_smem[];
  __shared__ int s_removed;
  compact_row<G, IPL>(cd, ci, rows, drop, od, oi, removed, n, f, k, cap,
                      compact_smem, &s_removed);
}

template <int G, int IPL>
int launch_compact(const float* cd, const int* ci, const int* rows,
                   const unsigned char* drop, float* od, int* oi,
                   int* removed, int n, int f, int k, int cap,
                   cudaStream_t stream) {
  constexpr int kRows = kSelectThreads / (32 * G);
  const size_t smem = kRows * select_group_bytes<G, IPL>(cap);
  const int blocks = (f + kRows - 1) / kRows;
  // always opted in: the dynamic part may not pass 48 KB less the static
  // s_removed otherwise (k 8192 needs 68 KB)
  if (rows == nullptr) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_compact_kernel<G, IPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    knn_compact_kernel<G, IPL><<<blocks, kSelectThreads, smem, stream>>>(
        cd, ci, drop, od, oi, removed, n, k, cap);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        knn_compact_rows_kernel<G, IPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    knn_compact_rows_kernel<G, IPL><<<blocks, kSelectThreads, smem, stream>>>(
        cd, ci, rows, drop, od, oi, removed, n, f, k, cap);
  }
  return (int)cudaGetLastError();
}

// the instance for lists of k (1 <= k <= kSelectMaxPadded)
int compact_dispatch(const float* cd, const int* ci, const int* rows,
                     const unsigned char* drop, float* od, int* oi,
                     int* removed, int n, int f, int k, cudaStream_t stream) {
  int padded = 32;
  while (padded < k) padded <<= 1;
  int cap = 1;                      // the winners' sort: at most k
  while (cap < k) cap <<= 1;
  return row_group_dispatch(padded, [&](auto g, auto ipl) {
    return launch_compact<decltype(g)::value, decltype(ipl)::value>(
        cd, ci, rows, drop, od, oi, removed, n, f, k, cap, stream);
  });
}

}  // namespace

extern "C" {

const char* knn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int knn_join_dists_launch(const float* x, const float* x2, const int* ids,
                          float* od, int* ev, int N, int n, int C, int dp,
                          int cn, cudaStream_t stream) {
  if (n <= 0 || C < 1 || dp < 0) return (int)cudaErrorInvalidValue;
  const bool vec =
      (dp & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (C > kJoinMaxC)
    return launch_join_wide(x, x2, ids, od, ev, N, n, C, dp, cn, vec,
                            stream);
  const int nb = (C + 3) / 4;
  const int tiles = nb * (nb + 1) / 2;
  const int slices = tiles * 8 <= kJoinMaxThreads   ? 8
                     : tiles * 4 <= kJoinMaxThreads ? 4
                                                    : 2;
  const int threads = (tiles * slices + 31) / 32 * 32;
  const size_t smem = (size_t)kJoinStages * 4 * nb * kJoinStride *
                      sizeof(float);
#define JOIN_LAUNCH(S, V)                                             \
  knn_join_dists_kernel<S, V><<<n, threads, smem, stream>>>(x, x2, ids, od, \
                                                            ev, N, C, dp, cn)
  switch (slices * (vec ? 1 : -1)) {
    case 8: JOIN_LAUNCH(8, 4); break;
    case 4: JOIN_LAUNCH(4, 4); break;
    case 2: JOIN_LAUNCH(2, 4); break;
    case -8: JOIN_LAUNCH(8, 1); break;
    case -4: JOIN_LAUNCH(4, 1); break;
    default: JOIN_LAUNCH(2, 1); break;
  }
#undef JOIN_LAUNCH
  return (int)cudaGetLastError();
}

int knn_join_select_launch(const float* gd, const int* gi, const float* kth,
                           float* od, int* oi, unsigned long long* scratch,
                           int n, int W, int c, cudaStream_t stream) {
  if (n <= 0 || W < 0 || c < 1) return (int)cudaErrorInvalidValue;
  int cap = 1;                      // the winners' sort: at most min(c, W)
  while (cap < c && cap < W) cap <<= 1;
  if (W > kSelectMaxPadded)
    return launch_select_stream(gd, gi, kth, od, oi, scratch, n, W, c, cap,
                                stream);
  int padded = 1;
  while (padded < W) padded <<= 1;
  if (padded <= kSelectWarpMaxPadded) {
    switch (padded <= 32 ? 1 : padded / 32) {
      case 1:
        return launch_select<1, 1>(gd, gi, kth, od, oi, n, W, c, cap, stream);
      case 2:
        return launch_select<1, 2>(gd, gi, kth, od, oi, n, W, c, cap, stream);
      case 4:
        return launch_select<1, 4>(gd, gi, kth, od, oi, n, W, c, cap, stream);
      case 8:
        return launch_select<1, 8>(gd, gi, kth, od, oi, n, W, c, cap, stream);
      case 16:
        return launch_select<1, 16>(gd, gi, kth, od, oi, n, W, c, cap,
                                    stream);
      default:
        return launch_select<1, 32>(gd, gi, kth, od, oi, n, W, c, cap,
                                    stream);
    }
  }
  switch (padded / kSelectThreads) {
    case 8:
      return launch_select<8, 8>(gd, gi, kth, od, oi, n, W, c, cap, stream);
    case 16:
      return launch_select<8, 16>(gd, gi, kth, od, oi, n, W, c, cap, stream);
    default:
      return launch_select<8, 32>(gd, gi, kth, od, oi, n, W, c, cap, stream);
  }
}

int knn_merge_launch(const float* cd, const int* ci, const float* qd,
                     const int* qi, float* od, int* oi, int* upd, int n, int k,
                     int c, cudaStream_t stream) {
  if (n <= 0 || k < 1 || c < 0 || k + c > kMergeMaxPool)
    return (int)cudaErrorInvalidValue;
  return merge_dispatch(cd, ci, nullptr, qd, qi, od, oi, upd, n, n, k, c,
                        stream);
}

int knn_merge_rows_launch(const float* cd, const int* ci, const int* rows,
                          const float* qd, const int* qi, float* od, int* oi,
                          int* upd, int n, int f, int k, int c,
                          cudaStream_t stream) {
  if (f <= 0 || k < 1 || c < 0 || k + c > kMergeMaxPool)
    return (int)cudaErrorInvalidValue;
  return merge_dispatch(cd, ci, rows, qd, qi, od, oi, upd, n, f, k, c,
                        stream);
}

int knn_compact_launch(const float* cd, const int* ci,
                       const unsigned char* drop, float* od, int* oi,
                       int* removed, int n, int k, cudaStream_t stream) {
  if (n <= 0 || k < 1 || k > kSelectMaxPadded)
    return (int)cudaErrorInvalidValue;
  return compact_dispatch(cd, ci, nullptr, drop, od, oi, removed, n, n, k,
                          stream);
}

int knn_compact_rows_launch(const float* cd, const int* ci, const int* rows,
                            const unsigned char* drop, float* od, int* oi,
                            int* removed, int n, int f, int k,
                            cudaStream_t stream) {
  if (f <= 0 || k < 1 || k > kSelectMaxPadded)
    return (int)cudaErrorInvalidValue;
  return compact_dispatch(cd, ci, rows, drop, od, oi, removed, n, f, k,
                          stream);
}

}  // extern "C"
