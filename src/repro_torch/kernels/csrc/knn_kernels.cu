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
// at any C: t-SNE's k = 91 neighbour graph gives C = 92 at rho 0.5, cn = 46.
// Bound: fp32 operations on the row's valid pairs (min(s, t) < cn, both
// ids valid), fed from shared memory; the candidates' rows come from L2 or
// device memory once a list row.
// Design: one block of 256 threads a row computes only what the mask can
// keep. Warp 0 first compacts the row's valid slots, new ones (s < cn)
// first, then old ones, each in slot order: V valid slots, vn of them new.
// The cross terms needed are G(u, v), u < V, v < vn (compacted indices), a
// V x vn block; it is cut into 8 x 8 tiles (bu, bv) over 8 vn-blocks of
// columns, and a tile whose rows and columns are both new is computed only
// on or below the diagonal (bu >= bv) and written both ways. So the old x
// old square and every empty slot cost nothing: no Gram, no gather. The
// valid rows are gathered once by cp.async into a ring of 2 or 3 stages of
// 32 features (16-byte copies where dp % 4 == 0, else 4-byte ones; features
// past dp zero-filled); 8 lanes a tile, lane `slice` taking features
// 4 slice .. 4 slice + 3 of each chunk, so a quarter-warp's 16-byte loads
// read one row's 128 contiguous bytes (no bank conflict), and 64 multiply-
// adds per 16 loads. A round holds 32 tiles; rows with more tiles take more
// rounds, each gathering the valid rows again. A butterfly over the 8
// lanes adds the partial tiles (the C <= 64 kernel's order of sums at 8
// slices), the tiles go to shared memory (H, V x vn), and the epilogue
// writes the row's C x C output in order: the norm expansion of common.cuh
// from H where the mask keeps the pair, +inf elsewhere, and the row's
// count of valid unordered pairs.
// Where the ring of all V rows, H and the slot maps do not fit a block
// (from C about 256 with every slot new, 320 with half), the same kernel
// runs in panels: the slot maps go to a slice of a scratch the wrapper
// allocates (a grid of at most a few blocks an SM walks the rows), a
// round's 32 tiles are a rectangle of 8 row blocks by 4 new column blocks
// whose 64 + 32 rows alone are staged (a ring of 3 x 96 rows, 41 KB,
// whatever C is), and each tile writes its distances and their mirrors
// straight into the output, which the block first fills with +inf: no H.
// The sums are the same, so both ways give the same bits.
// ---------------------------------------------------------------------------

constexpr int kJoinWideThreads = 256;
constexpr int kJoinWideSlices = 8;                 // lanes a tile
constexpr int kJoinWideTiles = kJoinWideThreads / kJoinWideSlices;
constexpr size_t kJoinWideMaxSmem = 232448 - 1024;  // a block's most, less static
constexpr int kJoinPanelRows = 8;                  // row blocks a panel round
constexpr int kJoinPanelCols = kJoinWideTiles / kJoinPanelRows;
constexpr int kJoinPanelStage = 8 * (kJoinPanelRows + kJoinPanelCols);

__host__ __device__ constexpr int pad8(int v) { return (v + 7) / 8 * 8; }

// the floats of the ring (stages x rows x kJoinStride), of H and of the
// slot maps (ids, norms, positions) of a wide join at (C, cn)
__host__ __device__ inline size_t join_wide_floats(int C, int cn,
                                                   int stages) {
  const int cp = pad8(C);
  return (size_t)stages * cp * kJoinStride +
         (size_t)cp * pad8(cn > 1 ? cn : 1) + 3 * (size_t)cp;
}

// the panels' scratch a block: the slot maps (ids, norms, positions and
// compacted -> slot), pad8(C) words each
__host__ __device__ inline size_t join_panel_ints(int C) {
  return 4 * (size_t)pad8(C);
}

// the scratch bytes a block of the wide join needs at (C, cn): 0 up to C 64
// and where the ring of all valid rows (2 stages at least), H and the slot
// maps fit a block, else the panels'
int64_t join_scratch_bytes(int C, int cn) {
  cn = cn < 0 ? 0 : (cn > C ? C : cn);
  if (C <= kJoinMaxC ||
      join_wide_floats(C, cn, 2) * sizeof(float) <= kJoinWideMaxSmem)
    return 0;
  return (int64_t)(join_panel_ints(C) * sizeof(int));
}

// kPanel 1: the panels (an int, so that build reports name the instance)
template <int kVec, int kStages, int kPanel>
__global__ void __launch_bounds__(kJoinWideThreads, 2)
    knn_join_dists_kernel_wide(const float* __restrict__ x,
                               const float* __restrict__ x2,
                               const int* __restrict__ ids,
                               float* __restrict__ od, int* __restrict__ ev,
                               int* __restrict__ scratch, int N, int n,
                               int C, int dp, int cn) {
  extern __shared__ __align__(16) float jsm[];
  __shared__ int s_counts[2];            // vn, V
  __shared__ int s_evals;
  constexpr bool panel = kPanel != 0;   // each way its own instance
  const int cp = pad8(C);
  const int cnp = pad8(cn > 1 ? cn : 1);
  const int stage = (panel ? kJoinPanelStage : cp) * kJoinStride;
  float* hbuf = jsm + kStages * stage;   // H: cp x cnp (not in panels)
  int* cid = panel ? scratch + blockIdx.x * join_panel_ints(C)
                   : reinterpret_cast<int*>(hbuf + (size_t)cp * cnp);
  float* cx2 = reinterpret_cast<float*>(cid + cp);
  int* pos = reinterpret_cast<int*>(cx2 + cp);
  int* slot = pos + cp;                  // panels only
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  const int slice = tid % kJoinWideSlices;
  const int chunks = (dp + kJoinChunk - 1) / kJoinChunk;

  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const int* rid = ids + (int64_t)row * C;
    float* out = od + (int64_t)row * C * C;
    if (tid < 32) {
      // the new valid slots, then the old ones, each in slot order
      int nv = 0;
#pragma unroll 1
      for (int pass = 0; pass < 2; ++pass) {
        for (int base = 0; base < C; base += 32) {
          const int s = base + lane;
          int id = -1;
          if (s < C) {
            id = rid[s];
            if (id >= N) id = -1;
          }
          const bool mine = id >= 0 && (pass == 0) == (s < cn);
          const unsigned b = __ballot_sync(0xffffffffu, mine);
          if (mine) {
            const int u = nv + __popc(b & below);
            cid[u] = id;
            cx2[u] = x2[id];
            pos[s] = u;
            if constexpr (panel) slot[u] = s;
          } else if (s < C && id < 0) {
            pos[s] = -1;
          }
          nv += __popc(b);
        }
        if (pass == 0 && lane == 0) s_counts[0] = nv;
      }
      if (lane == 0) {
        s_counts[1] = nv;
        s_evals = 0;
      }
    }
    if constexpr (panel)
      for (int64_t e = tid; e < (int64_t)C * C; e += kJoinWideThreads)
        out[e] = INFINITY;
    __syncthreads();
    const int vn = s_counts[0];
    const int V = s_counts[1];
    const int nbn = (vn + 7) >> 3;
    const int nbv = (V + 7) >> 3;
    const int tiles = nbn * nbv - nbn * (nbn - 1) / 2;
    const int hs = 8 * nbn;              // H's row stride this row
    int rounds = 0;
    if constexpr (panel) {
      for (int bv0 = 0; bv0 < nbn; bv0 += kJoinPanelCols)
        rounds += (nbv - bv0 + kJoinPanelRows - 1) / kJoinPanelRows;
    } else {
      rounds = (tiles + kJoinWideTiles - 1) / kJoinWideTiles;
      // the padding rows [V, 8 nbv) of every stage stay zero
      for (int e = tid; e < kStages * (8 * nbv - V) * kJoinStride;
           e += kJoinWideThreads) {
        const int st = e / ((8 * nbv - V) * kJoinStride);
        const int r = e - st * (8 * nbv - V) * kJoinStride;
        jsm[st * stage + V * kJoinStride + r] = 0.0f;
      }
    }
    int local = 0;

    for (int rd = 0; rd < rounds; ++rd) {
      // this thread's tile (bu, bv), and the staged rows: compacted rows
      // [a0, a0 + na) at ring row 0 and [b0, b0 + nb) at ring row boff
      int bu, bv, a0, na, b0, nb, boff;
      bool owner;
      if constexpr (panel) {
        // the rectangle of row blocks [bu0, bu0 + 8) by new column blocks
        // [bv0, bv0 + 4); tiles off the V x vn block or above the diagonal
        // write nothing
        int r = rd;
        int bv0 = 0;
        while (r >= (nbv - bv0 + kJoinPanelRows - 1) / kJoinPanelRows) {
          r -= (nbv - bv0 + kJoinPanelRows - 1) / kJoinPanelRows;
          bv0 += kJoinPanelCols;
        }
        const int bu0 = bv0 + kJoinPanelRows * r;
        const int t = tid / kJoinWideSlices;
        bu = bu0 + t % kJoinPanelRows;
        bv = bv0 + t / kJoinPanelRows;
        owner = bu < nbv && bv < nbn && bu >= bv;
        a0 = 8 * bu0;
        na = min(8 * kJoinPanelRows, V - a0);
        b0 = 8 * bv0;
        nb = min(8 * kJoinPanelCols, V - b0);
        boff = 8 * kJoinPanelRows;
      } else {
        // bv over the new column blocks, bu >= bv over all row blocks;
        // threads past the last tile compute the round's first and write
        // nothing
        int tile = rd * kJoinWideTiles + tid / kJoinWideSlices;
        owner = tile < tiles;
        if (!owner) tile = rd * kJoinWideTiles;
        bv = 0;
        while (tile >= nbv - bv) {
          tile -= nbv - bv;
          ++bv;
        }
        bu = bv + tile;
        a0 = 0;
        na = V;
        b0 = 0;
        nb = 0;
        boff = 0;
      }
      auto load = [&](int st, int kc) {
        float* dst = jsm + st * stage;
        join_load_chunk<kVec>(dst, x, cid + a0, na, dp, kc * kJoinChunk, tid,
                              kJoinWideThreads);
        if (nb > 0)
          join_load_chunk<kVec>(dst + boff * kJoinStride, x, cid + b0, nb, dp,
                                kc * kJoinChunk, tid, kJoinWideThreads);
      };

      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

      __syncthreads();                   // the ring's last round is done
#pragma unroll
      for (int st = 0; st < kStages - 1; ++st) {
        if (st < chunks) load(st, st);
        cp_async_commit();
      }
      const int ra_row = 8 * bu - a0;
      const int rb_row = 8 * bv - b0 + boff;
      for (int kc = 0; kc < chunks; ++kc) {
        cp_async_wait<kStages - 2>();    // this thread's copies of chunk kc
        __syncthreads();                 // everyone's; stage kc - 1 is free
        const int nxt = kc + kStages - 1;
        if (nxt < chunks) load(nxt % kStages, nxt);
        cp_async_commit();

        const float* st = jsm + (kc % kStages) * stage + 4 * slice;
        const float* ra = st + ra_row * kJoinStride;
        const float* rb = st + rb_row * kJoinStride;
        float4 b[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          b[c] = *reinterpret_cast<const float4*>(rb + c * kJoinStride);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 a =
              *reinterpret_cast<const float4*>(ra + r * kJoinStride);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            float v = fmaf(a.x, b[c].x, acc[r][c]);
            v = fmaf(a.y, b[c].y, v);
            v = fmaf(a.z, b[c].z, v);
            acc[r][c] = fmaf(a.w, b[c].w, v);
          }
        }
      }
      cp_async_wait<0>();                // only empty groups are left

#pragma unroll
      for (int off = 1; off < kJoinWideSlices; off <<= 1)
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
      if (owner) {
        // lane `slice` takes column 8 bv + slice: G(u, v) at H[u hs + v],
        // and where u is new too, G(v, u) at H[v hs + u]; in panels the
        // pair's distance at (slot u, slot v) and (slot v, slot u), counted
        // once (u old, or u > v)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            if (c == slice) {
              const int u = 8 * bu + r;
              const int v = 8 * bv + c;
              if constexpr (!panel) {
                hbuf[u * hs + v] = acc[r][c];
                if (bu < nbn) hbuf[v * hs + u] = acc[r][c];
              } else if (u < V && v < vn && u != v && cid[u] != cid[v]) {
                const float d = fmaxf(
                    __fsub_rn(__fadd_rn(cx2[v], cx2[u]),
                              __fmul_rn(2.0f, acc[r][c])),
                    0.0f);
                const int su = slot[u];
                const int sv = slot[v];
                out[(int64_t)su * C + sv] = d;
                out[(int64_t)sv * C + su] = d;
                local += (u >= vn || u > v) ? 1 : 0;
              }
            }
          }
        }
      }
    }
    __syncthreads();                     // H is whole

    if constexpr (!panel) {
      // the row's C x C output in order: pair (lo, hi) = (min, max) of
      // (s, t)
      for (int e = tid; e < C * C; e += kJoinWideThreads) {
        const int s = e / C;
        const int t = e - s * C;
        const int lo = min(s, t);
        const int hi = max(s, t);
        float v = INFINITY;
        if (lo != hi && lo < cn) {
          const int cu = pos[lo];          // new: below vn
          const int cv = pos[hi];
          if (cu >= 0 && cv >= 0 && cid[cu] != cid[cv]) {
            v = fmaxf(__fsub_rn(__fadd_rn(cx2[cu], cx2[cv]),
                                __fmul_rn(2.0f, hbuf[cv * hs + cu])),
                      0.0f);
            local += s < t ? 1 : 0;
          }
        }
        out[e] = v;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, off);
    if (lane == 0) atomicAdd(&s_evals, local);
    __syncthreads();
    if (tid == 0) ev[row] = s_evals;
    __syncthreads();                     // the maps are free for the next row
  }
}

// The wide join's instance: three stages where the ring, H and the maps
// fit a block's shared memory, else two; else panels (three stages of 96
// rows) over a grid of `blocks` blocks with the scratch the wrapper
// allocated (join_scratch_bytes a block). The panels are instances of
// their own, so the others hold no register for them.
int launch_join_wide(const float* x, const float* x2, const int* ids,
                     float* od, int* ev, int* scratch, int blocks, int N,
                     int n, int C, int dp, int cn, bool vec,
                     cudaStream_t stream) {
  cn = cn < 0 ? 0 : (cn > C ? C : cn);
  const bool panel = join_scratch_bytes(C, cn) > 0;
  if (panel != (scratch != nullptr) || (panel && blocks < 1))
    return (int)cudaErrorInvalidValue;
  int stages = 3;
  while (!panel &&
         join_wide_floats(C, cn, stages) * sizeof(float) > kJoinWideMaxSmem)
    --stages;
  const size_t smem =
      panel ? (size_t)3 * kJoinPanelStage * kJoinStride * sizeof(float)
            : join_wide_floats(C, cn, stages) * sizeof(float);
  auto kernel =
      panel ? (vec ? knn_join_dists_kernel_wide<4, 3, 1>
                   : knn_join_dists_kernel_wide<1, 3, 1>)
      : vec ? (stages == 3 ? knn_join_dists_kernel_wide<4, 3, 0>
                           : knn_join_dists_kernel_wide<4, 2, 0>)
            : (stages == 3 ? knn_join_dists_kernel_wide<1, 3, 0>
                           : knn_join_dists_kernel_wide<1, 2, 0>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = panel ? (blocks < n ? blocks : n) : n;
  kernel<<<grid, kJoinWideThreads, smem, stream>>>(x, x2, ids, od, ev, scratch,
                                                   N, n, C, dp, cn);
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
// to knn_join_select_kernel_resident or _stream, below). The row is read
// once, coalesced, into registers: thread t of the T in its group holds
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
// The resident-row core (block_select): one row of W keys, any W, held by a
// block of kSelectThreads threads, read through key_at(p): from shared
// memory where the row is resident (the select above a padded W of 8192,
// the merge above a pool of 8192), from device memory where it is streamed
// (the select past what a block's shared memory holds). Warp w owns the
// positions [w span, (w + 1) span), span = 32 ceil(W / T), read 32 at a
// time, coalesced. Keys, the sentinel and the (key, position) order are
// select_winners', so the result is the register instances' bit for bit:
//  1. the survivors s (keys below `big`); if s <= c every survivor wins;
//  2. else four 8-bit passes, each a 256-bin shared histogram of the keys
//     that match the digits found so far (a shared atomic a key: warp
//     aggregation by __match_any_sync cost 1.2-1.8x the time here) and
//     select_winners' find_bin, find the c-th smallest key T and `need`;
//  3. each warp counts its keys below T and equal to T, one barrier turns
//     the counts into each warp's offsets, and a second read of its range
//     writes its winners in position order as 64-bit (key, position)
//     words (a ballot a 32 keys, no barrier);
//  4. up to T winners each take the slot their rank names; more are
//     bitonic-sorted over the next power of two of their count.
// put(slot, position) is called once for each winner; returns how many.
// `words` holds the next power of two of min(c, W) words; `ints` holds
// kBlockSelectInts ints.
// ---------------------------------------------------------------------------

constexpr int kBlockSelectInts = 2 * kSelectBins + 2 * (kSelectThreads / 32);

template <class KeyAt, class Put>
__device__ __forceinline__ int block_select(KeyAt key_at, int W, uint32_t big,
                                            int c,
                                            unsigned long long* words,
                                            int* ints, Put put) {
  constexpr int T = kSelectThreads;
  constexpr int G = T / 32;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const unsigned below = (1u << lane) - 1u;
  int* hist = ints;                      // [2][kSelectBins]
  int* cnt = ints + 2 * kSelectBins;     // [G] below T, then [G] equal to T
  const int span = 32 * ((W + T - 1) / T);
  const int p0 = min(warp * span, W);
  const int p1 = min(p0 + span, W);
  auto key = [&](int p) { return p < p1 ? key_at(p) : big; };

  // 1. the survivors
  int mine = 0;
  for (int p = p0 + lane; p < p1; p += 32) mine += key_at(p) < big ? 1 : 0;
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) cnt[warp] = mine;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < G; ++w) s += cnt[w];
  __syncthreads();                       // cnt is read: free again

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
      for (int p = p0 + lane; p < p1; p += 32) {
        const uint32_t kb = key_at(p);
        if (kb < big && (kb & pmask) == prefix)
          atomicAdd(&h[(kb >> shift) & 0xff], 1);
      }
      __syncthreads();
      // h_next was last read before the barrier above
      for (int b = t; b < kSelectBins; b += T) h_next[b] = 0;
      int bin, rin;
      find_bin(h, r, lane, bin, rin);
      prefix |= (uint32_t)bin << shift;
      pmask |= 0xffu << shift;
      r = rin;
      __syncthreads();                   // h read, h_next clear
    }
    thr = prefix;
    need = r + 1;
  }

  // 3. the winners in position order: keys below T, then the first `need`
  // keys equal to it (T < big wherever need > 0)
  int lt = 0;
  int eq = 0;
  for (int p = p0 + lane; p < p1; p += 32) {
    const uint32_t kb = key_at(p);
    lt += kb < thr ? 1 : 0;
    eq += need > 0 && kb == thr ? 1 : 0;
  }
  lt = __reduce_add_sync(0xffffffffu, lt);
  eq = __reduce_add_sync(0xffffffffu, eq);
  if (lane == 0) {
    cnt[warp] = lt;
    cnt[G + warp] = eq;
  }
  __syncthreads();
  int e_at = 0;                          // keys equal to T before this warp
  int w_at = 0;                          // winners before this warp
  int e_run = 0;
  int nwin = 0;
#pragma unroll
  for (int w = 0; w < G; ++w) {
    if (w == warp) {
      e_at = e_run;
      w_at = nwin;
    }
    const int e_w = cnt[G + w];
    nwin += cnt[w] + max(0, min(e_w, need - e_run));
    e_run += e_w;
  }
  for (int base = p0; base < p1; base += 32) {
    const int p = base + lane;
    const uint32_t kb = key(p);
    const bool is_eq = need > 0 && kb == thr;
    const unsigned eb = __ballot_sync(0xffffffffu, is_eq);
    const bool win = kb < thr || (is_eq && e_at + __popc(eb & below) < need);
    const unsigned wb = __ballot_sync(0xffffffffu, win);
    if (win)
      words[w_at + __popc(wb & below)] =
          ((unsigned long long)kb << 32) | (unsigned)p;
    e_at += __popc(eb);
    w_at += __popc(wb);
  }
  __syncthreads();                       // the words are written

  // 4. each winner to its slot
  if (nwin <= T) {
    for (int j = t; j < nwin; j += T) {
      const unsigned long long w = words[j];
      int rank = 0;
#pragma unroll 4
      for (int x = 0; x < nwin; ++x) rank += words[x] < w;
      put(rank, (int)(w & 0xffffffffu));
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
    for (int j = t; j < nwin; j += T) put(j, (int)(words[j] & 0xffffffffu));
  }
  return nwin;
}

// ---------------------------------------------------------------------------
// knn_join_select above a padded W of kSelectMaxPadded, the same selection
// at any W: k = 91 gives a receiver select of 2 C x C = 16928 and a polish
// select of k^2 = 8281. A row no longer fits in a block's registers.
// knn_join_select_kernel_resident: where the row's keys and the winners'
// words fit kResidentMaxBytes of shared memory (two or three rows an SM),
// one block of 256 threads a row reads each (dist, id) entry once from
// device memory, coalesced, eight entries in flight a thread, and folds
// the prefilter (id >= 0 and dist < kth), -0 as +0 and the FLT_MAX
// sentinel into one 32-bit key in shared memory (68 KB at W 16928); the
// resident-row core then reads shared memory only, and the winners'
// distances and ids are read back from device memory (so -0.0 keeps its
// sign). knn_join_select_kernel_stream: wider rows (or wider outputs) are
// read from device memory (or L2) by the same core once a pass; the
// winners' words sit in shared memory up to kStreamSmemWords (64 KB),
// beyond it in the row's slice of a scratch the wrapper allocates.
// Bound: bytes. The resident instance reads a row once, as the bound
// counts it; the streamed one 3 to 7 times.
// ---------------------------------------------------------------------------

constexpr int kStreamSmemWords = 8192;
constexpr size_t kResidentMaxBytes = 110 * 1024;   // two rows an SM
constexpr int kResidentBatch = 8;        // entries in flight a thread

// the output slots past the winners: (+inf, -1)
__device__ __forceinline__ void select_put_fill(float* rod, int* roi,
                                                int nwin, int c) {
  for (int j = nwin + (int)threadIdx.x; j < c; j += kSelectThreads) {
    rod[j] = INFINITY;
    roi[j] = -1;
  }
}

__global__ void __launch_bounds__(kSelectThreads)
    knn_join_select_kernel_stream(const float* __restrict__ gd,
                                  const int* __restrict__ gi,
                                  const float* __restrict__ kth,
                                  float* __restrict__ od,
                                  int* __restrict__ oi,
                                  unsigned long long* __restrict__ scratch,
                                  int W, int c, int cap) {
  extern __shared__ __align__(16) unsigned long long stream_smem[];
  __shared__ __align__(16) int ints[kBlockSelectInts];
  const int row = blockIdx.x;
  unsigned long long* words =
      scratch != nullptr ? scratch + (int64_t)row * cap : stream_smem;
  const float th = kth[row];
  const float* rd = gd + (int64_t)row * W;
  const int* ri = gi + (int64_t)row * W;
  const uint32_t big = order_bits(FLT_MAX);
  float* rod = od + (int64_t)row * c;
  int* roi = oi + (int64_t)row * c;
  const int nwin = block_select(
      [&](int p) {
        const float d = rd[p];
        return ri[p] >= 0 && d < th ? order_bits(d) : big;
      },
      W, big, c, words, ints, [&](int slot, int p) {
        rod[slot] = rd[p];
        roi[slot] = ri[p];
      });
  select_put_fill(rod, roi, nwin, c);
}

__global__ void __launch_bounds__(kSelectThreads)
    knn_join_select_kernel_resident(const float* __restrict__ gd,
                                    const int* __restrict__ gi,
                                    const float* __restrict__ kth,
                                    float* __restrict__ od,
                                    int* __restrict__ oi, int W, int c,
                                    int cap) {
  extern __shared__ __align__(16) unsigned long long resident_smem[];
  __shared__ __align__(16) int ints[kBlockSelectInts];
  constexpr int T = kSelectThreads;
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  unsigned long long* words = resident_smem;
  uint32_t* keys = reinterpret_cast<uint32_t*>(resident_smem + cap);
  const float th = kth[row];
  const float* rd = gd + (int64_t)row * W;
  const int* ri = gi + (int64_t)row * W;
  const uint32_t big = order_bits(FLT_MAX);
  for (int base = 0; base < W; base += kResidentBatch * T) {
    float d[kResidentBatch];
    int id[kResidentBatch];
#pragma unroll
    for (int u = 0; u < kResidentBatch; ++u) {
      const int p = base + u * T + t;
      d[u] = p < W ? rd[p] : 0.0f;
      id[u] = p < W ? ri[p] : -1;
    }
#pragma unroll
    for (int u = 0; u < kResidentBatch; ++u) {
      const int p = base + u * T + t;
      if (p < W) keys[p] = id[u] >= 0 && d[u] < th ? order_bits(d[u]) : big;
    }
  }
  __syncthreads();
  float* rod = od + (int64_t)row * c;
  int* roi = oi + (int64_t)row * c;
  const int nwin = block_select(
      [&](int p) { return keys[p]; }, W, big, c, words, ints,
      [&](int slot, int p) {
        rod[slot] = rd[p];
        roi[slot] = ri[p];
      });
  select_put_fill(rod, roi, nwin, c);
}

// shared bytes of a resident row: the winners' words, then the keys
__host__ __device__ inline size_t select_resident_bytes(int W, int cap) {
  return (size_t)cap * sizeof(unsigned long long) +
         ((size_t)W * sizeof(uint32_t) + 7) / 8 * 8;
}

int launch_select_wide(const float* gd, const int* gi, const float* kth,
                       float* od, int* oi, unsigned long long* scratch,
                       int n, int W, int c, int cap, cudaStream_t stream) {
  const size_t resident = select_resident_bytes(W, cap);
  if (resident <= kResidentMaxBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_join_select_kernel_resident,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)resident);
    if (err != cudaSuccess) return (int)err;
    knn_join_select_kernel_resident<<<n, kSelectThreads, resident, stream>>>(
        gd, gi, kth, od, oi, W, c, cap);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr && cap > kStreamSmemWords)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      scratch != nullptr ? 0 : (size_t)cap * sizeof(unsigned long long);
  // always opted in: the dynamic part may pass 48 KB less the counts
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

constexpr int kMergeMaxPool = 8192;  // k + c: the widest pool in registers
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
// The merges above a pool of kMergeMaxPool (knn_merge_kernel_wide,
// knn_merge_rows_kernel_wide), the same merge at any pool: the online
// store's insert refinement and delete refill merge k + k^2 = 8372 a row at
// t-SNE's k = 91. A pool no longer fits in a block's registers, so one
// block of 256 threads a row holds it in memory: an open-addressing table
// of (id, lowest position) words sized to the pool (the next power of two
// of 1.5 m slots: 16384, 128 KB at m 8372), filled as merge_row fills its
// own (a warp's lanes that hold one id send the lowest position once;
// atomicCAS claims a slot, atomicMin lowers a claimed one), then the pool's
// 32-bit keys (written over its ids, each by the thread that read it),
// then the resident-row core (block_select) picks k and writes them
// ascending. The contract is merge_row's, so the output is the register
// instances' (and the plain merge's) bit for bit: a candidate is dropped
// if its id is < 0, sits in the list or repeats an earlier candidate; the
// list is never deduped; ties go to the lowest pool position; the output
// stops at the FLT_MAX sentinel; the count is the picks from the
// candidates. Where the table, the keys and the winners' words fit
// kMergeWideSmem of shared memory they live there, a block a row; beyond
// it they live in a scratch the wrapper allocates, a slice a block, and a
// grid of as many blocks as slices walks the rows. Either way one launch
// merges the call: the pool is never cut into slices, whose merges could
// accept a candidate that a later slice evicts.
// Bound: bytes (8 per list and candidate entry in, 8 per list entry out).
// ---------------------------------------------------------------------------

constexpr size_t kMergeWideSmem = 200 * 1024;

struct MergeWideLayout {
  int slots;                             // power of two >= 1.5 m
  int lg;                                // log2(slots)
  int cap;                               // power of two >= k: the words
  size_t bytes;                          // table, words, keys
};

__host__ __device__ inline MergeWideLayout merge_wide_layout(int k, int c) {
  const int m = k + c;
  MergeWideLayout l;
  l.slots = 1;
  l.lg = 0;
  while (l.slots < m + m / 2) {
    l.slots <<= 1;
    ++l.lg;
  }
  l.cap = 1;
  while (l.cap < k) l.cap <<= 1;
  l.bytes = (size_t)l.slots * sizeof(unsigned long long) +
            (size_t)l.cap * sizeof(unsigned long long) +
            ((size_t)m * sizeof(uint32_t) + 7) / 8 * 8;
  return l;
}

// One block merges candidate slot `slot` into list row rows[slot] (rows ==
// nullptr: list row `slot`); `mem` holds the row's table, words and keys.
__device__ __forceinline__ void merge_row_wide(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const int* __restrict__ rows, const float* __restrict__ qd,
    const int* __restrict__ qi, float* __restrict__ od, int* __restrict__ oi,
    int* __restrict__ upd, int n, int k, int c, MergeWideLayout l, int slot,
    char* mem, int* ints, int* s_picks) {
  constexpr int T = kSelectThreads;
  constexpr unsigned long long kEmpty = ~0ull;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int row = rows == nullptr ? slot : rows[slot];
  if (row < 0 || row >= n) {             // padding: count 0, write nothing
    if (t == 0) upd[slot] = 0;
    return;
  }
  unsigned long long* table = reinterpret_cast<unsigned long long*>(mem);
  unsigned long long* words = table + l.slots;
  uint32_t* keys = reinterpret_cast<uint32_t*>(words + l.cap);
  const int m = k + c;
  const int shift = 32 - l.lg;
  const float* rcd = cd + (int64_t)row * k;
  const int* rci = ci + (int64_t)row * k;
  const float* rqd = qd + (int64_t)slot * c;
  const int* rqi = qi + (int64_t)slot * c;

  for (int j = t; j < l.slots; j += T) table[j] = kEmpty;
  if (t == 0) *s_picks = 0;
  __syncthreads();
  for (int base = 0; base < m; base += T) {
    const int p = base + t;
    int id = -1;
    if (p < m) {
      id = p < k ? rci[p] : rqi[p - k];
      keys[p] = (uint32_t)id;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    if (id >= 0 && lane == __ffs(peers) - 1) {
      const unsigned long long w =
          ((unsigned long long)(unsigned)id << 32) | (unsigned)p;
      uint32_t h = ((uint32_t)id * 0x9E3779B1u) >> shift;
      while (true) {
        const unsigned long long prev = atomicCAS(&table[h], kEmpty, w);
        if (prev == kEmpty) break;
        if ((uint32_t)(prev >> 32) == (uint32_t)id) {
          atomicMin(&table[h], w);
          break;
        }
        h = (h + 1) & (l.slots - 1);
      }
    }
  }
  __syncthreads();

  const uint32_t big = order_bits(FLT_MAX);
  for (int p = t; p < m; p += T) {
    const int id = (int)keys[p];
    uint32_t kb = big;
    if (p < k) {
      const float d = rcd[p];
      if (d != -INFINITY && d < FLT_MAX) kb = order_bits(d);
    } else if (id >= 0) {
      uint32_t h = ((uint32_t)id * 0x9E3779B1u) >> shift;
      unsigned long long v = table[h];
      while ((uint32_t)(v >> 32) != (uint32_t)id) {
        h = (h + 1) & (l.slots - 1);
        v = table[h];
      }
      const float d = rqd[p - k];
      if ((int)(v & 0xffffffffu) == p && d < FLT_MAX) kb = order_bits(d);
    }
    keys[p] = kb;
  }
  __syncthreads();

  float* rod = od + (int64_t)row * k;
  int* roi = oi + (int64_t)row * k;
  int picked = 0;
  const int nwin = block_select(
      [&](int p) { return keys[p]; }, m, big, k, words, ints,
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
  select_put_fill(rod, roi, nwin, k);
  picked = __reduce_add_sync(0xffffffffu, picked);
  if (lane == 0) atomicAdd(s_picks, picked);
  __syncthreads();
  if (t == 0) upd[slot] = *s_picks;
}

// the row walk of both forms: scratch == nullptr, the row's memory in
// shared memory and a block a row; else the block's slice of the scratch
// and a grid-stride walk over the rows
__device__ __forceinline__ void merge_rows_wide(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const int* __restrict__ rows, const float* __restrict__ qd,
    const int* __restrict__ qi, float* __restrict__ od, int* __restrict__ oi,
    int* __restrict__ upd, int n, int f, int k, int c,
    char* __restrict__ scratch, char* smem) {
  __shared__ __align__(16) int ints[kBlockSelectInts];
  __shared__ int s_picks;
  const MergeWideLayout l = merge_wide_layout(k, c);
  char* mem = scratch != nullptr ? scratch + (size_t)blockIdx.x * l.bytes
                                 : smem;
  for (int slot = blockIdx.x; slot < f; slot += gridDim.x) {
    merge_row_wide(cd, ci, rows, qd, qi, od, oi, upd, n, k, c, l, slot, mem,
                   ints, &s_picks);
    __syncthreads();                     // the memory is free for the next
  }
}

__global__ void __launch_bounds__(kSelectThreads) knn_merge_kernel_wide(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const float* __restrict__ qd, const int* __restrict__ qi,
    float* __restrict__ od, int* __restrict__ oi, int* __restrict__ upd,
    int n, int k, int c, char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned long long merge_wide_smem[];
  merge_rows_wide(cd, ci, nullptr, qd, qi, od, oi, upd, n, n, k, c, scratch,
                  reinterpret_cast<char*>(merge_wide_smem));
}

__global__ void __launch_bounds__(kSelectThreads) knn_merge_rows_kernel_wide(
    const float* __restrict__ cd, const int* __restrict__ ci,
    const int* __restrict__ rows, const float* __restrict__ qd,
    const int* __restrict__ qi, float* __restrict__ od, int* __restrict__ oi,
    int* __restrict__ upd, int n, int f, int k, int c,
    char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned long long merge_wide_smem[];
  merge_rows_wide(cd, ci, rows, qd, qi, od, oi, upd, n, f, k, c, scratch,
                  reinterpret_cast<char*>(merge_wide_smem));
}

// the scratch bytes a block of the wide merge needs at (k, c): 0 where the
// register instances take the pool or its memory fits shared memory
int64_t merge_scratch_bytes(int k, int c) {
  if (k + c <= kMergeMaxPool) return 0;
  const MergeWideLayout l = merge_wide_layout(k, c);
  return l.bytes <= kMergeWideSmem ? 0 : (int64_t)l.bytes;
}

int launch_merge_wide(const float* cd, const int* ci, const int* rows,
                      const float* qd, const int* qi, float* od, int* oi,
                      int* upd, int n, int f, int k, int c, char* scratch,
                      int scratch_blocks, cudaStream_t stream) {
  const MergeWideLayout l = merge_wide_layout(k, c);
  const bool resident = l.bytes <= kMergeWideSmem;
  if (!resident && (scratch == nullptr || scratch_blocks < 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = resident ? l.bytes : 0;
  const int grid = resident || f < scratch_blocks ? f : scratch_blocks;
  char* mem = resident ? nullptr : scratch;
  if (rows == nullptr) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_merge_kernel_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    knn_merge_kernel_wide<<<grid, kSelectThreads, smem, stream>>>(
        cd, ci, qd, qi, od, oi, upd, n, k, c, mem);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        knn_merge_rows_kernel_wide,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    knn_merge_rows_kernel_wide<<<grid, kSelectThreads, smem, stream>>>(
        cd, ci, rows, qd, qi, od, oi, upd, n, f, k, c, mem);
  }
  return (int)cudaGetLastError();
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

int64_t knn_join_scratch_bytes(int C, int cn) {
  return join_scratch_bytes(C, cn);
}

int knn_join_dists_launch(const float* x, const float* x2, const int* ids,
                          float* od, int* ev, int* scratch,
                          int scratch_blocks, int N, int n, int C, int dp,
                          int cn, cudaStream_t stream) {
  if (n <= 0 || C < 1 || dp < 0) return (int)cudaErrorInvalidValue;
  const bool vec =
      (dp & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (C > kJoinMaxC)
    return launch_join_wide(x, x2, ids, od, ev, scratch, scratch_blocks, N,
                            n, C, dp, cn, vec, stream);
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
    return launch_select_wide(gd, gi, kth, od, oi, scratch, n, W, c, cap,
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

int64_t knn_merge_scratch_bytes(int k, int c) {
  return merge_scratch_bytes(k, c);
}

int knn_merge_launch(const float* cd, const int* ci, const float* qd,
                     const int* qi, float* od, int* oi, int* upd,
                     char* scratch, int scratch_blocks, int n, int k, int c,
                     cudaStream_t stream) {
  if (n <= 0 || k < 1 || c < 0) return (int)cudaErrorInvalidValue;
  if (k + c > kMergeMaxPool)
    return launch_merge_wide(cd, ci, nullptr, qd, qi, od, oi, upd, n, n, k,
                             c, scratch, scratch_blocks, stream);
  return merge_dispatch(cd, ci, nullptr, qd, qi, od, oi, upd, n, n, k, c,
                        stream);
}

int knn_merge_rows_launch(const float* cd, const int* ci, const int* rows,
                          const float* qd, const int* qi, float* od, int* oi,
                          int* upd, char* scratch, int scratch_blocks, int n,
                          int f, int k, int c, cudaStream_t stream) {
  if (f <= 0 || k < 1 || c < 0) return (int)cudaErrorInvalidValue;
  if (k + c > kMergeMaxPool)
    return launch_merge_wide(cd, ci, rows, qd, qi, od, oi, upd, n, f, k, c,
                             scratch, scratch_blocks, stream);
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
