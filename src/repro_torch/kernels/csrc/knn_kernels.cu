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
// Design: a radix select, not a sort of the row. An entry's key is the
// order-preserving bits of its distance (-0 as +0; entries that fail the
// prefilter, and survivors at FLT_MAX, carry the FLT_MAX sentinel), its
// input position the tie-break. A row belongs to one warp where W pads to
// at most 1024 (eight rows per block, so the search's 32-wide rows fill a
// warp, not a block), else to a block of 256 threads. The row is read once,
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

// G warps per row (1: eight rows per block; 8: one), IPL keys per thread
template <int G, int IPL>
__global__ void __launch_bounds__(kSelectThreads) knn_join_select_kernel(
    const float* __restrict__ gd, const int* __restrict__ gi,
    const float* __restrict__ kth, float* __restrict__ od,
    int* __restrict__ oi, int n, int W, int c, int cap) {
  constexpr int T = 32 * G;
  constexpr int kRows = kSelectThreads / T;
  constexpr int kScan = select_scan_ints<G, IPL>();
  constexpr int kRankMax = 4 * T;      // winners placed by rank up to here
  extern __shared__ __align__(16) unsigned long long select_smem[];
  const int grp = threadIdx.x / T;
  const int t = threadIdx.x - grp * T;
  const int warp = t >> 5;
  const int lane = t & 31;
  const unsigned below = (1u << lane) - 1u;
  const int row = blockIdx.x * kRows + grp;
  if (row >= n) return;          // a whole warp (kRows > 1 only for G 1)
  unsigned long long* words = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<char*>(select_smem) +
      grp * select_group_bytes<G, IPL>(cap));
  int* hist = reinterpret_cast<int*>(words + (cap < 2 ? 2 : cap));  // [2]
  int* scan_e = hist + 2 * kSelectBins;  // keys equal to T
  int* scan_w = scan_e + kScan;          // winners
  int* cnt = scan_w + kScan;             // survivors per warp

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
  float* rod = od + (int64_t)row * c;
  int* roi = oi + (int64_t)row * c;
  if (nwin <= kRankMax) {
    // a winner's slot is the count of winners below it
    group_sync<G>();
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
  int cap = 1;                      // the winners' sort: at most min(c, W)
  while (cap < c && cap < W) cap <<= 1;
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
