// The LM stack's f32 attention kernel for Hopper (sm_90a), CUDA C++: the
// exact path. bf16 inputs go to attention_sm90.cu (wgmma + TMA).
//
// Built by kernels/_lib.py together with the other sources into one shared
// library with a plain C interface (each source compiled by its own nvcc,
// all started together, then linked) and loaded with ctypes. The launcher
// takes raw device pointers, sizes and a stream, launches on that stream
// without synchronising, allocates nothing, and returns cudaGetLastError().
// The Python wrapper (kernels/flash_attention.py) checks shapes, dtypes,
// contiguity and 16-byte alignment and allocates the output; kernels/ref.py
// holds the plain PyTorch version.
//
// ---------------------------------------------------------------------------
// flash_attention: replaces flash_attention / _flash_kernel
// (src/repro/kernels/flash_attention.py:86,30), and is what the model's
// chunked_attention (models/attention.py) runs on a card, so its contract
// is the union of _flash_kernel's and _flash_block's:
//
//   q (B, Lq, H, Dq), k (B, Lk, Hkv, Dq), v (B, Lk, Hkv, Dv), all f32, in
//   the model's (batch, position, head, feature) layout; output
//   o (B, Lq, H, Dv) in f32. Logits q.k * scale, optionally
//   softcap * tanh(logits / softcap); masks from positions only:
//   qpos = q_offset + row, causal kpos <= qpos, window kpos > qpos - window,
//   kpos < Lk (ragged tails are masked, not refused). q head h reads kv
//   head h / (H / Hkv) (the GQA fold in the indexing: no repeated copy of
//   k and v). A row that sees no key comes out as 0. All arithmetic is
//   fp32 on the CUDA cores (no TF32, no tensor cores): logits, running max
//   m, denominator l and accumulator. Dq and Dv are multiples of 4 up to
//   256, and may differ.
//
// Bound: operations. 2 (Dq + Dv) flops per visible (q, k) pair and head at
// the fp32 rate: a causal prefill of 2 x 1000 at H 32, Dh 128 is 16.4
// GFLOP, 0.245 ms at 67 TFLOP/s.
//
// Design: a register-tiled SIMT kernel fed by a cp.async ring.
//  * Blocks. 128 threads per (b*h, tile of 64 query rows) (32 rows where
//    Dq or Dv exceeds 128); about 103 KB of shared memory at Dh 128, so two
//    blocks share an SM and one's barriers and softmax run under the
//    other's FMAs. A 1-D grid walks the query tiles from the last one down,
//    all heads of a tile together, so the heaviest causal tiles start first
//    and the tail is short.
//  * Tiles. Thread (ty, tx) = (tid / 16, tid % 16) owns 8 query rows (4
//    at 32 rows), 32 i + 4 ty + e, and for S = q k^T the 8 keys tx + 16 j
//    of each kv tile of 128 keys, for O the columns 64 g + 4 tx + e: 8 x 8
//    logits and 8 x 8 outputs at Dh 128: both products read one float of
//    shared memory per 4 FMAs, as float4s (q and P^T broadcast across a
//    half warp). A row's 16 threads are one half warp, so its max is a
//    16-lane shuffle; its sum stays per thread until the end.
//  * The ring. q's tile is staged once. Each kv tile then streams through a
//    ring of 2 stages of 18 KB as slices: k in 32 features of all 128 keys
//    (row-major, padded to 36 floats so that 8 keys' float4s hit distinct
//    banks), then v in 32 keys (16 above Dv 128) of all columns, each by
//    16-byte cp.async; the next slice's copy is in flight while this one's
//    products run, one barrier per slice. Features past Dq, columns past
//    Dv and keys past Lk are zero-filled, not read; v slices past the last
//    key any row can see are not loaded.
//  * Softmax. Logits in the log2 domain (log2(e) folded into the scale,
//    exp2f), masks only on tiles that straddle the causal diagonal, a window
//    edge or Lk; a masked logit is -inf and the running max starts at
//    -1e30, so p is exactly 0 there and a row that has seen nothing keeps
//    alpha 1 (JAX's where(mask, p, 0) guard). P goes to shared memory
//    transposed (keys by rows), where each thread reads its rows' p as
//    float4s for P v.
//  * Tiles skipped: kv tiles wholly above the causal diagonal, wholly
//    outside the window band or past Lk are never visited (kbeg, kend),
//    as JAX's triangle schedule and banded window slicing skip them.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kAttnThreads = 128;  // 8 thread rows x 16 thread columns
constexpr int kAttnBK = 128;       // keys per kv tile
constexpr int kAttnDS = 32;        // q / k features per k slice
constexpr int kAttnPad = 4;        // floats of padding per shared row
constexpr int kAttnStages = 2;
constexpr int kAttnMaxD = 256;     // largest Dq and Dv
constexpr float kAttnNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// kR query rows per thread (8: a 64-row tile; 4: 32 rows), kG groups of 64
// output columns (ceil(Dv / 64))
template <int kR, int kG>
struct AttnTile {
  static constexpr int kBQ = 8 * kR;              // query rows per block
  static constexpr int kVK = kG <= 2 ? 32 : 16;   // keys per v slice
  static constexpr int kVCols = 64 * kG;          // v columns staged
  static constexpr int kKStride = kAttnDS + kAttnPad;
  static constexpr int kVStride = kVCols + kAttnPad;
  static constexpr int kPStride = kBQ + kAttnPad;
  // floats per ring stage: a k slice or a v slice
  static constexpr int kStage = kAttnBK * kKStride > kVK * kVStride
                                    ? kAttnBK * kKStride
                                    : kVK * kVStride;
  static size_t smem(int dqp) {
    return sizeof(float) * ((size_t)kAttnStages * kStage +
                            (size_t)kAttnBK * kPStride +
                            (size_t)kBQ * (dqp + kAttnPad));
  }
};

__device__ __forceinline__ int attn_row(int i, int ty) {
  return 32 * (i >> 2) + 4 * ty + (i & 3);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// over the 16 threads of one row (the lanes of one half warp)
__device__ __forceinline__ float row_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

template <int kR, int kG>
__global__ void __launch_bounds__(kAttnThreads, 2) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Lq, int Lk,
    int H, int Hkv, int Dq, int Dv, float scale, float softcap, int causal,
    int window, int q_offset, int n_qt, int n_bh) {
  using T = AttnTile<kR, kG>;
  constexpr int kBQ = T::kBQ;
  extern __shared__ __align__(16) float smem[];
  const int dqp = (Dq + kAttnDS - 1) / kAttnDS * kAttnDS;
  const int nk = dqp / kAttnDS;             // k slices per kv tile
  const int sq = dqp + kAttnPad;
  float* ring = smem;                       // kAttnStages x kStage
  float* pt = ring + kAttnStages * T::kStage;   // P^T: kAttnBK x kPStride
  float* qs = pt + kAttnBK * T::kPStride;       // kBQ x sq

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // the last query tile first (all heads of it), the first one last
  const int qt = n_qt - 1 - (int)(blockIdx.x / n_bh);
  const int bh = (int)(blockIdx.x % n_bh);
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;
  // the tile's first and last query positions, and the kv range some row
  // of it can see
  const int qlo = q_offset + q0;
  const int qhi = q_offset + min(q0 + kBQ, Lq) - 1;
  int kbeg = 0;
  int kend = Lk;
  if (causal) kend = min(kend, qhi + 1);
  if (window >= 0) kbeg = max(0, qlo - window + 1);
  if (kbeg >= kend) kend = 0;               // no row sees a key
  kbeg = kbeg / kAttnBK * kAttnBK;

  // key j of this kv head at kb + j * ks (k) and vb + j * vs (v)
  const float* kb = k + ((int64_t)b * Lk * Hkv + hk) * Dq;
  const float* vb = v + ((int64_t)b * Lk * Hkv + hk) * Dv;
  const int64_t ks = (int64_t)Hkv * Dq;
  const int64_t vs = (int64_t)Hkv * Dv;
  {
    const float* qb = q + ((int64_t)b * Lq * H + h) * Dq;
    const int chunks = dqp / 4;
    for (int e = tid; e < kBQ * chunks; e += kAttnThreads) {
      const int r = e / chunks;
      const int c = (e - r * chunks) * 4;
      const bool ok = q0 + r < Lq && c < Dq;
      cp_async<16>(qs + r * sq + c,
                   ok ? qb + (int64_t)(q0 + r) * H * Dq + c : q, ok);
    }
  }
  // v slices of the kv tile at k0: up to the last key some row sees
  auto v_slices = [&](int k0) {
    return (min(kend, k0 + kAttnBK) - k0 + T::kVK - 1) / T::kVK;
  };
  // slice s of the kv tile at k0: k features [32 s, 32 s + 32) of its 128
  // keys for s < nk, else v keys [kVK (s - nk), kVK (s - nk + 1))
  auto load_slice = [&](int k0, int s, float* dst) {
    if (s < nk) {
      const int d0 = s * kAttnDS;
      // the copy loops stay rolled: unrolled, their addresses beside the
      // 160 live logits and sums spill
#pragma unroll 1
      for (int e = tid; e < kAttnBK * (kAttnDS / 4); e += kAttnThreads) {
        const int key = e / (kAttnDS / 4);
        const int c = (e - key * (kAttnDS / 4)) * 4;
        const int kp = k0 + key;
        const bool ok = kp < Lk && d0 + c < Dq;
        cp_async<16>(dst + key * T::kKStride + c,
                     ok ? kb + kp * ks + d0 + c : k, ok);
      }
    } else {
      const int v0 = k0 + (s - nk) * T::kVK;
      constexpr int kChunks = T::kVCols / 4;
#pragma unroll 1
      for (int e = tid; e < T::kVK * kChunks; e += kAttnThreads) {
        const int key = e / kChunks;
        const int c = (e - key * kChunks) * 4;
        const int kp = v0 + key;
        const bool ok = kp < Lk && c < Dv;
        cp_async<16>(dst + key * T::kVStride + c,
                     ok ? vb + kp * vs + c : v, ok);
      }
    }
  };
  // the producer's cursor: the next slice to load
  int pk0 = kbeg;
  int ps = 0;
  auto issue = [&](float* dst) {
    if (pk0 >= kend) return;
    load_slice(pk0, ps, dst);
    if (++ps == nk + v_slices(pk0)) {
      ps = 0;
      pk0 += kAttnBK;
    }
  };
  issue(ring);
  cp_async_commit();                        // the q tile and slice 0

  float m[kR], l[kR], acc[kR][kG][4];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kAttnNeg;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }
  // logit -> log2 domain: x c1, or c2 tanh(x c1) with a softcap
  const float c1 = softcap > 0.f ? scale / softcap : scale * kLog2e;
  const float c2 = softcap * kLog2e;

  int cur = 0;                              // the ring stage being read
  for (int k0 = kbeg; k0 < kend; k0 += kAttnBK) {
    const int ns = nk + v_slices(k0);
    float s[kR][8];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int si = 0; si < ns; ++si) {
      cp_async_wait<0>();
      __syncthreads();     // slice si has landed; the other stage is free
      issue(ring + (cur ^ 1) * T::kStage);
      cp_async_commit();
      const float* st = ring + cur * T::kStage;
      cur ^= 1;
      if (si < nk) {
        // S += q[:, 32 si:] k[:, 32 si:]^T
        const float* qd = qs + si * kAttnDS;
#pragma unroll
        for (int d = 0; d < kAttnDS; d += 4) {
          float4 kf[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            kf[j] = *reinterpret_cast<const float4*>(
                st + (tx + 16 * j) * T::kKStride + d);
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(
                qd + attn_row(i, ty) * sq + d);
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = dot4(a, kf[j], s[i][j]);
          }
        }
        if (si == nk - 1) {
          // softmax of the tile; P^T to shared memory (the last readers of
          // the previous tile's P^T passed a barrier since)
          const bool edge = k0 + kAttnBK > Lk ||
                            (causal && k0 + kAttnBK - 1 > qlo) ||
                            (window >= 0 && k0 <= qhi - window);
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            const int qp = qlo + attn_row(i, ty);
            float mx = kAttnNeg;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float x = softcap > 0.f ? c2 * tanhf(s[i][j] * c1)
                                      : s[i][j] * c1;
              if (edge) {
                const int kp = k0 + tx + 16 * j;
                const bool ok = kp < Lk && (!causal || kp <= qp) &&
                                (window < 0 || kp > qp - window);
                if (!ok) x = -INFINITY;
              }
              s[i][j] = x;
              mx = fmaxf(mx, x);
            }
            const float mn = fmaxf(m[i], row_max(mx));
            const float alpha = exp2f(m[i] - mn);
            m[i] = mn;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              s[i][j] = exp2f(s[i][j] - mn);
              sum += s[i][j];
            }
            l[i] = l[i] * alpha + sum;      // this thread's share of the row
#pragma unroll
            for (int g = 0; g < kG; ++g)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i4 = 0; i4 < kR / 4; ++i4)
              *reinterpret_cast<float4*>(pt + (tx + 16 * j) * T::kPStride +
                                         32 * i4 + 4 * ty) =
                  make_float4(s[4 * i4][j], s[4 * i4 + 1][j],
                              s[4 * i4 + 2][j], s[4 * i4 + 3][j]);
        }
      } else {
        // O += P[:, keys of the slice] v[keys of the slice]
        const float* pp = pt + (si - nk) * T::kVK * T::kPStride;
#pragma unroll
        for (int kk = 0; kk < T::kVK; ++kk) {
          float p[kR];
#pragma unroll
          for (int i4 = 0; i4 < kR / 4; ++i4) {
            const float4 pv = *reinterpret_cast<const float4*>(
                pp + kk * T::kPStride + 32 * i4 + 4 * ty);
            p[4 * i4] = pv.x;
            p[4 * i4 + 1] = pv.y;
            p[4 * i4 + 2] = pv.z;
            p[4 * i4 + 3] = pv.w;
          }
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            const float4 w = *reinterpret_cast<const float4*>(
                st + kk * T::kVStride + 64 * g + 4 * tx);
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              acc[i][g][0] = fmaf(p[i], w.x, acc[i][g][0]);
              acc[i][g][1] = fmaf(p[i], w.y, acc[i][g][1]);
              acc[i][g][2] = fmaf(p[i], w.z, acc[i][g][2]);
              acc[i][g][3] = fmaf(p[i], w.w, acc[i][g][3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();                       // the q tile, where no tile ran

#pragma unroll
  for (int i = 0; i < kR; ++i) l[i] = row_sum(l[i]);
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + attn_row(i, ty);
    if (row >= Lq) continue;
    float* dst = o + (((int64_t)b * Lq + row) * H + h) * Dv;
    const float inv = l[i] > 0.f ? 1.0f / l[i] : 0.f;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int col = 64 * g + 4 * tx;
      if (col < Dv)
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(acc[i][g][0] * inv, acc[i][g][1] * inv,
                        acc[i][g][2] * inv, acc[i][g][3] * inv);
    }
  }
}

template <int kR, int kG>
int launch_attention(const float* q, const float* k, const float* v,
                     float* o, int B, int Lq, int Lk, int H, int Hkv, int Dq,
                     int Dv, float scale, float softcap, int causal,
                     int window, int q_offset, cudaStream_t stream) {
  using T = AttnTile<kR, kG>;
  const size_t smem = T::smem((Dq + kAttnDS - 1) / kAttnDS * kAttnDS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<kR, kG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attention_kernel<kR, kG>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Lq + T::kBQ - 1) / T::kBQ;
  // one 1-D grid of n_qt * B * H blocks: it must fit in gridDim.x
  if ((int64_t)n_qt * B * H > INT_MAX) return (int)cudaErrorInvalidValue;
  const int n_bh = B * H;
  flash_attention_kernel<kR, kG>
      <<<(unsigned)n_qt * n_bh, kAttnThreads, smem, stream>>>(
          q, k, v, o, Lq, Lk, H, Hkv, Dq, Dv, scale, softcap, causal, window,
          q_offset, n_qt, n_bh);
  return (int)cudaGetLastError();
}

// 64 query rows per block where Dq and Dv are at most 128, else 32
int dispatch_attention(const float* q, const float* k, const float* v,
                       float* o, int B, int Lq, int Lk, int H, int Hkv,
                       int Dq, int Dv, float scale, float softcap, int causal,
                       int window, int q_offset, cudaStream_t stream) {
  const bool wide = Dq > 128;
  switch ((Dv + 63) / 64) {
    case 1:
      return wide ? launch_attention<4, 1>(q, k, v, o, B, Lq, Lk, H, Hkv, Dq,
                                           Dv, scale, softcap, causal,
                                           window, q_offset, stream)
                  : launch_attention<8, 1>(q, k, v, o, B, Lq, Lk, H, Hkv, Dq,
                                           Dv, scale, softcap, causal,
                                           window, q_offset, stream);
    case 2:
      return wide ? launch_attention<4, 2>(q, k, v, o, B, Lq, Lk, H, Hkv, Dq,
                                           Dv, scale, softcap, causal,
                                           window, q_offset, stream)
                  : launch_attention<8, 2>(q, k, v, o, B, Lq, Lk, H, Hkv, Dq,
                                           Dv, scale, softcap, causal,
                                           window, q_offset, stream);
    case 3:
      return launch_attention<4, 3>(q, k, v, o, B, Lq, Lk, H, Hkv, Dq, Dv,
                                    scale, softcap, causal, window, q_offset,
                                    stream);
    default:
      return launch_attention<4, 4>(q, k, v, o, B, Lq, Lk, H, Hkv, Dq, Dv,
                                    scale, softcap, causal, window, q_offset,
                                    stream);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers of f32 tensors, 16-byte aligned; window < 0
// means none, softcap <= 0 means none
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Lq, int Lk, int H, int Hkv,
                           int Dq, int Dv, float scale, float softcap,
                           int causal, int window, int q_offset,
                           cudaStream_t stream) {
  if (B < 1 || Lq < 1 || Lk < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      Dq < 4 || Dq > kAttnMaxD || Dq % 4 != 0 || Dv < 4 ||
      Dv > kAttnMaxD || Dv % 4 != 0 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  return dispatch_attention(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), B, Lq, Lk, H,
      Hkv, Dq, Dv, scale, softcap, causal, window, q_offset, stream);
}

}  // extern "C"
