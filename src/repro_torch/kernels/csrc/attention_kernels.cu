// The LM stack's f32 attention kernel for Hopper (sm_90a), CUDA C++: the
// exact path. bf16 inputs go to attention_sm90.cu (wgmma + TMA).
//
// Built by kernels/_lib.py together with the other sources into one shared
// library with a plain C interface (each source compiled by its own nvcc,
// all started together, then linked) and loaded with ctypes. The launcher
// takes raw device pointers, sizes and a stream, launches on that stream
// without synchronising, allocates nothing, and returns cudaGetLastError().
// The Python wrapper (kernels/flash_attention.py) checks shapes, dtypes and
// contiguity and allocates the output; kernels/ref.py holds the plain
// PyTorch version.
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
//   fp32: logits, running max m, denominator l and accumulator, as JAX's
//   kernel computes them.
//
// Bound: operations. A causal prefill of L 2048 at H 32, Dh 128 does about
// 34 GFLOP (4 * Dh per visible (q, k) pair), at the fp32 rate (no tensor
// cores: fp32 is exact).
//
// Design (the simple first kernel): one block of 256 threads per (b*h,
// tile of 64 query rows). The query tile is staged in shared memory once; the
// block then walks the kv tiles of 64 keys that some row of the tile can
// see (tiles wholly above the causal diagonal, wholly outside the window
// band or wholly past Lk are skipped, which is what JAX's triangle schedule
// and banded window slicing do), staging each k and v tile in fp32 shared
// memory (64 x 128 x 4 B = 32 KB each, so the block opts in above 48 KB).
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows 4ty..4ty+3: it computes
// the logits of keys tx, tx+16, tx+32, tx+48 with float4 reads of the q and
// k rows (the k rows padded by 4 floats, so eight neighbouring threads hit
// 32 distinct banks), reduces the row max and sum across the 16 threads of
// the row with shuffles, writes p to a padded shared tile, and accumulates
// p.v for columns g*64 + 4tx..4tx+3, g < ceil(Dv / 64), in registers. A
// masked logit is -1e30 and its p is forced to 0 (JAX's where(mask, p, 0)
// guard), so a tile that masks a whole row adds nothing and leaves m alone.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kAttnThreads = 256;
constexpr int kAttnBQ = 64;        // query rows per block
constexpr int kAttnBK = 64;        // keys per kv tile
constexpr int kAttnPad = 4;        // floats of padding per shared row
constexpr int kAttnMaxD = 256;     // largest Dq and Dv
constexpr float kAttnNeg = -1e30f;

__device__ __forceinline__ float widen(const float* p) { return __ldg(p); }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }

// rows [r0, r0 + kAttnBQ) of head hx of batch b of a (B, L, Hx, D) tensor,
// widened to fp32 into dst (row stride D + kAttnPad), zero past L
template <typename T>
__device__ void stage_rows(const T* __restrict__ src, float* dst, int b,
                           int hx, int Hx, int L, int D, int r0) {
  const int stride = D + kAttnPad;
  for (int i = threadIdx.x; i < kAttnBQ * D; i += kAttnThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int l = r0 + r;
    float val = 0.f;
    if (l < L) val = widen(src + (((int64_t)b * L + l) * Hx + hx) * D + c);
    dst[r * stride + c] = val;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float row_max(float v) {
  // over the 16 threads of one row (lanes tx of one half warp)
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

// G = ceil(Dv / 64) column groups of 64 per thread row
template <typename T, int G>
__global__ void __launch_bounds__(kAttnThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Lq, int Lk, int H,
    int Hkv, int Dq, int Dv, float scale, float softcap, int causal,
    int window, int q_offset) {
  static_assert(kAttnBQ == kAttnBK && kAttnThreads == 4 * kAttnBQ,
                "thread layout assumes 16 x 16 threads over 64 x 64 tiles");
  extern __shared__ __align__(16) float smem[];
  const int sq = Dq + kAttnPad;
  const int sv = Dv + kAttnPad;
  const int sp = kAttnBK + kAttnPad;
  float* qs = smem;                    // kAttnBQ x sq
  float* ks = qs + kAttnBQ * sq;       // kAttnBK x sq
  float* vs = ks + kAttnBK * sq;       // kAttnBK x sv
  float* ps = vs + kAttnBK * sv;       // kAttnBQ x sp

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kAttnBQ;
  // the tile's first and last query positions, and the kv range some row
  // of it can see
  const int qlo = q_offset + q0;
  const int qhi = q_offset + min(q0 + kAttnBQ, Lq) - 1;
  int kbeg = 0;
  int kend = Lk;
  if (causal) kend = min(kend, qhi + 1);
  if (window >= 0) kbeg = max(0, qlo - window + 1);
  kbeg = kbeg / kAttnBK * kAttnBK;

  stage_rows(q, qs, b, h, H, Lq, Dq, q0);

  float m[4], l[4], acc[4][G][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kAttnNeg;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += kAttnBK) {
    __syncthreads();       // the previous tile's readers are done
    stage_rows(k, ks, b, hk, Hkv, Lk, Dq, k0);
    stage_rows(v, vs, b, hk, Hkv, Lk, Dv, k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Dq; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * sq + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * sq + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], c[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qlo + 4 * ty + i;
      bool ok[4];
      float mx = kAttnNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < Lk && (!causal || kp <= qp) &&
                (window < 0 || kp > qp - window);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = ok[j] ? x : kAttnNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
        ps[(4 * ty + i) * sp + tx + 16 * j] = s[i][j];
      }
      l[i] = l[i] * alpha[i] + row_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();       // p complete

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha[i];
    const int kn = min(kAttnBK, Lk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(4 * ty + i) * sp + kk];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int col = g * 64 + 4 * tx;
        if (col < Dv) {
          const float4 w =
              *reinterpret_cast<const float4*>(vs + kk * sv + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g][0] = fmaf(p[i], w.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p[i], w.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p[i], w.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p[i], w.w, acc[i][g][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Lq) continue;
    T* dst = o + (((int64_t)b * Lq + row) * H + h) * Dv;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = g * 64 + 4 * tx;
      if (col >= Dv) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        narrow(dst + col + e, l[i] > 0.f ? acc[i][g][e] / l[i] : 0.f);
    }
  }
}

template <typename T, int G>
int launch_attention(const void* q, const void* k, const void* v, void* o,
                     int B, int Lq, int Lk, int H, int Hkv, int Dq, int Dv,
                     float scale, float softcap, int causal, int window,
                     int q_offset, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kAttnBQ + kAttnBK) * (Dq + kAttnPad) +
                       (size_t)kAttnBK * (Dv + kAttnPad) +
                       (size_t)kAttnBQ * (kAttnBK + kAttnPad));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + kAttnBQ - 1) / kAttnBQ, B * H);
  flash_attention_kernel<T, G><<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Lq, Lk, H, Hkv, Dq, Dv,
      scale, softcap, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_attention(const void* q, const void* k, const void* v, void* o,
                       int B, int Lq, int Lk, int H, int Hkv, int Dq, int Dv,
                       float scale, float softcap, int causal, int window,
                       int q_offset, cudaStream_t stream) {
  switch ((Dv + 63) / 64) {
    case 1:
      return launch_attention<T, 1>(q, k, v, o, B, Lq, Lk, H, Hkv, Dq, Dv,
                                    scale, softcap, causal, window, q_offset,
                                    stream);
    case 2:
      return launch_attention<T, 2>(q, k, v, o, B, Lq, Lk, H, Hkv, Dq, Dv,
                                    scale, softcap, causal, window, q_offset,
                                    stream);
    case 3:
      return launch_attention<T, 3>(q, k, v, o, B, Lq, Lk, H, Hkv, Dq, Dv,
                                    scale, softcap, causal, window, q_offset,
                                    stream);
    default:
      return launch_attention<T, 4>(q, k, v, o, B, Lq, Lk, H, Hkv, Dq, Dv,
                                    scale, softcap, causal, window, q_offset,
                                    stream);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers of f32 tensors; window < 0 means none,
// softcap <= 0 means none
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Lq, int Lk, int H, int Hkv,
                           int Dq, int Dv, float scale, float softcap,
                           int causal, int window, int q_offset,
                           cudaStream_t stream) {
  if (B < 1 || Lq < 1 || Lk < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      Dq < 4 || Dq > kAttnMaxD || Dq % 4 != 0 || Dv < 4 ||
      Dv > kAttnMaxD || Dv % 4 != 0 || (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return dispatch_attention<float>(q, k, v, o, B, Lq, Lk, H, Hkv, Dq, Dv,
                                   scale, softcap, causal, window, q_offset,
                                   stream);
}

}  // extern "C"
