// The LM stack's bf16 attention kernel for Hopper (sm_90a): wgmma fed by TMA.
//
// Built by kernels/_lib.py with the other sources (one nvcc per source, all
// started together, then linked into one shared library with a plain C
// interface, loaded with ctypes). The launcher takes raw device pointers,
// sizes and a stream, encodes the three TMA tensor maps on the host,
// launches on that stream without synchronising, allocates nothing, and
// returns a CUDA error code. kernels/flash_attention.py dispatches bf16
// inputs here and f32 inputs to attention_kernels.cu (the exact fp32 path).
//
// ---------------------------------------------------------------------------
// flash_attention, bf16: replaces flash_attention / _flash_kernel
// (src/repro/kernels/flash_attention.py:86,30) on bf16 inputs, with the
// contract of attention_kernels.cu: q (B, Lq, H, Dq), k (B, Lk, Hkv, Dq),
// v (B, Lk, Hkv, Dv) bf16 in the model's layout, o (B, Lq, H, Dv) bf16;
// logits q.k * scale, optionally softcap * tanh(logits / softcap); masks
// from positions (qpos = q_offset + row; causal kpos <= qpos; window kpos >
// qpos - window; kpos < Lk); q head h reads kv head h / (H / Hkv); a row
// that sees no key is 0. Dq and Dv are multiples of 16 up to 256.
//
// Bound: operations (4 * Dh per visible (q, k) pair at the bf16 tensor-core
// rate; the split P below adds 2 * Dh). The recorded prefill (1 x 1332,
// H 32/4, Dh 128) is 14.5 GFLOP.
//
// Design: one block per (b*h, tile of 128 query rows) of 384 threads: two
// consumer warpgroups of 64 rows each and one producer warpgroup. The grid
// walks the query tiles in reverse (blockIdx.y 0 is the last tile), so the
// long causal rows start first and the tail is short.
//  * TMA. Tensor maps over q, k and v as 4-D (D, H or Hkv, L, B) with boxes
//    of 64 columns (one 128-byte swizzled panel) x 64 rows (q) or BN rows
//    (k, v): a tile of Dh 128 is two panels. TMA zero-fills the box past D
//    (Dh 80 or 48 pad in shared memory for free: zero columns add nothing
//    to q.k, the extra v columns are not stored) and past L (masked by
//    position).
//  * The ring. One thread of the producer warpgroup loads the q tile
//    once, then keeps up to 3 (k, v) tiles of BN keys in flight on
//    mbarriers; each consumer warp releases a stage once its warpgroup's
//    wgmmas on it have retired. BN is 128 where Dv <= 128 (S, P and O then
//    take 192 of a consumer's 240 registers), else 64. Shared
//    memory: q 16 KB per 64 of Dq, a stage BN x 128 B per 64 of Dq (k) and
//    of Dv (v): at Dh 128 and BN 128, 32 + 3 x 64 = 224 KB of the 227 KB a
//    block can use. setmaxnreg moves registers from the producer
//    warpgroup (24) to the consumers (240).
//  * The pipeline. Each consumer warpgroup issues q k^T of tile t and
//    P v of tile t - 1 together, waits for the first, and runs tile t's
//    softmax while the tensor cores run the second; the two warpgroups
//    take turns to issue (two named barriers), so that each one's softmax
//    also runs under the other's products.
//  * S = q k^T: wgmma m64nBNk16 bf16 -> fp32, both operands in shared
//    memory, K-major (k's rows are contiguous in Dh), one per 16 of Dq.
//  * Masks and softmax on the accumulator fragment: softcap, then the
//    position masks only on tiles that straddle the causal diagonal, a
//    window edge or Lk (kv tiles no row of the block can see are never
//    loaded). A masked logit is -inf and the running max starts at -1e30,
//    so p is exactly 0 there and a row that has seen nothing keeps alpha 1
//    (JAX's where(mask, p, 0) guard). exp2 with log2(e) folded into the
//    scale; the row max is reduced over the 4 threads that share a row, the
//    row sum once at the end.
//  * O += P v: P feeds wgmma as the A operand from registers, as two bf16
//    terms, hi = bf16(p) and lo = bf16(p - hi), one wgmma each. P in one
//    bf16 (a 2^-9 rounding that JAX's fp32 kernel does not make) takes
//    causal rows that see few keys past the bf16 limit (rtol 1e-2, atol
//    2e-3), in an emulation of this kernel (tests/test_torch_attention.py)
//    and on the card; hi + lo carries p to 2^-17 for a second P v
//    product, half the operations of the first (about a sixth of the
//    kernel's time). v is the B operand from shared memory, MN-major
//    (the transpose bit). The fp32 accumulator is 64 x Dv per warpgroup,
//    in registers.
//  * Epilogue: divide by l (0 where l = 0), write bf16 rows below Lq.
// ---------------------------------------------------------------------------

#include <cuda.h>            // CUtensorMap; the encoder is reached through
                             // cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBM = 128;              // query rows per block
constexpr int kPanelCols = 64;        // bf16 columns per 128-byte panel
constexpr int kPanelBytes = 64 * 128; // 64 rows of one panel
constexpr int kMaxStages = 3;         // (k, v) tiles in flight, at most
constexpr int kSmemLimit = 232448;    // dynamic shared memory per block
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
constexpr int kProducerRegs = 24;     // setmaxnreg: 128 x 24 + 256 x 240
constexpr int kConsumerRegs = 240;    //   fits the 64K registers
constexpr int kMaxD = 256;
constexpr float kNeg = -1e30f;        // the running max before any key
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one box of 64 columns x 64 rows at (column c0, head c1, row c2, batch c3)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; lbo / sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major panel (rows of 128 B, 8-row groups 1024 B apart; LBO unused)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// MN-major panel of v: 64 columns per 128-byte row, 8 keys per 1024 B
// (one wgmma covers one panel's 64 columns, so the panel stride, LBO, is
// not read)
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, kPanelBytes, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// pin registers across the asynchronous wgmma: the compiler must neither
// read an accumulator before the wait nor reuse an operand register
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// d (64 x 64 fp32 fragment) = (scale_d ? d : 0) + a (smem) * b (smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 fp32 fragment) = (scale_d ? d : 0) + a (smem) * b (smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += a (registers, bf16 fragment) * b (smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats (a at the lower column) as a bf16 pair hi and the pair of
// what hi leaves, lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&r);
}

// PV = ceil(Dv / 64) panels of the output accumulator, BN keys per kv
// tile (128 where the registers allow, Dv <= 128; else 64). Accumulator
// fragment of wgmma m64nNk16 (per warpgroup): warp w, lane t holds rows
// 16w + t/4 (+8) and, for each 8-column chunk c, columns 8c + 2(t%4) + {0,1}
// in d[4c + {0,1}] (row t/4) and d[4c + {2,3}] (row t/4 + 8).
template <int PV, int BN>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel_sm90(
    __grid_constant__ const CUtensorMap tmq,
    __grid_constant__ const CUtensorMap tmk,
    __grid_constant__ const CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
    int Lq, int Lk, int H, int Hkv, int Dq, int Dv, float scale,
    float softcap, int causal, int window, int q_offset, int stages) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_k[kMaxStages];
  __shared__ __align__(8) uint64_t bar_v[kMaxStages];
  __shared__ __align__(8) uint64_t bar_free[kMaxStages];

  // 128-byte swizzled panels start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const int pq = (Dq + kPanelCols - 1) / kPanelCols;
  constexpr int kTile = BN * 128;       // bytes of one panel of BN rows
  uint8_t* sq = base;                                  // [2][pq] panels
  uint8_t* sk = sq + 2 * pq * kPanelBytes;             // [stages][pq]
  uint8_t* sv = sk + stages * pq * kTile;              // [stages][PV]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  // the kv range some row of the block can see
  const int qlo = q_offset + q0;
  const int qhi = q_offset + min(q0 + kBM, Lq) - 1;
  int kbeg = 0;
  int kend = Lk;
  if (causal) kend = min(kend, qhi + 1);
  if (window >= 0) kbeg = max(0, qlo - window + 1);
  kbeg = kbeg / BN * BN;
  const int ntiles = kend > kbeg ? (kend - kbeg + BN - 1) / BN : 0;

  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_free[s], kConsumers / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread issues every copy, the rest leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(&bar_q, 2 * pq * kPanelBytes);
      for (int w = 0; w < 2; ++w)
        for (int p = 0; p < pq; ++p)
          tma_load(sq + (w * pq + p) * kPanelBytes, &tmq, &bar_q,
                   p * kPanelCols, h, q0 + 64 * w, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % stages;
        if (t >= stages) mbar_wait(&bar_free[s], (t / stages - 1) & 1);
        const int k0 = kbeg + t * BN;
        mbar_expect_tx(&bar_k[s], pq * kTile);
        for (int p = 0; p < pq; ++p)
          tma_load(sk + (s * pq + p) * kTile, &tmk, &bar_k[s],
                   p * kPanelCols, hk, k0, b);
        mbar_expect_tx(&bar_v[s], PV * kTile);
        for (int p = 0; p < PV; ++p)
          tma_load(sv + (s * PV + p) * kTile, &tmv, &bar_v[s],
                   p * kPanelCols, hk, k0, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);   // row in the block
  const int qpos0 = q_offset + q0 + r0;                // its position
  const int wq_lo = q_offset + q0 + 64 * wg;
  const int wq_hi = wq_lo + 63;
  const float scale_log2 = scale * kLog2e;
  const int ksteps = Dq / 16;

  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float acc[PV][32];
#pragma unroll
  for (int p = 0; p < PV; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
  constexpr int kS = BN / 2;            // S fragment floats per thread
  constexpr int kP = BN / 4;            // P registers (bf16 pairs)
  uint32_t ph[kP], pl[kP];

  mbar_wait(&bar_q, 0);
  const uint32_t q_addr = smem_u32(sq + wg * pq * kPanelBytes);

  // S = q k^T of tile t into sc, issued (not waited for). Each tile's S
  // is a fresh, zeroed array: ptxas serialises the wgmmas (C7515) when
  // the accumulator is left undefined
  auto issue_s = [&](int t, float (&sc)[kS]) {
    const int s = t % stages;
    mbar_wait(&bar_k[s], (t / stages) & 1);
    const uint32_t k_addr = smem_u32(sk + s * pq * kTile);
    wg_fence();
#pragma unroll 1
    for (int kk = 0; kk < ksteps; ++kk) {
      const uint32_t col = (kk & 3) * 32;
      wgmma_ss(sc, kmajor_desc(q_addr + (kk >> 2) * kPanelBytes + col),
               kmajor_desc(k_addr + (kk >> 2) * kTile + col), kk > 0);
    }
    wg_commit();
  };
  // O += P v of tile t (P in ph + pl), issued
  auto issue_pv = [&](int t) {
    const int s = t % stages;
    mbar_wait(&bar_v[s], (t / stages) & 1);
    const uint32_t v_addr = smem_u32(sv + s * PV * kTile);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int p = 0; p < PV; ++p) {
        const uint64_t dv = mnmajor_desc(v_addr + p * kTile + kk * 2048);
        wgmma_rs(acc[p], ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                 ph[4 * kk + 3], dv);
        wgmma_rs(acc[p], pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                 pl[4 * kk + 3], dv);
      }
    wg_commit();
  };
  // softmax of tile t in place in sc: the fp32 p, m and l updated; the
  // rescale of the running max in alpha
  auto softmax = [&](int t, float (&sc)[kS], float (&alpha)[2]) {
    const int k0 = kbeg + t * BN;
    const bool edge = k0 + BN > Lk || (causal && k0 + BN - 1 > wq_lo) ||
                      (window >= 0 && k0 <= wq_hi - window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int e = 0; e < kS; ++e) {
      const int i = (e >> 1) & 1;
      float x;
      if (softcap > 0.f) {
        x = softcap * tanhf(sc[e] * scale / softcap) * kLog2e;
      } else {
        x = sc[e] * scale_log2;
      }
      if (edge) {
        const int kp = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        const int qp = qpos0 + 8 * i;
        const bool ok = kp < Lk && (!causal || kp <= qp) &&
                        (window < 0 || kp > qp - window);
        if (!ok) x = -INFINITY;
      }
      sc[e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      alpha[i] = ex2(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int e = 0; e < kS; ++e) {
      const int i = (e >> 1) & 1;
      sc[e] = ex2(sc[e] - m[i]);
      l[i] += sc[e];
    }
  };
  // rescale O and split P (A fragments of the four k16 steps: step kk's
  // registers are rows r0, r0 + 8 at keys 16kk + 2(lane % 4), then the
  // same rows 8 keys on, i.e. S chunks 2kk and 2kk + 1)
  auto rescale_and_pack = [&](const float (&sc)[kS],
                              const float (&alpha)[2]) {
#pragma unroll
    for (int p = 0; p < PV; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[p][e] *= alpha[(e >> 1) & 1];
#pragma unroll
    for (int e = 0; e < kP; ++e)
      split_bf16(sc[2 * e], sc[2 * e + 1], ph[e], pl[e]);
  };
  // pin what a retired wgmma group wrote or read: S, then O and P
  auto pin_s = [&](float (&sc)[kS]) {
#pragma unroll
    for (int e = 0; e < kS; ++e) pin(sc[e]);
  };
  auto pin_pv = [&]() {
#pragma unroll
    for (int p = 0; p < PV; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) pin(acc[p][e]);
#pragma unroll
    for (int e = 0; e < kP; ++e) {
      pin(ph[e]);
      pin(pl[e]);
    }
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_free[t % stages]);
  };
  // the two consumer warpgroups take turns to issue their products
  // (named barriers 1 and 2, 256 threads: one side syncs, the other
  // arrives), so that one's softmax runs while the other's products do
  auto turn_wait = [&]() {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kConsumers)
                 : "memory");
  };
  auto turn_pass = [&]() {
    asm volatile("bar.arrive %0, %1;" ::"r"(2 - wg), "n"(kConsumers)
                 : "memory");
  };

  // software pipeline: while the tensor cores run P v of tile t - 1, the
  // warpgroup runs the softmax of tile t, whose q k^T was issued first
  // Each warpgroup waits for its turn ntiles + 1 times and passes it as
  // often: warpgroup 1 once before its first turn (warpgroup 0 goes
  // first) and not after its last.
  if (ntiles > 0) {
    float alpha[2];
    if (wg == 1) turn_pass();
    {
      float sc[kS] = {};
      turn_wait();
      issue_s(0, sc);
      turn_pass();
      wg_wait_all();
      pin_s(sc);
      softmax(0, sc, alpha);
      rescale_and_pack(sc, alpha);
    }
    for (int t = 1; t < ntiles; ++t) {
      float sc[kS] = {};                // an undefined accumulator, too,
      turn_wait();                      // makes ptxas serialise
      issue_s(t, sc);
      issue_pv(t - 1);
      turn_pass();
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      pin_s(sc);                       // q k^T of tile t is in sc
      softmax(t, sc, alpha);
      wg_wait_all();
      pin_pv();                        // P v of tile t - 1 is in acc
      release(t - 1);
      rescale_and_pack(sc, alpha);
    }
    turn_wait();
    issue_pv(ntiles - 1);
    if (wg == 0) turn_pass();
    wg_wait_all();
    pin_pv();
    release(ntiles - 1);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int b_lq = b * Lq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= Lq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* dst = o + ((int64_t)(b_lq + row) * H + h) * Dv;
#pragma unroll
    for (int p = 0; p < PV; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = p * kPanelCols + 8 * c + 2 * (lane & 3);
        if (col < Dv)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(acc[p][4 * c + 2 * i] * inv,
                                    acc[p][4 * c + 2 * i + 1] * inv);
      }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, L, Hx, D) bf16 tensor as the 4-D map (D, Hx, L, B), boxes of 64
// columns x `rows` rows, 128-byte swizzle, zero fill out of bounds
bool encode_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
                int L, int Hx, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hx, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)D * 2;
  const cuuint64_t strides[3] = {row, row * Hx, row * Hx * L};
  const cuuint32_t box[4] = {kPanelCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dynamic shared memory: alignment slack, the q panels, the stages
size_t smem_bytes(int pq, int pv, int bn, int stages) {
  return 1024 + (size_t)kPanelBytes * 2 * pq +
         (size_t)stages * (pq + pv) * bn * 128;
}

template <int PV, int BN>
int launch_sm90(EncodeTiled fn, const void* q, const void* k, const void* v,
                void* o, int B, int Lq, int Lk, int H, int Hkv, int Dq,
                int Dv, float scale, float softcap, int causal, int window,
                int q_offset, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  // with no keys no k or v tile is loaded: their maps cover one row of q
  const bool empty = Lk == 0;
  if (!encode_map(fn, &mq, q, B, Lq, H, Dq, 64) ||
      !encode_map(fn, &mk, empty ? q : k, empty ? 1 : B, empty ? 1 : Lk,
                  empty ? 1 : Hkv, Dq, BN) ||
      !encode_map(fn, &mv, empty ? q : v, empty ? 1 : B, empty ? 1 : Lk,
                  empty ? 1 : Hkv, Dv, BN))
    return (int)cudaErrorInvalidValue;
  const int pq = (Dq + kPanelCols - 1) / kPanelCols;
  // as many stages as fit, up to kMaxStages (3 at Dh 128)
  int stages = kMaxStages;
  while (stages > 2 && smem_bytes(pq, PV, BN, stages) > (size_t)kSmemLimit)
    --stages;
  const size_t smem = smem_bytes(pq, PV, BN, stages);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel_sm90<PV, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Lq + kBM - 1) / kBM);
  flash_attention_kernel_sm90<PV, BN><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Lq, Lk, H, Hkv, Dq, Dv,
      scale, softcap, causal, window, q_offset, stages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers of bf16 tensors, 16-byte aligned; Dq and Dv
// multiples of 16 in [16, 256]; window < 0 means none, softcap <= 0 none
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* o, int B, int Lq, int Lk, int H,
                                int Hkv, int Dq, int Dv, float scale,
                                float softcap, int causal, int window,
                                int q_offset, cudaStream_t stream) {
  if (B < 1 || Lq < 1 || Lk < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      Dq < 16 || Dq > kMaxD || Dq % 16 != 0 || Dv < 16 || Dv > kMaxD ||
      Dv % 16 != 0 || (Lq + kBM - 1) / kBM > 65535 ||
      ((uintptr_t)q | (uintptr_t)o) % 16 ||
      (Lk > 0 && ((uintptr_t)k | (uintptr_t)v) % 16))
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int pq = (Dq + kPanelCols - 1) / kPanelCols;
  const int pv = (Dv + kPanelCols - 1) / kPanelCols;
  // 128-key tiles where S (64 floats), P (64 registers) and O fit in the
  // consumers' 240 registers and two stages in shared memory
  const bool wide = pv <= 2 && smem_bytes(pq, pv, 128, 2) <= kSmemLimit;
#define ATTN_ARGS fn, q, k, v, o, B, Lq, Lk, H, Hkv, Dq, Dv, scale, softcap, \
                  causal, window, q_offset, stream
  if (wide)
    return pv == 1 ? launch_sm90<1, 128>(ATTN_ARGS)
                   : launch_sm90<2, 128>(ATTN_ARGS);
  switch (pv) {
    case 1:
      return launch_sm90<1, 64>(ATTN_ARGS);
    case 2:
      return launch_sm90<2, 64>(ATTN_ARGS);
    case 3:
      return launch_sm90<3, 64>(ATTN_ARGS);
    default:
      return launch_sm90<4, 64>(ATTN_ARGS);
  }
#undef ATTN_ARGS
}

}  // extern "C"
