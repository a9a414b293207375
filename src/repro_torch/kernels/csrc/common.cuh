// Device helpers shared by the kernel sources: asynchronous copies into
// shared memory (all but attention_sm90.cu), and the local join's epilogue
// (knn_kernels.cu, quant_kernels.cu).
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// kBytes (4 or 16) from global to shared memory without a register stage;
// with ok false nothing is read and the destination is zero-filled.
// 16-byte copies bypass L1 (.cg); 4-byte ones may only go through it.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  static_assert(kBytes == 4 || kBytes == 16, "cp.async size");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(ok ? kBytes : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The local join's epilogue for one row, entries e0, e0 + step, ... of
// its C x C output: the distance by the norm expansion, (n2[s] + n2[t]) -
// f g with f = 2, or f = 2 (sc[s] sc[t]) where per-slot scales sc are given
// (the int8 join), with __fadd_rn / __fmul_rn so that nothing is
// contracted, clamped at 0; +inf on the diagonal and on pairs the join mask
// refuses (neither slot in the "new" prefix cn, a slot invalid, or one id
// twice). gram holds the cross terms g on its upper triangle (C x C, s <
// t); sid the slots' ids (-1 invalid), n2 their squared norms. The output
// is written in order, so a warp's stores are coalesced. Returns the valid
// unordered pairs among this thread's entries.
__device__ __forceinline__ int join_epilogue(const float* gram,
                                             const int* sid, const float* n2,
                                             float* __restrict__ out, int C,
                                             int cn, int e0, int step,
                                             const float* sc = nullptr) {
  int local = 0;
  for (int e = e0; e < C * C; e += step) {
    const int s = e / C;
    const int t = e - s * C;
    const int lo = min(s, t);
    const int hi = max(s, t);
    const int a = sid[lo];
    const int b = sid[hi];
    float v = INFINITY;
    if (lo != hi && lo < cn && a >= 0 && b >= 0 && a != b) {
      const float f = sc ? __fmul_rn(2.0f, __fmul_rn(sc[lo], sc[hi])) : 2.0f;
      v = fmaxf(__fsub_rn(__fadd_rn(n2[lo], n2[hi]),
                          __fmul_rn(f, gram[lo * C + hi])),
                0.0f);
      local += s < t ? 1 : 0;
    }
    out[e] = v;
  }
  return local;
}

// The epilogue of one piece of a quantized wide join's row (C above 64,
// cut into sets of slots): gram holds the cross terms of slots [i0, i0 + ri) x [j0,
// j0 + rj) (ri x rj, row-major; on a diagonal piece, i0 == j0, only its
// upper triangle s < t). sid_i / n2_i / sc_i describe set I's slots,
// sid_j / n2_j / sc_j set J's (the same arrays on a diagonal piece). The
// distance and the mask are join_epilogue's, with the pair's lower slot
// in set I. A diagonal piece writes its own square of the row's C x C
// output, an off-diagonal one both (I, J) and (J, I), each in order
// within its rows. Returns the valid unordered pairs among this thread's
// entries of the (I, J) orientation.
__device__ __forceinline__ int join_epilogue_piece(
    const float* gram, const int* sid_i, const float* n2_i,
    const float* sc_i, const int* sid_j, const float* n2_j,
    const float* sc_j, float* __restrict__ out, int C, int cn, int i0,
    int ri, int j0, int rj, int e0, int step) {
  const bool diag = i0 == j0;
  // slot i0 + s of set I and j0 + t of set J, i0 + s < j0 + t
  auto pair = [&](int s, int t, bool& ok) {
    const int a = sid_i[s];
    const int b = sid_j[t];
    ok = i0 + s < cn && a >= 0 && b >= 0 && a != b;
    if (!ok) return INFINITY;
    const float f =
        sc_i ? __fmul_rn(2.0f, __fmul_rn(sc_i[s], sc_j[t])) : 2.0f;
    return fmaxf(__fsub_rn(__fadd_rn(n2_i[s], n2_j[t]),
                           __fmul_rn(f, gram[s * rj + t])),
                 0.0f);
  };
  int local = 0;
  for (int e = e0; e < ri * rj; e += step) {
    const int s = e / rj;
    const int t = e - s * rj;
    bool ok = false;
    float v = INFINITY;
    if (!diag || s != t) v = diag && s > t ? pair(t, s, ok) : pair(s, t, ok);
    local += ok && (!diag || s < t) ? 1 : 0;
    out[(int64_t)(i0 + s) * C + j0 + t] = v;
  }
  if (!diag) {
    for (int e = e0; e < ri * rj; e += step) {
      const int t = e / ri;
      const int s = e - t * ri;
      bool ok;
      out[(int64_t)(j0 + t) * C + i0 + s] = pair(s, t, ok);
    }
  }
  return local;
}

}  // namespace
