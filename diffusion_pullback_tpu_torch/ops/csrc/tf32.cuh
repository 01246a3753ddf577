// f32-accurate products on Hopper's TF32 tensor cores ("3xTF32"), shared by
// the 'tf32x3' forward kernels (flash_fwd_tf32.cu at D = 512,
// flash_fwd_tf32_rows.cu at D = 40, 64, 80, 128 and 160).
//
// Each operand x is split into hi = rna(x), x rounded to TF32, and lo = x −
// hi (exact in f32), and a·b is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (the small
// terms first) with f32 accumulation, which keeps about 21 mantissa bits of
// each product where one TF32 product keeps 10. The rounding of hi is done
// in integer arithmetic (two instructions; cvt.rna.tf32.f32 checks for NaN
// and infinity besides, which finite inputs do not need). lo is passed as
// it is, its 13 low bits for the tensor core to drop (it reads the top 19
// bits of a TF32 operand): truncated, lo loses less than a TF32 ulp of
// itself, at most 2⁻²¹·|x| as |lo| ≤ half a TF32 ulp of x. Rounding lo as
// well (CUTLASS's 3xTF32 default) costs two instructions a value and moved
// no error on an H100 (ops/fwd_tf32_variants.py, "lo rounded": the same
// largest errors against the plain version at every path shape, 4–11 %
// slower).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32 {

// Finite x rounded to TF32, to nearest with ties away from zero (as
// cvt.rna.tf32.f32): half a TF32 ulp added to the magnitude, the 13 low
// mantissa bits cleared.
__device__ __forceinline__ uint32_t rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// d (16 × 8) += a (16 × 8) · b (8 × 8), TF32 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One operand fragment as TF32 hi and lo
template <int N>
struct Frag {
    uint32_t hi[N], lo[N];
    __device__ __forceinline__ void set(int i, float x) {
        hi[i] = rna(x);
        lo[i] = __float_as_uint(x - __uint_as_float(hi[i]));
    }
};

// d += a·b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
    mma(d, a.lo, b.hi);
    mma(d, a.hi, b.lo);
    mma(d, a.hi, b.hi);
}

}  // namespace tf32
