// f32-accurate products on Hopper's TF32 tensor cores ("3xTF32"), shared by
// the 'tf32x3' kernels (flash_fwd_tf32.cu, K1/K2 at D = 512;
// flash_fwd_tf32_rows.cu, K1/K2, flash_jvp_tf32_rows.cu, K3, and
// flash_bwd_tf32_rows.cu, K4/K5, at D = 40, 64, 80, 128 and 160), and the
// rows kernels' fragment reads and cp.async loads.
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

// ---- fragments of the backward's and the tangent's rows kernels
// (flash_bwd_tf32_rows.cu, flash_jvp_tf32_rows.cu): f32 tiles in shared
// memory at a row stride ≡ 4 mod 8, where these reads are free of bank
// conflicts

// A fragment (16 rows × k8) of a row-major tile X (row stride ld), split:
// rows g and g + 8, columns t and t + 4 of k8 step ks
__device__ __forceinline__ Frag<4> a_frag(const float* X, int ld, int ks, int g, int t) {
    const float* p = X + g * ld + 8 * ks + t;
    Frag<4> a;
    a.set(0, p[0]);
    a.set(1, p[8 * ld]);
    a.set(2, p[4]);
    a.set(3, p[8 * ld + 4]);
    return a;
}

// B fragment of X·Yᵀ from Y's rows (K-major), split: row g, columns t and
// t + 4 of k8 step ks
__device__ __forceinline__ Frag<2> b_frag_k(const float* Y, int ld, int ks, int g, int t) {
    const float* p = Y + g * ld + 8 * ks + t;
    Frag<2> b;
    b.set(0, p[0]);
    b.set(1, p[4]);
    return b;
}

// B fragment of A·Y from Y's columns (MN-major), split, for an A fragment
// taken from accumulators (acc_frag): rows 2t and 2t + 1, column 8n + g
__device__ __forceinline__ Frag<2> b_frag_mn(const float* Y, int ld, int n, int g, int t) {
    const float* p = Y + 2 * t * ld + 8 * n + g;
    Frag<2> b;
    b.set(0, p[0]);
    b.set(1, p[ld]);
    return b;
}

// An accumulator tile (rows g and g + 8, columns 2t and 2t + 1) as an A
// fragment: column 2t as the logical k t, 2t + 1 as t + 4
__device__ __forceinline__ Frag<4> acc_frag(const float (&x)[4]) {
    Frag<4> a;
    a.set(0, x[0]);
    a.set(1, x[2]);
    a.set(2, x[1]);
    a.set(3, x[3]);
    return a;
}

// ---- loads of the rows kernels (flash_fwd_tf32_rows.cu, flash_bwd_tf32_rows.cu,
// flash_jvp_tf32_rows.cu)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into shared memory at dst, zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

// 4 bytes, as cp_async16 (rows of L and δ, which need not be 16-byte aligned)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a contiguous (n, D) f32 matrix into shared
// memory at dst (row stride ld floats); rows at or past n are zero-filled.
// Every one of the block's NT threads issues its share of the 16-byte copies.
template <int D, int ROWS, int NT = 128>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int row0,
                                          int n) {
    constexpr int D4 = D / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWS * D4; e += NT) {
        const int r = e / D4, c = e % D4;
        const bool valid = row0 + r < n;
        cp_async16(smem_addr(dst + r * ld + 4 * c),
                   valid ? src + size_t(row0 + r) * D + 4 * c : src, valid);
    }
}

// src[row0, row0 + ROWS) of an f32 vector of n into shared memory at dst,
// zeros at or past n.
template <int ROWS, int NT = 128>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int row0, int n) {
    for (int e = threadIdx.x; e < ROWS; e += NT) {
        const bool valid = row0 + e < n;
        cp_async4(smem_addr(dst + e), valid ? src + row0 + e : src, valid);
    }
}

// The card's SM count, which the rows kernels' block rules read.
inline int sm_count() {
    static const int n = [] {
        int dev = 0, sms = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        return sms > 0 ? sms : 132;
    }();
    return n;
}

}  // namespace tf32
