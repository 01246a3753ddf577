// Shared pieces of the flash attention kernels (K1-K5) for Hopper: NEG_INF,
// f32/bf16 loads and stores, the tile shape and its thread mapping, and the
// loader of a (rows × D) tile into shared memory.
//
// The CUDA-core kernels ("simt": K1 in bf16 at D = 512, flash_fwd.cu, and
// K3 in f32, flash_jvp.cu; every other call runs a tensor-core design) keep
// their tiles in shared memory in f32 and compute with f32 FMAs. A thread
// block owns one tile of query rows and loops over tiles of key "columns".
// A group of G consecutive lanes shares TR = 4 rows; each lane holds TC
// columns of every row for the logits and DC of the D output columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace flash {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF
// log2(e): the tensor-core kernels take exponentials in base 2, with the
// softmax scale folded into it
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Io;

template <>
struct Io<float> {
    static __device__ __forceinline__ void load4(const float* p, float* out) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        out[0] = v.x;
        out[1] = v.y;
        out[2] = v.z;
        out[3] = v.w;
    }
    static __device__ __forceinline__ void store4(float* p, const float* in) {
        *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
    }
    static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
    static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                                 float* out) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        __nv_bfloat162 a, b;
        *reinterpret_cast<uint32_t*>(&a) = raw.x;
        *reinterpret_cast<uint32_t*>(&b) = raw.y;
        const float2 fa = __bfloat1622float2(a);
        const float2 fb = __bfloat1622float2(b);
        out[0] = fa.x;
        out[1] = fa.y;
        out[2] = fb.x;
        out[3] = fb.y;
    }
    static __device__ __forceinline__ void store4(__nv_bfloat16* p,
                                                  const float* in) {
        const __nv_bfloat162 a = __floats2bfloat162_rn(in[0], in[1]);
        const __nv_bfloat162 b = __floats2bfloat162_rn(in[2], in[3]);
        uint2 raw;
        raw.x = *reinterpret_cast<const uint32_t*>(&a);
        raw.y = *reinterpret_cast<const uint32_t*>(&b);
        *reinterpret_cast<uint2*>(p) = raw;
    }
    static __device__ __forceinline__ float round(float x) {
        return __bfloat162float(__float2bfloat16(x));
    }
};

// Tile shape. TR rows per thread (4: one float4 of a d-major row tile); G
// lanes per row group; each thread holds TC = BK/G logits of each of its
// rows. The D/4 float4 chunks of an output row are dealt round-robin over
// the G lanes (chunk g·G + c to lane c): DCH chunks, DC = 4·DCH columns per
// lane; where G does not divide D/4 (D = 40 or 80 at G = 8) the last round
// is held by some lanes only (has_chunk).
template <int D_, int BQ_, int BK_, int G_>
struct Tile {
    static constexpr int D = D_, BQ = BQ_, BK = BK_, G = G_, TR = 4;
    static constexpr int NT = (BQ / TR) * G;  // threads per block
    static constexpr int TC = BK / G;
    static constexpr int D4 = D / 4;
    static constexpr int DCH = (D4 + G - 1) / G;
    static constexpr int DC = 4 * DCH;
    static constexpr int VW = (TC % 4 == 0) ? 4 : 1;  // S-column vector width
    static constexpr int QS = BQ + 4;  // row stride (floats) of row-side d-major tiles
    static constexpr int KS = BK + 4;  // row stride of column-side d-major tiles
    static_assert(32 % G == 0, "a row group lies inside one warp");
    static_assert(BK % G == 0 && D % 4 == 0 && BQ % TR == 0, "tiling");
    static_assert(NT % 32 == 0 && NT <= 1024, "whole warps");
};

// Whether lane c of a row group holds output chunk g·G + c.
template <class C>
__device__ __forceinline__ bool has_chunk(int g, int c) {
    return C::D4 % C::G == 0 || g * C::G + c < C::D4;
}

// The CUDA-core tile of the head dims other than 64 and 512, for K3 in f32
// (bf16 runs "wgmma" there, K1, K2, K4 and K5 in f32 "tf32x3"): SD 1.5's 8
// heads of 40 and 80 (160 at 1024 px) and ImageNet128Cond's 4 of 128. 64
// rows × 32 columns, G = 8 (128 threads, 4 rows × 4 logits each), so K3's
// six tiles fit in shared memory at D = 160.
template <int D>
using TileN = Tile<D, 64, 32, 8>;

// The head dims K2–K5 take (K1 also takes 512).
__host__ __device__ constexpr bool pair_head_dim(int d) {
    return d == 40 || d == 64 || d == 80 || d == 128 || d == 160;
}

// f(std::integral_constant<int, D>{}) for a head dim D that runs on TileN;
// cudaErrorInvalidValue for any other.
template <class F>
int on_tile_n(int d, F&& f) {
    switch (d) {
        case 40: return f(std::integral_constant<int, 40>{});
        case 80: return f(std::integral_constant<int, 80>{});
        case 128: return f(std::integral_constant<int, 128>{});
        case 160: return f(std::integral_constant<int, 160>{});
    }
    return int(cudaErrorInvalidValue);
}

// The same over every head dim of pair_head_dim: 64 too.
template <class F>
int on_pair_head_dim(int d, F&& f) {
    if (d == 64) return f(std::integral_constant<int, 64>{});
    return on_tile_n(d, f);
}

// Column of the S tile held in a thread's slot j (lane c of its group):
// vector chunks interleaved over the group so that the lanes of a group
// read consecutive shared-memory words.
template <class C>
__device__ __forceinline__ int s_col(int j, int c) {
    return ((j / C::VW) * C::G + c) * C::VW + (j % C::VW);
}

// Rows [row0, row0 + R) of a contiguous (n, D) matrix into shared memory as
// f32: transposed into t_dst[D][ld] (d-major) when t_dst is set, row-major
// into r_dst[R][D] when r_dst is set. Rows at or past n read as 0.
template <typename T, int R, int D, int NT>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int n, float* t_dst, int ld,
                                          float* r_dst) {
    constexpr int D4 = D / 4;
    for (int e = threadIdx.x; e < R * D4; e += NT) {
        const int row = e / D4, d0 = (e % D4) * 4;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (row0 + row < n) Io<T>::load4(src + size_t(row0 + row) * D + d0, x);
        if (t_dst != nullptr) {
#pragma unroll
            for (int t = 0; t < 4; ++t) t_dst[(d0 + t) * ld + row] = x[t];
        }
        if (r_dst != nullptr)
            *reinterpret_cast<float4*>(r_dst + row * D + d0) =
                make_float4(x[0], x[1], x[2], x[3]);
    }
}

// Sum of x over the G lanes of a row group (every lane gets the sum).
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// Opt the kernel into `smem` bytes of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, int smem) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The tensor-core designs. "wgmma", bf16 at D = 40, 64, 80, 128 and 160:
// K1 / K2 (flash_fwd_tc.cu), K3 (flash_jvp_tc.cu) and K4 / K5
// (flash_bwd_tc.cu). "tf32x3" in f32: K1 and K2 (with lse) at D = 512
// (flash_fwd_tf32.cu) and at D = 40, 64, 80, 128 and 160
// (flash_fwd_tf32_rows.cu), K4 and K5 at those five (flash_bwd_tf32_rows.cu).
int fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
              int bh, int sq, int sk, int d, float scale, cudaStream_t stream);
int dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int bh, int bh_primal,
             int sq, int sk, int d, float scale, cudaStream_t stream);
int dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int bh,
              int bh_primal, int sq, int sk, int d, float scale, cudaStream_t stream);
int tangent_wgmma(const void* q, const void* k, const void* v, const void* dq,
                  const void* dk, const void* dv, const void* o, const void* lse,
                  void* dout, int bh, int bh_primal, int sq, int sk, int d, float scale,
                  cudaStream_t stream);
int fwd_tf32x3(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
               int sq, int sk, float scale, cudaStream_t stream);
int fwd_tf32x3_rows(const void* q, const void* k, const void* v, void* o, float* lse,
                    int bh, int sq, int sk, int d, float scale, cudaStream_t stream);
int dq_tf32x3_rows(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int bh_primal, int sq,
                   int sk, int d, float scale, cudaStream_t stream);
int dkv_tf32x3_rows(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh,
                    int bh_primal, int sq, int sk, int d, float scale, cudaStream_t stream);

// The designs flash_design returns.
enum Design { kSimt = 0, kWgmma = 1, kTf32x3 = 2 };

// Count a launch of kernel K<kernel> (1-5) on ``design`` when ``err`` is
// cudaSuccess (flash_fwd.cu keeps the counts, flash_served reads them) and
// return err: each C entry passes the launch of the branch it took through.
int served(int kernel, int design, int err);

}  // namespace flash

// The design rule (flash_fwd.cu): the flash::Design on which kernel
// K<kernel> (1–5) runs a call at head dim d (is_bf16: 0 float32, 1
// bfloat16): the tensor-core "wgmma" (1) or "tf32x3" (2), or the CUDA-core
// "simt" (0). The C entries dispatch on it, and the bindings ask it which
// design served a launch.
extern "C" int flash_design(int kernel, int d, int is_bf16);

// Launches of kernel K<kernel> (1-5) that the C entries made on design
// ``design`` since the library was loaded (-1 for an unknown pair): which
// kernel code served the calls, as counted where it was launched.
extern "C" long long flash_served(int kernel, int design);
