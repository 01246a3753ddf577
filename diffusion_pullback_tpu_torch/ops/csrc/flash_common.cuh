// Shared pieces of the flash attention kernels (K1-K5) for Hopper: NEG_INF,
// the head dims, the designs and the entries of each design's kernels.
// Every design runs on the tensor cores.

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

// The head dims K3–K5 take (K1 and K2 also take 512).
__host__ __device__ constexpr bool pair_head_dim(int d) {
    return d == 40 || d == 64 || d == 80 || d == 128 || d == 160;
}

// f(std::integral_constant<int, D>{}) for a head dim D of pair_head_dim;
// cudaErrorInvalidValue for any other.
template <class F>
int on_pair_head_dim(int d, F&& f) {
    switch (d) {
        case 40: return f(std::integral_constant<int, 40>{});
        case 64: return f(std::integral_constant<int, 64>{});
        case 80: return f(std::integral_constant<int, 80>{});
        case 128: return f(std::integral_constant<int, 128>{});
        case 160: return f(std::integral_constant<int, 160>{});
    }
    return int(cudaErrorInvalidValue);
}

// Opt the kernel into `smem` bytes of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, int smem) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The designs. "wgmma", bf16 at D = 40, 64, 80, 128 and 160: K1 / K2
// (flash_fwd_tc.cu), K3 (flash_jvp_tc.cu) and K4 / K5 (flash_bwd_tc.cu).
// "tf32x3" in f32: K1 and K2 (with lse) at D = 512 (flash_fwd_tf32.cu) and
// at D = 40, 64, 80, 128 and 160 (flash_fwd_tf32_rows.cu), K3 at those five
// (flash_jvp_tf32_rows.cu), K4 and K5 there (flash_bwd_tf32_rows.cu).
// "mma_bf16": K1 and K2 (with lse) in bf16 at D = 512 (flash_fwd_mma_bf16.cu).
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
int tangent_tf32x3_rows(const void* q, const void* k, const void* v, const void* dq,
                        const void* dk, const void* dv, const void* o, const void* lse,
                        void* dout, int bh, int bh_primal, int sq, int sk, int d, float scale,
                        cudaStream_t stream);
int fwd_mma_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                 int sq, int sk, float scale, cudaStream_t stream);

// The designs flash_design returns (-1: no kernel takes the call).
enum Design { kMmaBf16 = 0, kWgmma = 1, kTf32x3 = 2 };

// Count a launch of kernel K<kernel> (1-5) on ``design`` when ``err`` is
// cudaSuccess (flash_fwd.cu keeps the counts, flash_served reads them) and
// return err: each C entry passes the launch of the branch it took through.
int served(int kernel, int design, int err);

}  // namespace flash

// The design rule (flash_fwd.cu): the flash::Design on which kernel
// K<kernel> (1–5) runs a call at head dim d (is_bf16: 0 float32, 1
// bfloat16): "mma_bf16" (0), "wgmma" (1) or "tf32x3" (2), or -1 where no
// kernel takes it. The C entries dispatch on it, and the bindings ask it
// which design served a launch.
extern "C" int flash_design(int kernel, int d, int is_bf16);

// Launches of kernel K<kernel> (1-5) that the C entries made on design
// ``design`` since the library was loaded (-1 for an unknown pair): which
// kernel code served the calls, as counted where it was launched.
extern "C" long long flash_served(int kernel, int design);
