// Flash attention forward for Hopper, the C entries: O = softmax(Q Kᵀ ·
// scale) V (K1), and the same with the row logsumexp L = m + log l (K2);
// the design rule and the launch counts by design.
//
// K1 replaces the Pallas TPU kernel `_flash_kernel` / `_flash_forward`, K2
// `_flash_fwd_lse_kernel` / `_flash_forward_lse`, both in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py. Same arithmetic:
// online softmax per query row (running max m, normaliser l, accumulator),
// logits never written to device memory, f32 accumulation, the
// probabilities rounded to V's dtype before the P·V product (as the Pallas
// kernel's `p.astype(v.dtype)`), output cast to the input dtype. K2 also
// writes L in f32 as (B·H, Sq); Pallas broadcasts it to 128 lanes, a TPU
// layout choice.
//
// Layout (B·H, S, D), contiguous; f32 or bf16 inputs. K1 and K2 take head
// dims 40, 64, 80, 128 and 160 (the U-Net self-attentions: SD 2.1 / SDXL /
// ADM-256 at 64, SD 1.5 at 40 / 80 / 160, ImageNet128Cond at 128), and
// also 512 (the single-head VAE mid-block; K2 where ring attention shards
// it).
//
// Three designs, all on the tensor cores. bf16 at D = 40, 64, 80, 128 and
// 160 goes to "wgmma" (flash_fwd_tc.cu: TMA loads of 64-column panels,
// wgmma products, bound by the bf16 tensor-core rate); f32 at every head
// dim to "tf32x3" (each f32 product as three TF32 mma.sync products, which
// holds it within 2.5e-5 of the plain version at the path's shapes, a gate
// that one TF32 product misses; chip_smoke.py measures both):
// flash_fwd_tf32.cu at D = 512, flash_fwd_tf32_rows.cu at D = 40, 64, 80,
// 128 and 160; bf16 at D = 512 to "mma_bf16" (flash_fwd_mma_bf16.cu:
// mma.sync m16n8k16, warps that split D, since a wgmma kernel's warpgroup
// cannot hold a 64 × 512 f32 O in registers).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (flash_fwd, flash_fwd_lse below), loaded
// with ctypes.

#include "flash_common.cuh"

#include <atomic>

namespace {

// K1 (lse null) or K2 on the tf32x3 kernel of head dim d.
int tf32x3(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
           int sk, int d, float scale, cudaStream_t s) {
    return d == 512 ? flash::fwd_tf32x3(q, k, v, o, lse, bh, sq, sk, scale, s)
                    : flash::fwd_tf32x3_rows(q, k, v, o, lse, bh, sq, sk, d, scale, s);
}

std::atomic<long long> g_served[6][3];  // by kernel (1-5) and design

}  // namespace

int flash::served(int kernel, int design, int err) {
    if (err == int(cudaSuccess)) g_served[kernel][design].fetch_add(1, std::memory_order_relaxed);
    return err;
}

extern "C" {

long long flash_served(int kernel, int design) {
    if (kernel < 1 || kernel > 5 || design < 0 || design > 2) return -1;
    return g_served[kernel][design].load(std::memory_order_relaxed);
}

// The one design rule (declared in flash_common.cuh): at D = 40, 64, 80,
// 128 and 160 K1–K5 run the wgmma kernels in bf16 and the tf32x3 kernels in
// f32; at D = 512 (the VAE's head) K1 and K2 (K2 as ring attention's
// inner) run tf32x3 in f32 and mma_bf16 in bf16; no kernel takes any other
// call (-1).
int flash_design(int kernel, int d, int is_bf16) {
    if (flash::pair_head_dim(d)) return is_bf16 ? flash::kWgmma : flash::kTf32x3;
    if (d == 512 && kernel <= 2) return is_bf16 ? flash::kMmaBf16 : flash::kTf32x3;
    return -1;
}

// q (bh, sq, d), k/v (bh, sk, d), o (bh, sq, d): contiguous device arrays
// of one dtype (is_bf16 = 0: float32, 1: bfloat16), 16-byte aligned.
// Returns a cudaError_t code: 0 on a launch that was accepted.
int flash_fwd(const void* q, const void* k, const void* v, void* o, int bh,
              int sq, int sk, int d, int is_bf16, float scale, void* stream) {
    if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0)
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (flash_design(1, d, is_bf16)) {
        case flash::kWgmma:
            return flash::served(1, flash::kWgmma,
                                 flash::fwd_wgmma(q, k, v, o, nullptr, bh, sq, sk, d, scale, s));
        case flash::kTf32x3:
            return flash::served(1, flash::kTf32x3,
                                 tf32x3(q, k, v, o, nullptr, bh, sq, sk, d, scale, s));
        case flash::kMmaBf16:
            return flash::served(1, flash::kMmaBf16,
                                 flash::fwd_mma_bf16(q, k, v, o, nullptr, bh, sq, sk, scale, s));
    }
    return int(cudaErrorInvalidValue);
}

// K2: as flash_fwd, plus lse (bh, sq) float32, the row logsumexp of the
// scaled logits. Head dims 40, 64, 80, 128, 160 (flash::pair_head_dim; bf16
// on wgmma, f32 on tf32x3), and 512 (bf16 on mma_bf16, f32 on tf32x3).
int flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int sq, int sk, int d, int is_bf16,
                  float scale, void* stream) {
    if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0)
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* l = static_cast<float*>(lse);
    switch (flash_design(2, d, is_bf16)) {
        case flash::kWgmma:
            return flash::served(2, flash::kWgmma,
                                 flash::fwd_wgmma(q, k, v, o, l, bh, sq, sk, d, scale, s));
        case flash::kTf32x3:
            return flash::served(2, flash::kTf32x3,
                                 tf32x3(q, k, v, o, l, bh, sq, sk, d, scale, s));
        case flash::kMmaBf16:
            return flash::served(2, flash::kMmaBf16,
                                 flash::fwd_mma_bf16(q, k, v, o, l, bh, sq, sk, scale, s));
    }
    return int(cudaErrorInvalidValue);
}

}  // extern "C"
