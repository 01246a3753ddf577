// Flash attention backward for Hopper, the C entries: given the forward's
// row logsumexp L and δ = rowsum(dO ∘ O) (computed by the caller, as the
// Pallas wrapper computes it in XLA), with P = exp(Q Kᵀ · scale − L)
// recomputed per tile:
//
//   K4  dQ = scale · Σ_k [P ∘ (dO Vᵀ − δ)] K                (flash_dq)
//   K5  dV = Σ_q Pᵀ dO,  dK = scale · Σ_q [P ∘ (dO Vᵀ − δ)]ᵀ Q  (flash_dkv)
//
// Replace the Pallas TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel`
// (the two pallas_calls of `_flash_backward`) in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py. Both designs are on
// the tensor cores, chosen by flash_design (flash_common.cuh): bf16 goes to
// "wgmma" (flash_bwd_tc.cu), f32 to "tf32x3" (flash_bwd_tf32_rows.cu), at
// every head dim (40, 64, 80, 128, 160).
//
// Layout (B·H, S, D), contiguous. The cotangent (dO, δ) and the outputs may
// carry more slices than the primal: a vmap over probes folds the probe
// axis into their B·H, and cotangent slice b reads primal slice b %
// bh_primal (Q, K, V, L), so the probes share one copy.

#include "flash_common.cuh"

namespace {

bool bad_shape(int bh, int bh_primal, int sq, int sk, int d) {
    return bh <= 0 || bh > 65535 || bh_primal <= 0 || bh % bh_primal ||
           sq <= 0 || sk <= 0 || !flash::pair_head_dim(d);
}

}  // namespace

extern "C" {

// Both: q (bh_primal, sq, d), k/v (bh_primal, sk, d), lse (bh_primal, sq)
// f32; dout (bh, sq, d), delta (bh, sq) f32, bh a multiple of bh_primal.
// Contiguous device arrays of one dtype (is_bf16 = 0: float32, 1: bfloat16)
// apart from lse and delta, 16-byte aligned; head dims 40, 64, 80, 128,
// 160. Return a cudaError_t code: 0 on a launch that was accepted.

// K4: dq (bh, sq, d).
int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int bh,
             int bh_primal, int sq, int sk, int d, int is_bf16, float scale,
             void* stream) {
    if (bad_shape(bh, bh_primal, sq, sk, d)) return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (flash_design(4, d, is_bf16)) {
        case flash::kWgmma:
            return flash::served(4, flash::kWgmma,
                                 flash::dq_wgmma(q, k, v, dout, lse, delta, dq, bh, bh_primal,
                                                 sq, sk, d, scale, s));
        case flash::kTf32x3:
            return flash::served(4, flash::kTf32x3,
                                 flash::dq_tf32x3_rows(q, k, v, dout, lse, delta, dq, bh,
                                                       bh_primal, sq, sk, d, scale, s));
    }
    return int(cudaErrorInvalidValue);
}

// K5: dk, dv (bh, sk, d).
int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int bh,
              int bh_primal, int sq, int sk, int d, int is_bf16, float scale,
              void* stream) {
    if (bad_shape(bh, bh_primal, sq, sk, d)) return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (flash_design(5, d, is_bf16)) {
        case flash::kWgmma:
            return flash::served(5, flash::kWgmma,
                                 flash::dkv_wgmma(q, k, v, dout, lse, delta, dk, dv, bh,
                                                  bh_primal, sq, sk, d, scale, s));
        case flash::kTf32x3:
            return flash::served(5, flash::kTf32x3,
                                 flash::dkv_tf32x3_rows(q, k, v, dout, lse, delta, dk, dv, bh,
                                                        bh_primal, sq, sk, d, scale, s));
    }
    return int(cudaErrorInvalidValue);
}

}  // extern "C"
