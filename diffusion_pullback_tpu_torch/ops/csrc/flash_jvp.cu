// Flash attention tangent (K3) for Hopper: the C entry of the forward-mode
// JVP of O = softmax(Q Kᵀ · scale) V given the forward's row logsumexp L,
//
//     Ṡ = (Q̇ Kᵀ + Q K̇ᵀ) · scale,   P = exp(S − L) recomputed per tile,
//     Ȯ = Σ_k (P∘Ṡ) V + P V̇ − rowsum(P∘Ṡ) ∘ O.
//
// Replaces the Pallas TPU kernel `_flash_tangent_kernel` / `_flash_tangent`
// in diffusion_pullback_tpu/ops/pallas/flash_attention.py. Two designs, both
// on the tensor cores, chosen by flash_design (flash_fwd.cu): bf16 runs
// "wgmma" (flash_jvp_tc.cu), f32 "tf32x3" (flash_jvp_tf32_rows.cu: each f32
// product as three TF32 mma.sync products, which keeps Ȯ within 2.5e-5 of
// max(1, max |plain|), a gate that one TF32 product misses).
//
// Layout (B·H, S, D), contiguous; head dims 40, 64, 80, 128, 160. The tangents
// may carry more slices than the primal: a vmap over probes folds the probe
// axis into B·H of Q̇, K̇, V̇ and Ȯ only, and tangent slice b reads primal
// slice b % bh_primal, so the probes share one copy of Q, K, V, O and L.

#include "flash_common.cuh"

extern "C" {

// q, o (bh_primal, sq, d), k/v (bh_primal, sk, d), lse (bh_primal, sq) f32;
// dq, dout (bh, sq, d), dk/dv (bh, sk, d), bh a multiple of bh_primal.
// Contiguous device arrays of one dtype (is_bf16 = 0: float32, 1: bfloat16)
// apart from lse, 16-byte aligned; head dims 40, 64, 80, 128, 160.
// Returns a cudaError_t code: 0 on a launch that was accepted.
int flash_tangent(const void* q, const void* k, const void* v, const void* dq,
                  const void* dk, const void* dv, const void* o,
                  const void* lse, void* dout, int bh, int bh_primal, int sq,
                  int sk, int d, int is_bf16, float scale, void* stream) {
    if (bh <= 0 || bh > 65535 || bh_primal <= 0 || bh % bh_primal || sq <= 0 ||
        sk <= 0 || !flash::pair_head_dim(d))
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (flash_design(3, d, is_bf16)) {
        case flash::kWgmma:
            return flash::served(3, flash::kWgmma,
                                 flash::tangent_wgmma(q, k, v, dq, dk, dv, o, lse, dout, bh,
                                                      bh_primal, sq, sk, d, scale, s));
        case flash::kTf32x3:
            return flash::served(3, flash::kTf32x3,
                                 flash::tangent_tf32x3_rows(q, k, v, dq, dk, dv, o, lse, dout,
                                                            bh, bh_primal, sq, sk, d, scale, s));
    }
    return int(cudaErrorInvalidValue);
}

}  // extern "C"
