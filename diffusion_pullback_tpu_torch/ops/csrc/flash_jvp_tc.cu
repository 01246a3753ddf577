// Flash attention tangent (K3) on Hopper's tensor cores, bf16 at head dim
// 64: the forward-mode JVP of O = softmax(Q Kᵀ · scale) V given the
// forward's row logsumexp L,
//
//     Ṡ = (Q̇ Kᵀ + Q K̇ᵀ) · scale,   P = exp(S · scale − L) recomputed per tile,
//     Ȯ = Σ_k (P∘Ṡ) V + P V̇ − rowsum(P∘Ṡ) ∘ O.
//
// For bf16 inputs at D = 64 (every tangent pass of the SD pullback) this
// replaces the Pallas TPU kernel `_flash_tangent_kernel` / `_flash_tangent`
// in diffusion_pullback_tpu/ops/pallas/flash_attention.py; flash_jvp.cu's
// entry routes those calls here, and f32 stays on its CUDA-core design.
// Same rounding as the Pallas kernel and the plain version: P∘Ṡ and P
// rounded to bf16 before their products with V and V̇, rowsum(P∘Ṡ) and the
// accumulator in f32, Ȯ written in O's dtype.
//
// Batching: the tangents (Q̇, K̇, V̇) and Ȯ may carry r·bh_primal slices;
// slice b reads primal slice b % bh_primal (Q, K, V, O, L), so the
// pullback's probes share one copy of the primal.
//
// What bounds it: 10·BH·Sq·Sk·D operations (five products of the tile
// size) on a few B·H·S·D elements, so it is bound by operations, at the
// bf16 tensor-core rate (989 TFLOP/s dense on an H100 SXM).
//
// Design "wgmma", a sibling of K4 (flash_bwd_tc.cu): a block owns 64 query
// rows of tangent slice bt and loops over the key tiles, with one consumer
// warpgroup and one producer warp. The producer's lane 0 loads the block's
// Q (primal map) and Q̇ (tangent map) once, and streams K, V (primal) and
// K̇, V̇ (tangent) through a ring of STAGES stages of four 8 KB tiles with
// TMA (hopper.cuh's maps in the 128-byte swizzle; six maps per launch).
// Per key tile the consumers compute, as wgmma m64n64k16 with f32
// accumulators:
//   S = Q·Kᵀ, Ṡ/scale = Q̇·Kᵀ + Q·K̇ᵀ   A and B K-major from shared memory
//                                       (two chains into Ṡ's accumulator);
//   P = 2^(S·scale·log2 e − L·log2 e), P∘Ṡ, and the row sums of the
//   unrounded P∘Ṡ in two registers a thread; P and P∘Ṡ rounded to bf16 and
//   repacked from the accumulators into A fragments (no shared memory);
//   Ȯ += (P∘Ṡ)·V + P·V̇                A from registers, V and V̇ MN-major.
// Keys at or past sk (zero-filled rows still give P = exp(−L) ≠ 0) are
// masked to P = P∘Ṡ = 0 on the last tile only, under a template flag. The
// epilogue reduces the row sums over the quad that shares a row and writes
// Ȯ = acc − rowsum ∘ O, O read from primal slice bt % bh_primal.
//
// Built with nvcc for sm_90a into the flash library.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kLog2e;
using namespace hopper;

constexpr int STAGES = 2;
constexpr int NT = 128 + 32;  // the consumer warpgroup, the producer warp
// Q and Q̇, STAGES × (K, V, K̇, V̇), the mbarriers, plus 1024 bytes to align
// the tiles as the swizzle requires
constexpr int SMEM = 2 * TILE + 4 * STAGES * TILE + 64 + 1024;

// Shared memory: the block's own tiles (q, dq), the ring (tile t of stage
// s at ring + (4s + t)·TILE: K, V, K̇, V̇), the mbarriers.
struct Smem {
    uint32_t q, dq, ring, bars;
    __device__ explicit Smem(uint8_t* raw) {
        q = (smem_u32(raw) + 1023u) & ~1023u;
        dq = q + TILE;
        ring = dq + TILE;
        bars = ring + 4 * STAGES * TILE;
    }
    __device__ uint32_t tile(int s, int t) const { return ring + (4 * s + t) * TILE; }
    __device__ uint32_t full(int s) const { return bars + 8u * s; }
    __device__ uint32_t empty(int s) const { return bars + 8u * (STAGES + s); }
    __device__ uint32_t own() const { return bars + 8u * (2 * STAGES); }
};

// On S and Ṡ/scale in accumulator layout (element 4c + 2i + j: row r + 8i,
// column 8c + 2q + j), the rows' L·log2 e in l2[i]: S becomes P =
// 2^(S·scale2 − l2), t becomes P∘Ṡ, and rs[i] gains the row sums of P∘Ṡ;
// columns at or past n (MASK) get P = P∘Ṡ = 0.
template <bool MASK>
__device__ __forceinline__ void tangent_scores(float (&s)[32], float (&t)[32],
                                               float (&rs)[2], const float (&l2)[2],
                                               float scale, float scale2, int n, int qd) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[4 * c + e], scale2, -l2[e / 2]));
            if (MASK && 8 * c + 2 * qd + (e & 1) >= n) p = 0.f;
            const float pds = p * (t[4 * c + e] * scale);
            rs[e / 2] += pds;
            s[4 * c + e] = p;
            t[4 * c + e] = pds;
        }
}

__global__ void __launch_bounds__(NT, 1)
flash_tangent_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdq,
                           const __grid_constant__ CUtensorMap tdk,
                           const __grid_constant__ CUtensorMap tdv,
                           const __nv_bfloat16* __restrict__ o,
                           const float* __restrict__ lse,
                           __nv_bfloat16* __restrict__ dout, int bh_primal, int sq,
                           int sk, float scale) {
    extern __shared__ uint8_t smem_raw[];
    const Smem sm(smem_raw);
    const int q0 = blockIdx.x * TILE_ROWS;
    const int bt = blockIdx.y, bp = bt % bh_primal;  // tangent, primal slice
    const int nk = (sk + TILE_ROWS - 1) / TILE_ROWS;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(sm.full(s), 1);
            mbar_init(sm.empty(s), 128);
        }
        mbar_init(sm.own(), 1);
        mbar_init_fence();
    }
    __syncthreads();

    if (warp == 4) {  // the producer warp
        if (lane == 0) {
            mbar_expect_tx(sm.own(), 2 * TILE);
            tma_load(sm.q, &tq, sm.own(), q0, bp);
            tma_load(sm.dq, &tdq, sm.own(), q0, bt);
            for (int j = 0; j < nk; ++j) {
                const int s = j % STAGES, k0 = j * TILE_ROWS;
                mbar_wait(sm.empty(s), ((j / STAGES) & 1) ^ 1);
                mbar_expect_tx(sm.full(s), 4 * TILE);
                tma_load(sm.tile(s, 0), &tk, sm.full(s), k0, bp);
                tma_load(sm.tile(s, 1), &tv, sm.full(s), k0, bp);
                tma_load(sm.tile(s, 2), &tdk, sm.full(s), k0, bt);
                tma_load(sm.tile(s, 3), &tdv, sm.full(s), k0, bt);
            }
        }
        return;
    }

    // The consumer warpgroup: this thread holds rows r and r + 8 of the
    // accumulators, columns 8c + 2·qd + {0, 1}.
    const int qd = lane % 4;
    const int r = 16 * warp + lane / 4;
    const float scale2 = scale * kLog2e;
    float l2[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = q0 + r + 8 * i;
        l2[i] = row < sq ? lse[size_t(bp) * sq + row] * kLog2e : 0.f;
    }
    const uint64_t x_q = desc_sw128(sm.q), x_dq = desc_sw128(sm.dq);
    float acc[32];  // Σ (P∘Ṡ)·V + P·V̇ (64 × D)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;

    mbar_wait(sm.own(), 0);
    for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES;
        const int k0 = j * TILE_ROWS;
        mbar_wait(sm.full(st), (j / STAGES) & 1);
        const uint64_t x_k = desc_sw128(sm.tile(st, 0)), x_v = desc_sw128(sm.tile(st, 1));
        const uint64_t x_dk = desc_sw128(sm.tile(st, 2)), x_dv = desc_sw128(sm.tile(st, 3));

        float s[32], t[32];  // S = Q·Kᵀ, Ṡ/scale = Q̇·Kᵀ + Q·K̇ᵀ
        reg_fence(s);
        reg_fence(t);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, x_q + 2 * kk, x_k + 2 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(t, x_dq + 2 * kk, x_k + 2 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(t, x_q + 2 * kk, x_dk + 2 * kk, 1);
        wgmma_commit();
        wgmma_wait();
        reg_fence(s);
        reg_fence(t);

        if (k0 + TILE_ROWS <= sk)
            tangent_scores<false>(s, t, rs, l2, scale, scale2, 0, qd);
        else
            tangent_scores<true>(s, t, rs, l2, scale, scale2, sk - k0, qd);
        uint32_t pa[4][4], pds[4][4];
        acc_to_a(s, pa);
        acc_to_a(t, pds);

        reg_fence(acc);  // Ȯ += (P∘Ṡ)·V + P·V̇
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_tb(acc, pds[kk], x_v + kk * MN_STEP);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_tb(acc, pa[kk], x_dv + kk * MN_STEP);
        wgmma_commit();
        wgmma_wait();
        reg_fence(acc);
        mbar_arrive(sm.empty(st));
    }

    // Ȯ = acc − rowsum(P∘Ṡ) ∘ O, the row sums reduced over the row's quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        const int row = q0 + r + 8 * i;
        if (row >= sq) continue;
        const __nv_bfloat16* orow = o + (size_t(bp) * sq + row) * D;
        __nv_bfloat16* drow = dout + (size_t(bt) * sq + row) * D;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
            const int col = 8 * c + 2 * qd;
            const float2 ov = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(orow + col));
            *reinterpret_cast<uint32_t*>(drow + col) =
                pack_bf16(acc[4 * c + 2 * i] - rs[i] * ov.x,
                          acc[4 * c + 2 * i + 1] - rs[i] * ov.y);
        }
    }
}

}  // namespace

namespace flash {

// K3 on contiguous bf16 q, o (bh_primal, sq, 64), k/v (bh_primal, sk, 64),
// lse (bh_primal, sq) f32, dq, dout (bh, sq, 64), dk/dv (bh, sk, 64);
// 16-byte aligned. flash_tangent (flash_jvp.cu) routes its bf16 D = 64
// calls here. Returns a cudaError_t code: 0 on a launch that was accepted.
int tangent_wgmma(const void* q, const void* k, const void* v, const void* dq,
                  const void* dk, const void* dv, const void* o, const void* lse,
                  void* dout, int bh, int bh_primal, int sq, int sk, float scale,
                  cudaStream_t stream) {
    CUtensorMap m[6];  // primal Q, K, V over bh_primal; tangents over bh
    cudaError_t err = head_map(&m[0], q, bh_primal, sq);
    if (err == cudaSuccess) err = head_map(&m[1], k, bh_primal, sk);
    if (err == cudaSuccess) err = head_map(&m[2], v, bh_primal, sk);
    if (err == cudaSuccess) err = head_map(&m[3], dq, bh, sq);
    if (err == cudaSuccess) err = head_map(&m[4], dk, bh, sk);
    if (err == cudaSuccess) err = head_map(&m[5], dv, bh, sk);
    if (err == cudaSuccess) err = allow_smem(flash_tangent_wgmma_kernel, SMEM);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sq + TILE_ROWS - 1) / TILE_ROWS, bh);
    flash_tangent_wgmma_kernel<<<grid, NT, SMEM, stream>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], static_cast<const __nv_bfloat16*>(o),
        static_cast<const float*>(lse), static_cast<__nv_bfloat16*>(dout), bh_primal,
        sq, sk, scale);
    return int(cudaGetLastError());
}

}  // namespace flash
