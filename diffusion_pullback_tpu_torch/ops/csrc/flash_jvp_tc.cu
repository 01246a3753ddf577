// Flash attention tangent (K3) on Hopper's tensor cores, bf16 at head dims
// 40, 64, 80, 128 and 160: the forward-mode JVP of O = softmax(Q Kᵀ ·
// scale) V given the forward's row logsumexp L,
//
//     Ṡ = (Q̇ Kᵀ + Q K̇ᵀ) · scale,   P = exp(S · scale − L) recomputed per tile,
//     Ȯ = Σ_k (P∘Ṡ) V + P V̇ − rowsum(P∘Ṡ) ∘ O.
//
// For bf16 inputs at these head dims (every tangent pass of the SD 2.1,
// SDXL and ADM-256 pullbacks at 64, SD 1.5's at 40 and 80,
// ImageNet128Cond's at 128) this replaces the Pallas TPU kernel
// `_flash_tangent_kernel` / `_flash_tangent` in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py; flash_jvp.cu's
// entry routes those calls here, and f32 ones to "tf32x3"
// (flash_jvp_tf32_rows.cu).
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
// Q (primal) and Q̇ (tangent) once, and streams K, V (primal) and K̇, V̇
// (tangent) through a ring of STAGES stages of four tiles with TMA
// (hopper.cuh's maps in the 128-byte swizzle). A tile is held as P =
// ⌈D/64⌉ column panels of 64 bf16 columns (hopper.cuh's Panels: P = 1, 1,
// 2, 2, 3 at D = 40, 64, 80, 128, 160), one TMA box each, the last one
// D % 64 columns wide where 64 does not divide D: 12 tensor maps per launch
// there, 6 where it does; a tile's boxes count 128·D bytes toward their
// mbarrier. Per key tile the consumers compute, as wgmma with f32
// accumulators:
//   S = Q·Kᵀ, Ṡ/scale = Q̇·Kᵀ + Q·K̇ᵀ   m64n64k16, A and B K-major from
//                                       shared memory over the ⌈D/16⌉ k16
//                                       steps that hold real columns (two
//                                       chains into Ṡ's accumulator);
//   P = 2^(S·scale·log2 e − L·log2 e), P∘Ṡ, and the row sums of the
//   unrounded P∘Ṡ in two registers a thread; P and P∘Ṡ rounded to bf16 and
//   repacked from the accumulators into A fragments (no shared memory);
//   Ȯ += (P∘Ṡ)·V + P·V̇                A from registers, V and V̇ MN-major,
//                                       one m64nNk16 per panel into its
//                                       accumulator block (acc[P][32]), N =
//                                       64 or the last panel's D % 64.
// At D = 40 the third k16 step reads columns 40–47 of the last panel of Q,
// Q̇, K and K̇, which TMA never writes: the block zeroes that panel of all
// its tiles once, at its start (a NaN there would poison S and Ṡ). Keys at
// or past sk (zero-filled rows still give P = exp(−L) ≠ 0) are masked to
// P = P∘Ṡ = 0 on the last tile only, under a template flag. The epilogue
// reduces the row sums over the quad that shares a row and writes Ȯ = acc
// − rowsum ∘ O for columns below D, O read from primal slice bt %
// bh_primal.
//
// Shared memory: the block's two tiles and STAGES × four, 16·P KB + STAGES
// × 32·P KB. Two stages fit at P = 1 and 2 (80 and 160 KB); at P = 3
// (D = 160) two would take 240 KB, above the 227 KB a block may use, so
// D = 160 runs one stage (144 KB). With one stage (SPLIT) the stage's two
// halves are waited for and freed apart, each with its own mbarriers: K
// and K̇ as soon as S and Ṡ are done, so the next key tile's K and K̇ load
// under this tile's softmax and Ȯ products, and V and V̇ once Ȯ's products
// are done. On an H100 that took K3 at (16,4096,160) from 1.22–1.26 to
// 0.75 ms; with two stages it lost, (250,4096,64) 5.03–5.45 against
// 4.78–4.84 ms (PERF.md §6; ops/bwd_tc_variants.py builds both
// alternatives). Registers: a thread holds D/2 f32 accumulators, S and Ṡ
// (32 each) and their bf16 fragments (16 together).
//
// Built with nvcc for sm_90a into the flash library.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kLog2e;
using namespace hopper;

template <int DIM>
constexpr int STAGES = (Panels<DIM>::P < 3) ? 2 : 1;
// whether a stage's halves (K, K̇ and V, V̇) have mbarriers of their own
template <int DIM>
constexpr bool SPLIT = STAGES<DIM> == 1;
constexpr int NT = 128 + 32;  // the consumer warpgroup, the producer warp
// Q and Q̇, STAGES × (K, V, K̇, V̇), the mbarriers, plus 1024 bytes to align
// the tiles as the swizzle requires
template <int DIM>
constexpr int SMEM = Panels<DIM>::TB * (2 + 4 * STAGES<DIM>) + 64 + 1024;

// Shared memory: the block's own tiles (q, dq), the ring (tile t of stage
// s at ring + (4s + t)·TB: K, V, K̇, V̇), the mbarriers: full and empty of
// each stage's K and K̇ (of the whole stage unless SPLIT), then those of V
// and V̇ where SPLIT.
template <int DIM>
struct Smem {
    static constexpr int TB = Panels<DIM>::TB, ST = STAGES<DIM>;
    uint32_t q, dq, ring, bars;
    __device__ explicit Smem(uint8_t* raw) {
        q = (smem_u32(raw) + 1023u) & ~1023u;
        dq = q + TB;
        ring = dq + TB;
        bars = ring + 4 * ST * TB;
    }
    __device__ uint32_t tile(int s, int t) const { return ring + (4 * s + t) * TB; }
    __device__ uint32_t full(int s) const { return bars + 8u * s; }
    __device__ uint32_t empty(int s) const { return bars + 8u * (ST + s); }
    __device__ uint32_t own() const { return bars + 8u * (2 * ST); }
    __device__ uint32_t fullv(int s) const {
        return SPLIT<DIM> ? bars + 8u * (2 * ST + 1 + s) : full(s);
    }
    __device__ uint32_t emptyv(int s) const {
        return SPLIT<DIM> ? bars + 8u * (3 * ST + 1 + s) : empty(s);
    }
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

// tq, tk, tv, tdq, tdk, tdv: boxes of 64 columns; the *_t maps: of the
// last panel's D % 64 (the same maps where 64 divides DIM).
template <int DIM>
__global__ void __launch_bounds__(NT, 1)
flash_tangent_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdq,
                           const __grid_constant__ CUtensorMap tdk,
                           const __grid_constant__ CUtensorMap tdv,
                           const __grid_constant__ CUtensorMap tq_t,
                           const __grid_constant__ CUtensorMap tk_t,
                           const __grid_constant__ CUtensorMap tv_t,
                           const __grid_constant__ CUtensorMap tdq_t,
                           const __grid_constant__ CUtensorMap tdk_t,
                           const __grid_constant__ CUtensorMap tdv_t,
                           const __nv_bfloat16* __restrict__ o,
                           const float* __restrict__ lse,
                           __nv_bfloat16* __restrict__ dout, int bh_primal, int sq,
                           int sk, float scale) {
    using Pn = Panels<DIM>;
    constexpr int ST = STAGES<DIM>;
    constexpr bool split = SPLIT<DIM>;
    extern __shared__ uint8_t smem_raw[];
    const Smem<DIM> sm(smem_raw);
    const int q0 = blockIdx.x * TILE_ROWS;
    const int bt = blockIdx.y, bp = bt % bh_primal;  // tangent, primal slice
    const int nk = (sk + TILE_ROWS - 1) / TILE_ROWS;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    zero_tail_panels<DIM, NT>(sm.q, 2 + 4 * ST);  // Q·Kᵀ's columns 40–47 at D = 40
    if (threadIdx.x == 0) {
        for (int s = 0; s < ST; ++s) {
            mbar_init(sm.full(s), 1);
            mbar_init(sm.empty(s), 128);
            if (split) {
                mbar_init(sm.fullv(s), 1);
                mbar_init(sm.emptyv(s), 128);
            }
        }
        mbar_init(sm.own(), 1);
        mbar_init_fence();
    }
    __syncthreads();

    if (warp == 4) {  // the producer warp
        if (lane == 0) {
            mbar_expect_tx(sm.own(), 2 * Pn::TX);
            load_tile<DIM>(sm.q, &tq, &tq_t, sm.own(), q0, bp);
            load_tile<DIM>(sm.dq, &tdq, &tdq_t, sm.own(), q0, bt);
            for (int j = 0; j < nk; ++j) {
                const int s = j % ST, k0 = j * TILE_ROWS, freed = ((j / ST) & 1) ^ 1;
                mbar_wait(sm.empty(s), freed);
                mbar_expect_tx(sm.full(s), (split ? 2 : 4) * Pn::TX);
                load_tile<DIM>(sm.tile(s, 0), &tk, &tk_t, sm.full(s), k0, bp);
                load_tile<DIM>(sm.tile(s, 2), &tdk, &tdk_t, sm.full(s), k0, bt);
                if (split) {
                    mbar_wait(sm.emptyv(s), freed);
                    mbar_expect_tx(sm.fullv(s), 2 * Pn::TX);
                }
                load_tile<DIM>(sm.tile(s, 1), &tv, &tv_t, sm.fullv(s), k0, bp);
                load_tile<DIM>(sm.tile(s, 3), &tdv, &tdv_t, sm.fullv(s), k0, bt);
            }
        }
        return;
    }

    // The consumer warpgroup: this thread holds rows r and r + 8 of the
    // accumulators, columns 8c + 2·qd + {0, 1} of each panel.
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
    Acc<DIM> acc;  // Σ (P∘Ṡ)·V + P·V̇ (64 × DIM)
    zero<DIM>(acc);

    mbar_wait(sm.own(), 0);
    for (int j = 0; j < nk; ++j) {
        const int st = j % ST;
        const int k0 = j * TILE_ROWS;
        mbar_wait(sm.full(st), (j / ST) & 1);
        const uint64_t x_k = desc_sw128(sm.tile(st, 0)), x_v = desc_sw128(sm.tile(st, 1));
        const uint64_t x_dk = desc_sw128(sm.tile(st, 2)), x_dv = desc_sw128(sm.tile(st, 3));

        float s[32], t[32];  // S = Q·Kᵀ, Ṡ/scale = Q̇·Kᵀ + Q·K̇ᵀ
        reg_fence(s);
        reg_fence(t);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Pn::KSTEPS; ++kk)
            wgmma_ss_n64(s, x_q + k_step(kk), x_k + k_step(kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < Pn::KSTEPS; ++kk)
            wgmma_ss_n64(t, x_dq + k_step(kk), x_k + k_step(kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < Pn::KSTEPS; ++kk)
            wgmma_ss_n64(t, x_q + k_step(kk), x_dk + k_step(kk), 1);
        wgmma_commit();
        wgmma_wait();
        reg_fence(s);
        reg_fence(t);
        if (split) mbar_arrive(sm.empty(st));  // K and K̇ are free

        if (k0 + TILE_ROWS <= sk)
            tangent_scores<false>(s, t, rs, l2, scale, scale2, 0, qd);
        else
            tangent_scores<true>(s, t, rs, l2, scale, scale2, sk - k0, qd);
        uint32_t pa[4][4], pds[4][4];
        acc_to_a(s, pa);
        acc_to_a(t, pds);

        if (split) mbar_wait(sm.fullv(st), (j / ST) & 1);
        fence_panels<DIM>(acc);  // Ȯ += (P∘Ṡ)·V + P·V̇
        wgmma_fence();
        product_rs<DIM>(acc, pds, x_v);
        product_rs<DIM>(acc, pa, x_dv);
        wgmma_commit();
        wgmma_wait();
        fence_panels<DIM>(acc);
        mbar_arrive(sm.emptyv(st));
    }

    // Ȯ = acc − rowsum(P∘Ṡ) ∘ O, the row sums reduced over the row's quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        const int row = q0 + r + 8 * i;
        if (row >= sq) continue;
        const __nv_bfloat16* orow = o + (size_t(bp) * sq + row) * DIM;
        __nv_bfloat16* drow = dout + (size_t(bt) * sq + row) * DIM;
#pragma unroll
        for (int p = 0; p < Pn::P; ++p)
#pragma unroll
            for (int c = 0; c < D / 8; ++c) {
                if (D * p + 8 * c >= DIM) continue;  // the panel's zero columns
                const int col = D * p + 8 * c + 2 * qd;
                const float2 ov = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(orow + col));
                *reinterpret_cast<uint32_t*>(drow + col) =
                    pack_bf16(acc[p][4 * c + 2 * i] - rs[i] * ov.x,
                              acc[p][4 * c + 2 * i + 1] - rs[i] * ov.y);
            }
    }
}

// Primal Q, K, V over bh_primal heads, tangents Q̇, K̇, V̇ over bh: boxes of
// 64 columns in m[0..6), of the last panel's D % 64 in m[6..12) where 64
// does not divide DIM; then the launch.
template <int DIM>
int launch(const void* q, const void* k, const void* v, const void* dq, const void* dk,
           const void* dv, const void* o, const void* lse, void* dout, int bh,
           int bh_primal, int sq, int sk, float scale, cudaStream_t stream) {
    constexpr int tail = Panels<DIM>::TAIL;
    const void* ptr[6] = {q, k, v, dq, dk, dv};
    const int heads[6] = {bh_primal, bh_primal, bh_primal, bh, bh, bh};
    const int rows[6] = {sq, sk, sk, sq, sk, sk};
    CUtensorMap m[12];
    auto kernel = flash_tangent_wgmma_kernel<DIM>;
    cudaError_t err = cudaSuccess;
    for (int i = 0; i < (tail ? 12 : 6) && err == cudaSuccess; ++i)
        err = head_map(&m[i], ptr[i % 6], heads[i % 6], rows[i % 6], DIM, i < 6 ? D : tail);
    if (err == cudaSuccess) err = flash::allow_smem(kernel, SMEM<DIM>);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sq + TILE_ROWS - 1) / TILE_ROWS, bh);
    constexpr int t = tail ? 6 : 0;  // the tail maps, or the full ones
    kernel<<<grid, NT, SMEM<DIM>, stream>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], m[t], m[t + 1], m[t + 2], m[t + 3], m[t + 4],
        m[t + 5], static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse),
        static_cast<__nv_bfloat16*>(dout), bh_primal, sq, sk, scale);
    return int(cudaGetLastError());
}

}  // namespace

namespace flash {

// K3 on contiguous bf16 q, o (bh_primal, sq, d), k/v (bh_primal, sk, d),
// lse (bh_primal, sq) f32, dq, dout (bh, sq, d), dk/dv (bh, sk, d); 16-byte
// aligned; d = 40, 64, 80, 128 or 160. flash_tangent (flash_jvp.cu) routes
// its bf16 calls here. Returns a cudaError_t code: 0 on a launch that was
// accepted, cudaErrorInvalidValue at any other d.
int tangent_wgmma(const void* q, const void* k, const void* v, const void* dq,
                  const void* dk, const void* dv, const void* o, const void* lse,
                  void* dout, int bh, int bh_primal, int sq, int sk, int d, float scale,
                  cudaStream_t stream) {
    return on_pair_head_dim(d, [&](auto dim) {
        return launch<decltype(dim)::value>(q, k, v, dq, dk, dv, o, lse, dout, bh,
                                             bh_primal, sq, sk, scale, stream);
    });
}

}  // namespace flash
