// Flash attention tangent (K3) on Hopper's tensor cores for f32 at head
// dims 40, 64, 80, 128 and 160: the forward-mode JVP of O = softmax(Q Kᵀ ·
// scale) V given the forward's row logsumexp L,
//
//     Ṡ = (Q̇ Kᵀ + Q K̇ᵀ) · scale,   P = exp(S − L) recomputed per tile,
//     Ȯ = Σ_k (P∘Ṡ) V + P V̇ − rowsum(P∘Ṡ) ∘ O.
//
// For f32 inputs (the pullbacks of the U-Nets run in f32: SD 2.1 and SDXL
// at 64, SD 1.5 at 40 / 80 / 160, ImageNet128Cond at 128) this replaces
// the Pallas TPU kernel `_flash_tangent_kernel` / `_flash_tangent` in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py; flash_jvp.cu's
// entry routes those calls here. Same arithmetic: the casts of P∘Ṡ and P
// to the operands' dtype round nothing in f32; rowsum(P∘Ṡ) and the sums in
// f32.
//
// Batching: the tangents (Q̇, K̇, V̇) and Ȯ may carry r·bh_primal slices;
// tangent slice b reads primal slice b % bh_primal (Q, K, V, O, L), so the
// pullback's probes share one copy of the primal.
//
// What bounds it: 10·BH·Sq·Sk·D operations (five products of the tile
// size: S, Q̇Kᵀ, QK̇ᵀ, (P∘Ṡ)V, PV̇) on a few B·H·S·D elements, so it is
// bound by operations. Each f32 product runs as three TF32 products
// (tf32.cuh), so the least time is the operations at a third of the dense
// TF32 rate (494.7 / 3 ≈ 164.9 TFLOP/s on an H100 SXM).
//
// Design "tf32x3", K4's (flash_bwd_tf32_rows.cu) carried over: mma.sync
// m16n8k8 TF32, each f32 product as three; 4 warps a block; a block owns
// 64·MT query rows of one tangent slice, warp w rows [16·MT·w, 16·MT·(w +
// 1)), and loops over tiles of KW keys (kKeys: 32 at D = 40 and 128, 16 at
// 64, 80 and 160); per warp and tile:
//   S = Q·Kᵀ, Ṡ/scale = Q̇·Kᵀ + Q·K̇ᵀ   D / 8 k8 steps, the last two products
//                              into one accumulator; Q and Q̇ (A) and K and
//                              K̇ (B, K-major: key rows) split into hi and
//                              lo at fragment load;
//   P, P∘Ṡ                     in the accumulator layout, with P =
//                              2^(S·scale·log2 e − L·log2 e), L·log2 e of
//                              rows g and g + 8 in registers, keys at or
//                              past sk masked; rowsum(P∘Ṡ) kept in
//                              registers, summed over a row's four lanes at
//                              the end;
//   Ȯ += (P∘Ṡ)·V + P·V̇         P∘Ṡ and P from the accumulators straight to
//                              the A fragment (lane t's keys 2t and 2t + 1
//                              as the logical k t and t + 4), V and V̇ the
//                              MN-major B operand read at key rows 2t and
//                              2t + 1.
// Each tile's products into Ȯ are summed on the tensor cores from zero, NG
// n8 tiles of Ȯ at a pass (kGroup), and added to Ȯ by an f32 add, as K4's
// dQ (flash_fwd_tf32_rows.cu measured the tensor cores' sums across all
// tiles 1.6e-5 off at 4096 tokens). Ȯ = acc − rowsum(P∘Ṡ)∘O at the store,
// O read from device memory. Q and Q̇ of the block are loaded once; K, K̇,
// V and V̇ stream through a ring of STAGES = 2 stages with cp.async (rows
// past the sequence zero-filled). Every tile has row stride D + 4 floats
// (≡ 4 mod 8), so both fragment reads are free of bank conflicts. The
// block shape by the grid (tangent_tf32x3_rows).
//
// Built with nvcc for sm_90a into the flash library.

#include "flash_common.cuh"
#include "tf32.cuh"

namespace {

using flash::kLog2e;
using tf32::a_frag;
using tf32::acc_frag;
using tf32::b_frag_k;
using tf32::b_frag_mn;
using tf32::cp_async_commit;
using tf32::cp_async_wait;
using tf32::Frag;
using tf32::load_rows;
using tf32::mma3;

constexpr int NW = 4, NT = 32 * NW;  // warps, threads
constexpr int STAGES = 2;            // ring stages

// Keys a tile: 16 where a ring of 32-key stages would cost a block an SM
// (D = 64 and 80) or not fit beside Q and Q̇ (D = 160), else 32 (measured
// on an H100, ops/bwd_tc_variants.py --dtype f32: 16 keys won at D = 64
// and 80, lost at 40 and 128, where they leave the blocks an SM as they
// are and double the tiles)
template <int D>
constexpr int kKeys = D == 40 || D == 128 ? 32 : 16;

// n8 tiles of Ȯ a pass of the products into it, each pass NG independent
// sums per m-tile: the more, the more products in flight and the more
// registers (measured: all of them in one pass won or tied at every D and
// block shape)
template <int D, int MT>
constexpr int kGroup = D / 8;

// Row stride in floats of every tile: ≡ 4 mod 8 (conflict-free fragment
// reads both ways) and a multiple of 4 (16-byte rows for cp.async)
template <int D>
constexpr int kStride = D + 4;

template <int D, int MT>  // Q and Q̇ of 16·NW·MT rows, the K/K̇/V/V̇ ring
constexpr int kSmemFloats = 2 * 16 * NW * MT * kStride<D> + 4 * STAGES * kKeys<D> * kStride<D>;

// K3 at head dim D on blocks of 4 warps of MT m-tiles (16 query rows each),
// every warp over all KW keys of a tile.
template <int D, int MT>
__global__ void __launch_bounds__(NT)
flash_tangent_tf32_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dq,
                               const float* __restrict__ dk, const float* __restrict__ dv,
                               const float* __restrict__ o, const float* __restrict__ lse,
                               float* __restrict__ dout, int bh_primal, int sq, int sk,
                               float scale) {
    constexpr int KW = kKeys<D>, NK = KW / 8;  // keys a tile, n8 tiles of S
    constexpr int WQ = 16 * MT, BQ = WQ * NW;  // query rows of a warp, of the block
    constexpr int KSTEPS = D / 8;              // k8 steps of S and Ṡ, n8 tiles of Ȯ
    constexpr int NG = kGroup<D, MT>;          // n8 tiles of Ȯ a pass
    constexpr int LD = kStride<D>, TILE = KW * LD;

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;              // [BQ][LD]
    float* dQs = Qs + BQ * LD;     // [BQ][LD]
    float* ring = dQs + BQ * LD;   // [STAGES][K, K̇, V, V̇][KW][LD]

    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, column
    const int q0 = blockIdx.x * BQ;
    const size_t bt = blockIdx.y;              // tangent slice
    const size_t bp = blockIdx.y % bh_primal;  // primal slice
    const float* src[4] = {k + bp * sk * D, dk + bt * sk * D, v + bp * sk * D,
                           dv + bt * sk * D};
    const float scale2 = scale * kLog2e;
    const int ntiles = (sk + KW - 1) / KW;

    // copy groups: Q and Q̇, then one per K/K̇/V/V̇ tile, the first STAGES − 1 here
    const auto load_tile = [&](int j) {
        float* stage = ring + (j % STAGES) * 4 * TILE;
#pragma unroll
        for (int i = 0; i < 4; ++i) load_rows<D, KW>(stage + i * TILE, LD, src[i], j * KW, sk);
    };
    load_rows<D, BQ>(Qs, LD, q + bp * sq * D, q0, sq);
    load_rows<D, BQ>(dQs, LD, dq + bt * sq * D, q0, sq);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
        if (j < ntiles) load_tile(j);
        cp_async_commit();
    }

    // L·log2 e and rowsum(P∘Ṡ) (this lane's share) of rows g (h = 0) and
    // g + 8 (h = 1) of each m-tile
    float l2[MT][2], rs[MT][2];
    float acc[MT][KSTEPS][4];  // Ȯ: m-tile, n8 tile, accumulator
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = q0 + WQ * w + 16 * mt + 8 * h + g;
            l2[mt][h] = row < sq ? lse[bp * sq + row] * kLog2e : 0.f;
            rs[mt][h] = 0.f;
        }
#pragma unroll
        for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    }
    const float* Qw = Qs + WQ * w * LD;  // this warp's rows
    const float* dQw = dQs + WQ * w * LD;

    for (int j = 0; j < ntiles; ++j) {
        // into the stage that tile j − 1 freed
        if (j + STAGES - 1 < ntiles) load_tile(j + STAGES - 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();  // tile j (and Q, Q̇)
        __syncthreads();

        const float* Kt = ring + (j % STAGES) * 4 * TILE;
        const float* dKt = Kt + TILE;
        const float* Vt = Kt + 2 * TILE;
        const float* dVt = Kt + 3 * TILE;

        // S = Q·Kᵀ and Ṡ/scale = Q̇·Kᵀ + Q·K̇ᵀ for WQ rows × KW keys; each B
        // fragment serves the warp's MT m-tiles
        float s[MT][NK][4], sd[MT][NK][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NK; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[mt][nt][e] = sd[mt][nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
            Frag<4> aq[MT], adq[MT];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                aq[mt] = a_frag(Qw + 16 * mt * LD, LD, ks, g, t);
                adq[mt] = a_frag(dQw + 16 * mt * LD, LD, ks, g, t);
            }
#pragma unroll
            for (int nt = 0; nt < NK; ++nt) {
                const Frag<2> bk = b_frag_k(Kt + 8 * nt * LD, LD, ks, g, t);
                const Frag<2> bdk = b_frag_k(dKt + 8 * nt * LD, LD, ks, g, t);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    mma3(s[mt][nt], aq[mt], bk);
                    mma3(sd[mt][nt], adq[mt], bk);
                    mma3(sd[mt][nt], aq[mt], bdk);
                }
            }
        }

        // P into s and P∘Ṡ into sd, rows g (e = 0, 1) and g + 8 (e = 2, 3);
        // lane t holds keys 8nt + 2t and 8nt + 2t + 1 of the tile
        const int key0 = j * KW + 2 * t;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NK; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = key0 + 8 * nt + (e & 1) < sk
                                        ? exp2f(fmaf(s[mt][nt][e], scale2, -l2[mt][e / 2]))
                                        : 0.f;
                    const float pds = p * (sd[mt][nt][e] * scale);
                    rs[mt][e / 2] += pds;
                    s[mt][nt][e] = p;
                    sd[mt][nt][e] = pds;
                }

        // Ȯ += (P∘Ṡ)·V + P·V̇, NG n8 tiles of Ȯ at a time: each over the
        // tile's NK k8 steps, summed from zero and added in f32; each B
        // fragment serves the MT m-tiles
#pragma unroll
        for (int n0 = 0; n0 < KSTEPS; n0 += NG) {
            float part[MT][NG][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int i = 0; i < NG; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e) part[mt][i][e] = 0.f;
#pragma unroll
            for (int nt = 0; nt < NK; ++nt) {
                Frag<4> apds[MT], ap[MT];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    apds[mt] = acc_frag(sd[mt][nt]);
                    ap[mt] = acc_frag(s[mt][nt]);
                }
#pragma unroll
                for (int i = 0; i < NG; ++i) {
                    if (n0 + i >= KSTEPS) continue;
                    const Frag<2> bv = b_frag_mn(Vt + 8 * nt * LD, LD, n0 + i, g, t);
                    const Frag<2> bdv = b_frag_mn(dVt + 8 * nt * LD, LD, n0 + i, g, t);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        mma3(part[mt][i], apds[mt], bv);
                        mma3(part[mt][i], ap[mt], bdv);
                    }
                }
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int i = 0; i < NG; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (n0 + i < KSTEPS) acc[mt][n0 + i][e] += part[mt][i][e];
        }
        __syncthreads();  // the stage is free for tile j + STAGES
    }

    // Ȯ = acc − rowsum(P∘Ṡ) ∘ O, the row sum over the row's four lanes
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float r = rs[mt][h];
            r += __shfl_xor_sync(0xffffffffu, r, 1);
            r += __shfl_xor_sync(0xffffffffu, r, 2);
            const int row = q0 + WQ * w + 16 * mt + 8 * h + g;
            if (row >= sq) continue;
            const float* orow = o + (bp * sq + row) * D + 2 * t;
            float* out = dout + (bt * sq + row) * D + 2 * t;
#pragma unroll
            for (int n = 0; n < KSTEPS; ++n) {
                const float2 ov = *reinterpret_cast<const float2*>(orow + 8 * n);
                *reinterpret_cast<float2*>(out + 8 * n) =
                    make_float2(acc[mt][n][2 * h] - r * ov.x, acc[mt][n][2 * h + 1] - r * ov.y);
            }
        }
}

template <int D, int MT>
int launch(const float* q, const float* k, const float* v, const float* dq, const float* dk,
           const float* dv, const float* o, const float* lse, float* dout, int bh,
           int bh_primal, int sq, int sk, float scale, cudaStream_t stream) {
    constexpr int smem = kSmemFloats<D, MT> * int(sizeof(float));
    static_assert(smem <= 232448, "shared memory of one block");
    auto kernel = flash_tangent_tf32_rows_kernel<D, MT>;
    const cudaError_t err = flash::allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    const int rows = 16 * NW * MT;
    const dim3 grid((sq + rows - 1) / rows, bh);
    kernel<<<grid, NT, smem, stream>>>(q, k, v, dq, dk, dv, o, lse, dout, bh_primal, sq, sk,
                                       scale);
    return int(cudaGetLastError());
}

}  // namespace

namespace flash {

// K3 on contiguous f32 q, o (bh_primal, sq, d), k/v (bh_primal, sk, d), lse
// (bh_primal, sq), dq, dout (bh, sq, d), dk/dv (bh, sk, d), 16-byte
// aligned, d one of pair_head_dim's; flash_tangent (flash_jvp.cu) routes its
// f32 calls here. The block's query rows: 128 (at D ≤ 80) where there are at
// least 3 such blocks an SM, else 64. Returns a cudaError_t code: 0 on a
// launch that was accepted.
int tangent_tf32x3_rows(const void* q, const void* k, const void* v, const void* dq,
                        const void* dk, const void* dv, const void* o, const void* lse,
                        void* dout, int bh, int bh_primal, int sq, int sk, int d, float scale,
                        cudaStream_t stream) {
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    const bool rows128 = (long long)((sq + 127) / 128) * bh >= 3 * tf32::sm_count();
    auto* out = static_cast<float*>(dout);
    return on_pair_head_dim(d, [&](auto dim) {
        constexpr int D = decltype(dim)::value;
        if constexpr (D <= 80) {
            if (rows128)
                return launch<D, 2>(f(q), f(k), f(v), f(dq), f(dk), f(dv), f(o), f(lse), out, bh,
                                    bh_primal, sq, sk, scale, stream);
        }
        return launch<D, 1>(f(q), f(k), f(v), f(dq), f(dk), f(dv), f(o), f(lse), out, bh,
                            bh_primal, sq, sk, scale, stream);
    });
}

}  // namespace flash
