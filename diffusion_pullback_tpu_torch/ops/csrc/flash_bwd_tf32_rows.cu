// Flash attention backward (K4 and K5) on Hopper's tensor cores for f32 at
// head dims 40, 64, 80, 128 and 160, given the forward's row logsumexp L and
// δ = rowsum(dO ∘ O), with P = exp(Q Kᵀ · scale − L) recomputed per tile:
//
//   K4  dQ = scale · Σ_k [P ∘ (dO Vᵀ − δ)] K                    (dq_tf32x3_rows)
//   K5  dV = Σ_q Pᵀ dO,  dK = scale · Σ_q [P ∘ (dO Vᵀ − δ)]ᵀ Q  (dkv_tf32x3_rows)
//
// For f32 inputs at these head dims (the pullbacks of the U-Nets run in
// f32: SD 2.1 and SDXL at 64, SD 1.5 at 40 / 80 / 160, ImageNet128Cond at
// 128) this replaces the Pallas TPU kernels `_flash_dq_kernel` and
// `_flash_dkv_kernel` (the dq and dkv pallas_calls of `_flash_backward`) in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py; flash_bwd.cu's
// entries route those calls here. Same arithmetic: the casts of dS and P to
// the operands' dtype round nothing in f32; sums in f32; the scale applied
// once, at the store.
//
// Batching: the cotangent (dO, δ) and the outputs may carry r·bh_primal
// slices; slice b reads primal slice b % bh_primal (Q, K, V, L), so the
// pullback's probes share one copy of the primal.
//
// What bounds them: K4 does 6·BH·Sq·Sk·D operations (three products of the
// tile size), K5 8·BH·Sq·Sk·D (four), on a few B·H·S·D elements, so both
// are bound by operations. Each f32 product runs as three TF32 products
// (tf32.cuh), so the least time is the operations at a third of the dense
// TF32 rate (494.7 / 3 ≈ 164.9 TFLOP/s on an H100 SXM).
//
// Design "tf32x3", flash_fwd_tf32_rows.cu's carried over: mma.sync m16n8k8
// TF32, each f32 product as three; 4 warps a block; one owner per output
// tile and no atomics.
//   K4  a block owns 64·MT query rows of one cotangent slice, warp w rows
//       [16·MT·w, 16·MT·(w + 1)), and loops over tiles of 32 keys; per
//       warp and tile:
//       S = Q·Kᵀ, dP = dO·Vᵀ   D / 8 k8 steps; Q and dO (A) and K and V
//                              (B, K-major: key rows) split into hi and lo
//                              at fragment load;
//       dS = P ∘ (dP − δ)      in the accumulator layout, with P =
//                              2^(S·scale·log2 e − L·log2 e), L·log2 e and
//                              δ of rows g and g + 8 in registers, keys at
//                              or past sk masked;
//       dQ += dS·K             dS from the accumulators straight to the A
//                              fragment (lane t's keys 2t and 2t + 1 as the
//                              logical k t and t + 4), K the MN-major B
//                              operand read at key rows 2t and 2t + 1.
//   K5  a block owns the key rows of R row groups of one cotangent slice,
//       warp w MT m16 tiles of row group w % R, and loops over tiles of QW·C
//       queries (QW = 32 at D ≤ 80, 16 above: the two accumulators take D
//       floats a lane), split over the C = 4 / R warps of a row group and
//       their partial sums added through shared memory at the end; per
//       warp and tile:
//       Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ  K and V the A operand, Q and dO K-major;
//       Pᵀ, dSᵀ                L and δ per column (query): each tile's
//                              arrive with it in shared memory, lane t
//                              reads those of its columns 2t and 2t + 1;
//       dV += Pᵀ·dO, dK += dSᵀ·Q  Pᵀ, dSᵀ as K4's dS, dO and Q MN-major.
// Each tile's products into dQ, dK and dV are summed on the tensor cores
// from zero, NG n8 tiles of the output at a pass (kDqGroup, kDkvGroup), and
// added to the output by an f32 add: flash_fwd_tf32_rows.cu measured the
// tensor cores' sums across all tiles 1.6e-5 off at 4096 tokens, and 0.7e-6
// so. Q/dO (K4) or K/V (K5) of the block are loaded once; the other two
// (and in K5 the tile's L and δ) stream through a ring of STAGES = 2
// stages with cp.async (rows past the sequence zero-filled). Every tile has
// row stride D + 4 floats (≡ 4 mod 8), which makes both fragment reads
// conflict-free: a K-major or A read (rows g, columns t) and an MN-major
// read (rows 2t, columns g). Block shapes by the grid (dq_tf32x3_rows,
// dkv_tf32x3_rows).
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
using tf32::load_vec;
using tf32::mma3;

constexpr int NW = 4, NT = 32 * NW;  // warps, threads
constexpr int STAGES = 2;            // ring stages
constexpr int KW = 32;               // K4: keys a tile

// K5: queries of a warp a tile
template <int D>
constexpr int kQueries = D > 80 ? 16 : 32;

// n8 tiles of the output a pass of the products into dQ (K4), dK and dV
// (K5), each pass NG independent sums per m-tile and output: the more, the
// more products in flight, and the more registers (measured best on an
// H100, ops/bwd_tc_variants.py: K4 all of them with one m-tile a warp, one
// with two, which spill; K5 all of them at D = 40, else 4)
template <int D, int MT>
constexpr int kDqGroup = MT == 1 ? D / 8 : 1;
template <int D>
constexpr int kDkvGroup = D < 64 ? D / 8 : 4;

// Row stride in floats of every tile: ≡ 4 mod 8 (conflict-free fragment
// reads both ways) and a multiple of 4 (16-byte rows for cp.async)
template <int D>
constexpr int kStride = D + 4;

template <int D, int MT>  // Q and dO of 16·NW·MT rows, the K/V ring
constexpr int kDqSmemFloats = 2 * 16 * NW * MT * kStride<D> + 2 * STAGES * KW * kStride<D>;

template <int D, int R, int MT>  // K and V of 16·R·MT rows, the Q/dO/L/δ ring
constexpr int kDkvSmemFloats = 2 * 16 * R * MT * kStride<D> +
                               2 * STAGES * kQueries<D> * (NW / R) * (kStride<D> + 1);

// K4 at head dim D on blocks of 4 warps of MT m-tiles (16 query rows each),
// every warp over all 32 keys of a tile.
template <int D, int MT>
__global__ void __launch_bounds__(NT)
flash_dq_tf32_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int bh_primal, int sq, int sk,
                          float scale) {
    constexpr int NK = KW / 8;                // n8 tiles of S
    constexpr int WQ = 16 * MT, BQ = WQ * NW;  // query rows of a warp, of the block
    constexpr int KSTEPS = D / 8;             // k8 steps of S and dP, n8 tiles of dQ
    constexpr int NG = kDqGroup<D, MT>;       // n8 tiles of dQ a pass of dS·K
    constexpr int LD = kStride<D>;

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;                  // [BQ][LD]
    float* dOs = Qs + BQ * LD;         // [BQ][LD]
    float* Ks = dOs + BQ * LD;         // [STAGES][KW][LD]
    float* Vs = Ks + STAGES * KW * LD;  // [STAGES][KW][LD]

    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, column
    const int q0 = blockIdx.x * BQ;
    const size_t bt = blockIdx.y;              // cotangent slice
    const size_t bp = blockIdx.y % bh_primal;  // primal slice
    const float* kb = k + bp * sk * D;
    const float* vb = v + bp * sk * D;
    const float scale2 = scale * kLog2e;
    const int ntiles = (sk + KW - 1) / KW;

    // copy groups: Q and dO, then one per K/V tile, the first STAGES − 1 here
    const auto load_tile = [&](int j) {
        const int st = j % STAGES;
        load_rows<D, KW>(Ks + st * KW * LD, LD, kb, j * KW, sk);
        load_rows<D, KW>(Vs + st * KW * LD, LD, vb, j * KW, sk);
    };
    load_rows<D, BQ>(Qs, LD, q + bp * sq * D, q0, sq);
    load_rows<D, BQ>(dOs, LD, dout + bt * sq * D, q0, sq);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
        if (j < ntiles) load_tile(j);
        cp_async_commit();
    }

    // L·log2 e and δ of rows g (h = 0) and g + 8 (h = 1) of each m-tile
    float l2[MT][2], dl[MT][2];
    float acc[MT][KSTEPS][4];  // dQ: m-tile, n8 tile, accumulator
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = q0 + WQ * w + 16 * mt + 8 * h + g;
            l2[mt][h] = row < sq ? lse[bp * sq + row] * kLog2e : 0.f;
            dl[mt][h] = row < sq ? delta[bt * sq + row] : 0.f;
        }
#pragma unroll
        for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    }
    const float* Qw = Qs + WQ * w * LD;  // this warp's rows
    const float* dOw = dOs + WQ * w * LD;

    for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        // into the stage that tile j − 1 freed
        if (j + STAGES - 1 < ntiles) load_tile(j + STAGES - 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();  // tile j (and Q, dO)
        __syncthreads();

        const float* Kt = Ks + st * KW * LD;
        const float* Vt = Vs + st * KW * LD;

        // S = Q·Kᵀ and dP = dO·Vᵀ for WQ rows × KW keys; each B fragment
        // serves the warp's MT m-tiles
        float s[MT][NK][4], dp[MT][NK][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NK; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[mt][nt][e] = dp[mt][nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
            Frag<4> aq[MT], ado[MT];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                aq[mt] = a_frag(Qw + 16 * mt * LD, LD, ks, g, t);
                ado[mt] = a_frag(dOw + 16 * mt * LD, LD, ks, g, t);
            }
#pragma unroll
            for (int nt = 0; nt < NK; ++nt) {
                const Frag<2> bk = b_frag_k(Kt + 8 * nt * LD, LD, ks, g, t);
                const Frag<2> bv = b_frag_k(Vt + 8 * nt * LD, LD, ks, g, t);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    mma3(s[mt][nt], aq[mt], bk);
                    mma3(dp[mt][nt], ado[mt], bv);
                }
            }
        }

        // dS = P ∘ (dP − δ) of rows g (e = 0, 1) and g + 8 (e = 2, 3); lane
        // t holds keys 8nt + 2t and 8nt + 2t + 1 of the tile
        const int key0 = j * KW + 2 * t;
        Frag<4> ds[MT][NK];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NK; ++nt) {
                float x[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    x[e] = key0 + 8 * nt + (e & 1) < sk
                               ? exp2f(fmaf(s[mt][nt][e], scale2, -l2[mt][e / 2])) *
                                     (dp[mt][nt][e] - dl[mt][e / 2])
                               : 0.f;
                ds[mt][nt] = acc_frag(x);
            }

        // dQ += dS·K, NG n8 tiles of dQ at a time: each over the tile's NK
        // k8 steps, summed from zero and added in f32; each B fragment
        // serves the MT m-tiles
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
            for (int nt = 0; nt < NK; ++nt)
#pragma unroll
                for (int i = 0; i < NG; ++i) {
                    if (n0 + i >= KSTEPS) continue;
                    const Frag<2> b = b_frag_mn(Kt + 8 * nt * LD, LD, n0 + i, g, t);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) mma3(part[mt][i], ds[mt][nt], b);
                }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int i = 0; i < NG; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (n0 + i < KSTEPS) acc[mt][n0 + i][e] += part[mt][i][e];
        }
        __syncthreads();  // stage st is free for tile j + STAGES
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = q0 + WQ * w + 16 * mt + 8 * h + g;
            if (row >= sq) continue;
            float* out = dq + (bt * sq + row) * D + 2 * t;
#pragma unroll
            for (int n = 0; n < KSTEPS; ++n)
                *reinterpret_cast<float2*>(out + 8 * n) =
                    make_float2(acc[mt][n][2 * h] * scale, acc[mt][n][2 * h + 1] * scale);
        }
}

// K5 at head dim D on blocks of R row groups of MT m-tiles (16 key rows
// each) a warp, each tile's kQueries<D>·C queries split over C = 4 / R warps.
template <int D, int R, int MT>
__global__ void __launch_bounds__(NT)
flash_dkv_tf32_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv, int bh_primal,
                           int sq, int sk, float scale) {
    constexpr int C = NW / R, QW = kQueries<D>;  // query slices, queries of a warp a tile
    constexpr int NQ = QW / 8, BQ = QW * C;      // n8 tiles of Sᵀ, queries a tile
    constexpr int WK = 16 * MT, BKR = WK * R;    // key rows of a warp, of the block
    constexpr int KSTEPS = D / 8;                // k8 steps of Sᵀ and dPᵀ, n8 tiles of dK, dV
    constexpr int NG = kDkvGroup<D>;             // n8 tiles of each a pass of Pᵀ·dO, dSᵀ·Q
    constexpr int LD = kStride<D>;

    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;                     // [BKR][LD]
    float* Vs = Ks + BKR * LD;            // [BKR][LD]
    float* Qs = Vs + BKR * LD;            // [STAGES][BQ][LD]
    float* dOs = Qs + STAGES * BQ * LD;   // [STAGES][BQ][LD]
    float* Ls = dOs + STAGES * BQ * LD;   // [STAGES][BQ]  L of the tile's queries
    float* Ds = Ls + STAGES * BQ;         // [STAGES][BQ]  δ

    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, column
    const int rg = w % R, kc = w / R;      // this warp's row group and query slice
    const int k0 = blockIdx.x * BKR;
    const size_t bt = blockIdx.y;              // cotangent slice
    const size_t bp = blockIdx.y % bh_primal;  // primal slice
    const float* qb = q + bp * sq * D;
    const float* dob = dout + bt * sq * D;
    const float* lb = lse + bp * sq;
    const float* db = delta + bt * sq;
    const float scale2 = scale * kLog2e;
    const int ntiles = (sq + BQ - 1) / BQ;

    // copy groups: K and V, then one per Q/dO/L/δ tile, the first STAGES − 1 here
    const auto load_tile = [&](int j) {
        const int st = j % STAGES;
        load_rows<D, BQ>(Qs + st * BQ * LD, LD, qb, j * BQ, sq);
        load_rows<D, BQ>(dOs + st * BQ * LD, LD, dob, j * BQ, sq);
        load_vec<BQ>(Ls + st * BQ, lb, j * BQ, sq);
        load_vec<BQ>(Ds + st * BQ, db, j * BQ, sq);
    };
    load_rows<D, BKR>(Ks, LD, k + bp * sk * D, k0, sk);
    load_rows<D, BKR>(Vs, LD, v + bp * sk * D, k0, sk);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
        if (j < ntiles) load_tile(j);
        cp_async_commit();
    }

    float acck[MT][KSTEPS][4], accv[MT][KSTEPS][4];  // dK, dV: m-tile, n8 tile, accumulator
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acck[mt][n][e] = accv[mt][n][e] = 0.f;
    const float* Kw = Ks + WK * rg * LD;
    const float* Vw = Vs + WK * rg * LD;

    for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        if (j + STAGES - 1 < ntiles) load_tile(j + STAGES - 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();  // tile j (and K, V)
        __syncthreads();

        const float* Qt = Qs + (st * BQ + kc * QW) * LD;  // this warp's queries
        const float* dOt = dOs + (st * BQ + kc * QW) * LD;
        const float* Lt = Ls + st * BQ + kc * QW;
        const float* Dt = Ds + st * BQ + kc * QW;

        // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for WK keys × QW queries; each B
        // fragment serves the warp's MT m-tiles
        float s[MT][NQ][4], dp[MT][NQ][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[mt][nt][e] = dp[mt][nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
            Frag<4> ak[MT], av[MT];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                ak[mt] = a_frag(Kw + 16 * mt * LD, LD, ks, g, t);
                av[mt] = a_frag(Vw + 16 * mt * LD, LD, ks, g, t);
            }
#pragma unroll
            for (int nt = 0; nt < NQ; ++nt) {
                const Frag<2> bq = b_frag_k(Qt + 8 * nt * LD, LD, ks, g, t);
                const Frag<2> bdo = b_frag_k(dOt + 8 * nt * LD, LD, ks, g, t);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    mma3(s[mt][nt], ak[mt], bq);
                    mma3(dp[mt][nt], av[mt], bdo);
                }
            }
        }

        // Pᵀ = 2^(Sᵀ·scale·log2 e − L·log2 e) and dSᵀ = Pᵀ ∘ (dPᵀ − δ): lane
        // t's columns are the queries 8nt + 2t (c = 0) and 8nt + 2t + 1 (c =
        // 1) of its slice, queries at or past sq masked
        const int qi0 = j * BQ + kc * QW + 2 * t;
        Frag<4> pf[MT][NQ], dsf[MT][NQ];
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
            float l2[2], dl[2];
            bool in[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                l2[c] = Lt[8 * nt + 2 * t + c] * kLog2e;
                dl[c] = Dt[8 * nt + 2 * t + c];
                in[c] = qi0 + 8 * nt + c < sq;
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                float p[4], x[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    p[e] = in[e & 1] ? exp2f(fmaf(s[mt][nt][e], scale2, -l2[e & 1])) : 0.f;
                    x[e] = p[e] * (dp[mt][nt][e] - dl[e & 1]);
                }
                pf[mt][nt] = acc_frag(p);
                dsf[mt][nt] = acc_frag(x);
            }
        }

        // dV += Pᵀ·dO and dK += dSᵀ·Q, NG n8 tiles of each at a time: each
        // over the slice's NQ k8 steps, summed from zero and added in f32
#pragma unroll
        for (int n0 = 0; n0 < KSTEPS; n0 += NG) {
            float pv[MT][NG][4], pk[MT][NG][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int i = 0; i < NG; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e) pv[mt][i][e] = pk[mt][i][e] = 0.f;
#pragma unroll
            for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
                for (int i = 0; i < NG; ++i) {
                    if (n0 + i >= KSTEPS) continue;
                    const Frag<2> bdo = b_frag_mn(dOt + 8 * nt * LD, LD, n0 + i, g, t);
                    const Frag<2> bq = b_frag_mn(Qt + 8 * nt * LD, LD, n0 + i, g, t);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        mma3(pv[mt][i], pf[mt][nt], bdo);
                        mma3(pk[mt][i], dsf[mt][nt], bq);
                    }
                }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int i = 0; i < NG; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (n0 + i < KSTEPS) {
                            accv[mt][n0 + i][e] += pv[mt][i][e];
                            acck[mt][n0 + i][e] += pk[mt][i][e];
                        }
        }
        __syncthreads();  // stage st is free for tile j + STAGES
    }

    if constexpr (C > 1) {
        // the query slices' partial dK and dV added into slice 0's warp of
        // each row group, through shared memory (idle now): lane-major
        constexpr int PART = MT * KSTEPS * 8 * 32;
        if (kc > 0) {
            float* p = smem + ((kc - 1) * R + rg) * PART + lane;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        p[((mt * KSTEPS + n) * 8 + e) * 32] = acck[mt][n][e];
                        p[((mt * KSTEPS + n) * 8 + 4 + e) * 32] = accv[mt][n][e];
                    }
        }
        __syncthreads();
        if (kc > 0) return;
#pragma unroll
        for (int c = 1; c < C; ++c) {
            const float* p = smem + ((c - 1) * R + rg) * PART + lane;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        acck[mt][n][e] += p[((mt * KSTEPS + n) * 8 + e) * 32];
                        accv[mt][n][e] += p[((mt * KSTEPS + n) * 8 + 4 + e) * 32];
                    }
        }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = k0 + WK * rg + 16 * mt + 8 * h + g;
            if (row >= sk) continue;
            float* krow = dk + (bt * sk + row) * D + 2 * t;
            float* vrow = dv + (bt * sk + row) * D + 2 * t;
#pragma unroll
            for (int n = 0; n < KSTEPS; ++n) {
                *reinterpret_cast<float2*>(krow + 8 * n) =
                    make_float2(acck[mt][n][2 * h] * scale, acck[mt][n][2 * h + 1] * scale);
                *reinterpret_cast<float2*>(vrow + 8 * n) =
                    make_float2(accv[mt][n][2 * h], accv[mt][n][2 * h + 1]);
            }
        }
}

template <int D, int MT>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* lse, const float* delta, float* dq, int bh, int bh_primal, int sq,
              int sk, float scale, cudaStream_t stream) {
    constexpr int smem = kDqSmemFloats<D, MT> * int(sizeof(float));
    static_assert(smem <= 232448, "shared memory of one block");
    auto kernel = flash_dq_tf32_rows_kernel<D, MT>;
    const cudaError_t err = flash::allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    const int rows = 16 * NW * MT;
    const dim3 grid((sq + rows - 1) / rows, bh);
    kernel<<<grid, NT, smem, stream>>>(q, k, v, dout, lse, delta, dq, bh_primal, sq, sk, scale);
    return int(cudaGetLastError());
}

template <int D, int R, int MT>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dk, float* dv, int bh,
               int bh_primal, int sq, int sk, float scale, cudaStream_t stream) {
    constexpr int smem = kDkvSmemFloats<D, R, MT> * int(sizeof(float));
    static_assert(smem <= 232448, "shared memory of one block");
    static_assert((NW / R - 1) * R * MT * D * 32 <= kDkvSmemFloats<D, R, MT>,
                  "the merge fits in shared memory");
    auto kernel = flash_dkv_tf32_rows_kernel<D, R, MT>;
    const cudaError_t err = flash::allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    const int rows = 16 * R * MT;
    const dim3 grid((sk + rows - 1) / rows, bh);
    kernel<<<grid, NT, smem, stream>>>(q, k, v, dout, lse, delta, dk, dv, bh_primal, sq, sk,
                                       scale);
    return int(cudaGetLastError());
}

// Blocks of n rows over s rows of bh slices
long long blocks(int n, int s, int bh) { return (long long)((s + n - 1) / n) * bh; }

}  // namespace

namespace flash {

// K4 and K5 on contiguous f32 q (bh_primal, sq, d), k/v (bh_primal, sk, d),
// lse (bh_primal, sq), dout (bh, sq, d), delta (bh, sq), 16-byte aligned, d
// one of pair_head_dim's; flash_dq and flash_dkv (flash_bwd.cu) route their
// f32 calls here. Return a cudaError_t code: 0 on a launch that was accepted.

// K4, dq (bh, sq, d). The block's query rows: 128 (at D ≤ 80) where there
// are at least 3 such blocks an SM, else 64 (measured on an H100,
// ops/bwd_tc_variants.py; 32-row blocks, each key tile split over two
// warps, lost at every path shape).
int dq_tf32x3_rows(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int bh, int bh_primal, int sq,
                   int sk, int d, float scale, cudaStream_t stream) {
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    const bool rows128 = blocks(128, sq, bh) >= 3 * tf32::sm_count();
    auto* out = static_cast<float*>(dq);
    return on_pair_head_dim(d, [&](auto dim) {
        constexpr int D = decltype(dim)::value;
        if constexpr (D <= 80) {
            if (rows128)
                return launch_dq<D, 2>(f(q), f(k), f(v), f(dout), f(lse), f(delta), out, bh,
                                       bh_primal, sq, sk, scale, stream);
        }
        return launch_dq<D, 1>(f(q), f(k), f(v), f(dout), f(lse), f(delta), out, bh, bh_primal,
                               sq, sk, scale, stream);
    });
}

// K5, dk and dv (bh, sk, d). The block's key rows: 64 where such blocks
// give every SM one, else 32.
int dkv_tf32x3_rows(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int bh,
                    int bh_primal, int sq, int sk, int d, float scale, cudaStream_t stream) {
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    const int rows = blocks(64, sk, bh) >= tf32::sm_count() ? 64 : 32;
    auto* ok = static_cast<float*>(dk);
    auto* ov = static_cast<float*>(dv);
    return on_pair_head_dim(d, [&](auto dim) {
        constexpr int D = decltype(dim)::value;
        return rows == 64 ? launch_dkv<D, 4, 1>(f(q), f(k), f(v), f(dout), f(lse), f(delta), ok,
                                                ov, bh, bh_primal, sq, sk, scale, stream)
                          : launch_dkv<D, 2, 1>(f(q), f(k), f(v), f(dout), f(lse), f(delta), ok,
                                                ov, bh, bh_primal, sq, sk, scale, stream);
    });
}

}  // namespace flash
