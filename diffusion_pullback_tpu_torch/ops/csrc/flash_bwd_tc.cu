// Flash attention backward on Hopper's tensor cores, bf16 at head dims 40,
// 64, 80, 128 and 160, given the forward's row logsumexp L and
// δ = rowsum(dO ∘ O), with P = exp(Q Kᵀ · scale − L) recomputed per tile:
//
//   K4  dQ = scale · Σ_k [P ∘ (dO Vᵀ − δ)] K
//   K5  dV = Σ_q Pᵀ dO,  dK = scale · Σ_q [P ∘ (dO Vᵀ − δ)]ᵀ Q
//
// For bf16 inputs at these head dims (every pullback call of the SD 2.1,
// SDXL and ADM-256 paths at 64, SD 1.5's at 40 and 80, ImageNet128Cond's at
// 128) this replaces the Pallas TPU kernels `_flash_dq_kernel` and
// `_flash_dkv_kernel` (the dq and dkv pallas_calls of `_flash_backward`) in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py; flash_bwd.cu's
// entries route those calls here, and f32 ones to flash_bwd_tf32_rows.cu
// (wgmma has no f32 operand). Same
// rounding as the Pallas kernels and the plain versions: dS rounded to bf16
// before dS·K (K4), P and dS before Pᵀ·dO and dSᵀ·Q (K5); sums in f32;
// outputs in bf16.
//
// Batching: the cotangent (dO, δ) and the outputs may carry r·bh_primal
// slices; slice b reads primal slice b % bh_primal (Q, K, V, L), so the
// pullback's probes share one copy of the primal.
//
// What bounds them: K4 does 6·BH·Sq·Sk·D operations (three products of the
// tile size), K5 8·BH·Sq·Sk·D (four), on a few B·H·S·D elements, so both are
// bound by operations, at the bf16 tensor-core rate (989 TFLOP/s dense on
// an H100 SXM).
//
// Design "wgmma": one owner per output tile, no atomics. A K4 block owns 64
// query rows of one head and loops over the key tiles; a K5 block owns 64
// key rows and loops over the query tiles. Each block has one consumer
// warpgroup (one wgmma M = 64) and one producer warp. The producer's lane 0
// loads the block's own two tiles once (K4: Q, dO; K5: K, V) and streams
// the other two (K4: K, V; K5: Q, dO) through a ring of STAGES stages with
// TMA (hopper.cuh's 3-D maps in the 128-byte swizzle; Q, K, V mapped over
// the primal's heads and read at head b % bh_primal, dO over the
// cotangent's and read at head b). A tile is held as P = ⌈D/64⌉ column
// panels of 64 bf16 columns (hopper.cuh's Panels: P = 1, 1, 2, 2, 3 at D =
// 40, 64, 80, 128, 160), one TMA box each, the last one D % 64 columns wide
// where 64 does not divide D: 8 tensor maps per launch there, 4 where it
// does; a tile's boxes count 128·D bytes toward their mbarrier. Every
// product is a wgmma with f32 accumulators:
//   K4  S = Q·Kᵀ, dP = dO·Vᵀ    m64n64k16, A and B K-major from shared
//                               memory, over the ⌈D/16⌉ k16 steps that
//                               hold real columns (3, 4, 5, 8, 10);
//       dQ += dS·K              A = dS from registers, K MN-major, one
//                               m64nNk16 per K panel into its accumulator
//                               block (acc[P][32]), N = 64 or the last
//                               panel's D % 64 (40, 16, 32);
//   K5  Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ  as K4's S and dP;
//       dV += Pᵀ·dO, dK += dSᵀ·Q  A = Pᵀ, dSᵀ from registers, dO and Q
//                               MN-major, per panel as K4's dQ.
// At D = 40 the third k16 step reads columns 40–47 of the last panel of
// all four operands, which TMA never writes: the block zeroes that panel
// of its own two tiles and of every stage's two once, at its start.
// Between the products, in registers: P = 2^(S·scale·log2 e − L·log2 e) and
// dS = P ∘ (dP − δ), rounded to bf16 and repacked from the accumulators into
// A fragments as the forward repacks P (no round trip through shared
// memory). K4 holds L and δ of its two rows per thread in registers; K5
// needs them per column (query), so the producer warp writes each query
// tile's 64 of each into the stage beside its TMA tiles with ordinary
// guarded loads (a TMA map over f32 (Sq, B·H) would need Sq·4 bytes to be
// a multiple of 16). Columns past the sequence (keys ≥ sk in K4, queries ≥
// sq in K5: zero-filled operands still give P = exp(−L) ≠ 0) are masked to
// P = dS = 0 on the last tile only, under a template flag.
//
// K5's registers: a thread holds D/2 f32 accumulators each of dK and dV,
// plus Sᵀ and dPᵀ (32 each) and their bf16 fragments (16 together),
// against the 255 that __launch_bounds__(160, 1) allows. Sᵀ and dPᵀ are
// dead once packed, so nvcc fits K5 over whole 64-query tiles in 156, 168,
// 196, 244 and 254 registers at D = 40, 64, 80, 128 and 160 with no spill
// (K4: 110, 124, 130, 156, 176). Splitting a stage into two 32-query
// halves holds fewer registers but ran slower at 128 and 160 on an H100
// (PERF.md §6).
//
// What the panels cost: S and dP (K5: Sᵀ and dPᵀ) run 16·⌈D/16⌉ of D
// columns (48/40 at D = 40, exact at the others), the products into dQ,
// dK and dV exactly D, so K4 does 1.13× and K5 1.10× the bound's
// operations at D = 40 and no more at 64–160. Shared memory: the block's
// two tiles, STAGES × two, K5's L and δ: 49 KB at P = 1, 97 at P = 2, 145
// at P = 3.
//
// Left for later: overlap of the elementwise work with the products (each
// tile waits on its wgmmas), a persistent grid, and tensor maps cached
// across launches (encoded per launch on the host).
//
// Built with nvcc for sm_90a into the flash library.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kLog2e;
using namespace hopper;

constexpr int STAGES = 2;
constexpr int NT = 128 + 32;  // the consumer warpgroup, the producer warp
// K5's L (in base 2) and δ of a stage's query tile
constexpr int COL_BYTES = 2 * TILE_ROWS * 4;
// the block's two tiles, STAGES × two streamed ones, K5's L and δ, the
// mbarriers, plus 1024 bytes to align the tiles as the swizzle requires
template <int DIM>
constexpr int SMEM = Panels<DIM>::TB * (2 + 2 * STAGES) + STAGES * COL_BYTES + 64 + 1024;

// Shared memory of both kernels: the block's own tiles (a, b), the ring
// (c, d per stage), K5's per-stage columns, the mbarriers; each tile is
// Panels<DIM>::TB bytes. The kernels name the wgmma descriptors of these
// tiles x_q, x_k, x_v, x_do.
template <int DIM>
struct Smem {
    static constexpr int TB = Panels<DIM>::TB;
    uint8_t* base;  // 1024-byte aligned
    uint32_t a, b, c, d, cols, bars;
    __device__ explicit Smem(uint8_t* raw)
        : base(raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u)) {
        a = smem_u32(base);
        b = a + TB;
        c = b + TB;                 // stage s: + s·TB
        d = c + STAGES * TB;
        cols = d + STAGES * TB;     // stage s: + s·COL_BYTES
        bars = cols + STAGES * COL_BYTES;
    }
    __device__ uint32_t full(int s) const { return bars + 8u * s; }
    __device__ uint32_t empty(int s) const { return bars + 8u * (STAGES + s); }
    __device__ uint32_t own() const { return bars + 8u * (2 * STAGES); }
    __device__ float* col(int s) const {  // [L·log2 e | δ] of stage s
        return reinterpret_cast<float*>(base + (cols - a) + s * COL_BYTES);
    }
};

// Zeroes the panels D = 40's last k16 step reads (a, b and every stage's c
// and d lie TB apart), then the barrier counts: full gets the producer's
// lane 0 (with the TMA bytes) and, for K5, the other 31 lanes of the
// producer warp; empty the 128 consumers.
template <int DIM>
__device__ __forceinline__ void init_block(const Smem<DIM>& sm, int full_count) {
    zero_tail_panels<DIM, NT>(sm.a, 2 + 2 * STAGES);
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(sm.full(s), full_count);
            mbar_init(sm.empty(s), 128);
        }
        mbar_init(sm.own(), 1);
        mbar_init_fence();
    }
    __syncthreads();
}

// A = X·Yᵀ and B = Z·Wᵀ (64 × 64 each) for the tiles at descriptors x, y,
// z, w, all K-major over the head dim's k16 steps, then wait.
template <int DIM>
__device__ __forceinline__ void two_products(float (&a)[32], float (&b)[32], uint64_t x,
                                             uint64_t y, uint64_t z, uint64_t w) {
    reg_fence(a);
    reg_fence(b);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Panels<DIM>::KSTEPS; ++kk)
        wgmma_ss_n64(a, x + k_step(kk), y + k_step(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < Panels<DIM>::KSTEPS; ++kk)
        wgmma_ss_n64(b, z + k_step(kk), w + k_step(kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    reg_fence(a);
    reg_fence(b);
}

// The bf16 outputs of a 64-row tile in accumulator layout, times mul, rows
// below n and columns below DIM: row r + 8i of out (its first row at out).
template <int DIM>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const Acc<DIM>& acc,
                                           float mul, int r, int qd, int n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        if (r + 8 * i >= n) continue;
        __nv_bfloat16* row = out + size_t(r + 8 * i) * DIM;
#pragma unroll
        for (int p = 0; p < Panels<DIM>::P; ++p)
#pragma unroll
            for (int c = 0; c < D / 8; ++c) {
                if (D * p + 8 * c >= DIM) continue;  // the panel's zero columns
                *reinterpret_cast<uint32_t*>(row + D * p + 8 * c + 2 * qd) = pack_bf16(
                    acc[p][4 * c + 2 * i] * mul, acc[p][4 * c + 2 * i + 1] * mul);
            }
    }
}

// ---- K4: dQ -------------------------------------------------------------------

// On S and dP in accumulator layout (element 4c + 2i + j: row r + 8i,
// column 8c + 2q + j), rows' L·log2 e and δ in l2[i], dl[i]: S becomes
// dS = P ∘ (dP − δ), P = 2^(S·scale2 − l2); columns at or past n (MASK)
// get dS = 0.
template <bool MASK>
__device__ __forceinline__ void dscores_rows(float (&s)[32], const float (&dp)[32],
                                             const float (&l2)[2], const float (&dl)[2],
                                             float scale2, int n, int qd) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[4 * c + e], scale2, -l2[e / 2]));
            if (MASK && 8 * c + 2 * qd + (e & 1) >= n) p = 0.f;
            s[4 * c + e] = p * (dp[4 * c + e] - dl[e / 2]);
        }
}

// tq, tk, tv, tdo: boxes of 64 columns; tq_t, tk_t, tv_t, tdo_t: of the
// last panel's D % 64 (the same maps where 64 divides DIM).
template <int DIM>
__global__ void __launch_bounds__(NT, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tq_t,
                      const __grid_constant__ CUtensorMap tk_t,
                      const __grid_constant__ CUtensorMap tv_t,
                      const __grid_constant__ CUtensorMap tdo_t,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int bh_primal, int sq, int sk,
                      float scale) {
    using Pn = Panels<DIM>;
    extern __shared__ uint8_t smem_raw[];
    const Smem<DIM> sm(smem_raw);  // a = Q, b = dO; ring: c = K, d = V
    const int q0 = blockIdx.x * TILE_ROWS;
    const int bt = blockIdx.y, bp = bt % bh_primal;  // cotangent, primal slice
    const int nk = (sk + TILE_ROWS - 1) / TILE_ROWS;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    init_block(sm, 1);

    if (warp == 4) {  // the producer warp
        if (lane == 0) {
            mbar_expect_tx(sm.own(), 2 * Pn::TX);
            load_tile<DIM>(sm.a, &tq, &tq_t, sm.own(), q0, bp);
            load_tile<DIM>(sm.b, &tdo, &tdo_t, sm.own(), q0, bt);
            for (int j = 0; j < nk; ++j) {
                const int s = j % STAGES;
                mbar_wait(sm.empty(s), ((j / STAGES) & 1) ^ 1);
                mbar_expect_tx(sm.full(s), 2 * Pn::TX);
                load_tile<DIM>(sm.c + s * Pn::TB, &tk, &tk_t, sm.full(s), j * TILE_ROWS, bp);
                load_tile<DIM>(sm.d + s * Pn::TB, &tv, &tv_t, sm.full(s), j * TILE_ROWS, bp);
            }
        }
        return;
    }

    // The consumer warpgroup: this thread holds rows r and r + 8 of the
    // accumulators, columns 8c + 2·qd + {0, 1}.
    const int qd = lane % 4;
    const int r = 16 * warp + lane / 4;
    const float scale2 = scale * kLog2e;
    float l2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = q0 + r + 8 * i;
        l2[i] = row < sq ? lse[size_t(bp) * sq + row] * kLog2e : 0.f;
        dl[i] = row < sq ? delta[size_t(bt) * sq + row] : 0.f;
    }
    const uint64_t x_q = desc_sw128(sm.a), x_do = desc_sw128(sm.b);
    Acc<DIM> acc;  // dQ (64 × DIM)
    zero<DIM>(acc);

    mbar_wait(sm.own(), 0);
    for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES;
        const int k0 = j * TILE_ROWS;
        mbar_wait(sm.full(st), (j / STAGES) & 1);
        const uint64_t x_k = desc_sw128(sm.c + st * Pn::TB);
        const uint64_t x_v = desc_sw128(sm.d + st * Pn::TB);

        float s[32], dp[32];  // S = Q·Kᵀ, dP = dO·Vᵀ
        two_products<DIM>(s, dp, x_q, x_k, x_do, x_v);
        if (k0 + TILE_ROWS <= sk)
            dscores_rows<false>(s, dp, l2, dl, scale2, 0, qd);
        else
            dscores_rows<true>(s, dp, l2, dl, scale2, sk - k0, qd);
        uint32_t ds[4][4];
        acc_to_a(s, ds);

        fence_panels<DIM>(acc);  // dQ += dS·K
        wgmma_fence();
        product_rs<DIM>(acc, ds, x_k);
        wgmma_commit();
        wgmma_wait();
        fence_panels<DIM>(acc);
        mbar_arrive(sm.empty(st));
    }
    store_rows<DIM>(dq + (size_t(bt) * sq + q0) * DIM, acc, scale, r, qd, sq - q0);
}

// ---- K5: dK, dV ---------------------------------------------------------------

// On Sᵀ and dPᵀ in accumulator layout (rows keys, columns queries), the
// columns' L·log2 e and δ at col[0..64) and col[64..128): S becomes the
// unrounded P = 2^(S·scale2 − l2), dP becomes dS = P ∘ (dP − δ); columns at
// or past n (MASK) get P = dS = 0.
template <bool MASK>
__device__ __forceinline__ void dscores_cols(float (&s)[32], float (&dp)[32],
                                             const float* col, float scale2, int n,
                                             int qd) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const float2 l2 = *reinterpret_cast<const float2*>(col + 8 * c + 2 * qd);
        const float2 dl = *reinterpret_cast<const float2*>(col + TILE_ROWS + 8 * c + 2 * qd);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const bool hi = e & 1;
            float p = exp2f(fmaf(s[4 * c + e], scale2, -(hi ? l2.y : l2.x)));
            if (MASK && 8 * c + 2 * qd + hi >= n) p = 0.f;
            s[4 * c + e] = p;
            dp[4 * c + e] = p * (dp[4 * c + e] - (hi ? dl.y : dl.x));
        }
    }
}

template <int DIM>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tq_t,
                       const __grid_constant__ CUtensorMap tk_t,
                       const __grid_constant__ CUtensorMap tv_t,
                       const __grid_constant__ CUtensorMap tdo_t,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       int bh_primal, int sq, int sk, float scale) {
    using Pn = Panels<DIM>;
    extern __shared__ uint8_t smem_raw[];
    const Smem<DIM> sm(smem_raw);  // a = K, b = V; ring: c = Q, d = dO, cols
    const int k0 = blockIdx.x * TILE_ROWS;
    const int bt = blockIdx.y, bp = bt % bh_primal;  // cotangent, primal slice
    const int nq = (sq + TILE_ROWS - 1) / TILE_ROWS;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    init_block(sm, 32);

    if (warp == 4) {  // the producer warp: every lane writes L and δ
        if (lane == 0) {
            mbar_expect_tx(sm.own(), 2 * Pn::TX);
            load_tile<DIM>(sm.a, &tk, &tk_t, sm.own(), k0, bp);
            load_tile<DIM>(sm.b, &tv, &tv_t, sm.own(), k0, bp);
        }
        for (int j = 0; j < nq; ++j) {
            const int s = j % STAGES;
            mbar_wait(sm.empty(s), ((j / STAGES) & 1) ^ 1);
            float* col = sm.col(s);
            for (int e = lane; e < TILE_ROWS; e += 32) {
                const int q = j * TILE_ROWS + e;
                col[e] = q < sq ? lse[size_t(bp) * sq + q] * kLog2e : 0.f;
                col[TILE_ROWS + e] = q < sq ? delta[size_t(bt) * sq + q] : 0.f;
            }
            if (lane == 0) {
                mbar_expect_tx(sm.full(s), 2 * Pn::TX);
                load_tile<DIM>(sm.c + s * Pn::TB, &tq, &tq_t, sm.full(s), j * TILE_ROWS, bp);
                load_tile<DIM>(sm.d + s * Pn::TB, &tdo, &tdo_t, sm.full(s), j * TILE_ROWS, bt);
            } else {
                mbar_arrive(sm.full(s));
            }
        }
        return;
    }

    const int qd = lane % 4;
    const int r = 16 * warp + lane / 4;
    const float scale2 = scale * kLog2e;
    const uint64_t x_k = desc_sw128(sm.a), x_v = desc_sw128(sm.b);
    Acc<DIM> acck, accv;  // dK, dV (64 keys × DIM)
    zero<DIM>(acck);
    zero<DIM>(accv);

    mbar_wait(sm.own(), 0);
    for (int j = 0; j < nq; ++j) {
        const int st = j % STAGES;
        const int q0 = j * TILE_ROWS;
        mbar_wait(sm.full(st), (j / STAGES) & 1);
        const uint64_t x_q = desc_sw128(sm.c + st * Pn::TB);
        const uint64_t x_do = desc_sw128(sm.d + st * Pn::TB);
        const float* col = sm.col(st);

        float s[32], dp[32];  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
        two_products<DIM>(s, dp, x_k, x_q, x_v, x_do);
        if (q0 + TILE_ROWS <= sq)
            dscores_cols<false>(s, dp, col, scale2, 0, qd);
        else
            dscores_cols<true>(s, dp, col, scale2, sq - q0, qd);
        uint32_t pa[4][4], ds[4][4];
        acc_to_a(s, pa);
        acc_to_a(dp, ds);

        fence_panels<DIM>(accv);  // dV += Pᵀ·dO, dK += dSᵀ·Q
        fence_panels<DIM>(acck);
        wgmma_fence();
        product_rs<DIM>(accv, pa, x_do);
        product_rs<DIM>(acck, ds, x_q);
        wgmma_commit();
        wgmma_wait();
        fence_panels<DIM>(accv);
        fence_panels<DIM>(acck);
        mbar_arrive(sm.empty(st));
    }
    const size_t out = (size_t(bt) * sk + k0) * DIM;
    store_rows<DIM>(dk + out, acck, scale, r, qd, sk - k0);
    store_rows<DIM>(dv + out, accv, 1.f, r, qd, sk - k0);
}

// ---- host side ------------------------------------------------------------------

// Q, K, V over the primal's heads, dO over the cotangent's: boxes of 64
// columns in m[0..4), of the last panel's D % 64 in m[4..8) where 64 does
// not divide DIM.
template <int DIM>
cudaError_t maps(CUtensorMap (&m)[8], const void* q, const void* k, const void* v,
                 const void* dout, int bh, int bh_primal, int sq, int sk) {
    constexpr int tail = Panels<DIM>::TAIL;
    const void* ptr[4] = {q, k, v, dout};
    const int heads[4] = {bh_primal, bh_primal, bh_primal, bh};
    const int rows[4] = {sq, sk, sk, sq};
    cudaError_t err = cudaSuccess;
    for (int i = 0; i < (tail ? 8 : 4) && err == cudaSuccess; ++i)
        err = head_map(&m[i], ptr[i % 4], heads[i % 4], rows[i % 4], DIM, i < 4 ? D : tail);
    return err;
}

template <int DIM>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int bh_primal, int sq,
              int sk, float scale, cudaStream_t stream) {
    CUtensorMap m[8];
    auto kernel = flash_dq_wgmma_kernel<DIM>;
    cudaError_t err = maps<DIM>(m, q, k, v, dout, bh, bh_primal, sq, sk);
    if (err == cudaSuccess) err = flash::allow_smem(kernel, SMEM<DIM>);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sq + TILE_ROWS - 1) / TILE_ROWS, bh);
    constexpr int t = Panels<DIM>::TAIL ? 4 : 0;  // the tail maps, or the full ones
    kernel<<<grid, NT, SMEM<DIM>, stream>>>(
        m[0], m[1], m[2], m[3], m[t], m[t + 1], m[t + 2], m[t + 3],
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<__nv_bfloat16*>(dq), bh_primal, sq, sk, scale);
    return int(cudaGetLastError());
}

template <int DIM>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int bh_primal, int sq, int sk, float scale, cudaStream_t stream) {
    CUtensorMap m[8];
    auto kernel = flash_dkv_wgmma_kernel<DIM>;
    cudaError_t err = maps<DIM>(m, q, k, v, dout, bh, bh_primal, sq, sk);
    if (err == cudaSuccess) err = flash::allow_smem(kernel, SMEM<DIM>);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sk + TILE_ROWS - 1) / TILE_ROWS, bh);
    constexpr int t = Panels<DIM>::TAIL ? 4 : 0;
    kernel<<<grid, NT, SMEM<DIM>, stream>>>(
        m[0], m[1], m[2], m[3], m[t], m[t + 1], m[t + 2], m[t + 3],
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), bh_primal, sq,
        sk, scale);
    return int(cudaGetLastError());
}

}  // namespace

namespace flash {

// K4 and K5 on contiguous bf16 q (bh_primal, sq, d), k/v (bh_primal, sk,
// d), dout (bh, sq, d), lse (bh_primal, sq) and delta (bh, sq) f32; dq
// (bh, sq, d), dk/dv (bh, sk, d) bf16; 16-byte aligned; d = 40, 64, 80,
// 128 or 160. flash_dq and flash_dkv (flash_bwd.cu) route their bf16 calls
// here. Return a cudaError_t code: 0 on a launch that was accepted,
// cudaErrorInvalidValue at any other d.
int dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int bh, int bh_primal,
             int sq, int sk, int d, float scale, cudaStream_t stream) {
    return on_pair_head_dim(d, [&](auto dim) {
        return launch_dq<decltype(dim)::value>(q, k, v, dout, lse, delta, dq, bh, bh_primal,
                                                sq, sk, scale, stream);
    });
}

int dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int bh,
              int bh_primal, int sq, int sk, int d, float scale, cudaStream_t stream) {
    return on_pair_head_dim(d, [&](auto dim) {
        return launch_dkv<decltype(dim)::value>(q, k, v, dout, lse, delta, dk, dv, bh,
                                                 bh_primal, sq, sk, scale, stream);
    });
}

}  // namespace flash
