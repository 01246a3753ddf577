// Flash attention backward on Hopper's tensor cores, bf16 at head dim 64,
// given the forward's row logsumexp L and δ = rowsum(dO ∘ O), with
// P = exp(Q Kᵀ · scale − L) recomputed per tile:
//
//   K4  dQ = scale · Σ_k [P ∘ (dO Vᵀ − δ)] K
//   K5  dV = Σ_q Pᵀ dO,  dK = scale · Σ_q [P ∘ (dO Vᵀ − δ)]ᵀ Q
//
// For bf16 inputs at D = 64 (every pullback call of the SD path) this
// replaces the Pallas TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel`
// (the dq and dkv pallas_calls of `_flash_backward`) in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py; flash_bwd.cu's
// entries route those calls here, and f32 stays on its CUDA-core design
// (wgmma has no f32 operand; TF32 would lose the 1e-4 agreement). Same
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
// cotangent's and read at head b). Every product is one of two wgmma forms,
// m64n64k16 with f32 accumulators:
//   K4  S = Q·Kᵀ, dP = dO·Vᵀ    A and B K-major from shared memory;
//       dQ += dS·K              A = dS from registers, K MN-major;
//   K5  Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ  A and B K-major from shared memory;
//       dV += Pᵀ·dO, dK += dSᵀ·Q  A = Pᵀ, dSᵀ from registers, dO and Q
//                               MN-major.
// Between them, in registers: P = 2^(S·scale·log2 e − L·log2 e) and
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
// Left for later: overlap of the elementwise work with the products (each
// tile waits on its wgmmas), a persistent grid, and tensor maps cached
// across launches (four are encoded per launch on the host).
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
constexpr int SMEM = 2 * TILE + 2 * STAGES * TILE + STAGES * COL_BYTES + 64 + 1024;

// Shared memory of both kernels: the block's own tiles (a, b), the ring
// (c, d per stage), K5's per-stage columns, the mbarriers. The kernels name
// the wgmma descriptors of these tiles x_q, x_k, x_v, x_do.
struct Smem {
    uint8_t* base;  // 1024-byte aligned
    uint32_t a, b, c, d, cols, bars;
    __device__ explicit Smem(uint8_t* raw)
        : base(raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u)) {
        a = smem_u32(base);
        b = a + TILE;
        c = b + TILE;               // stage s: + s·TILE
        d = c + STAGES * TILE;
        cols = d + STAGES * TILE;   // stage s: + s·COL_BYTES
        bars = cols + STAGES * COL_BYTES;
    }
    __device__ uint32_t full(int s) const { return bars + 8u * s; }
    __device__ uint32_t empty(int s) const { return bars + 8u * (STAGES + s); }
    __device__ uint32_t own() const { return bars + 8u * (2 * STAGES); }
    __device__ float* col(int s) const {  // [L·log2 e | δ] of stage s
        return reinterpret_cast<float*>(base + (cols - a) + s * COL_BYTES);
    }
};

// Barrier counts: full gets the producer's lane 0 (with the TMA bytes) and,
// for K5, the other 31 lanes of the producer warp; empty the 128 consumers.
__device__ __forceinline__ void init_barriers(const Smem& sm, int full_count) {
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

// A = X·Yᵀ and B = Z·Wᵀ for the 64 × 64 tiles at descriptors x, y, z, w
// (all K-major, D / 16 k16 steps 32 bytes apart), then wait.
__device__ __forceinline__ void two_products(float (&a)[32], float (&b)[32], uint64_t x,
                                             uint64_t y, uint64_t z, uint64_t w) {
    reg_fence(a);
    reg_fence(b);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(a, x + 2 * kk, y + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(b, z + 2 * kk, w + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait();
    reg_fence(a);
    reg_fence(b);
}

// acc += A·Y for A in A fragments over 64 columns and Y MN-major at y.
__device__ __forceinline__ void product_rs(float (&acc)[32], const uint32_t (&a)[4][4],
                                           uint64_t y) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64_tb(acc, a[kk], y + kk * MN_STEP);
}

// The bf16 outputs of a 64-row tile in accumulator layout, times mul, rows
// below n: row r + 8i of out (its first row at out).
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[32],
                                           float mul, int r, int qd, int n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        if (r + 8 * i >= n) continue;
        __nv_bfloat16* row = out + size_t(r + 8 * i) * D;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
            *reinterpret_cast<uint32_t*>(row + 8 * c + 2 * qd) =
                pack_bf16(acc[4 * c + 2 * i] * mul, acc[4 * c + 2 * i + 1] * mul);
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

__global__ void __launch_bounds__(NT, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int bh_primal, int sq, int sk,
                      float scale) {
    extern __shared__ uint8_t smem_raw[];
    const Smem sm(smem_raw);  // a = Q, b = dO; ring: c = K, d = V
    const int q0 = blockIdx.x * TILE_ROWS;
    const int bt = blockIdx.y, bp = bt % bh_primal;  // cotangent, primal slice
    const int nk = (sk + TILE_ROWS - 1) / TILE_ROWS;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    init_barriers(sm, 1);

    if (warp == 4) {  // the producer warp
        if (lane == 0) {
            mbar_expect_tx(sm.own(), 2 * TILE);
            tma_load(sm.a, &tq, sm.own(), q0, bp);
            tma_load(sm.b, &tdo, sm.own(), q0, bt);
            for (int j = 0; j < nk; ++j) {
                const int s = j % STAGES;
                mbar_wait(sm.empty(s), ((j / STAGES) & 1) ^ 1);
                mbar_expect_tx(sm.full(s), 2 * TILE);
                tma_load(sm.c + s * TILE, &tk, sm.full(s), j * TILE_ROWS, bp);
                tma_load(sm.d + s * TILE, &tv, sm.full(s), j * TILE_ROWS, bp);
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
    float acc[32];  // dQ (64 × D)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;

    mbar_wait(sm.own(), 0);
    for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES;
        const int k0 = j * TILE_ROWS;
        mbar_wait(sm.full(st), (j / STAGES) & 1);
        const uint64_t x_k = desc_sw128(sm.c + st * TILE), x_v = desc_sw128(sm.d + st * TILE);

        float s[32], dp[32];  // S = Q·Kᵀ, dP = dO·Vᵀ
        two_products(s, dp, x_q, x_k, x_do, x_v);
        if (k0 + TILE_ROWS <= sk)
            dscores_rows<false>(s, dp, l2, dl, scale2, 0, qd);
        else
            dscores_rows<true>(s, dp, l2, dl, scale2, sk - k0, qd);
        uint32_t ds[4][4];
        acc_to_a(s, ds);

        reg_fence(acc);  // dQ += dS·K
        wgmma_fence();
        product_rs(acc, ds, x_k);
        wgmma_commit();
        wgmma_wait();
        reg_fence(acc);
        mbar_arrive(sm.empty(st));
    }
    store_rows(dq + (size_t(bt) * sq + q0) * D, acc, scale, r, qd, sq - q0);
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

__global__ void __launch_bounds__(NT, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       int bh_primal, int sq, int sk, float scale) {
    extern __shared__ uint8_t smem_raw[];
    const Smem sm(smem_raw);  // a = K, b = V; ring: c = Q, d = dO, cols
    const int k0 = blockIdx.x * TILE_ROWS;
    const int bt = blockIdx.y, bp = bt % bh_primal;  // cotangent, primal slice
    const int nq = (sq + TILE_ROWS - 1) / TILE_ROWS;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    init_barriers(sm, 32);

    if (warp == 4) {  // the producer warp: every lane writes L and δ
        if (lane == 0) {
            mbar_expect_tx(sm.own(), 2 * TILE);
            tma_load(sm.a, &tk, sm.own(), k0, bp);
            tma_load(sm.b, &tv, sm.own(), k0, bp);
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
                mbar_expect_tx(sm.full(s), 2 * TILE);
                tma_load(sm.c + s * TILE, &tq, sm.full(s), j * TILE_ROWS, bp);
                tma_load(sm.d + s * TILE, &tdo, sm.full(s), j * TILE_ROWS, bt);
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
    float acck[32], accv[32];  // dK, dV (64 keys × D)
#pragma unroll
    for (int e = 0; e < 32; ++e) acck[e] = accv[e] = 0.f;

    mbar_wait(sm.own(), 0);
    for (int j = 0; j < nq; ++j) {
        const int st = j % STAGES;
        const int q0 = j * TILE_ROWS;
        mbar_wait(sm.full(st), (j / STAGES) & 1);
        const uint64_t x_q = desc_sw128(sm.c + st * TILE), x_do = desc_sw128(sm.d + st * TILE);

        float s[32], dp[32];  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
        two_products(s, dp, x_k, x_q, x_v, x_do);
        if (q0 + TILE_ROWS <= sq)
            dscores_cols<false>(s, dp, sm.col(st), scale2, 0, qd);
        else
            dscores_cols<true>(s, dp, sm.col(st), scale2, sq - q0, qd);
        uint32_t pa[4][4], ds[4][4];
        acc_to_a(s, pa);
        acc_to_a(dp, ds);

        reg_fence(accv);  // dV += Pᵀ·dO, dK += dSᵀ·Q
        reg_fence(acck);
        wgmma_fence();
        product_rs(accv, pa, x_do);
        product_rs(acck, ds, x_q);
        wgmma_commit();
        wgmma_wait();
        reg_fence(accv);
        reg_fence(acck);
        mbar_arrive(sm.empty(st));
    }
    const size_t out = (size_t(bt) * sk + k0) * D;
    store_rows(dk + out, acck, scale, r, qd, sk - k0);
    store_rows(dv + out, accv, 1.f, r, qd, sk - k0);
}

// ---- host side ------------------------------------------------------------------

// Q, K, V over the primal's heads, dO over the cotangent's.
cudaError_t maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                 const void* dout, int bh, int bh_primal, int sq, int sk) {
    cudaError_t err = head_map(&m[0], q, bh_primal, sq);
    if (err == cudaSuccess) err = head_map(&m[1], k, bh_primal, sk);
    if (err == cudaSuccess) err = head_map(&m[2], v, bh_primal, sk);
    if (err == cudaSuccess) err = head_map(&m[3], dout, bh, sq);
    return err;
}

}  // namespace

namespace flash {

// K4 and K5 on contiguous bf16 q (bh_primal, sq, 64), k/v (bh_primal, sk,
// 64), dout (bh, sq, 64), lse (bh_primal, sq) and delta (bh, sq) f32; dq
// (bh, sq, 64), dk/dv (bh, sk, 64) bf16; 16-byte aligned. flash_dq and
// flash_dkv (flash_bwd.cu) route their bf16 D = 64 calls here. Return a
// cudaError_t code: 0 on a launch that was accepted.
int dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int bh, int bh_primal,
             int sq, int sk, float scale, cudaStream_t stream) {
    CUtensorMap m[4];
    cudaError_t err = maps(m, q, k, v, dout, bh, bh_primal, sq, sk);
    if (err == cudaSuccess) err = allow_smem(flash_dq_wgmma_kernel, SMEM);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sq + TILE_ROWS - 1) / TILE_ROWS, bh);
    flash_dq_wgmma_kernel<<<grid, NT, SMEM, stream>>>(
        m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), bh_primal, sq,
        sk, scale);
    return int(cudaGetLastError());
}

int dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int bh,
              int bh_primal, int sq, int sk, float scale, cudaStream_t stream) {
    CUtensorMap m[4];
    cudaError_t err = maps(m, q, k, v, dout, bh, bh_primal, sq, sk);
    if (err == cudaSuccess) err = allow_smem(flash_dkv_wgmma_kernel, SMEM);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sk + TILE_ROWS - 1) / TILE_ROWS, bh);
    flash_dkv_wgmma_kernel<<<grid, NT, SMEM, stream>>>(
        m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), bh_primal, sq, sk, scale);
    return int(cudaGetLastError());
}

}  // namespace flash
