// Flash attention backward for Hopper, given the forward's row logsumexp L
// and δ = rowsum(dO ∘ O) (computed by the caller, as the Pallas wrapper
// computes it in XLA), with P = exp(Q Kᵀ · scale − L) recomputed per tile:
//
//   K4  dQ = scale · Σ_k [P ∘ (dO Vᵀ − δ)] K                (flash_dq)
//   K5  dV = Σ_q Pᵀ dO,  dK = scale · Σ_q [P ∘ (dO Vᵀ − δ)]ᵀ Q  (flash_dkv)
//
// Replace the Pallas TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel`
// (the two pallas_calls of `_flash_backward`) in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py. The Pallas kernels
// round dS to K's dtype before dS·K (K4), P to dO's and dS to Q's before
// Pᵀ·dO and dSᵀ·Q (K5): in f32, the dtype of the kernels below, that
// rounds nothing.
//
// Two designs, chosen by flash_design (flash_common.cuh): bf16 at every
// head dim (40, 64, 80, 128, 160) goes to the tensor-core design "wgmma"
// (flash_bwd_tc.cu); f32 runs the CUDA-core design "simt" below, since
// wgmma has no f32 operand and TF32 would lose the 1e-4 agreement with the
// plain versions.
//
// Layout (B·H, S, D), contiguous; head dims 40, 64, 80, 128, 160. The cotangent
// (dO, δ) and the outputs may carry more slices than the primal: a vmap over
// probes folds the probe axis into their B·H, and cotangent slice b reads
// primal slice b % bh_primal (Q, K, V, L), so the probes share one copy.
//
// Parallelism: the Pallas kernels carry their accumulators across a
// sequential grid axis (K blocks for dQ, Q blocks for dK/dV). Here each
// output tile has one owner and no atomics: a K4 block owns a 64-row Q tile
// and loops over the K tiles; a K5 block owns a 64-row K tile and loops over
// the Q tiles (Q innermost, as the Pallas dkv grid). The logits S and dO Vᵀ
// are computed in one pass over d from d-major tiles; dS (and P)
// go through shared memory for the products that follow. At D = 64:
// 64×64 tiles, 256 threads, K4 103 KB of dynamic shared memory (2 blocks
// per SM), K5 138 KB (1 block per SM). At D = 40, 80, 128, 160:
// flash::TileN, 64 rows × 32 columns, 128 threads, K4 47.1–162.3 KB, K5
// 61.2–191.7 KB.
//
// What bounds them: K4 does 6·BH·Sq·Sk·D operations (three products of the
// tile size), K5 8·BH·Sq·Sk·D (four), against a few B·H·S·D elements, so
// both are bound by operations: in f32 on the CUDA cores, 67 TFLOP/s peak
// on an H100 SXM.

#include "flash_common.cuh"

namespace {

using flash::s_col;

// 64 rows × 64 columns, G = 16 lanes per row group: 256 threads, each with
// 4 rows × 4 logits and 4 rows × 4 output columns.
using TileB = flash::Tile<64, 64, 64, 16>;

// K4: Qᵀ, dOᵀ (row side, d-major); Kᵀ, Vᵀ (column side, d-major); K
// row-major; dSᵀ
template <class C>
constexpr int kDqSmemFloats =
    2 * C::D * C::QS + 2 * C::D * C::KS + C::BK * C::D + C::BK * C::QS;

// K5: Kᵀ, Vᵀ (row side); Qᵀ, dOᵀ (column side); Q and dO row-major; Pᵀ
// and dSᵀ ([query][key]); L and δ of the Q tile
template <class C>
constexpr int kDkvSmemFloats = 2 * C::D * C::QS + 2 * C::D * C::KS +
                               2 * C::BK * C::D + 2 * C::BK * C::QS + 2 * C::BK;

// s = A·Bᵀ and t = A2·B2ᵀ for this thread's TR×TC slots, from d-major row
// tiles (At, A2t; stride RS) and column tiles (Bt, B2t; stride CS).
template <class C>
__device__ __forceinline__ void two_logits(const float* At, const float* A2t,
                                           const float* Bt, const float* B2t,
                                           int r0, int c,
                                           float (&s)[C::TR][C::TC],
                                           float (&t)[C::TR][C::TC]) {
    constexpr int TR = C::TR, TC = C::TC, RS = C::QS, CS = C::KS;
    static_assert(TC == 4 && C::VW == 4, "one float4 of columns per lane");
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < C::D; ++d) {
        const float4 av = *reinterpret_cast<const float4*>(At + d * RS + r0);
        const float4 a2v = *reinterpret_cast<const float4*>(A2t + d * RS + r0);
        const float4 bv = *reinterpret_cast<const float4*>(Bt + d * CS + c * 4);
        const float4 b2v = *reinterpret_cast<const float4*>(B2t + d * CS + c * 4);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float a2r[4] = {a2v.x, a2v.y, a2v.z, a2v.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
        const float b2r[4] = {b2v.x, b2v.y, b2v.z, b2v.w};
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) {
                s[i][j] = fmaf(ar[i], br[j], s[i][j]);
                t[i][j] = fmaf(a2r[i], b2r[j], t[i][j]);
            }
    }
}

template <class C>
__global__ void __launch_bounds__(C::NT)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int bh_primal, int sq, int sk,
                float scale) {
    constexpr int D = C::D, BQ = C::BQ, BK = C::BK, G = C::G, TR = C::TR;
    constexpr int TC = C::TC, DC = C::DC, QS = C::QS, KS = C::KS, NT = C::NT;

    extern __shared__ __align__(16) float smem[];
    float* Qt = smem;            // [D][QS]  Qᵀ
    float* dOt = Qt + D * QS;    // [D][QS]  dOᵀ
    float* Kt = dOt + D * QS;    // [D][KS]  Kᵀ
    float* Vt = Kt + D * KS;     // [D][KS]  Vᵀ
    float* Ks = Vt + D * KS;     // [BK][D]  K
    float* DSt = Ks + BK * D;    // [BK][QS] dSᵀ

    const int tid = threadIdx.x;
    const int c = tid % G;
    const int r0 = (tid / G) * TR;
    const int q0 = blockIdx.x * BQ;
    const size_t bt = blockIdx.y;              // cotangent slice
    const size_t bp = blockIdx.y % bh_primal;  // primal slice

    flash::load_tile<float, BQ, D, NT>(q + bp * sq * D, q0, sq, Qt, QS, nullptr);
    flash::load_tile<float, BQ, D, NT>(dout + bt * sq * D, q0, sq, dOt, QS, nullptr);

    float lrow[TR], drow[TR], acc[TR][DC];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
        const int row = q0 + r0 + i;
        lrow[i] = row < sq ? lse[bp * sq + row] : 0.f;
        drow[i] = row < sq ? delta[bt * sq + row] : 0.f;
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < sk; k0 += BK) {
        __syncthreads();
        flash::load_tile<float, BK, D, NT>(k + bp * sk * D, k0, sk, Kt, KS, Ks);
        flash::load_tile<float, BK, D, NT>(v + bp * sk * D, k0, sk, Vt, KS, nullptr);
        __syncthreads();

        float s[TR][TC], dp[TR][TC];
        two_logits<C>(Qt, dOt, Kt, Vt, r0, c, s, dp);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) {
                const int col = s_col<C>(j, c);
                const float p =
                    k0 + col < sk ? expf(s[i][j] * scale - lrow[i]) : 0.f;
                DSt[col * QS + r0 + i] = p * (dp[i][j] - drow[i]);
            }
        __syncthreads();

        const int kn = min(BK, sk - k0);
        for (int j = 0; j < kn; ++j) {
            const float4 dsv = *reinterpret_cast<const float4*>(DSt + j * QS + r0);
            const float dsr[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
            for (int g = 0; g < DC / 4; ++g) {
                if (!flash::has_chunk<C>(g, c)) continue;
                const float4 kv = *reinterpret_cast<const float4*>(
                    Ks + j * D + (g * G + c) * 4);
                const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
                for (int i = 0; i < TR; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[i][4 * g + e] = fmaf(dsr[i], kr[e], acc[i][4 * g + e]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
        const int row = q0 + r0 + i;
        if (row >= sq) continue;
        float* out = dq + (bt * sq + row) * D;
#pragma unroll
        for (int g = 0; g < DC / 4; ++g) {
            if (!flash::has_chunk<C>(g, c)) continue;
            float x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) x[e] = acc[i][4 * g + e] * scale;
            flash::Io<float>::store4(out + (g * G + c) * 4, x);
        }
    }
}

// Rows are keys, columns are queries: the block owns keys [k0, k0 + 64).
template <class C>
__global__ void __launch_bounds__(C::NT)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int bh_primal, int sq,
                 int sk, float scale) {
    constexpr int D = C::D, BR = C::BQ, BC = C::BK, G = C::G, TR = C::TR;
    constexpr int TC = C::TC, DC = C::DC, RS = C::QS, CS = C::KS, NT = C::NT;

    extern __shared__ __align__(16) float smem[];
    float* Kt = smem;            // [D][RS]  Kᵀ of the block's keys
    float* Vt = Kt + D * RS;     // [D][RS]  Vᵀ
    float* Qt = Vt + D * RS;     // [D][CS]  Qᵀ of the current Q tile
    float* dOt = Qt + D * CS;    // [D][CS]  dOᵀ
    float* Qs = dOt + D * CS;    // [BC][D]  Q
    float* dOs = Qs + BC * D;    // [BC][D]  dO
    float* Pq = dOs + BC * D;    // [BC][RS] P as [query][key]
    float* DSq = Pq + BC * RS;   // [BC][RS] dS as [query][key]
    float* Ls = DSq + BC * RS;   // [BC]     L of the Q tile
    float* Dl = Ls + BC;         // [BC]     δ of the Q tile

    const int tid = threadIdx.x;
    const int c = tid % G;
    const int r0 = (tid / G) * TR;
    const int k0 = blockIdx.x * BR;
    const size_t bt = blockIdx.y;              // cotangent slice
    const size_t bp = blockIdx.y % bh_primal;  // primal slice

    flash::load_tile<float, BR, D, NT>(k + bp * sk * D, k0, sk, Kt, RS, nullptr);
    flash::load_tile<float, BR, D, NT>(v + bp * sk * D, k0, sk, Vt, RS, nullptr);

    float acck[TR][DC], accv[TR][DC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acck[i][j] = accv[i][j] = 0.f;

    for (int q0 = 0; q0 < sq; q0 += BC) {
        __syncthreads();
        flash::load_tile<float, BC, D, NT>(q + bp * sq * D, q0, sq, Qt, CS, Qs);
        flash::load_tile<float, BC, D, NT>(dout + bt * sq * D, q0, sq, dOt, CS, dOs);
        for (int e = tid; e < BC; e += NT) {
            const bool in = q0 + e < sq;
            Ls[e] = in ? lse[bp * sq + q0 + e] : 0.f;
            Dl[e] = in ? delta[bt * sq + q0 + e] : 0.f;
        }
        __syncthreads();

        // Sᵀ = K Qᵀ and (dO Vᵀ)ᵀ = V dOᵀ for this thread's keys × queries
        float s[TR][TC], dp[TR][TC];
        two_logits<C>(Kt, Vt, Qt, dOt, r0, c, s, dp);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) {
                const int col = s_col<C>(j, c);
                const float p =
                    q0 + col < sq ? expf(s[i][j] * scale - Ls[col]) : 0.f;
                Pq[col * RS + r0 + i] = p;
                DSq[col * RS + r0 + i] = p * (dp[i][j] - Dl[col]);
            }
        __syncthreads();

        // dV += Pᵀ dO, dK += dSᵀ Q over this Q tile
        const int qn = min(BC, sq - q0);
        for (int j = 0; j < qn; ++j) {
            const float4 pv = *reinterpret_cast<const float4*>(Pq + j * RS + r0);
            const float4 dsv = *reinterpret_cast<const float4*>(DSq + j * RS + r0);
            const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
            const float dsr[4] = {dsv.x, dsv.y, dsv.z, dsv.w};
#pragma unroll
            for (int g = 0; g < DC / 4; ++g) {
                if (!flash::has_chunk<C>(g, c)) continue;
                const float4 ov = *reinterpret_cast<const float4*>(
                    dOs + j * D + (g * G + c) * 4);
                const float4 qv = *reinterpret_cast<const float4*>(
                    Qs + j * D + (g * G + c) * 4);
                const float orr[4] = {ov.x, ov.y, ov.z, ov.w};
                const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
                for (int i = 0; i < TR; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        accv[i][4 * g + e] = fmaf(pr[i], orr[e], accv[i][4 * g + e]);
                        acck[i][4 * g + e] = fmaf(dsr[i], qr[e], acck[i][4 * g + e]);
                    }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
        const int row = k0 + r0 + i;
        if (row >= sk) continue;
        float* krow = dk + (bt * sk + row) * D;
        float* vrow = dv + (bt * sk + row) * D;
#pragma unroll
        for (int g = 0; g < DC / 4; ++g) {
            if (!flash::has_chunk<C>(g, c)) continue;
            float xk[4], xv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                xk[e] = acck[i][4 * g + e] * scale;
                xv[e] = accv[i][4 * g + e];
            }
            flash::Io<float>::store4(krow + (g * G + c) * 4, xk);
            flash::Io<float>::store4(vrow + (g * G + c) * 4, xv);
        }
    }
}

template <class C>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh,
              int bh_primal, int sq, int sk, float scale, cudaStream_t stream) {
    const int smem = kDqSmemFloats<C> * int(sizeof(float));
    auto kernel = flash_dq_kernel<C>;
    cudaError_t err = flash::allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
    auto f32 = [](const void* p) { return static_cast<const float*>(p); };
    kernel<<<grid, C::NT, smem, stream>>>(
        f32(q), f32(k), f32(v), f32(dout), f32(lse), f32(delta), static_cast<float*>(dq),
        bh_primal, sq, sk, scale);
    return int(cudaGetLastError());
}

template <class C>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int bh_primal, int sq, int sk, float scale,
               cudaStream_t stream) {
    const int smem = kDkvSmemFloats<C> * int(sizeof(float));
    auto kernel = flash_dkv_kernel<C>;
    cudaError_t err = flash::allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sk + C::BQ - 1) / C::BQ, bh);
    auto f32 = [](const void* p) { return static_cast<const float*>(p); };
    kernel<<<grid, C::NT, smem, stream>>>(
        f32(q), f32(k), f32(v), f32(dout), f32(lse), f32(delta), static_cast<float*>(dk),
        static_cast<float*>(dv), bh_primal, sq, sk, scale);
    return int(cudaGetLastError());
}

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
// 160. Return a cudaError_t code: 0 on a launch that was accepted,
// cudaErrorInvalidValue for bf16 that flash_design does not send to wgmma
// (simt is f32 only).

// K4: dq (bh, sq, d).
int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int bh,
             int bh_primal, int sq, int sk, int d, int is_bf16, float scale,
             void* stream) {
    if (bad_shape(bh, bh_primal, sq, sk, d)) return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (flash_design(4, d, is_bf16))
        return flash::served(4, flash::kWgmma,
                             flash::dq_wgmma(q, k, v, dout, lse, delta, dq, bh, bh_primal, sq,
                                             sk, d, scale, s));
    if (is_bf16) return int(cudaErrorInvalidValue);  // simt below is f32 only
    if (d == 64)
        return flash::served(4, flash::kSimt,
                             launch_dq<TileB>(q, k, v, dout, lse, delta, dq, bh, bh_primal,
                                              sq, sk, scale, s));
    return flash::served(4, flash::kSimt, flash::on_tile_n(d, [&](auto dim) {
        return launch_dq<flash::TileN<decltype(dim)::value>>(
            q, k, v, dout, lse, delta, dq, bh, bh_primal, sq, sk, scale, s);
    }));
}

// K5: dk, dv (bh, sk, d).
int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int bh,
              int bh_primal, int sq, int sk, int d, int is_bf16, float scale,
              void* stream) {
    if (bad_shape(bh, bh_primal, sq, sk, d)) return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (flash_design(5, d, is_bf16))
        return flash::served(5, flash::kWgmma,
                             flash::dkv_wgmma(q, k, v, dout, lse, delta, dk, dv, bh,
                                              bh_primal, sq, sk, d, scale, s));
    if (is_bf16) return int(cudaErrorInvalidValue);
    if (d == 64)
        return flash::served(5, flash::kSimt,
                             launch_dkv<TileB>(q, k, v, dout, lse, delta, dk, dv, bh,
                                               bh_primal, sq, sk, scale, s));
    return flash::served(5, flash::kSimt, flash::on_tile_n(d, [&](auto dim) {
        return launch_dkv<flash::TileN<decltype(dim)::value>>(
            q, k, v, dout, lse, delta, dk, dv, bh, bh_primal, sq, sk, scale, s);
    }));
}

}  // extern "C"
