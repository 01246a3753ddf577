// Flash attention tangent (K3) for Hopper: the forward-mode JVP of
// O = softmax(Q Kᵀ · scale) V given the forward's row logsumexp L,
//
//     Ṡ = (Q̇ Kᵀ + Q K̇ᵀ) · scale,   P = exp(S − L) recomputed per tile,
//     Ȯ = Σ_k (P∘Ṡ) V + P V̇ − rowsum(P∘Ṡ) ∘ O.
//
// Replaces the Pallas TPU kernel `_flash_tangent_kernel` / `_flash_tangent`
// in diffusion_pullback_tpu/ops/pallas/flash_attention.py. The Pallas
// kernel rounds P∘Ṡ and P to the input dtype before their products with V
// and V̇ (`pds.astype(v.dtype)`, `p.astype(dv.dtype)`): in f32, the dtype of
// the kernel below, that rounds nothing; rowsum(P∘Ṡ) and the accumulator
// are f32.
//
// Two designs, chosen by flash_design (flash_common.cuh): bf16 at every
// head dim (40, 64, 80, 128, 160) goes to the tensor-core design "wgmma"
// (flash_jvp_tc.cu); f32 runs the CUDA-core design "simt" below, since
// wgmma has no f32 operand and TF32 would lose the 1e-4 agreement with the
// plain version.
//
// Layout (B·H, S, D), contiguous; head dims 40, 64, 80, 128, 160. The tangents
// may carry more slices than the primal: a vmap over probes folds the probe
// axis into B·H of Q̇, K̇, V̇ and Ȯ only, and tangent slice b reads primal
// slice b % bh_primal, so the probes share one copy of Q, K, V, O and L.
//
// Parallelism: the Pallas grid carries the accumulator and the row sum
// across a sequential K-block axis. Here one thread block owns a 64-row Q
// tile and loops over the K/V tiles itself, keeping the Ȯ accumulator and
// its share of rowsum(P∘Ṡ) in registers; blocks are independent (grid = Q
// tiles × B·H). Per K tile it stages Kᵀ, K̇ᵀ (d-major), V and V̇ in shared
// memory, computes S and Ṡ in one pass over d, and writes the Pᵀ and
// (P∘Ṡ)ᵀ tiles to shared memory for the two products with V and V̇. D =
// 64: 64×64 tiles, 137 KB of dynamic shared memory (opted in), 256
// threads, 1 block per SM. D = 40, 80, 128, 160: flash::TileN, 64 Q rows
// × 32 keys, 128 threads, 60.9–191.5 KB.
//
// What bounds it: 10·BH·Sq·Sk·D operations (five products of the tile
// size) against 8·BH·S·D elements read or written, so it is bound by
// operations: in f32 on the CUDA cores, 67 TFLOP/s peak on an H100 SXM.

#include "flash_common.cuh"

namespace {

using flash::s_col;

// 64 Q rows × 64 keys, G = 16 lanes per row group: 256 threads, each with
// 4 rows × 4 logits and 4 rows × 4 output columns.
using TileJ = flash::Tile<64, 64, 64, 16>;

template <class C>
constexpr int kSmemFloats =
    2 * C::D * C::QS + 2 * C::D * C::KS + 2 * C::BK * C::D + 2 * C::BK * C::QS;

template <class C>
__global__ void __launch_bounds__(C::NT)
flash_tangent_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dq,
                     const float* __restrict__ dk, const float* __restrict__ dv,
                     const float* __restrict__ o, const float* __restrict__ lse,
                     float* __restrict__ dout, int bh_primal, int sq, int sk,
                     float scale) {
    constexpr int D = C::D, BQ = C::BQ, BK = C::BK, G = C::G, TR = C::TR;
    constexpr int TC = C::TC, DC = C::DC, QS = C::QS, KS = C::KS, NT = C::NT;
    static_assert(TC == 4 && C::VW == 4, "one float4 of columns per lane");

    extern __shared__ __align__(16) float smem[];
    float* Qt = smem;            // [D][QS]  Qᵀ
    float* dQt = Qt + D * QS;    // [D][QS]  Q̇ᵀ
    float* Kt = dQt + D * QS;    // [D][KS]  Kᵀ
    float* dKt = Kt + D * KS;    // [D][KS]  K̇ᵀ
    float* Vs = dKt + D * KS;    // [BK][D]  V
    float* dVs = Vs + BK * D;    // [BK][D]  V̇
    float* Pt = dVs + BK * D;    // [BK][QS] Pᵀ, rounded
    float* PSt = Pt + BK * QS;   // [BK][QS] (P∘Ṡ)ᵀ, rounded

    const int tid = threadIdx.x;
    const int c = tid % G;
    const int r0 = (tid / G) * TR;
    const int q0 = blockIdx.x * BQ;
    const size_t bt = blockIdx.y;              // tangent slice
    const size_t bp = blockIdx.y % bh_primal;  // primal slice

    flash::load_tile<float, BQ, D, NT>(q + bp * sq * D, q0, sq, Qt, QS, nullptr);
    flash::load_tile<float, BQ, D, NT>(dq + bt * sq * D, q0, sq, dQt, QS, nullptr);

    float lrow[TR], acc[TR][DC], rs[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
        const int row = q0 + r0 + i;
        lrow[i] = row < sq ? lse[bp * sq + row] : 0.f;
        rs[i] = 0.f;
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < sk; k0 += BK) {
        __syncthreads();  // the previous tile's products are done with smem
        flash::load_tile<float, BK, D, NT>(k + bp * sk * D, k0, sk, Kt, KS, nullptr);
        flash::load_tile<float, BK, D, NT>(dk + bt * sk * D, k0, sk, dKt, KS, nullptr);
        flash::load_tile<float, BK, D, NT>(v + bp * sk * D, k0, sk, nullptr, 0, Vs);
        flash::load_tile<float, BK, D, NT>(dv + bt * sk * D, k0, sk, nullptr, 0, dVs);
        __syncthreads();

        // S = Q Kᵀ and Ṡ/scale = Q̇ Kᵀ + Q K̇ᵀ for this thread's TR×TC slots
        float s[TR][TC], t[TR][TC];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            const float4 qv = *reinterpret_cast<const float4*>(Qt + d * QS + r0);
            const float4 dqv = *reinterpret_cast<const float4*>(dQt + d * QS + r0);
            const float4 kv = *reinterpret_cast<const float4*>(Kt + d * KS + c * 4);
            const float4 dkv = *reinterpret_cast<const float4*>(dKt + d * KS + c * 4);
            const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
            const float dqr[4] = {dqv.x, dqv.y, dqv.z, dqv.w};
            const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
            const float dkr[4] = {dkv.x, dkv.y, dkv.z, dkv.w};
#pragma unroll
            for (int i = 0; i < TR; ++i)
#pragma unroll
                for (int j = 0; j < TC; ++j) {
                    s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
                    t[i][j] = fmaf(dqr[i], kr[j], fmaf(qr[i], dkr[j], t[i][j]));
                }
        }

        // P = exp(S·scale − L) (0 past sk), P∘Ṡ; both into smem
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) {
                const int col = s_col<C>(j, c);
                const float p =
                    k0 + col < sk ? expf(s[i][j] * scale - lrow[i]) : 0.f;
                const float pds = p * (t[i][j] * scale);
                rs[i] += pds;
                Pt[col * QS + r0 + i] = p;
                PSt[col * QS + r0 + i] = pds;
            }
        __syncthreads();

        // acc += (P∘Ṡ) V + P V̇
        const int kn = min(BK, sk - k0);
        for (int j = 0; j < kn; ++j) {
            const float4 pv = *reinterpret_cast<const float4*>(Pt + j * QS + r0);
            const float4 psv = *reinterpret_cast<const float4*>(PSt + j * QS + r0);
            const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
            const float psr[4] = {psv.x, psv.y, psv.z, psv.w};
#pragma unroll
            for (int g = 0; g < DC / 4; ++g) {
                if (!flash::has_chunk<C>(g, c)) continue;
                const float4 vv = *reinterpret_cast<const float4*>(
                    Vs + j * D + (g * G + c) * 4);
                const float4 dvv = *reinterpret_cast<const float4*>(
                    dVs + j * D + (g * G + c) * 4);
                const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
                const float dvr[4] = {dvv.x, dvv.y, dvv.z, dvv.w};
#pragma unroll
                for (int i = 0; i < TR; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[i][4 * g + e] = fmaf(
                            psr[i], vr[e], fmaf(pr[i], dvr[e], acc[i][4 * g + e]));
            }
        }
    }

    // Ȯ = acc − rowsum(P∘Ṡ) ∘ O
#pragma unroll
    for (int i = 0; i < TR; ++i) {
        const float rsum = flash::group_sum<G>(rs[i]);
        const int row = q0 + r0 + i;
        if (row >= sq) continue;
        const float* orow = o + (bp * sq + row) * D;
        float* drow = dout + (bt * sq + row) * D;
#pragma unroll
        for (int g = 0; g < DC / 4; ++g) {
            if (!flash::has_chunk<C>(g, c)) continue;
            float ov[4], out[4];
            flash::Io<float>::load4(orow + (g * G + c) * 4, ov);
#pragma unroll
            for (int e = 0; e < 4; ++e) out[e] = acc[i][4 * g + e] - rsum * ov[e];
            flash::Io<float>::store4(drow + (g * G + c) * 4, out);
        }
    }
}

template <class C>
int launch(const void* q, const void* k, const void* v, const void* dq,
           const void* dk, const void* dv, const void* o, const void* lse,
           void* dout, int bh, int bh_primal, int sq, int sk, float scale,
           cudaStream_t stream) {
    const int smem = kSmemFloats<C> * int(sizeof(float));
    auto kernel = flash_tangent_kernel<C>;
    cudaError_t err = flash::allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
    auto in = [](const void* p) { return static_cast<const float*>(p); };
    kernel<<<grid, C::NT, smem, stream>>>(
        in(q), in(k), in(v), in(dq), in(dk), in(dv), in(o),
        static_cast<const float*>(lse), static_cast<float*>(dout), bh_primal, sq,
        sk, scale);
    return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, o (bh_primal, sq, d), k/v (bh_primal, sk, d), lse (bh_primal, sq) f32;
// dq, dout (bh, sq, d), dk/dv (bh, sk, d), bh a multiple of bh_primal.
// Contiguous device arrays of one dtype (is_bf16 = 0: float32, 1: bfloat16)
// apart from lse, 16-byte aligned; head dims 40, 64, 80, 128, 160.
// Returns a cudaError_t code: cudaErrorInvalidValue for bf16 that
// flash_design does not send to wgmma (simt is f32 only).
int flash_tangent(const void* q, const void* k, const void* v, const void* dq,
                  const void* dk, const void* dv, const void* o,
                  const void* lse, void* dout, int bh, int bh_primal, int sq,
                  int sk, int d, int is_bf16, float scale, void* stream) {
    if (bh <= 0 || bh > 65535 || bh_primal <= 0 || bh % bh_primal || sq <= 0 ||
        sk <= 0 || !flash::pair_head_dim(d))
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (flash_design(3, d, is_bf16))
        return flash::served(3, flash::kWgmma,
                             flash::tangent_wgmma(q, k, v, dq, dk, dv, o, lse, dout, bh,
                                                  bh_primal, sq, sk, d, scale, s));
    if (is_bf16) return int(cudaErrorInvalidValue);  // simt below is f32 only
    if (d == 64)
        return flash::served(3, flash::kSimt,
                             launch<TileJ>(q, k, v, dq, dk, dv, o, lse, dout, bh, bh_primal,
                                           sq, sk, scale, s));
    return flash::served(3, flash::kSimt, flash::on_tile_n(d, [&](auto dim) {
        return launch<flash::TileN<decltype(dim)::value>>(q, k, v, dq, dk, dv, o, lse, dout,
                                                         bh, bh_primal, sq, sk, scale, s);
    }));
}

}  // extern "C"
