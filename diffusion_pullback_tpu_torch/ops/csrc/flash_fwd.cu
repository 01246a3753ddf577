// Flash attention forward for Hopper: O = softmax(Q Kᵀ · scale) V (K1), and
// the same with the row logsumexp L = m + log l (K2).
//
// K1 replaces the Pallas TPU kernel `_flash_kernel` / `_flash_forward`, K2
// `_flash_fwd_lse_kernel` / `_flash_forward_lse`, both in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py. Same arithmetic:
// online softmax per query row (running max m, normaliser l, accumulator),
// logits never written to device memory, f32 accumulation, the
// probabilities rounded to V's dtype before the P·V product (as the Pallas
// kernel's `p.astype(v.dtype)`), output cast to the input dtype. K2 also
// writes L in f32 as (B·H, Sq); Pallas broadcasts it to 128 lanes, a TPU
// layout choice.
//
// Layout (B·H, S, D), contiguous; f32 or bf16 inputs. K1 and K2 take head
// dims 40, 64, 80, 128 and 160 (the U-Net self-attentions: SD 2.1 / SDXL /
// ADM-256 at 64, SD 1.5 at 40 / 80 / 160, ImageNet128Cond at 128), and K1
// also 512 (the single-head VAE mid-block), K2 at 512 in f32 only.
//
// Three designs. bf16 at D = 40, 64, 80, 128 and 160 goes to the
// tensor-core design "wgmma" (flash_fwd_tc.cu: TMA loads of 64-column
// panels, wgmma products, bound by the bf16 tensor-core rate); f32 at every
// head dim to the tensor-core design "tf32x3" (each f32 product as three
// TF32 mma.sync products, which holds it within 2.5e-5 of the plain version
// at the path's shapes, a gate that one TF32 product misses; chip_smoke.py
// measures both): flash_fwd_tf32.cu at D = 512, flash_fwd_tf32_rows.cu at
// D = 40, 64, 80, 128 and 160. Only K1 in bf16 at D = 512 runs the
// CUDA-core design "simt" below: wgmma has no f32 operand, and its bf16
// kernel holds at most three panels (D ≤ 192).
//
// "simt": the Pallas grid carries the softmax state across a sequential
// K-block axis. Here one thread block owns a Q tile and loops over all K/V
// tiles itself; blocks are independent (grid = Q tiles × B·H). Each tile
// goes through shared memory in f32: Qᵀ and Kᵀ (d-major, so a thread reads
// its rows/columns of S with vector loads), V row-major, and the
// probability tile Pᵀ. A group of G consecutive lanes shares TR query rows;
// the row max and row sum are reduced with warp shuffles inside the group,
// and the same group splits the D output columns of those rows.
//
// What bounds it: the work is 4·BH·Sq·Sk·D operations on
// 2·(BH·Sq·D + BH·Sk·D) elements (K2: plus BH·Sq f32), so at the path's
// shapes it is bound by operations, not bytes. "simt" computes on the CUDA
// cores in FP32 (67 TFLOP/s peak on an H100 SXM), far below the bf16
// tensor-core rate that bounds bf16 work. The design keeps each S
// element's D-long dot product and each P·V update in registers fed by
// broadcast or conflict-free shared-memory loads, so the FMA units rather
// than shared memory set the pace.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (flash_fwd, flash_fwd_lse below), loaded
// with ctypes.

#include "flash_common.cuh"

#include <atomic>

namespace {

using flash::Io;
using flash::kNegInf;
using flash::s_col;
using flash::Tile;

// Qᵀ, Kᵀ, V and Pᵀ tiles in f32
template <class C>
constexpr int kSmemFloats = C::D * C::QS + C::D * C::KS + C::BK * C::D + C::BK * C::QS;

// D=512 in bf16 (f32 runs "tf32x3"): 32×32 tiles, 256 threads, 217.6 KB
// shared memory (1 block per SM).
using TileD512 = Tile<512, 32, 32, 32>;

template <typename T, class C>
__global__ void __launch_bounds__(C::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 float scale) {
    constexpr int D = C::D, BQ = C::BQ, BK = C::BK, G = C::G, TR = C::TR;
    constexpr int TC = C::TC, DC = C::DC, QS = C::QS, KS = C::KS;
    constexpr int D4 = D / 4;

    extern __shared__ __align__(16) float smem[];
    float* Qt = smem;           // [D][QS]  Qᵀ tile
    float* Kt = Qt + D * QS;    // [D][KS]  Kᵀ tile
    float* Vs = Kt + D * KS;    // [BK][D]  V tile
    float* Pt = Vs + BK * D;    // [BK][QS] Pᵀ tile

    const int tid = threadIdx.x;
    const int c = tid % G;          // lane within the row group
    const int r0 = (tid / G) * TR;  // first tile row of this thread
    const int q0 = blockIdx.x * BQ;
    const size_t bh = blockIdx.y;
    const T* qb = q + bh * sq * D;
    const T* kb = k + bh * sk * D;
    const T* vb = v + bh * sk * D;

    // Q tile → Qᵀ (rows past sq read as 0 and are never stored)
    for (int e = tid; e < BQ * D4; e += C::NT) {
        const int row = e / D4, d0 = (e % D4) * 4;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (q0 + row < sq) Io<T>::load4(qb + size_t(q0 + row) * D + d0, x);
#pragma unroll
        for (int t = 0; t < 4; ++t) Qt[(d0 + t) * QS + row] = x[t];
    }

    float m[TR], l[TR], acc[TR][DC];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < sk; k0 += BK) {
        __syncthreads();  // the previous tile's P·V is done with Vs and Pt
        for (int e = tid; e < BK * D4; e += C::NT) {
            const int row = e / D4, d0 = (e % D4) * 4;
            float xk[4] = {0.f, 0.f, 0.f, 0.f}, xv[4] = {0.f, 0.f, 0.f, 0.f};
            if (k0 + row < sk) {
                Io<T>::load4(kb + size_t(k0 + row) * D + d0, xk);
                Io<T>::load4(vb + size_t(k0 + row) * D + d0, xv);
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) Kt[(d0 + t) * KS + row] = xk[t];
            *reinterpret_cast<float4*>(Vs + row * D + d0) =
                make_float4(xv[0], xv[1], xv[2], xv[3]);
        }
        __syncthreads();

        // S = Q Kᵀ for this thread's TR×TC slots
        float s[TR][TC];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            const float4 qv = *reinterpret_cast<const float4*>(Qt + d * QS + r0);
            const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
            float kr[TC];
            if constexpr (C::VW == 4) {
#pragma unroll
                for (int g = 0; g < TC / 4; ++g) {
                    const float4 kv = *reinterpret_cast<const float4*>(
                        Kt + d * KS + (g * G + c) * 4);
                    kr[4 * g] = kv.x;
                    kr[4 * g + 1] = kv.y;
                    kr[4 * g + 2] = kv.z;
                    kr[4 * g + 3] = kv.w;
                }
            } else {
#pragma unroll
                for (int j = 0; j < TC; ++j) kr[j] = Kt[d * KS + j * G + c];
            }
#pragma unroll
            for (int i = 0; i < TR; ++i)
#pragma unroll
                for (int j = 0; j < TC; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
        }

        // online softmax; Pᵀ gets the probabilities rounded to V's dtype
#pragma unroll
        for (int i = 0; i < TR; ++i) {
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < TC; ++j) {
                const bool valid = k0 + s_col<C>(j, c) < sk;
                s[i][j] = valid ? s[i][j] * scale : kNegInf;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = G / 2; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float corr = expf(m[i] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < TC; ++j) {
                const int col = s_col<C>(j, c);
                const float p = (k0 + col < sk) ? expf(s[i][j] - m_new) : 0.f;
                ps += p;
                Pt[col * QS + r0 + i] = Io<T>::round(p);
            }
#pragma unroll
            for (int off = G / 2; off > 0; off >>= 1)
                ps += __shfl_xor_sync(0xffffffffu, ps, off);
            l[i] = l[i] * corr + ps;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
        }
        __syncthreads();

        // acc += P V (rows of V past sk are zero, as are their P entries)
        const int kn = min(BK, sk - k0);
        for (int j = 0; j < kn; ++j) {
            const float4 pv = *reinterpret_cast<const float4*>(Pt + j * QS + r0);
            const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int g = 0; g < DC / 4; ++g) {
                if (!flash::has_chunk<C>(g, c)) continue;
                const float4 vv = *reinterpret_cast<const float4*>(
                    Vs + j * D + (g * G + c) * 4);
                const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
                for (int i = 0; i < TR; ++i)
#pragma unroll
                    for (int t = 0; t < 4; ++t)
                        acc[i][4 * g + t] = fmaf(pr[i], vr[t], acc[i][4 * g + t]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
        const int row = q0 + r0 + i;
        if (row >= sq) continue;
        T* orow = o + (bh * sq + row) * D;
#pragma unroll
        for (int g = 0; g < DC / 4; ++g) {
            if (!flash::has_chunk<C>(g, c)) continue;
            float out[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) out[t] = acc[i][4 * g + t] / l[i];
            Io<T>::store4(orow + (g * G + c) * 4, out);
        }
    }
}

template <typename T, class C>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
           int sk, float scale, cudaStream_t stream) {
    const int smem = kSmemFloats<C> * int(sizeof(float));
    auto kernel = flash_fwd_kernel<T, C>;
    cudaError_t err = flash::allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sq + C::BQ - 1) / C::BQ, bh);
    kernel<<<grid, C::NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), sq, sk, scale);
    return int(cudaGetLastError());
}

// K1 (lse null) or K2 on the tf32x3 kernel of head dim d.
int tf32x3(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
           int sk, int d, float scale, cudaStream_t s) {
    return d == 512 ? flash::fwd_tf32x3(q, k, v, o, lse, bh, sq, sk, scale, s)
                    : flash::fwd_tf32x3_rows(q, k, v, o, lse, bh, sq, sk, d, scale, s);
}

std::atomic<long long> g_served[6][3];  // by kernel (1-5) and design

}  // namespace

int flash::served(int kernel, int design, int err) {
    if (err == int(cudaSuccess)) g_served[kernel][design].fetch_add(1, std::memory_order_relaxed);
    return err;
}

extern "C" {

long long flash_served(int kernel, int design) {
    if (kernel < 1 || kernel > 5 || design < 0 || design > 2) return -1;
    return g_served[kernel][design].load(std::memory_order_relaxed);
}

// The one design rule (declared in flash_common.cuh): bf16 at D = 40, 64,
// 80, 128 and 160 runs the wgmma kernels of K1–K5; in f32, K1, K2, K4 and
// K5 at those head dims and K1 and K2 at D = 512 (the VAE's head; K2 as
// ring attention's inner) run the tf32x3 kernels; every other call runs on
// the CUDA cores (K3 in f32, and K1 in bf16 at 512).
int flash_design(int kernel, int d, int is_bf16) {
    if (is_bf16 && flash::pair_head_dim(d)) return flash::kWgmma;
    if (!is_bf16 && kernel != 3 && (flash::pair_head_dim(d) || (kernel <= 2 && d == 512)))
        return flash::kTf32x3;
    return flash::kSimt;
}

// q (bh, sq, d), k/v (bh, sk, d), o (bh, sq, d): contiguous device arrays
// of one dtype (is_bf16 = 0: float32, 1: bfloat16), 16-byte aligned.
// Returns a cudaError_t code: 0 on a launch that was accepted.
int flash_fwd(const void* q, const void* k, const void* v, void* o, int bh,
              int sq, int sk, int d, int is_bf16, float scale, void* stream) {
    if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0)
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (flash_design(1, d, is_bf16)) {
        case flash::kWgmma:
            return flash::served(1, flash::kWgmma,
                                 flash::fwd_wgmma(q, k, v, o, nullptr, bh, sq, sk, d, scale, s));
        case flash::kTf32x3:
            return flash::served(1, flash::kTf32x3,
                                 tf32x3(q, k, v, o, nullptr, bh, sq, sk, d, scale, s));
    }
    if (d != 512) return int(cudaErrorInvalidValue);
    return flash::served(1, flash::kSimt,
                         launch<__nv_bfloat16, TileD512>(q, k, v, o, bh, sq, sk, scale, s));
}

// K2: as flash_fwd, plus lse (bh, sq) float32, the row logsumexp of the
// scaled logits. Head dims 40, 64, 80, 128, 160 (flash::pair_head_dim; bf16
// on wgmma, f32 on tf32x3), and 512 in f32 (tf32x3).
int flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int sq, int sk, int d, int is_bf16,
                  float scale, void* stream) {
    const int design = flash_design(2, d, is_bf16);
    if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 ||
        !(flash::pair_head_dim(d) || design == flash::kTf32x3))
        return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* l = static_cast<float*>(lse);
    switch (design) {
        case flash::kWgmma:
            return flash::served(2, flash::kWgmma,
                                 flash::fwd_wgmma(q, k, v, o, l, bh, sq, sk, d, scale, s));
        case flash::kTf32x3:
            return flash::served(2, flash::kTf32x3,
                                 tf32x3(q, k, v, o, l, bh, sq, sk, d, scale, s));
    }
    return int(cudaErrorInvalidValue);
}

}  // extern "C"
