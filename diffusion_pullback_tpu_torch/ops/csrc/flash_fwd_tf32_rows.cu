// Flash attention forward (K1, and K2 with the row logsumexp) on Hopper's
// tensor cores for f32 at head dims 40, 64, 80, 128 and 160: O =
// softmax(Q Kᵀ · scale) V, and L = m + log l when lse is not null.
//
// For f32 inputs at these head dims (the U-Net self-attentions: SD 2.1,
// SDXL and ADM-256 at 64, SD 1.5 at 40 / 80 / 160, ImageNet128Cond at 128,
// whenever the U-Net runs in f32) this replaces the Pallas TPU kernels
// `_flash_kernel` / `_flash_forward` (K1) and `_flash_fwd_lse_kernel` /
// `_flash_forward_lse` (K2) in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py; flash_fwd.cu's
// entries route those calls here. Same arithmetic: online softmax per query
// row in f32, logits never written to device memory, the probabilities
// unrounded before P·V (`p.astype(v.dtype)` is a no-op in f32), output in
// f32, L in natural log.
//
// What bounds it: 4·BH·Sq·Sk·D operations on 4·BH·S·D f32 elements, so at
// the path's shapes it is bound by operations. Each f32 product runs as
// three TF32 products (tf32.cuh), so the least time is the operations at a
// third of the dense TF32 rate (494.7 / 3 ≈ 164.9 TFLOP/s on an H100 SXM);
// the CUDA cores' f32 FMAs (67 TFLOP/s) cannot reach it.
//
// Design "tf32x3" for D ≤ 160: mma.sync m16n8k8 TF32 (Hopper's TF32 wgmma
// takes only K-major operands, and V is MN-major in P·V). A block of 4 warps
// owns the query rows of R row groups of one head and loops over tiles of BK
// keys (64, and 32 at D = 160, where two 32-row blocks then fit an SM);
// warp w owns row group w % R, MT m16 tiles of it, and the keys w / R of
// the C = 4 / R equal slices of every tile. Three block shapes, by the
// grid (each measured best where it runs, ops/fwd_tf32_variants.py):
//   128 rows   R = 4, MT = 2, at D ≤ 80 where there are at least 3 such
//              blocks for every 2 SMs: each K and V fragment serves two
//              m-tiles, which halves the loads and splits per product;
//   64 rows    where 64-row blocks give every SM one: at D ≤ 64 R = 2, MT
//              = 2, C = 2 (each tile's keys split over two warp pairs), at
//              D = 80–160 R = 4, MT = 1;
//   32 rows    R = 2, MT = 1, C = 2, else: twice the blocks, so 1024-token
//              calls at B·H 4–8 still put a block on nearly every SM.
// Where C = 2, the warps of a row group merge their (m, l, O) through
// shared memory at the end, as the online softmax merges two key tiles.
// Per warp and key tile:
//   S = Q·Kᵀ   16·MT × KW (KW = BK / C keys), D / 8 k8 steps of three TF32
//              products each; K split into hi and lo at fragment load, Q
//              once into registers at D ≤ 80 with one m-tile, else at each
//              k8 step from shared memory (its registers would not fit);
//   softmax    in registers: each row's 4 lanes (a row of the accumulator
//              layout) reduce m and l with two shuffles, in base 2 with the
//              scale folded into log2(e), keys at or past sk masked; l sums
//              the unrounded P;
//   O += P·V   P goes from the accumulator layout straight to the A
//              fragment: lane t holds keys 2t and 2t + 1 of a k8 step and
//              takes them as the logical k t and t + 4, and reads V's rows
//              2t and 2t + 1 for them (V is the "col" B operand, split at
//              fragment load); O (16·MT × D per warp) stays in registers,
//              each tile's P·V summed apart and added to it in f32.
// K and V go through a ring of STAGES = 2 stages, filled by 16-byte cp.async
// copies (rows past the sequence zero-filled) that every thread issues, so
// tile j + 1 loads while tile j is computed. The row strides make every fragment
// load free of bank conflicts: Q and K rows are ≡ 8 or 24 words mod 32 (a
// half-warp's float2 loads of rows g, columns 2t span all banks), V rows ≡
// 4 or 12 mod 16 (rows 2t, columns g). 48.1–172.0 KB of shared memory, 128
// threads.
//
// Built with nvcc for sm_90a into the flash library.

#include "flash_common.cuh"
#include "tf32.cuh"

namespace {

using flash::kLog2e;
using flash::kNegInf;
using tf32::cp_async_commit;
using tf32::cp_async_wait;
using tf32::Frag;
using tf32::load_rows;
using tf32::mma3;

constexpr int NW = 4, NT = 32 * NW;  // warps, threads
constexpr int STAGES = 2;            // K/V ring stages
// keys per tile: 32 at D = 160, where two 32-row blocks then fit an SM
template <int D>
constexpr int kKeys = D > 128 ? 32 : 64;

// Row strides in floats (multiples of 4: 16-byte aligned rows for cp.async)
template <int D>
constexpr int kQKStride = (D % 32 == 8 || D % 32 == 24) ? D : D + 8;
template <int D>
constexpr int kVStride = D + 4;

template <int D, int BQ>  // BQ query rows
constexpr int kSmemFloats = BQ * kQKStride<D> + STAGES * kKeys<D> * (kQKStride<D> + kVStride<D>);

template <int D, int R, int MT>
__global__ void __launch_bounds__(NT)
flash_fwd_tf32_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int sq, int sk, float scale) {
    constexpr int C = NW / R, BK = kKeys<D>;  // key slices, keys a tile
    constexpr int WQ = 16 * MT, BQ = WQ * R;  // query rows of a warp, of the block
    constexpr int KW = BK / C, NK = KW / 8;   // a warp's keys of a tile, its n8 tiles of S
    constexpr int KSTEPS = D / 8;             // k8 steps of Q·Kᵀ, n8 tiles of O
    constexpr int QS = kQKStride<D>, VS = kVStride<D>;
    constexpr bool Q_IN_REGS = D <= 80 && MT == 1;

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;                   // [BQ][QS]
    float* Ks = Qs + BQ * QS;           // [STAGES][BK][QS]
    float* Vs = Ks + STAGES * BK * QS;  // [STAGES][BK][VS]

    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
    const int rg = w % R, kc = w / R;      // this warp's row group and key slice
    const int q0 = blockIdx.x * BQ;
    const size_t bh = blockIdx.y;
    const float* qb = q + bh * sq * D;
    const float* kb = k + bh * sk * D;
    const float* vb = v + bh * sk * D;
    const float scale2 = scale * kLog2e;
    const int ntiles = (sk + BK - 1) / BK;

    // copy groups: Q, then one per K/V tile, the first STAGES − 1 here
    const auto load_tile = [&](int j) {
        const int st = j % STAGES;
        load_rows<D, BK>(Ks + st * BK * QS, QS, kb, j * BK, sk);
        load_rows<D, BK>(Vs + st * BK * VS, VS, vb, j * BK, sk);
    };
    load_rows<D, BQ>(Qs, QS, qb, q0, sq);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
        if (j < ntiles) load_tile(j);
        cp_async_commit();
    }

    // this warp's m-tile mt of Q (16 rows) as an A fragment: rows g and
    // g + 8, columns 2t and 2t + 1 of a k8 step as the logical t and t + 4
    const float* Qw = Qs + WQ * rg * QS;
    const auto q_frag = [&](int mt, int ks) {
        const float* p = Qw + (16 * mt + g) * QS + 8 * ks + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(p);
        const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * QS);
        Frag<4> a;
        a.set(0, x0.x);
        a.set(1, x1.x);
        a.set(2, x0.y);
        a.set(3, x1.y);
        return a;
    };
    Frag<4> qreg[Q_IN_REGS ? KSTEPS : 1];
    if constexpr (Q_IN_REGS) {
        cp_async_wait<STAGES - 1>();  // Q (the first K/V tiles may still be in flight)
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) qreg[ks] = q_frag(0, ks);
    }

    // per m-tile: rows g (h = 0) and g + 8 (h = 1); m in base 2
    float m[MT][2], l[MT][2];
    float acc[MT][KSTEPS][4];  // O: m-tile, n8 tile, accumulator
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) m[mt][h] = kNegInf, l[mt][h] = 0.f;
#pragma unroll
        for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    }

    for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        // into the stage that tile j − 1 freed
        if (j + STAGES - 1 < ntiles) load_tile(j + STAGES - 1);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();  // tile j
        __syncthreads();

        const float* Kt = Ks + (st * BK + kc * KW) * QS;  // this warp's keys
        const float* Vt = Vs + (st * BK + kc * KW) * VS;

        // S = Q·Kᵀ for WQ rows × KW keys: lane (g, t) reads key row g of
        // each n8 tile, columns 2t and 2t + 1, as B's logical k t and t + 4;
        // each B fragment serves the warp's MT m-tiles
        float s[MT][NK][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NK; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
            Frag<4> a[MT];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                if constexpr (Q_IN_REGS) a[mt] = qreg[ks];
                else a[mt] = q_frag(mt, ks);
            }
#pragma unroll
            for (int nt = 0; nt < NK; ++nt) {
                const float2 x =
                    *reinterpret_cast<const float2*>(Kt + (8 * nt + g) * QS + 8 * ks + 2 * t);
                Frag<2> b;
                b.set(0, x.x);
                b.set(1, x.y);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma3(s[mt][nt], a[mt], b);
            }
        }


        // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3) of each
        // m-tile; lane t holds keys 8nt + 2t and 8nt + 2t + 1 of its slice
        const int key0 = j * BK + kc * KW + 2 * t;
        float corr[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            float mx[2] = {kNegInf, kNegInf}, ps[2] = {0.f, 0.f};
#pragma unroll
            for (int nt = 0; nt < NK; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float& x = s[mt][nt][e];
                    x = key0 + 8 * nt + (e & 1) < sk ? x * scale2 : kNegInf;
                    mx[e / 2] = fmaxf(mx[e / 2], x);
                }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
                const float m_new = fmaxf(m[mt][h], mx[h]);
                corr[mt][h] = exp2f(m[mt][h] - m_new);
                m[mt][h] = m_new;
            }
#pragma unroll
            for (int nt = 0; nt < NK; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float& x = s[mt][nt][e];
                    x = key0 + 8 * nt + (e & 1) < sk ? exp2f(x - m[mt][e / 2]) : 0.f;
                    ps[e / 2] += x;
                }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
                ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
                l[mt][h] = l[mt][h] * corr[mt][h] + ps[h];
            }
        }

        // O = O·corr + P·V: n8 tile nt of S is k8 step nt of P·V; each B
        // fragment of V serves the MT m-tiles. The tile's P·V is summed on
        // the tensor cores from zero and added to O·corr by an f32 FMA:
        // accumulated across all tiles on the tensor cores, O read up to
        // 1.6e-5 from the plain version at 4096 tokens, 0.7e-6 so (an H100,
        // ops/fwd_tf32_variants.py, "P·V summed across tiles")
        float pv[MT][KSTEPS][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) pv[mt][n][e] = 0.f;
#pragma unroll
        for (int nt = 0; nt < NK; ++nt) {
            Frag<4> a[MT];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                a[mt].set(0, s[mt][nt][0]);
                a[mt].set(1, s[mt][nt][2]);
                a[mt].set(2, s[mt][nt][1]);
                a[mt].set(3, s[mt][nt][3]);
            }
            const float* vp = Vt + (8 * nt + 2 * t) * VS + g;
#pragma unroll
            for (int n = 0; n < KSTEPS; ++n) {
                Frag<2> b;
                b.set(0, vp[8 * n]);
                b.set(1, vp[VS + 8 * n]);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) mma3(pv[mt][n], a[mt], b);
            }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    acc[mt][n][e] = fmaf(acc[mt][n][e], corr[mt][e / 2], pv[mt][n][e]);
        __syncthreads();  // stage st is free for tile j + STAGES
    }

    if constexpr (C > 1) {
        // the key slices' (O, m, l) merged into slice 0's warp of each row
        // group, through the idle K and V rings: lane-major, so conflict-free
        constexpr int PART = MT * (4 * KSTEPS + 4) * 32;
        if (kc > 0) {
            float* p = Ks + ((kc - 1) * R + rg) * PART + lane;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt, p += (4 * KSTEPS + 4) * 32) {
#pragma unroll
                for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) p[(4 * n + e) * 32] = acc[mt][n][e];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    p[(4 * KSTEPS + h) * 32] = m[mt][h];
                    p[(4 * KSTEPS + 2 + h) * 32] = l[mt][h];
                }
            }
        }
        __syncthreads();
        if (kc > 0) return;
#pragma unroll
        for (int c = 1; c < C; ++c) {
            const float* p = Ks + ((c - 1) * R + rg) * PART + lane;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt, p += (4 * KSTEPS + 4) * 32) {
                float f0[2], f1[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float mc = p[(4 * KSTEPS + h) * 32], lc = p[(4 * KSTEPS + 2 + h) * 32];
                    const float m_new = fmaxf(m[mt][h], mc);
                    f0[h] = exp2f(m[mt][h] - m_new);
                    f1[h] = exp2f(mc - m_new);
                    l[mt][h] = l[mt][h] * f0[h] + lc * f1[h];
                    m[mt][h] = m_new;
                }
#pragma unroll
                for (int n = 0; n < KSTEPS; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[mt][n][e] = acc[mt][n][e] * f0[e / 2] + p[(4 * n + e) * 32] * f1[e / 2];
            }
        }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = q0 + WQ * rg + 16 * mt + 8 * h + g;
            if (row >= sq) continue;
            float* orow = o + (bh * sq + row) * D + 2 * t;
#pragma unroll
            for (int n = 0; n < KSTEPS; ++n)
                *reinterpret_cast<float2*>(orow + 8 * n) =
                    make_float2(acc[mt][n][2 * h] / l[mt][h], acc[mt][n][2 * h + 1] / l[mt][h]);
            // K2: L = (m + log2 l)·ln 2, m being the base-2 running max
            if (lse != nullptr && t == 0)
                lse[bh * sq + row] = (m[mt][h] + log2f(l[mt][h])) * 0.6931471805599453f;
        }
}

// K1 or K2 at head dim D on blocks of R row groups of MT m-tiles (16 rows
// each) a warp, each tile's keys split over 4 / R warps.
template <int D, int R, int MT>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh,
           int sq, int sk, float scale, cudaStream_t stream) {
    constexpr int smem = kSmemFloats<D, 16 * R * MT> * int(sizeof(float));
    static_assert(smem <= 232448, "shared memory of one block");
    static_assert((NW / R - 1) * R * MT * (4 * (D / 8) + 4) * 32 <=
                      STAGES * kKeys<D> * (kQKStride<D> + kVStride<D>),
                  "the merge fits in the K and V rings");
    auto kernel = flash_fwd_tf32_rows_kernel<D, R, MT>;
    const cudaError_t err = flash::allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    const int rows = 16 * R * MT;
    const dim3 grid((sq + rows - 1) / rows, bh);
    kernel<<<grid, NT, smem, stream>>>(q, k, v, o, lse, sq, sk, scale);
    return int(cudaGetLastError());
}

}  // namespace

namespace flash {

// K1 (lse null) or K2 (lse (bh, sq) f32) on contiguous f32 q (bh, sq, d),
// k/v (bh, sk, d), o (bh, sq, d), 16-byte aligned, d one of
// pair_head_dim's; flash_fwd and flash_fwd_lse (flash_fwd.cu) route their
// f32 calls at those head dims here. Returns a cudaError_t code: 0 on a
// launch that was accepted.
int fwd_tf32x3_rows(const void* q, const void* k, const void* v, void* o, float* lse,
                    int bh, int sq, int sk, int d, float scale, cudaStream_t stream) {
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(o);
    // the block's query rows: 128 (at D ≤ 80) where there are at least 3
    // such blocks for every 2 SMs, 64 where they give every SM one, else 32
    const long long sms = tf32::sm_count(), n128 = (long long)((sq + 127) / 128) * bh;
    const int rows = 2 * n128 >= 3 * sms ? 128 : (long long)((sq + 63) / 64) * bh >= sms ? 64 : 32;
    return on_pair_head_dim(d, [&](auto dim) {
        constexpr int D = decltype(dim)::value;
        // 64 rows: at D ≤ 64 two row groups of two m-tiles, else four of one
        constexpr int R64 = D <= 64 ? 2 : 4, MT64 = D <= 64 ? 2 : 1;
        if constexpr (D <= 80) {
            if (rows == 128) return launch<D, 4, 2>(qf, kf, vf, of, lse, bh, sq, sk, scale, stream);
        }
        return rows >= 64 ? launch<D, R64, MT64>(qf, kf, vf, of, lse, bh, sq, sk, scale, stream)
                          : launch<D, 2, 1>(qf, kf, vf, of, lse, bh, sq, sk, scale, stream);
    });
}

}  // namespace flash
