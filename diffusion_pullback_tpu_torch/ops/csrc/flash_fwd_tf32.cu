// Flash attention forward (K1, and K2 with the row logsumexp) on Hopper's
// tensor cores for f32 at head dim 512, the VAE mid-block's single head:
// O = softmax(Q Kᵀ · scale) V, and L = m + log l when lse is not null.
//
// For f32 inputs at D = 512 this replaces the Pallas TPU kernels
// `_flash_kernel` / `_flash_forward` (K1) and `_flash_fwd_lse_kernel` /
// `_flash_forward_lse` (K2, which ring attention runs per ring step on the
// VAE's shards) in diffusion_pullback_tpu/ops/pallas/flash_attention.py;
// flash_fwd.cu's entries route those calls here. Same arithmetic: online
// softmax per query row in f32, logits never written to device memory, the
// probabilities unrounded before P·V (`p.astype(v.dtype)` is a no-op in
// f32), output in f32, L in natural log.
//
// What bounds it: 4·BH·Sq·Sk·D operations on 4·BH·S·D f32 elements, so it
// is bound by operations. f32-accurate products run on the tensor cores as
// three TF32 products ("3xTF32", tf32.cuh): each operand x is split into
// hi = tf32(x) and lo = tf32(x − hi), and a·b is a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi (the small terms first) with f32 accumulation, which keeps
// about 21 mantissa bits of each product where one TF32 product keeps 10.
// The least time is then the operations at a third of the TF32 rate
// (494.7 / 3 ≈ 164.9 TFLOP/s dense on an H100 SXM).
//
// Design "tf32x3": mma.sync m16n8k8 TF32 (Hopper's TF32 wgmma takes only
// K-major operands, and V is MN-major in P·V). A block owns BQ = 32 query
// rows (so (1, 4096, 512) still fills 128 SMs) and loops over key tiles of
// BK = 32, with 8 warps; each warp owns 64 of the 512 D columns:
//   S = Q·Kᵀ   each warp sums over its own 64 columns of D for the whole
//              32 × 32 tile; warps w and w + 4 add their partial sums into
//              slot w % 4 of shared memory (warp w stores, then warp w + 4
//              adds: shared-memory float atomics are compare-and-swap loops
//              on this card);
//   softmax    8 lanes a row over the four slots' sum, in base 2 with the
//              scale folded into log2(e): the running max m and normaliser
//              l of each row; P split into TF32 hi and lo once, and the
//              rescale corr, into shared memory;
//   O += P·V   each warp's 32 × 64 slice of O stays in registers (64 f32 a
//              thread), rescaled by corr, with P (32 × 32) and its V columns
//              read from shared memory.
// The Q tile (64 KB of f32) is loaded once; K and V have one buffer each,
// filled by 1-D bulk copies (one a row, four started by each warp, on an
// mbarrier a buffer) so that the next K tile loads under the softmax
// and P·V, and the next V tile under Q·Kᵀ. Rows past the sequence are not
// copied: the buffers start zeroed, so such rows hold zeros or an earlier
// tile's finite values, which the mask (keys) or the bounds of the store
// (queries) discard. The row strides make every fragment load free
// of bank conflicts: inside each 8- or 16-element chunk of the k dimension
// a lane reads adjacent elements as the logical columns t and t + 4, for A
// and B alike, so a fragment is one float4 or float2 load. 226.6 KB of
// shared memory, 256 threads, one block per SM. flash_fwd_tf32_rows.cu
// serves the narrower head dims, where warps own query rows instead.
//
// Built with nvcc for sm_90a into the flash library.

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using flash::kLog2e;
using flash::kNegInf;
using tf32::Frag;
using tf32::mma3;

constexpr int D = 512;
constexpr int BQ = 32, BK = 32;
constexpr int NW = 8, NT = 32 * NW;
constexpr int DW = D / NW;       // D columns a warp owns
constexpr int SLOTS = NW / 2;    // partial sums of S: warps w and w + 4 share slot w
// row strides in floats: Q and K (float4 fragments), V (scalar), the S
// slots and P (float2 fragments); each row 16-byte aligned for the copies
constexpr int QS = D + 16, VS = D + 4, SS = BK + 8, PS = BK + 8;
constexpr int SMEM_FLOATS =
    BQ * QS + BK * QS + BK * VS + SLOTS * BQ * SS + 2 * BQ * PS + BQ;
constexpr int SMEM = SMEM_FLOATS * 4 + 24;  // and the K, V and Q mbarriers

// Rows [row0, row0 + 32) below n of a contiguous (n, D) f32 matrix into
// shared memory at dst (row stride ld floats), completing on bar, whose
// bytes thread 0 announces: lanes 0–3 of warp w copy rows 4w..4w+3 (a warp
// starts its copies one lane at a time, so one warp starting all 32 holds
// up the block). Called by every thread.
__device__ __forceinline__ void copy_rows(uint32_t dst, int ld, const float* src, int row0,
                                          int n, uint32_t bar) {
    const int lane = threadIdx.x % 32, r = 4 * (threadIdx.x / 32) + lane;
    if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, max(0, min(32, n - row0)) * D * 4);
    if (lane < 4 && row0 + r < n)
        hopper::bulk_load(dst + 4u * r * ld, src + size_t(row0 + r) * D, D * 4, bar);
}

// ---- the kernel -------------------------------------------------------------

__global__ void __launch_bounds__(NT, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int sq, int sk, float scale) {
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;                  // [BQ][QS]
    float* Ks = Qs + BQ * QS;          // [BK][QS]
    float* Vs = Ks + BK * QS;          // [BK][VS]
    float* Ss = Vs + BK * VS;          // [SLOTS][BQ][SS] partial sums of S
    float* Ph = Ss + SLOTS * BQ * SS;  // [BQ][PS] P's TF32 hi
    float* Pl = Ph + BQ * PS;          // [BQ][PS] P's TF32 lo
    float* row_f = Pl + BQ * PS;       // [BQ] corr per tile, then l
    const uint32_t sQ = hopper::smem_u32(Qs), sK = hopper::smem_u32(Ks),
                   sV = hopper::smem_u32(Vs);
    const uint32_t kbar = hopper::smem_u32(row_f + BQ), vbar = kbar + 8, qbar = kbar + 16;

    const int q0 = blockIdx.x * BQ;
    const size_t bh = blockIdx.y;
    const float* qb = q + bh * sq * D;
    const float* kb = k + bh * sk * D;
    const float* vb = v + bh * sk * D;
    const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
    // softmax layout: 8 lanes a row, 4 columns each
    const int srow = tid / 8, scol = 4 * (tid % 8);
    const float scale2 = scale * kLog2e;
    float* slot = Ss + (w % SLOTS) * BQ * SS;

    // zero Q, K and V (rows that are never copied), then the first tiles
    for (int e = tid; e < (BQ * QS + BK * QS + BK * VS) / 4; e += NT)
        reinterpret_cast<float4*>(smem)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (tid == 0) {
        hopper::mbar_init(kbar, 1);
        hopper::mbar_init(vbar, 1);
        hopper::mbar_init(qbar, 1);
        hopper::mbar_init_fence();
    }
    __syncthreads();
    copy_rows(sQ, QS, qb, q0, sq, qbar);
    copy_rows(sK, QS, kb, 0, sk, kbar);
    copy_rows(sV, VS, vb, 0, sk, vbar);

    float m = kNegInf, l = 0.f;  // this softmax row's state, m in base 2
    float acc[2][8][4];          // O: m-tile (16 rows), n-tile (8 columns)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    hopper::mbar_wait(qbar, 0);
    for (int j = 0, k0 = 0; k0 < sk; ++j, k0 += BK) {
        hopper::mbar_wait(kbar, j & 1);  // this K tile

        // S over this warp's 64 columns of D: chunks of 16, two k8 steps
        // each; lane t reads columns 4t..4t+3 of a chunk, step st takes
        // 4t + 2st and 4t + 2st + 1 as the logical columns t and t + 4
        float s[2][4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
        for (int c = 0; c < DW / 16; ++c) {
            const int d0 = DW * w + 16 * c + 4 * t;
            float4 qa[2][2], kv[4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    qa[mt][h] = *reinterpret_cast<const float4*>(Qs + (16 * mt + 8 * h + g) * QS + d0);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
                kv[nt] = *reinterpret_cast<const float4*>(Ks + (8 * nt + g) * QS + d0);
#pragma unroll
            for (int st = 0; st < 2; ++st) {
                Frag<4> a[2];
                Frag<2> b[4];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    a[mt].set(0, st ? qa[mt][0].z : qa[mt][0].x);
                    a[mt].set(1, st ? qa[mt][1].z : qa[mt][1].x);
                    a[mt].set(2, st ? qa[mt][0].w : qa[mt][0].y);
                    a[mt].set(3, st ? qa[mt][1].w : qa[mt][1].y);
                }
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    b[nt].set(0, st ? kv[nt].z : kv[nt].x);
                    b[nt].set(1, st ? kv[nt].w : kv[nt].y);
                }
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt) mma3(s[mt][nt], a[mt], b[nt]);
            }
        }
        // the partial sums into the slots: warp w stores, then warp w + 4
        // adds (element (row, col) of a fragment at slot[row·SS + col])
        const auto at = [&](int mt, int nt, int h) {
            return reinterpret_cast<float2*>(slot + (16 * mt + 8 * h + g) * SS + 8 * nt + 2 * t);
        };
        if (w < SLOTS) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        *at(mt, nt, h) = make_float2(s[mt][nt][2 * h], s[mt][nt][2 * h + 1]);
        }
        __syncthreads();  // the K buffer is free

        if (k0 + BK < sk) copy_rows(sK, QS, kb, k0 + BK, sk, kbar);
        if (w >= SLOTS) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        float2* p = at(mt, nt, h);
                        const float2 x = *p;
                        *p = make_float2(x.x + s[mt][nt][2 * h], x.y + s[mt][nt][2 * h + 1]);
                    }
        }
        __syncthreads();  // S is summed in the slots

        // online softmax of row srow over columns scol..scol+3; keys at or
        // past sk are masked
        {
            float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int sl = 0; sl < SLOTS; ++sl) {
                const float4 p = *reinterpret_cast<const float4*>(Ss + (sl * BQ + srow) * SS + scol);
                x[0] += p.x;
                x[1] += p.y;
                x[2] += p.z;
                x[3] += p.w;
            }
            float mx = kNegInf;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                x[e] = k0 + scol + e < sk ? x[e] * scale2 : kNegInf;
                mx = fmaxf(mx, x[e]);
            }
#pragma unroll
            for (int off = 1; off < 8; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m, mx);
            const float corr = exp2f(m - m_new);
            float ps = 0.f;
            Frag<4> p;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                x[e] = k0 + scol + e < sk ? exp2f(x[e] - m_new) : 0.f;
                ps += x[e];
                p.set(e, x[e]);
            }
#pragma unroll
            for (int off = 1; off < 8; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
            l = l * corr + ps;
            m = m_new;
            *reinterpret_cast<uint4*>(Ph + srow * PS + scol) =
                make_uint4(p.hi[0], p.hi[1], p.hi[2], p.hi[3]);
            *reinterpret_cast<uint4*>(Pl + srow * PS + scol) =
                make_uint4(p.lo[0], p.lo[1], p.lo[2], p.lo[3]);
            if (scol == 0) row_f[srow] = corr;
        }
        hopper::mbar_wait(vbar, j & 1);  // this V tile
        __syncthreads();

        // O = O·corr + P·V over this warp's 64 columns: k8 steps of keys;
        // lane t takes keys 2t and 2t + 1 of a step as the logical t, t + 4
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float cr = row_f[16 * mt + 8 * h + g];
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    acc[mt][nt][2 * h] *= cr;
                    acc[mt][nt][2 * h + 1] *= cr;
                }
            }
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
            const int kr = 8 * ks + 2 * t;
            Frag<4> a[2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                const int r0 = (16 * mt + g) * PS + kr, r1 = r0 + 8 * PS;
                const uint2 h0 = *reinterpret_cast<const uint2*>(Ph + r0);
                const uint2 h1 = *reinterpret_cast<const uint2*>(Ph + r1);
                const uint2 l0 = *reinterpret_cast<const uint2*>(Pl + r0);
                const uint2 l1 = *reinterpret_cast<const uint2*>(Pl + r1);
                a[mt].hi[0] = h0.x, a[mt].hi[1] = h1.x, a[mt].hi[2] = h0.y, a[mt].hi[3] = h1.y;
                a[mt].lo[0] = l0.x, a[mt].lo[1] = l1.x, a[mt].lo[2] = l0.y, a[mt].lo[3] = l1.y;
            }
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                const float* vp = Vs + kr * VS + DW * w + 8 * nt + g;
                Frag<2> b;
                b.set(0, vp[0]);
                b.set(1, vp[VS]);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) mma3(acc[mt][nt], a[mt], b);
            }
        }
        __syncthreads();  // the V buffer, P and corr are free

        if (k0 + BK < sk) copy_rows(sV, VS, vb, k0 + BK, sk, vbar);
    }

    if (scol == 0) {
        row_f[srow] = l;
        // K2: L = (m + log2 l)·ln 2, m being the base-2 running max
        if (lse != nullptr && q0 + srow < sq)
            lse[bh * sq + q0 + srow] = (m + log2f(l)) * 0.6931471805599453f;
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = 16 * mt + 8 * h + g;
            if (q0 + row >= sq) continue;
            const float lr = row_f[row];
            float* orow = o + (bh * sq + q0 + row) * D + DW * w + 2 * t;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
                *reinterpret_cast<float2*>(orow + 8 * nt) =
                    make_float2(acc[mt][nt][2 * h] / lr, acc[mt][nt][2 * h + 1] / lr);
        }
}

}  // namespace

namespace flash {

// K1 (lse null) or K2 (lse (bh, sq) f32) on contiguous f32 q (bh, sq, 512),
// k/v (bh, sk, 512), o (bh, sq, 512), 16-byte aligned; flash_fwd and
// flash_fwd_lse (flash_fwd.cu) route their f32 D = 512 calls here. Returns
// a cudaError_t code: 0 on a launch that was accepted.
int fwd_tf32x3(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
               int sq, int sk, float scale, cudaStream_t stream) {
    const cudaError_t err = allow_smem(flash_fwd_tf32x3_kernel, SMEM);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sq + BQ - 1) / BQ, bh);
    flash_fwd_tf32x3_kernel<<<grid, NT, SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk, scale);
    return int(cudaGetLastError());
}

}  // namespace flash
