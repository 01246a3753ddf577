// Flash attention forward on Hopper's tensor cores for bf16 at head dim
// 512, the VAE mid-block's single head: O = softmax(Q Kᵀ · scale) V (K1),
// and the same with the row logsumexp L = m + log l in f32 (K2).
//
// For bf16 inputs at D = 512 (a VAE built in bf16, `sd_vae(dtype=
// "bfloat16")`) this replaces the Pallas TPU kernels `_flash_kernel` /
// `_flash_forward` (K1: the VAE's attention) and `_flash_fwd_lse_kernel` /
// `_flash_forward_lse` (K2: ring attention's inner over the shards of that
// head) in diffusion_pullback_tpu/ops/pallas/flash_attention.py;
// flash_fwd.cu's entries route those calls here. Same arithmetic: online
// softmax per query row in f32, logits never written to device memory, the
// probabilities rounded to bf16 before P·V (the Pallas kernel's
// `p.astype(v.dtype)`) while the row sum l takes them unrounded, f32
// accumulation, the output rounded to bf16; K2's L from the f32 state of
// each row, on the scaled logits with the natural log.
//
// What bounds it: 4·BH·Sq·Sk·D operations on 4·BH·S·D bf16 elements, so it
// is bound by operations at the dense bf16 tensor-core rate (989 TFLOP/s on
// an H100 SXM).
//
// Design "mma_bf16": mma.sync m16n8k16 bf16 with f32 accumulators, in the
// layout of flash_fwd_tf32.cu (K1 in f32 at D = 512) with one bf16 product
// in place of three TF32 ones. The wgmma kernel of the narrower head dims
// (flash_fwd_tc.cu) holds at most three 64-column panels of a row, and one
// warpgroup's 64 × 512 f32 O would take 256 registers a thread. Here a block
// owns BQ = 32 query rows (so (1, 4096, 512) still fills 128 SMs) and loops
// over key tiles of BK = 32, with 8 warps; each warp owns 64 of the 512 D
// columns:
//   S = Q·Kᵀ   each warp sums over its own 64 columns of D for the whole
//              32 × BK tile and stores its partial sums into a slot of
//              shared memory of its own (one barrier a tile; flash_fwd_tf32.cu
//              shares a slot between two warps, which its f32 tiles need);
//   softmax    8 lanes a row over the eight slots' sum, in base 2 with the
//              scale folded into log2(e): the running max m and normaliser
//              l of each row; P rounded to bf16, and the rescale corr, into
//              shared memory;
//   O += P·V   each warp's 32 × 64 slice of O stays in registers (64 f32 a
//              thread), rescaled by corr, with P and its V columns read from
//              shared memory.
// Every fragment is read with ldmatrix (V, the MN-major B operand of P·V,
// with .trans); the bf16 rows of Q, K and V are D + 8 elements apart (1040
// bytes ≡ 16 mod 128), so the eight rows of each 8 × 8 matrix fall in eight
// different 16-byte bank groups. The Q tile (32 KB) is loaded once, and
// each warp keeps its A fragments of Q in registers; K and V stream through
// a ring of STAGES stages, filled by 1-D bulk copies (one a row, started by
// BK / 8 lanes of every warp, on an mbarrier a buffer): tile j + STAGES's K
// loads once tile j's Q·Kᵀ is done, its V once tile j's P·V is. Rows past
// the sequence are not copied: the buffers start zeroed, so such rows hold
// zeros or an earlier tile's finite values, which the mask (keys) or the
// bounds of the store (queries) discard. 256 threads, one block per SM.
//
// Built with nvcc for sm_90a into the flash library.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::kLog2e;
using flash::kNegInf;

constexpr int D = 512;
constexpr int BQ = 32, BK = 32;  // query rows of a block, keys of a tile
constexpr int STAGES = 2;        // of the K and V ring
constexpr int NW = 8, NT = 32 * NW;
constexpr int DW = D / NW;     // D columns a warp owns
// slots of partial sums of S: one a warp (with NW / 2, warps w and w + 4
// share slot w, w adding into it after w + 4 stored: a smaller tile of
// shared memory for one more barrier a tile)
constexpr int SLOTS = NW;
constexpr int NK = BK / 8;     // n8 tiles of S
constexpr int SC = BK / 8;     // columns of a softmax lane
// row strides in elements: Q, K and V (bf16), the S slots (f32), P (bf16)
constexpr int QS = D + 8, SS = BK + 8, PS = BK + 8;
constexpr int SMEM = (BQ + 2 * STAGES * BK) * QS * 2 + SLOTS * BQ * SS * 4 + BQ * PS * 2 +
                     BQ * 4 + 8 * (2 * STAGES + 1);  // and the K, V and Q mbarriers

// Four 8 × 8 b16 matrices of shared memory into a fragment: lane i names
// row i % 8 of matrix i / 8, and receives row i / 4, columns 2·(i % 4) and
// 2·(i % 4) + 1 of each (with .trans the transposed matrices').
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d (16 × 8) += a (16 × 16) · b (16 × 8), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + ROWS) below n of a contiguous (n, D) bf16 matrix into
// shared memory at dst (row stride QS), completing on bar, whose bytes
// thread 0 announces: lanes 0 … ROWS / 8 − 1 of warp w copy rows ROWS / 8 · w
// on (a warp starts its copies one lane at a time, so one warp starting
// them all holds up the block). Called by every thread.
template <int ROWS>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* src, int row0, int n,
                                          uint32_t bar) {
    constexpr int PER = ROWS / NW;
    const int lane = threadIdx.x % 32, r = PER * (threadIdx.x / 32) + lane;
    if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, max(0, min(ROWS, n - row0)) * D * 2);
    if (lane < PER && row0 + r < n)
        hopper::bulk_load(dst + 2u * r * QS, src + size_t(row0 + r) * D, D * 2, bar);
}

__global__ void __launch_bounds__(NT, 1)
flash_fwd_mma_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int sq, int sk, float scale) {
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);                    // [BQ][QS]
    bf16* Ks = Qs + BQ * QS;                                     // [STAGES][BK][QS]
    bf16* Vs = Ks + STAGES * BK * QS;                            // [STAGES][BK][QS]
    float* Ss = reinterpret_cast<float*>(Vs + STAGES * BK * QS);  // [SLOTS][BQ][SS] partial S
    bf16* Ps = reinterpret_cast<bf16*>(Ss + SLOTS * BQ * SS);    // [BQ][PS] P, rounded
    float* row_f = reinterpret_cast<float*>(Ps + BQ * PS);       // [BQ] corr per tile, then l
    const uint32_t sQ = hopper::smem_u32(Qs), sK = hopper::smem_u32(Ks),
                   sV = hopper::smem_u32(Vs), sP = hopper::smem_u32(Ps);
    // mbarriers: K of each stage, V of each stage, Q
    const uint32_t kbar = hopper::smem_u32(row_f + BQ), vbar = kbar + 8 * STAGES,
                   qbar = vbar + 8 * STAGES;
    constexpr uint32_t TILE = 2u * BK * QS;  // bytes of a K or V tile

    const int q0 = blockIdx.x * BQ;
    const size_t bh = blockIdx.y;
    const bf16* qb = q + bh * sq * D;
    const bf16* kb = k + bh * sk * D;
    const bf16* vb = v + bh * sk * D;
    const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator row group, column pair
    // softmax layout: 8 lanes a row, SC columns each
    const int srow = tid / 8, scol = SC * (tid % 8);
    const float scale2 = scale * kLog2e;
    float* slot = Ss + (w % SLOTS) * BQ * SS;
    // this lane's ldmatrix rows and columns: A (16 rows × k16) of Q and P,
    // B of S (two n8 tiles of keys × k16 of D) from K, B of P·V (k16 of keys
    // × two n8 tiles of D) from V with .trans
    const int a_row = lane % 16, a_col = 8 * (lane / 16);
    const int k_row = lane % 8 + 8 * (lane / 16), k_col = 8 * (lane / 8 % 2);
    const int v_row = lane % 8 + 8 * (lane / 8 % 2), v_col = 8 * (lane / 16);

    // zero Q, K and V (rows that are never copied), then the first tiles
    for (int e = tid; e < (BQ + 2 * STAGES * BK) * QS * 2 / 16; e += NT)
        reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (tid == 0) {
        for (int s = 0; s < 2 * STAGES + 1; ++s) hopper::mbar_init(kbar + 8 * s, 1);
        hopper::mbar_init_fence();
    }
    __syncthreads();
    copy_rows<BQ>(sQ, qb, q0, sq, qbar);
#pragma unroll
    for (int s = 0; s < STAGES; ++s)
        if (s * BK < sk) {
            copy_rows<BK>(sK + s * TILE, kb, s * BK, sk, kbar + 8 * s);
            copy_rows<BK>(sV + s * TILE, vb, s * BK, sk, vbar + 8 * s);
        }

    float m = kNegInf, l = 0.f;  // this softmax row's state, m in base 2
    float acc[2][8][4];          // O: m-tile (16 rows), n-tile (8 columns)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    // this warp's A fragments of Q: m-tile, k16 step of its 64 columns
    hopper::mbar_wait(qbar, 0);
    uint32_t qa[2][DW / 16][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int kk = 0; kk < DW / 16; ++kk)
            ldsm_x4(qa[mt][kk], sQ + 2u * ((16 * mt + a_row) * QS + DW * w + 16 * kk + a_col));

    for (int j = 0, k0 = 0; k0 < sk; ++j, k0 += BK) {
        const int st = j % STAGES;
        const uint32_t parity = (j / STAGES) & 1;
        const uint32_t sKt = sK + st * TILE, sVt = sV + st * TILE;
        hopper::mbar_wait(kbar + 8 * st, parity);  // this K tile

        // S over this warp's 64 columns of D, four k16 steps
        float s[2][NK][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NK; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DW / 16; ++kk) {
            const int c0 = DW * w + 16 * kk;
#pragma unroll
            for (int np = 0; np < NK / 2; ++np) {
                uint32_t b[4];
                ldsm_x4(b, sKt + 2u * ((16 * np + k_row) * QS + c0 + k_col));
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    mma(s[mt][2 * np], qa[mt][kk], b[0], b[1]);
                    mma(s[mt][2 * np + 1], qa[mt][kk], b[2], b[3]);
                }
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
                for (int nt = 0; nt < NK; ++nt)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        *at(mt, nt, h) = make_float2(s[mt][nt][2 * h], s[mt][nt][2 * h + 1]);
        }
        __syncthreads();  // stage st's K is free (and with a slot a warp, S is in the slots)

        if (k0 + STAGES * BK < sk)
            copy_rows<BK>(sKt, kb, k0 + STAGES * BK, sk, kbar + 8 * st);
        if constexpr (SLOTS < NW) {
            if (w >= SLOTS) {
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            float2* p = at(mt, nt, h);
                            const float2 x = *p;
                            *p = make_float2(x.x + s[mt][nt][2 * h], x.y + s[mt][nt][2 * h + 1]);
                        }
            }
            __syncthreads();  // S is summed in the slots
        }

        // online softmax of row srow over columns scol … scol + SC − 1; keys
        // at or past sk are masked
        {
            float x[SC];
#pragma unroll
            for (int e = 0; e < SC; ++e) x[e] = 0.f;
#pragma unroll
            for (int sl = 0; sl < SLOTS; ++sl)
#pragma unroll
                for (int e4 = 0; e4 < SC; e4 += 4) {
                    const float4 p = *reinterpret_cast<const float4*>(
                        Ss + (sl * BQ + srow) * SS + scol + e4);
                    x[e4] += p.x;
                    x[e4 + 1] += p.y;
                    x[e4 + 2] += p.z;
                    x[e4 + 3] += p.w;
                }
            float mx = kNegInf;
#pragma unroll
            for (int e = 0; e < SC; ++e) {
                x[e] = k0 + scol + e < sk ? x[e] * scale2 : kNegInf;
                mx = fmaxf(mx, x[e]);
            }
#pragma unroll
            for (int off = 1; off < 8; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m, mx);
            const float corr = exp2f(m - m_new);
            float ps = 0.f;
            uint32_t packed[SC / 2];
#pragma unroll
            for (int e = 0; e < SC; e += 2) {
                const float p0 = k0 + scol + e < sk ? exp2f(x[e] - m_new) : 0.f;
                const float p1 = k0 + scol + e + 1 < sk ? exp2f(x[e + 1] - m_new) : 0.f;
                ps += p0 + p1;
                packed[e / 2] = hopper::pack_bf16(p0, p1);
            }
#pragma unroll
            for (int off = 1; off < 8; off <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
            l = l * corr + ps;
            m = m_new;
#pragma unroll
            for (int e = 0; e < SC / 2; e += 2)
                *reinterpret_cast<uint2*>(Ps + srow * PS + scol + 2 * e) =
                    make_uint2(packed[e], packed[e + 1]);
            if (scol == 0) row_f[srow] = corr;
        }
        hopper::mbar_wait(vbar + 8 * st, parity);  // this V tile
        __syncthreads();

        // O = O·corr + P·V over this warp's 64 columns, k16 steps of keys
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
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
                ldsm_x4(a[mt], sP + 2u * ((16 * mt + a_row) * PS + 16 * kk + a_col));
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t b[4];
                ldsm_x4_t(b, sVt + 2u * ((16 * kk + v_row) * QS + DW * w + 16 * np + v_col));
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    mma(acc[mt][2 * np], a[mt], b[0], b[1]);
                    mma(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
                }
            }
        }
        __syncthreads();  // stage st's V, P and corr are free

        if (k0 + STAGES * BK < sk)
            copy_rows<BK>(sVt, vb, k0 + STAGES * BK, sk, vbar + 8 * st);
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
            const float inv = 1.f / row_f[row];
            bf16* orow = o + (bh * sq + q0 + row) * D + DW * w + 2 * t;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
                *reinterpret_cast<uint32_t*>(orow + 8 * nt) =
                    hopper::pack_bf16(acc[mt][nt][2 * h] * inv, acc[mt][nt][2 * h + 1] * inv);
        }
}

}  // namespace

namespace flash {

// K1 (lse null) or K2 (lse (bh, sq) f32) on contiguous bf16 q (bh, sq,
// 512), k/v (bh, sk, 512), o (bh, sq, 512), 16-byte aligned; flash_fwd and
// flash_fwd_lse (flash_fwd.cu) route their bf16 D = 512 calls here. Returns
// a cudaError_t code: 0 on a launch that was accepted.
int fwd_mma_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                 int sq, int sk, float scale, cudaStream_t stream) {
    static_assert(SMEM <= 232448, "shared memory of one block");
    const cudaError_t err = allow_smem(flash_fwd_mma_bf16_kernel, SMEM);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sq + BQ - 1) / BQ, bh);
    flash_fwd_mma_bf16_kernel<<<grid, NT, SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, sq, sk, scale);
    return int(cudaGetLastError());
}

}  // namespace flash
