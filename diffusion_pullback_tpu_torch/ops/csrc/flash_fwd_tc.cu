// Flash attention forward on Hopper's tensor cores, bf16 at head dims 40,
// 64, 80, 128 and 160: O = softmax(Q Kᵀ · scale) V (K1) and, with LSE, also
// the row logsumexp L = m + log l (K2).
//
// For bf16 inputs at these head dims (the U-Net self-attentions: SD 2.1,
// SDXL and ADM-256 at 64, SD 1.5 at 40 / 80 / 160, ImageNet128Cond at 128)
// this replaces the Pallas TPU kernels `_flash_kernel` / `_flash_forward`
// (K1) and `_flash_fwd_lse_kernel` / `_flash_forward_lse` (K2) in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py; flash_fwd.cu's
// entries route those calls here. f32 inputs go to the "tf32x3" design
// (flash_fwd_tf32.cu at D = 512, flash_fwd_tf32_rows.cu at these head
// dims): wgmma has no f32 operand, and one TF32 product keeps about 10
// mantissa bits of an f32 product where three keep about 21.
//
// What bounds it: 4·BH·Sq·Sk·D operations on 2·(BH·Sq·D + BH·Sk·D) bf16
// elements, so at the path's shapes it is bound by operations, at the bf16
// tensor-core rate (989 TFLOP/s dense on an H100 SXM); f32 FMAs on the CUDA
// cores could not pass their 67 TFLOP/s peak.
//
// Design "wgmma": a thread block owns BQ = 64 query rows of one head, with
// one consumer warpgroup (one wgmma M = 64) and one producer warp. The
// producer's lane 0 loads the Q tile once, and K and V through a ring of
// STAGES stages of BK = 64 keys, with TMA: 3-D tensor maps over
// (D, S, B·H), so a ragged tile is zero-filled inside its head and never
// reads the next head's rows. Each stage has a "full" mbarrier (the TMA
// bytes arrived) and an "empty" one (every consumer thread is done with
// it). A tile is held as P = ⌈D/64⌉ column panels of 64 bf16 columns (8 KB
// in TMA's 128-byte swizzle, the layout the wgmma descriptors read), one
// TMA box each at column 64·p; where 64 does not divide D the last box is
// D % 64 columns wide (40, 16, 32 at D = 40, 80, 160), so no box reads
// past a row, and the panel's columns at or past D are never written (at
// D = 40 the block zeroes them in Q and K at its start). TMA lays a
// narrow box out as 128-byte rows in the same swizzle, and a tile's boxes
// count 128·D bytes toward their mbarrier. P is 1, 1, 2, 2 and 3 at D =
// 40, 64, 80, 128 and 160. For each key tile a consumer warpgroup computes
//   S = Q·Kᵀ    wgmma m64n64k16, A = Q and B = K from shared memory, both
//               K-major, f32 accumulators, over the ⌈D/16⌉ k-steps that
//               hold real columns (3, 4, 5, 8, 10; at D = 40 the third
//               reads the zeroed columns 40–47); step kk lies in panel
//               kk / 4, 32·(kk % 4) bytes into its swizzled rows;
//   softmax     the Pallas kernel's arithmetic in f32, in base 2 with the
//               scale folded into log2(e): keys at or past sk masked to
//               NEG_INF, m_new, corr = 2^(m − m_new), P = 2^(t − m_new),
//               l summed from the unrounded P, the output accumulator
//               rescaled by corr, L = m·ln 2 + log l; each row lies on a
//               quad of 4 lanes and is reduced with two shuffles;
//   O += P·V    one wgmma m64nNk16 per V panel and k-step into that
//               panel's accumulator block (acc[P][32]), N = 64 or, in the
//               last panel, its TAIL columns (m64n40k16 at D = 40), A = P
//               rounded to bf16 (the Pallas kernel's p.astype(v.dtype))
//               repacked from the S accumulators into register fragments
//               of 16 keys, B = V from shared memory, MN-major (the
//               transpose bit).
// The epilogue writes O / l in bf16 (and L in f32) for rows below sq and
// columns below D.
//
// What the panels cost: Q·Kᵀ runs 16·⌈D/16⌉ of D columns (48/40 at D = 40,
// exact at the others) and P·V exactly D, so the products do 1.1× the
// operations the bound counts at D = 40 and no more at 64–160. Shared
// memory holds Q and STAGES × (K, V): 40·P KB at two stages, so three
// blocks share an SM by registers at P = 1, two by shared memory at P = 2
// and one at P = 3 (120 KB); a third stage gained nothing at any D on an
// H100 (PERF.md §6). Small blocks (64 × 64 tiles, 160 threads) let blocks
// share an SM, so one block's softmax hides behind another's products; of
// the tilings 64 or 128 each way this one was the fastest, or near it, at
// every D = 64 shape of the SD path on an H100.
//
// Built with nvcc for sm_90a (wgmma exists only there) into the flash
// library; the PTX wrappers and the tensor maps are hopper.cuh's.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kLog2e;
using flash::kNegInf;
using namespace hopper;

constexpr int BQ = TILE_ROWS, BK = TILE_ROWS, STAGES = 2;
constexpr int NT = 128 + 32;  // the consumer warpgroup, the producer warp

// Shared memory of head dim DIM: Q and STAGES × (K, V) as Panels<DIM>
// tiles, the mbarriers, plus 1024 bytes to align the tiles as the 128-byte
// swizzle requires.
template <int DIM>
constexpr int SMEM = Panels<DIM>::TB * (1 + 2 * STAGES) + 64 + 1024;

// One key tile of the online softmax, on S in wgmma's accumulator layout
// (element 4c + 2i + j of this thread is row r + 8i, column 8c + 2q + j),
// in base 2: t = S·scale·log2(e), so m is the running max of t and
// P = 2^(t − m) = exp(S·scale − m·ln 2). Columns at or past kn (MASK) are
// set to NEG_INF and their P to 0. S becomes the unrounded P; l gains its
// row sums; corr is 2^(m_prev − m_new), the accumulator's rescale.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale2, int kn, int qd) {
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float t = s[4 * c + e] * scale2;
            if (MASK && 8 * c + 2 * qd + (e & 1) >= kn) t = kNegInf;
            s[4 * c + e] = t;
            mx[e / 2] = fmaxf(mx[e / 2], t);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float p = exp2f(s[4 * c + e] - m[e / 2]);
            if (MASK && 8 * c + 2 * qd + (e & 1) >= kn) p = 0.f;
            s[4 * c + e] = p;
            ps[e / 2] += p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
        l[i] = l[i] * corr[i] + ps[i];
    }
}

// ---- the kernel -------------------------------------------------------------

// tq, tk, tv: boxes of 64 columns; tq_t, tk_t, tv_t: of the TAIL columns
// (unused where TAIL is 0).
template <int DIM, bool LSE>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tq_t,
                       const __grid_constant__ CUtensorMap tk_t,
                       const __grid_constant__ CUtensorMap tv_t,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int sq, int sk, float scale) {
    using Pn = Panels<DIM>;
    constexpr int P = Pn::P, TB = Pn::TB;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sK = sQ + TB;             // stage s: + s·TB, panel p: + p·TILE
    const uint32_t sV = sK + STAGES * TB;
    const uint32_t bars = sV + STAGES * TB;  // full[], empty[], Q
    const auto full = [bars](int s) { return bars + 8u * s; };
    const auto empty = [bars](int s) { return bars + 8u * (STAGES + s); };
    const uint32_t qbar = bars + 8u * (2 * STAGES);

    const int q0 = blockIdx.x * BQ;
    const int bh = blockIdx.y;
    const int nk = (sk + BK - 1) / BK;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    zero_tail_panels<DIM, NT>(sQ, 1 + STAGES);  // Q and every K stage, for Q·Kᵀ
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 128);
        }
        mbar_init(qbar, 1);
        mbar_init_fence();
    }
    __syncthreads();

    if (warp == 4) {  // the producer warp
        if (lane == 0) {
            mbar_expect_tx(qbar, Pn::TX);
            load_tile<DIM>(sQ, &tq, &tq_t, qbar, q0, bh);
            for (int j = 0; j < nk; ++j) {
                const int s = j % STAGES;
                mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
                mbar_expect_tx(full(s), 2 * Pn::TX);
                load_tile<DIM>(sK + s * TB, &tk, &tk_t, full(s), j * BK, bh);
                load_tile<DIM>(sV + s * TB, &tv, &tv_t, full(s), j * BK, bh);
            }
        }
        return;
    }

    // The consumer warpgroup. In wgmma's accumulator layout this thread
    // holds rows r and r + 8 (r = 16·warp + lane / 4) and, of each 8-column
    // chunk c, columns 8c + 2·(lane % 4) + {0, 1}: element 4c + 2i + j is
    // (r + 8i, 8c + 2q + j); acc[p] holds columns 64p.. of O.
    const int qd = lane % 4;
    const int r = 16 * warp + lane / 4;
    const uint64_t dq = desc_sw128(sQ);

    float s[BK / 2];     // S (64 × BK), then P
    float acc[P][D / 2]; // O (64 × DIM): panel p in its first width(p) / 2
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in base 2
    const float scale2 = scale * kLog2e;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[p][e] = 0.f;

    mbar_wait(qbar, 0);
    for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES;
        const int k0 = j * BK;
        mbar_wait(full(st), (j / STAGES) & 1);

        // S = Q·Kᵀ over the k16 steps that hold columns below DIM
        const uint64_t dk = desc_sw128(sK + st * TB);
        reg_fence(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Pn::KSTEPS; ++kk)
            wgmma_ss_n64(s, dq + k_step(kk), dk + k_step(kk), kk > 0);
        wgmma_commit();
        wgmma_wait();
        reg_fence(s);

        // online softmax over this tile's keys; only the last tile can be ragged
        float corr[2];
        if (k0 + BK <= sk)
            softmax_tile<false>(s, m, l, corr, scale2, 0, qd);
        else
            softmax_tile<true>(s, m, l, corr, scale2, sk - k0, qd);
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
            for (int e = 0; e < Pn::width(p) / 2; ++e) acc[p][e] *= corr[(e / 2) & 1];

        // P in bf16 as A fragments of 16 keys
        uint32_t pa[BK / 16][4];
        acc_to_a(s, pa);

        // O += P·V, panel by panel: V's 16-key slices are 16 rows (2048
        // bytes) apart
        const uint64_t dv = desc_sw128(sV + st * TB);
#pragma unroll
        for (int p = 0; p < P; ++p) reg_fence(acc[p], Pn::width(p) / 2);
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                wgmma_rs_panel<DIM>(acc[p], pa[kk], dv + kk * MN_STEP, p);
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int p = 0; p < P; ++p) reg_fence(acc[p], Pn::width(p) / 2);
        mbar_arrive(empty(st));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = q0 + r + 8 * i;
        if (row >= sq) continue;
        __nv_bfloat16* orow = o + (size_t(bh) * sq + row) * DIM;
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
            for (int c = 0; c < D / 8; ++c) {
                if (D * p + 8 * c >= DIM) continue;  // the panel's zero columns
                *reinterpret_cast<uint32_t*>(orow + D * p + 8 * c + 2 * qd) = pack_bf16(
                    acc[p][4 * c + 2 * i] / l[i], acc[p][4 * c + 2 * i + 1] / l[i]);
            }
        if constexpr (LSE) {
            if (qd == 0) lse[size_t(bh) * sq + row] = m[i] * 0.6931471805599453f + logf(l[i]);
        }
    }
}

template <int DIM, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
           int sq, int sk, float scale, cudaStream_t stream) {
    // boxes of 64 columns (m[0..2]) and of the last panel's TAIL (m[3..5])
    constexpr int tail = Panels<DIM>::TAIL;
    CUtensorMap m[6];
    const void* ptr[3] = {q, k, v};
    const int rows[3] = {sq, sk, sk};
    cudaError_t err = cudaSuccess;
    for (int i = 0; i < (tail ? 6 : 3) && err == cudaSuccess; ++i)
        err = head_map(&m[i], ptr[i % 3], bh, rows[i % 3], DIM, i < 3 ? D : tail);
    if (err != cudaSuccess) return int(err);
    const int t = tail ? 3 : 0;
    auto kernel = flash_fwd_wgmma_kernel<DIM, LSE>;
    constexpr int smem = SMEM<DIM>;
    err = flash::allow_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sq + BQ - 1) / BQ, bh);
    kernel<<<grid, NT, smem, stream>>>(
        m[0], m[1], m[2], m[t], m[t + 1], m[t + 2], static_cast<__nv_bfloat16*>(o), lse,
        sq, sk, scale);
    return int(cudaGetLastError());
}

template <int DIM>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
             int sq, int sk, float scale, cudaStream_t stream) {
    return lse ? launch<DIM, true>(q, k, v, o, lse, bh, sq, sk, scale, stream)
               : launch<DIM, false>(q, k, v, o, lse, bh, sq, sk, scale, stream);
}

}  // namespace

namespace flash {

// K1 (lse null) or K2 on contiguous bf16 q (bh, sq, d), k/v (bh, sk, d),
// o (bh, sq, d), lse (bh, sq) f32, 16-byte aligned, at d = 40, 64, 80, 128
// or 160; flash_fwd and flash_fwd_lse (flash_fwd.cu) route their bf16
// calls at those head dims here. Returns a cudaError_t code: 0 on a launch
// that was accepted, cudaErrorInvalidValue at any other d.
int fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
              int bh, int sq, int sk, int d, float scale, cudaStream_t stream) {
    switch (d) {
        case 40: return launch_d<40>(q, k, v, o, lse, bh, sq, sk, scale, stream);
        case 64: return launch_d<64>(q, k, v, o, lse, bh, sq, sk, scale, stream);
        case 80: return launch_d<80>(q, k, v, o, lse, bh, sq, sk, scale, stream);
        case 128: return launch_d<128>(q, k, v, o, lse, bh, sq, sk, scale, stream);
        case 160: return launch_d<160>(q, k, v, o, lse, bh, sq, sk, scale, stream);
    }
    return int(cudaErrorInvalidValue);
}

}  // namespace flash
