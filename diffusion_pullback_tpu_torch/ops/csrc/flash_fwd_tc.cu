// Flash attention forward on Hopper's tensor cores, bf16 at head dim 64:
// O = softmax(Q Kᵀ · scale) V (K1) and, with LSE, also the row logsumexp
// L = m + log l (K2).
//
// For bf16 inputs at D = 64 (every U-Net self-attention of the SD path)
// this replaces the Pallas TPU kernels `_flash_kernel` / `_flash_forward`
// (K1) and `_flash_fwd_lse_kernel` / `_flash_forward_lse` (K2) in
// diffusion_pullback_tpu/ops/pallas/flash_attention.py; flash_fwd.cu's
// entries route those calls here. f32 inputs go to the "tf32x3" design at
// D = 512 (flash_fwd_tf32.cu) and stay on flash_fwd.cu's CUDA-core design
// at D = 64, as bf16 at D = 512 does: wgmma has no f32 operand, and one
// TF32 product keeps about 10 mantissa bits of an f32 product where three
// keep about 21.
//
// What bounds it: 4·BH·Sq·Sk·D operations on 2·(BH·Sq·D + BH·Sk·D) bf16
// elements, so at the path's shapes it is bound by operations, at the bf16
// tensor-core rate (989 TFLOP/s dense on an H100 SXM). The CUDA-core design
// computes in f32 FMAs and cannot pass their 67 TFLOP/s peak.
//
// Design "wgmma": a thread block owns BQ = 64 query rows of one head, with
// one consumer warpgroup (one wgmma M = 64) and one producer warp. The
// producer's lane 0 loads the Q tile once, and K and V through a ring of
// STAGES stages of BK = 64 keys, with TMA: 3-D tensor maps over
// (D, S, B·H), so a ragged tile is zero-filled inside its head and never
// reads the next head's rows. Each stage has a "full" mbarrier (the TMA
// bytes arrived) and an "empty" one (every consumer thread is done with
// it). A D = 64 bf16 row is 128 bytes, so TMA's 128-byte swizzle is the
// layout the wgmma descriptors read. For each key tile a consumer
// warpgroup computes
//   S = Q·Kᵀ    wgmma m64n64k16, A = Q and B = K from shared memory, both
//               K-major, f32 accumulators, D / 16 = 4 k-steps;
//   softmax     the Pallas kernel's arithmetic in f32, in base 2 with the
//               scale folded into log2(e): keys at or past sk masked to
//               NEG_INF, m_new, corr = 2^(m − m_new), P = 2^(t − m_new),
//               l summed from the unrounded P, the output accumulator
//               rescaled by corr, L = m·ln 2 + log l; each row lies on a
//               quad of 4 lanes and is reduced with two shuffles;
//   O += P·V    wgmma m64n64k16, A = P rounded to bf16 (the Pallas
//               kernel's p.astype(v.dtype)) repacked from the S
//               accumulators into register fragments of 16 keys, B = V
//               from shared memory, MN-major (the transpose bit).
// The epilogue writes O / l in bf16 (and L in f32) for rows below sq.
// Small blocks (64 × 64 tiles, 160 threads) let three share an SM by
// registers, so one block's softmax hides behind another's products; of
// the tilings 64 or 128 each way this one was the fastest, or near it, at
// every shape of the SD path on an H100.
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
// Q, STAGES × (K, V) and the mbarriers, plus 1024 bytes to align the tiles
// as the 128-byte swizzle requires
constexpr int SMEM = TILE + 2 * STAGES * TILE + 64 + 1024;

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

template <bool LSE>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int sq, int sk, float scale) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sK = sQ + TILE;             // stage s: + s·TILE
    const uint32_t sV = sK + STAGES * TILE;
    const uint32_t bars = sV + STAGES * TILE;  // full[], empty[], Q
    const auto full = [bars](int s) { return bars + 8u * s; };
    const auto empty = [bars](int s) { return bars + 8u * (STAGES + s); };
    const uint32_t qbar = bars + 8u * (2 * STAGES);

    const int q0 = blockIdx.x * BQ;
    const int bh = blockIdx.y;
    const int nk = (sk + BK - 1) / BK;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

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
            mbar_expect_tx(qbar, TILE);
            tma_load(sQ, &tq, qbar, q0, bh);
            for (int j = 0; j < nk; ++j) {
                const int s = j % STAGES;
                mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
                mbar_expect_tx(full(s), 2 * TILE);
                tma_load(sK + s * TILE, &tk, full(s), j * BK, bh);
                tma_load(sV + s * TILE, &tv, full(s), j * BK, bh);
            }
        }
        return;
    }

    // The consumer warpgroup. In wgmma's accumulator layout this thread
    // holds rows r and r + 8 (r = 16·warp + lane / 4) and, of each 8-column
    // chunk c, columns 8c + 2·(lane % 4) + {0, 1}: element 4c + 2i + j is
    // (r + 8i, 8c + 2q + j).
    const int qd = lane % 4;
    const int r = 16 * warp + lane / 4;
    const uint64_t dq = desc_sw128(sQ);

    float s[BK / 2];    // S (64 × BK), then P
    float acc[D / 2];   // O (64 × D)
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in base 2
    const float scale2 = scale * kLog2e;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

    mbar_wait(qbar, 0);
    for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES;
        const int k0 = j * BK;
        mbar_wait(full(st), (j / STAGES) & 1);

        // S = Q·Kᵀ: four k16 steps along d, 32 bytes apart in a swizzled row
        const uint64_t dk = desc_sw128(sK + st * TILE);
        reg_fence(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
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
        for (int e = 0; e < D / 2; ++e) acc[e] *= corr[(e / 2) & 1];

        // P in bf16 as A fragments of 16 keys
        uint32_t pa[BK / 16][4];
        acc_to_a(s, pa);

        // O += P·V: V's 16-key slices are 16 rows (2048 bytes) apart
        const uint64_t dv = desc_sw128(sV + st * TILE);
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs_n64_tb(acc, pa[kk], dv + kk * MN_STEP);
        wgmma_commit();
        wgmma_wait();
        reg_fence(acc);
        mbar_arrive(empty(st));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = q0 + r + 8 * i;
        if (row >= sq) continue;
        __nv_bfloat16* orow = o + (size_t(bh) * sq + row) * D;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
            *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * qd) =
                pack_bf16(acc[4 * c + 2 * i] / l[i], acc[4 * c + 2 * i + 1] / l[i]);
        if constexpr (LSE) {
            if (qd == 0) lse[size_t(bh) * sq + row] = m[i] * 0.6931471805599453f + logf(l[i]);
        }
    }
}

template <bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
           int sq, int sk, float scale, cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    cudaError_t err = head_map(&tq, q, bh, sq);
    if (err == cudaSuccess) err = head_map(&tk, k, bh, sk);
    if (err == cudaSuccess) err = head_map(&tv, v, bh, sk);
    if (err != cudaSuccess) return int(err);
    auto kernel = flash_fwd_wgmma_kernel<LSE>;
    err = flash::allow_smem(kernel, SMEM);
    if (err != cudaSuccess) return int(err);
    const dim3 grid((sq + BQ - 1) / BQ, bh);
    kernel<<<grid, NT, SMEM, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, sq, sk, scale);
    return int(cudaGetLastError());
}

}  // namespace

namespace flash {

// K1 (lse null) or K2 on contiguous bf16 q (bh, sq, 64), k/v (bh, sk, 64),
// o (bh, sq, 64), lse (bh, sq) f32, 16-byte aligned; flash_fwd and
// flash_fwd_lse (flash_fwd.cu) route their bf16 D = 64 calls here. Returns
// a cudaError_t code: 0 on a launch that was accepted.
int fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
              int bh, int sq, int sk, float scale, cudaStream_t stream) {
    return lse ? launch<true>(q, k, v, o, lse, bh, sq, sk, scale, stream)
               : launch<false>(q, k, v, o, lse, bh, sq, sk, scale, stream);
}

}  // namespace flash
