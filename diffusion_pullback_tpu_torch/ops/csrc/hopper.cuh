// Hopper primitives of the tensor-core kernels: the wgmma kernels, bf16
// at head dims 40, 64, 80, 128 and 160 (flash_fwd_tc.cu, K1/K2;
// flash_jvp_tc.cu, K3; flash_bwd_tc.cu, K4/K5), and the tf32x3 kernel
// (flash_fwd_tf32.cu, K1 in f32 at head dim 512: mbarriers and bulk copies
// only). Inline PTX for shared memory addresses,
// mbarriers, TMA and bulk loads and wgmma, the column panels of a row, and
// the host's encoding of a TMA tensor map over (B·H, S, D) bf16.
//
// Layout: a D = 64 bf16 row is 128 bytes, so TMA's 128-byte swizzle is the
// layout the wgmma descriptors read. A 64-row tile is 8 KB; a K-major
// operand advances its descriptor 32 bytes per k16 step inside the swizzle
// span, an MN-major one (the transpose bit) 16 rows (2048 bytes) per step.
// A row of another head dim (80, 160, 256 or 320 bytes at D = 40, 80, 128,
// 160) is held as ⌈D/64⌉ column panels of 64 columns, each such a tile
// (Panels): one TMA box per panel, the last one D % 64 columns wide where
// 64 does not divide D, so that no box reads past a row (TMA zero-fills a
// box that reaches past the row's end, but K1 then ran far slower on an
// H100: PERF.md §6). The panels cost a product with the head dim as its
// depth (Q·Kᵀ in the forward; S and the two products into Ṡ in K3; S and
// dP in K4, Sᵀ and dPᵀ in K5) 48/40 of its work at D = 40 (a k16 step over
// the zeroed columns 40–47) and nothing at the other head dims; the
// products with the head dim as their width run exactly D columns. So the
// forward (4·BH·Sq·Sk·D operations at the bf16 rate, 989 TFLOP/s) does
// 1.1× the bound's operations at D = 40, K3 (10·BH·Sq·Sk·D) 1.12×, K4
// (6·BH·Sq·Sk·D) 1.13× and K5 (8·BH·Sq·Sk·D) 1.10×.
//
// cuTensorMapEncodeTiled is reached through the runtime's
// cudaGetDriverEntryPoint, so the library does not link libcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

constexpr int D = 64;          // the width of a panel
constexpr int ROW = D * 2;     // bytes of a bf16 row: one 128-byte swizzle span
constexpr int TILE_ROWS = 64;  // rows of every TMA box and wgmma tile
constexpr int TILE = TILE_ROWS * ROW;
constexpr int MN_STEP = 16 * ROW >> 4;  // an MN-major k16 step, in descriptor units

// ---- PTX: shared memory, mbarriers, TMA ------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
                 : "memory");
}

// Makes the mbarrier initialisations visible to the TMA unit.
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// The box of `map` at (col, row, head) into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head, int col = 0) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head)
        : "memory");
}

// `bytes` (a multiple of 16) from global src into shared memory at dst, a
// 1-D bulk copy that completes on bar's transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// ---- PTX: wgmma ---------------------------------------------------------------

// Descriptor of a tile in TMA's 128-byte swizzle: 128-byte rows, 8-row
// groups 1024 bytes apart (SBO). LBO is not read for these layouts: a
// K-major k16 step stays inside the 128-byte span, and an MN-major tile is
// one 64-element span wide.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
    return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
           (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma (they are its operands from issue to wait): the
// first n of r (n a constant once unrolled).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N], int n = N) {
#pragma unroll
    for (int i = 0; i < N; ++i)
        if (i < n) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64×N, f32) = A·Bᵀ (+ d if acc), A and B K-major from shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
}

// d (64×64, f32) += A·B, A (64×16 bf16) from registers, B (16×64) from
// shared memory MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64_tb(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same with N = 16, 32 or 40 columns of B (the last panel of a
// forward tile at D = 80, 160 or 40): d holds N / 2 accumulators in the
// layout of the first N columns of the N = 64 product.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float* d, const uint32_t* a, uint64_t db) {
    wgmma_rs_n64_tb(d, a, db);
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<40>(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19"
        "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<32>(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<16>(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 × 64 f32 accumulator, rounded to bf16, as the A fragments of four
// k16 steps along its columns. In wgmma's accumulator layout this thread's
// element 4c + 2i + j is (r + 8i, 8c + 2·(lane % 4) + j), r = 16·warp +
// lane / 4; step kk's fragment is (r, 2q..), (r + 8, 2q..), (r, 8 + 2q..),
// (r + 8, 8 + 2q..) of columns 16kk.., straight from chunks 2kk and 2kk + 1.
__device__ __forceinline__ void acc_to_a(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) a[kk][t] = pack_bf16(s[8 * kk + 2 * t], s[8 * kk + 2 * t + 1]);
}

// ---- column panels ----------------------------------------------------------

// The panels of head dim DIM: P of them per 64-row tile (TB bytes), FULL
// of 64 columns and a last one of TAIL = DIM % 64 columns where that is not
// 0, TX bytes loaded per tile (TMA counts a narrow box's 128·TAIL bytes),
// KSTEPS k16 steps of a product whose depth is the head dim.
template <int DIM>
struct Panels {
    static constexpr int P = (DIM + D - 1) / D;
    static constexpr int FULL = DIM / D, TAIL = DIM % D;
    static constexpr int TB = P * TILE;
    static constexpr int TX = TILE_ROWS * DIM * 2;
    // columns of panel p, the N of a product whose width is the head dim
    __host__ __device__ static constexpr int width(int p) { return p < FULL ? D : TAIL; }
    static constexpr int KSTEPS = (DIM + 15) / 16;
    static_assert(DIM % 8 == 0 && P <= 3, "8-column output chunks, acc[P][32] in registers");
};

// Descriptor step to k16 step kk of a K-major tile: panel kk / 4, 32 bytes
// per step inside its swizzled rows.
__device__ __forceinline__ uint64_t k_step(int kk) {
    return uint64_t(kk / 4) * (TILE >> 4) + 2 * (kk % 4);
}

// The loads of one 64-row tile at `row` of head bh into the panels at dst:
// FULL boxes of 64 columns through `map`, then the TAIL columns through
// `tail`.
template <int DIM>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          const CUtensorMap* tail, uint32_t bar,
                                          int row, int bh) {
    using Pn = Panels<DIM>;
    for (int p = 0; p < Pn::FULL; ++p) tma_load(dst + p * TILE, map, bar, row, bh, D * p);
    if (Pn::TAIL) tma_load(dst + Pn::FULL * TILE, tail, bar, row, bh, D * Pn::FULL);
}

// Where 16 does not divide DIM (D = 40), the last k16 step of a K-major
// product reads the columns past DIM of the last panel, which TMA never
// writes: the block's NT threads zero that panel in the n tiles TB bytes
// apart from `first` (before any load into them), and fence the stores
// for the async proxy (wgmma, TMA). A NaN there would poison the product
// even against a zero in the other operand.
template <int DIM, int NT>
__device__ __forceinline__ void zero_tail_panels(uint32_t first, int n) {
    using Pn = Panels<DIM>;
    if constexpr (DIM % 16 != 0) {
        for (int t = 0; t < n; ++t)
            for (int e = threadIdx.x; e < TILE / 16; e += NT)
                asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(
                                 first + t * Pn::TB + (Pn::P - 1) * TILE + 16 * e),
                             "r"(0)
                             : "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
}

// d (panel p of a 64 × DIM accumulator, width(p) columns) += A·B, A (64×16
// bf16) from registers, B's panel p MN-major at db + p panels.
template <int DIM>
__device__ __forceinline__ void wgmma_rs_panel(float* d, const uint32_t* a, uint64_t db, int p) {
    using Pn = Panels<DIM>;
    if (p < Pn::FULL)
        wgmma_rs_n64_tb(d, a, db + p * (TILE >> 4));
    else
        wgmma_rs_tb<Pn::TAIL ? Pn::TAIL : D>(d, a, db + p * (TILE >> 4));
}

// The accumulators of a 64 × DIM output: panel p in the first width(p) / 2
// of acc[p].
template <int DIM>
using Acc = float[Panels<DIM>::P][32];

template <int DIM>
__device__ __forceinline__ void fence_panels(Acc<DIM>& acc) {
#pragma unroll
    for (int p = 0; p < Panels<DIM>::P; ++p) reg_fence(acc[p], Panels<DIM>::width(p) / 2);
}

// acc += A·Y for A in the A fragments of 64 columns and Y MN-major at y,
// panel by panel.
template <int DIM>
__device__ __forceinline__ void product_rs(Acc<DIM>& acc, const uint32_t (&a)[4][4],
                                           uint64_t y) {
#pragma unroll
    for (int p = 0; p < Panels<DIM>::P; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_panel<DIM>(acc[p], a[kk], y + kk * MN_STEP, p);
}

// acc = 0
template <int DIM>
__device__ __forceinline__ void zero(Acc<DIM>& acc) {
#pragma unroll
    for (int p = 0; p < Panels<DIM>::P; ++p)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
}

// ---- host side ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                    &found) != cudaSuccess ||
            found != cudaDriverEntryPointSuccess)
            return EncodeTiled(nullptr);
        return reinterpret_cast<EncodeTiled>(p);
    }();
    return fn;
}

// Tensor map of a contiguous (heads, s, d) bf16 array, innermost dimension
// first, with boxes of (cols, TILE_ROWS, 1) in the 128-byte swizzle: a box
// of 64 columns is one panel (the whole row at d = 64); a narrower box (the
// last panel's cols = d % 64 at d = 40, 80, 160) lands in shared memory in
// the same layout, 128-byte rows swizzled alike, and leaves the panel's
// other columns untouched. Rows past s read as zeros, so a ragged tile
// never reads the next head's rows; the box counts its whole 2·cols·64
// bytes toward the mbarrier, those zeros too. Rows are 2·d bytes apart, a
// multiple of 16 at d = 40, 64, 80, 128 and 160, as TMA requires.
inline cudaError_t head_map(CUtensorMap* map, const void* ptr, int heads, int s,
                            int d = D, int cols = D) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t row = cuuint64_t(d) * 2;
    const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(s), cuuint64_t(heads)};
    const cuuint64_t strides[2] = {row, cuuint64_t(s) * row};
    const cuuint32_t box[3] = {cuuint32_t(cols), TILE_ROWS, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
