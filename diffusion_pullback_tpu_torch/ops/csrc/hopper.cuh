// Hopper primitives of the tensor-core kernels: the wgmma kernels
// (flash_fwd_tc.cu, K1/K2; flash_jvp_tc.cu, K3; flash_bwd_tc.cu, K4/K5),
// bf16 at head dim 64, and the tf32x3 kernel (flash_fwd_tf32.cu, K1 in f32
// at head dim 512: mbarriers and bulk copies only). Inline PTX for shared
// memory addresses, mbarriers, TMA and bulk loads and wgmma, and the host's
// encoding of a TMA tensor map over (B·H, S, 64) bf16.
//
// Layout: a D = 64 bf16 row is 128 bytes, so TMA's 128-byte swizzle is the
// layout the wgmma descriptors read. A 64-row tile is 8 KB; a K-major
// operand advances its descriptor 32 bytes per k16 step inside the swizzle
// span, an MN-major one (the transpose bit) 16 rows (2048 bytes) per step.
//
// cuTensorMapEncodeTiled is reached through the runtime's
// cudaGetDriverEntryPoint, so the library does not link libcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

constexpr int D = 64;
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

// The box of `map` at (d 0, row, head) into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(head)
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
// the asynchronous wgmma (they are its operands from issue to wait).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
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

// Tensor map of a contiguous (heads, s, 64) bf16 array, innermost dimension
// first, with boxes of (64, TILE_ROWS, 1) in the 128-byte swizzle; rows past
// s read as zeros, so a ragged tile never reads the next head's rows.
inline cudaError_t head_map(CUtensorMap* map, const void* ptr, int heads, int s) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {D, cuuint64_t(s), cuuint64_t(heads)};
    const cuuint64_t strides[2] = {ROW, cuuint64_t(s) * ROW};
    const cuuint32_t box[3] = {D, TILE_ROWS, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
