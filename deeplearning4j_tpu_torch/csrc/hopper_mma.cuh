// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (csrc/flash_attention_fwd.cu, csrc/flash_attention_bwd.cu,
// csrc/flash_attention_bwd_dkv.cu): 16-byte cp.async copies into
// 128-byte-swizzled shared-memory panels, wgmma shared-memory descriptors,
// and the m64n64k16 bf16 wgmma with both operands in shared memory (SS) or
// A in registers (RS); and, for the same kernels' f32 FMA paths, padded f32
// row tiles and their float4 loads. csrc/conv1x1_bias_relu.cu takes its
// cp.async copies.
//
// A panel holds R rows of 64 bf16 values (128 bytes a row) in the layout of
// CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte group g of row r sits at
// r * 128 + ((g ^ (r % 8)) * 16), and a panel starts on a 1024-byte
// boundary. Wider rows (D = 128, 256) are NC panels side by side; D = 96
// is two panels whose last 32 columns are zero.
//
// Accumulator fragment of an m64nN f32 wgmma, thread t of the warpgroup
// (w = t / 32, g = (t % 32) / 4, c = t % 4): d[4j + e] is row 16w + g and
// d[4j + 2 + e] is row 16w + g + 8, both at column 8j + 2c + e (e = 0, 1).
// Registers 8kk..8kk+7 of such a fragment are, pairwise packed to bf16,
// the register A operand of the k-step kk of a following product.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace dl4j_sm90 {

constexpr int PANEL = 64;                  // bf16 columns in a panel
constexpr uint32_t ROW_BYTES = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte group g (0..7) of row r inside a swizzled panel
__device__ __forceinline__ uint32_t swz(int r, int g) {
    return (uint32_t)r * ROW_BYTES + ((uint32_t)(g ^ (r & 7)) << 4);
}

// 16 (or 4) bytes from global to shared memory, asynchronously; zeros when
// !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// makes this thread's generic-proxy writes to shared memory (cp.async's
// included, once waited for) visible to wgmma's async-proxy reads
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [t0, t0 + R) of a [seq, D] bf16 slab into NC = ceil(D / 64) swizzled
// panels of R rows at `dst`, zeros past seq and past D; thread `tid` of
// `nth` issues its share of the 16-byte copies
template <int D, int R>
__device__ __forceinline__ void load_panels(uint32_t dst,
                                            const __nv_bfloat16* src,
                                            int t0, int seq, int tid,
                                            int nth) {
    constexpr int G = ((D + PANEL - 1) / PANEL) * 8;   // groups a row
    for (int i = tid; i < R * G; i += nth) {
        const int r = i / G, g = i % G;
        const int t = t0 + r;
        const bool ok = t < seq && g * 8 < D;
        const __nv_bfloat16* s = ok ? src + (size_t)t * D + g * 8 : src;
        cp_async16(dst + (uint32_t)(g >> 3) * (R * ROW_BYTES) + swz(r, g & 7),
                   s, ok);
    }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. K-major operand
// (rows of 64 contiguous K values): sbo = 1024 (the next 8 rows), lbo
// unused; a k-step of 16 adds 32 bytes to the start address. MN-major
// operand (rows = K, 64 contiguous M/N values): sbo = 1024 (the next 8 K
// rows), lbo = the next 64 M/N columns' panel; a k-step adds 2048 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo,
                                         uint32_t sbo) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4)
           | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
           | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
           | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A[64x16] . B[16x64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d += A[64x16] . B[16x64], A in registers (four bf16 pairs a thread, the
// fragment above), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// the register A operand of k-step kk from an accumulator fragment,
// rounded to bf16
__device__ __forceinline__ void frag_to_a(const float (&d)[32], int kk,
                                          uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
        a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// f32 row tiles: D padded to a multiple of 64 columns (zeros past D), rows
// LD = DP + 4 floats apart, so the 16-byte loads of eight consecutive rows
// fall in eight different bank groups
template <int D> struct F32Rows {
    static constexpr int DP = ((D + 63) / 64) * 64;
    static constexpr int LD = DP + 4;
};

// rows [t0, t0 + R) of a [seq, D] f32 slab into rows of stride LD at dst,
// zeros past seq and from D to DP; thread `tid` of `nth` issues its share
template <int D, int R>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int t0, int seq, int tid,
                                              int nth) {
    constexpr int LD = F32Rows<D>::LD, G = F32Rows<D>::DP / 4;
    for (int i = tid; i < R * G; i += nth) {
        const int r = i / G, gi = i % G;
        const int t = t0 + r;
        const bool ok = t < seq && gi * 4 < D;
        cp_async16(smem_u32(dst + r * LD + gi * 4),
                   ok ? src + (size_t)t * D + gi * 4 : src, ok);
    }
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

}  // namespace dl4j_sm90
