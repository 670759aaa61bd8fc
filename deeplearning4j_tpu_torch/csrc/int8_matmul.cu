// int8 x int8 -> int32 matmul with the per-row x per-column rescale, for
// Hopper (sm_90a), plain CUDA C++ behind a C interface (loaded with ctypes
// by deeplearning4j_tpu_torch/ops/kernels/quantized.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/kernels/quantized.py
// `int8_matmul_pallas` (the pl.pallas_call) / `_matmul_kernel`. Same
// function:
//   x_q [M, K] int8, w_q [K, N] int8, x_scale [M] f32, w_scale [N] f32;
//   acc = x_q . w_q summed exactly in int32;
//   out [M, N] f32 = (float(acc) * x_scale[m]) * w_scale[n], in that order,
//   so the result is bitwise the plain version's (the reference pins this
//   kernel at 0.0).
//
// What bounds it on this card: 2*M*K*N int8 operations against
// M*K + K*N bytes in, 4*M*N bytes out and 4*(M + N) bytes of scales. At the
// int8 serving net's widths (M <= 256, K 512, N 256-512) that is at most
// ~110 operations a byte against the card's balance of 1979 TOP/s /
// 3.35 TB/s = 590: bound by bytes, with tensor cores; this kernel uses the
// CUDA cores' __dp4a, whose int8 rate is far below the tensor cores'.
//
// Design, and what it leaves for later: one thread block per 64x64 output
// tile, 256 threads, 4x4 outputs per thread (rows ty + 16*i, columns
// tx + 16*j). K is walked in steps of 32: each step packs four consecutive
// k of a row of x, and four consecutive k of a column of w (w is stored
// [K, N], so its tile is transposed on the way in), into one 32-bit word in
// shared memory; each __dp4a then adds four int8 products into an int32
// accumulator. Ragged M and N are guarded, and a K that is not a multiple
// of 32 (or of 4) is padded with zeros in shared memory, which adds nothing
// to an exact sum. The rescale is in registers and the tile is written
// once. mma.sync / wgmma s8 x s8 -> s32 on the tensor cores, TMA and
// double-buffered loads are a later, faster version's work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // k per shared-memory step (8 packed words)
constexpr int KW = BK / 4;      // packed words per row of a tile
constexpr int LDW = KW + 1;     // padded word stride (odd: no bank conflicts)
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t byte_at(const int8_t* p, bool ok) {
    return ok ? (uint32_t)(uint8_t)(*p) : 0u;
}

__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ xq,
                   const int8_t* __restrict__ wq,
                   const float* __restrict__ xs,
                   const float* __restrict__ ws, float* __restrict__ out,
                   int M, int K, int N) {
    __shared__ int32_t as[BM][LDW];     // x tile: [row][k/4], 4 k a word
    __shared__ int32_t bs[BN][LDW];     // w tile, transposed: [col][k/4]
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

    int32_t acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < K; k0 += BK) {
        // x tile: 64 rows x 8 words; a row's words read by 8 neighbours
#pragma unroll
        for (int l = 0; l < (BM * KW) / THREADS; ++l) {
            const int idx = tid + l * THREADS;
            const int r = idx / KW, kw = idx % KW;
            const int m = m0 + r, k = k0 + 4 * kw;
            const int8_t* p = xq + (size_t)m * K + k;
            uint32_t word = 0;
            if (m < M) {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    word |= byte_at(p + q, k + q < K) << (8 * q);
            }
            as[r][kw] = (int32_t)word;
        }
        // w tile: 8 words x 64 columns; neighbouring threads read
        // neighbouring columns of one k row
#pragma unroll
        for (int l = 0; l < (BN * KW) / THREADS; ++l) {
            const int idx = tid + l * THREADS;
            const int c = idx % BN, kw = idx / BN;
            const int n = n0 + c, k = k0 + 4 * kw;
            uint32_t word = 0;
            if (n < N) {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    word |= byte_at(wq + (size_t)(k + q) * N + n, k + q < K)
                            << (8 * q);
            }
            bs[c][kw] = (int32_t)word;
        }
        __syncthreads();
#pragma unroll
        for (int kw = 0; kw < KW; ++kw) {
            int32_t a[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = as[ty + 16 * i][kw];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = bs[tx + 16 * j][kw];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = __dp4a(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

    // epilogue: (float(acc) * x_scale[m]) * w_scale[n], one write
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= M) continue;
        const float sx = xs[m];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n >= N) continue;
            const float y = __fmul_rn(__int2float_rn(acc[i][j]), sx);
            out[(size_t)m * N + n] = __fmul_rn(y, ws[n]);
        }
    }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). All arrays are contiguous: x_q [M, K] and w_q
// [K, N] int8, x_scale [M] and w_scale [N] f32, out [M, N] f32.
extern "C" int dl4j_int8_matmul(const void* xq, const void* wq,
                                const void* xs, const void* ws, void* out,
                                int M, int K, int N, void* stream) {
    if (M < 1 || K < 1 || N < 1 || (N + BN - 1) / BN > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    int8_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
        static_cast<const float*>(xs), static_cast<const float*>(ws),
        static_cast<float*>(out), M, K, N);
    return (int)cudaGetLastError();
}
