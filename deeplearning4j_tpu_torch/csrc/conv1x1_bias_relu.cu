// Fused 1x1 convolution + bias + relu for Hopper (sm_90a), plain CUDA C++
// behind a C interface (loaded with ctypes by
// deeplearning4j_tpu_torch/ops/kernels/conv.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/kernels/conv.py
// `_conv1x1_pallas` (the pl.pallas_call) / `_conv_kernel`. Same function:
//   x [M, C] (the NHWC activation map as rows, M = N*H*W), W [C, F], b [F],
//   all f32 or all bf16;
//   out [M, F] = relu(x . W + b) in x's dtype, with the product accumulated
//   in f32 and the bias added in f32 before the relu and the one cast.
//   bf16 inputs are widened to f32 exactly, so both dtypes share one f32
//   FMA chain; the cast of the result rounds to nearest even.
//
// What bounds it on this card: 2*M*C*F flops against (M*C + C*F + F + M*F)
// elements moved. At f32 that is C*F / (2*(C + F)) flops per byte for large
// M against the card's balance of 67 TFLOP/s / 3.35 TB/s = 20: GoogLeNet's
// narrow convs (C 64-256, F 16-128) are bound by bytes, its wide ones (C
// 480-832, F 128-384) by operations. In bf16 every one of them is bound by
// bytes (the balance is 295 at 989 TFLOP/s) -- with tensor cores, which this
// kernel does not use.
//
// Design, and what it leaves for later: one thread block per 64x64 output
// tile, 256 threads, 4x4 outputs per thread (rows ty + 16*i, columns
// tx + 16*j, so a warp's stores are contiguous). The C axis is walked in
// steps of 16: each step stages a 64x16 tile of x (transposed, padded to an
// odd row stride) and a 16x64 tile of W in shared memory, converted to f32,
// then each thread does 16 x 16 scalar FMAs from registers. Ragged M, C and
// F are zero-filled on load and masked on store. The bias, relu and cast
// happen in registers and the output tile is written once. It uses neither
// tensor cores (wgmma; TF32 is out: the f32 pin is 1e-5) nor TMA, and does
// not double-buffer the next C step's loads: a later, faster version's work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;          // output rows (pixels) per block
constexpr int BN = 64;          // output channels per block
constexpr int BK = 16;          // input channels per shared-memory step
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1x1_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ b, T* __restrict__ out, int M, int C,
               int F) {
    __shared__ float xs[BK][BM + 1];    // x tile, transposed: [k][row]
    __shared__ float ws[BK][BN];        // W tile: [k][col]
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.x * BM, f0 = blockIdx.y * BN;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < C; k0 += BK) {
        // x tile: 64 rows x 16 channels, 16 consecutive channels per row
        // read by 16 neighbouring threads
#pragma unroll
        for (int l = 0; l < (BM * BK) / THREADS; ++l) {
            const int idx = tid + l * THREADS;
            const int r = idx / BK, kk = idx % BK;
            const int m = m0 + r, k = k0 + kk;
            xs[kk][r] = (m < M && k < C)
                ? to_f(x[(size_t)m * C + k]) : 0.0f;
        }
        // W tile: 16 channels x 64 outputs, a row's outputs contiguous
#pragma unroll
        for (int l = 0; l < (BK * BN) / THREADS; ++l) {
            const int idx = tid + l * THREADS;
            const int kk = idx / BN, c = idx % BN;
            const int k = k0 + kk, f = f0 + c;
            ws[kk][c] = (k < C && f < F) ? to_f(w[(size_t)k * F + f]) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

    // epilogue: bias in f32, relu, one cast, one write of the tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int f = f0 + tx + 16 * j;
        if (f >= F) continue;
        const float bias = to_f(b[f]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = m0 + ty + 16 * i;
            if (m >= M) continue;
            const float y = acc[i][j] + bias;
            out[(size_t)m * F + f] = from_f<T>(y > 0.0f ? y : 0.0f);
        }
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int M, int C, int F, cudaStream_t stream) {
    const dim3 grid((M + BM - 1) / BM, (F + BN - 1) / BN);
    conv1x1_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(out), M, C, F);
    return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). x [M, C], w [C, F], b [F] and out [M, F] are
// contiguous, all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1).
extern "C" int dl4j_conv1x1_bias_relu(const void* x, const void* w,
                                      const void* b, void* out, int M, int C,
                                      int F, int is_bf16, void* stream) {
    if (M < 1 || C < 1 || F < 1 || (F + BN - 1) / BN > 65535)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return (int)launch<__nv_bfloat16>(x, w, b, out, M, C, F, s);
    return (int)launch<float>(x, w, b, out, M, C, F, s);
}
