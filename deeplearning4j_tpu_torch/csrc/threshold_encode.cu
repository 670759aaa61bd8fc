// Threshold encode for Hopper (sm_90a), plain CUDA C++ behind a C interface
// (loaded with ctypes by deeplearning4j_tpu_torch/ops/threshold_encode.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_compression.py
// `threshold_encode_pallas` (the pl.pallas_call) / `_encode_kernel`. Same
// function, one pass over a flat residual r[n] (f32 or bf16) with the
// threshold t already rounded to r's dtype by the caller:
//   s        = sign(r) where |r| >= t, else +0      (in r's dtype)
//   signs[i] = int8(s)                               in {-1, 0, +1}
//   res[i]   = r - s * t                             (in r's dtype)
// It must equal the plain version bit for bit, so: NaN compares false,
// keeps sign 0 and stays in the residual; a zero keeps its own sign as
// sign(r) (which matters only at t == 0, where -0 - (-0 * 0) is +0);
// s * t is exact (s is 0 or +-1) and the subtraction rounds once, in f32
// for f32 and from the f32 difference to bf16 for bf16 (the difference of
// two bf16 values within 2^16 of each other is exact in f32, and beyond
// that the smaller one is below half a bf16 ulp either way).
//
// What bounds it on this card: bytes. Each element is read once and
// written twice (4 + 1 + 4 bytes in f32, 2 + 1 + 2 in bf16) for three
// compares and one subtraction, so the least time is 9 (5) bytes an
// element over 3.35 TB/s.
//
// Design: a grid-stride loop in which a thread takes 16 bytes of r at a
// time (four f32 or eight bf16) and writes 16 bytes of residual and 4 or 8
// bytes of signs, neighbouring threads on neighbouring addresses; the
// ragged tail past the last whole vector is done one element at a time by
// the first threads. The wide path needs r and res aligned to 16 bytes
// and signs to the vector's sign bytes; a row of an [n, P] carry with odd
// P is not, and then the same loop runs one element at a time (4-byte
// accesses are still coalesced). No shared memory, no tensor cores, no
// TMA: there is nothing to reuse.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;     // a few waves of resident blocks

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// One element: its sign byte and its new residual. `t` is exact in T.
template <typename T>
__device__ __forceinline__ void encode_one(T rin, float t, signed char& sign,
                                           T& res) {
    const float r = to_f(rin);
    float s = 0.f;
    if (fabsf(r) >= t)                   // false for NaN
        s = r > 0.f ? 1.f : (r < 0.f ? -1.f : r);    // a zero keeps its sign
    sign = (signed char)(int)s;
    res = from_f<T>(__fsub_rn(r, __fmul_rn(s, t)));
}

template <typename T> struct SignVec;            // the signs of 16 bytes of T
template <> struct SignVec<float> { using type = uint32_t; };
template <> struct SignVec<__nv_bfloat16> { using type = uint2; };

template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS)
threshold_encode_kernel(const T* __restrict__ r, signed char* __restrict__ signs,
                        T* __restrict__ res, long long n, float t) {
    constexpr int V = 16 / sizeof(T);
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long step = (long long)gridDim.x * THREADS;
    long long done = 0;
    if constexpr (WIDE) {
        using SV = typename SignVec<T>::type;
        const long long nvec = n / V;
        for (long long i = tid; i < nvec; i += step) {
            __align__(16) T in[V];
            __align__(16) T out[V];
            __align__(8) signed char sg[V];
            *reinterpret_cast<uint4*>(in) = reinterpret_cast<const uint4*>(r)[i];
#pragma unroll
            for (int j = 0; j < V; ++j) encode_one<T>(in[j], t, sg[j], out[j]);
            reinterpret_cast<uint4*>(res)[i] = *reinterpret_cast<uint4*>(out);
            reinterpret_cast<SV*>(signs)[i] = *reinterpret_cast<SV*>(sg);
        }
        done = nvec * V;
    }
    for (long long i = done + tid; i < n; i += step)
        encode_one<T>(r[i], t, signs[i], res[i]);
}

template <typename T>
cudaError_t launch(const void* r, void* signs, void* res, long long n,
                   float t, cudaStream_t stream) {
    constexpr int V = 16 / sizeof(T);
    const bool wide = (reinterpret_cast<uintptr_t>(r) % 16 == 0)
                      && (reinterpret_cast<uintptr_t>(res) % 16 == 0)
                      && (reinterpret_cast<uintptr_t>(signs) % V == 0);
    const long long work = wide ? (n + V - 1) / V : n;
    long long blocks = (work + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    if (blocks < 1) blocks = 1;
    if (wide)
        threshold_encode_kernel<T, true><<<(int)blocks, THREADS, 0, stream>>>(
            static_cast<const T*>(r), static_cast<signed char*>(signs),
            static_cast<T*>(res), n, t);
    else
        threshold_encode_kernel<T, false><<<(int)blocks, THREADS, 0, stream>>>(
            static_cast<const T*>(r), static_cast<signed char*>(signs),
            static_cast<T*>(res), n, t);
    return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). `threshold` is the threshold already rounded to
// the residual's dtype (a bf16 value is exact in float). `res` must not
// overlap `r`.
extern "C" int dl4j_threshold_encode(const void* r, void* signs, void* res,
                                     long long n, float threshold,
                                     int is_bf16, void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return (int)launch<__nv_bfloat16>(r, signs, res, n, threshold, s);
    return (int)launch<float>(r, signs, res, n, threshold, s);
}
