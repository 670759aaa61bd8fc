// Fused 1x1 convolution + bias + relu for Hopper (sm_90a), CUDA C++ behind
// a C interface (loaded with ctypes by
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
// narrow convs (F 16-48) are bound by bytes, its wide ones by operations.
// The serving path is f32 under a 1e-5 pin, so the products stay on full
// f32 FMAs: TF32 keeps about three digits.
//
// Design: a GEMM with the bias, relu and cast in its epilogue, planned per
// shape on the host (ops/kernels/conv.py `tile_plan`, from M, C, F and the
// SM count), which picks one of three compiled tile shapes, BM x BN = 64 x
// 32, 64 x 64 or 128 x 32 (a narrow F takes a narrow tile, not a 64-wide
// one that is mostly zeros), and a split of C, so that every SM holds a
// few blocks. A block of 128 threads owns a BM x BN output tile; each
// thread a TM x 4 micro-tile (8 x 4, or 4 x 4 at 64 x 32), rows TY apart
// and columns as one float4 group, so one 16-byte shared load feeds 4 FMAs
// on both sides and the fully unrolled C step keeps the next loads in
// flight under the FMAs. C is walked in steps of 32 through a three-stage
// ring of cp.async copies (16-byte copies where rows of x and W are
// 16-byte multiples, 4-byte ones for f32 otherwise, plain loads for bf16
// otherwise), so two steps' loads are in flight while one is multiplied.
// The x tile is kept as rows of 32 channels padded by 4 words, so a warp's
// float4 reads of 2-4 rows fall in distinct banks; the W tile as rows of
// BN output channels, read by consecutive threads. Ragged M, C and F are
// zero-filled on load and masked on store. Small tiles of 128 threads
// were measured against 128-row tiles of 256 threads with 8 x 8
// micro-tiles: the small ones let 3-5 blocks share an SM and hide the
// loads' latency better on these short-C products.
//
// Split C: where the output tiles are too few to fill the card (the 7x7
// convs: M = 1568, 25-50 tiles against 132 SMs, each looping over C = 832),
// the plan splits C over the S <= 8 blocks of a thread-block cluster. Each
// block multiplies its share of C into an f32 partial tile in its own
// shared memory; after a cluster barrier the blocks reduce the tile
// together, each taking every S-th group of four outputs and adding the S
// partials through distributed shared memory in rank order (rank 0 first),
// then the bias, relu and cast. No atomics: the order of every sum is fixed
// by the plan, so results are the same from run to run.
//
// Left for later: bf16 on the tensor cores (wgmma; no path runs K7 in
// bf16), a 3xTF32 split for f32 on wgmma, TMA and a persistent grid.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>

#include <atomic>

#include "hopper_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace dl4j_sm90;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int BK = 32;                  // input channels a step
constexpr int STAGES = 3;
constexpr int MAX_SPLITS = 8;           // blocks of a portable cluster

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// four consecutive values from shared memory, widened to f32
__device__ __forceinline__ float4 ld4f(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4f(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

// relu(acc + bias) for four consecutive outputs of one row, cast, stored
// with one 16 (8) byte write where all four lie inside F and `vec`
__device__ __forceinline__ void store4(float* out, float4 y, int f, int F,
                                      bool vec) {
    if (vec && f + 3 < F) {
        *reinterpret_cast<float4*>(out) = y;
    } else {
        const float e[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (f + u < F) out[u] = e[u];
    }
}
__device__ __forceinline__ void store4(bf16* out, float4 y, int f, int F,
                                       bool vec) {
    if (vec && f + 3 < F) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
        uint2 u;
        u.x = *reinterpret_cast<uint32_t*>(&lo);
        u.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(out) = u;
    } else {
        const float e[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (f + u < F) out[u] = __float2bfloat16(e[u]);
    }
}

__device__ __forceinline__ float4 bias_relu(float4 a, const float (&bias)[4]) {
    return make_float4(fmaxf(a.x + bias[0], 0.f), fmaxf(a.y + bias[1], 0.f),
                       fmaxf(a.z + bias[2], 0.f), fmaxf(a.w + bias[3], 0.f));
}

template <typename T, int BM, int BN> struct Cfg {
    static constexpr int TX = BN / 4;              // threads along F
    static constexpr int TY = THREADS / TX;        // threads along M
    static constexpr int TM = BM / TY;             // rows a thread
    static constexpr int PAD = 16 / sizeof(T);     // 16 bytes, in elements
    static constexpr int LDA = BK + PAD;           // x tile row, elements
    static constexpr int LDB = BN;                 // W tile row, elements
    static constexpr int LDP = BN + 4;             // partial tile row, floats
    static constexpr size_t STAGE =
        ((size_t)BM * LDA + (size_t)BK * LDB) * sizeof(T);
    static constexpr size_t PART = (size_t)BM * LDP * sizeof(float);
    static constexpr size_t SMEM =
        STAGES * STAGE > PART ? STAGES * STAGE : PART;
    static_assert(TX * TY == THREADS && TM * TY == BM && TM >= 1,
                  "tile and threads disagree");
};

// x rows [m0, m0 + BM) x channels [k0, k0 + BK) and W channels
// [k0, k0 + BK) x outputs [f0, f0 + BN) into a stage; zeros from M, k_end
// and F on. VEC: 16-byte copies (rows are 16-byte multiples, pointers
// aligned); else 4-byte cp.async for f32, plain loads for bf16.
template <typename T, int BM, int BN, bool VEC>
__device__ __forceinline__ void load_stage(T* sA, T* sB,
                                           const T* __restrict__ x,
                                           const T* __restrict__ w, int M,
                                           int C, int F, int m0, int f0,
                                           int k0, int k_end, int tid) {
    using G = Cfg<T, BM, BN>;
    if constexpr (VEC) {
        constexpr int E = 16 / sizeof(T);          // elements a copy
        constexpr int AG = BK / E, BG = BN / E;
        for (int i = tid; i < BM * AG; i += THREADS) {
            const int r = i / AG, kk = (i % AG) * E;
            const int m = m0 + r, kc = k0 + kk;
            const bool ok = m < M && kc < k_end;
            cp_async16(smem_u32(sA + r * G::LDA + kk),
                       ok ? x + (size_t)m * C + kc : x, ok);
        }
        for (int i = tid; i < BK * BG; i += THREADS) {
            const int kk = i / BG, n = (i % BG) * E;
            const int kc = k0 + kk, f = f0 + n;
            const bool ok = kc < k_end && f < F;
            cp_async16(smem_u32(sB + kk * G::LDB + n),
                       ok ? w + (size_t)kc * F + f : w, ok);
        }
    } else {
        for (int i = tid; i < BM * BK; i += THREADS) {
            const int r = i / BK, kk = i % BK;
            const int m = m0 + r, kc = k0 + kk;
            const bool ok = m < M && kc < k_end;
            const T* src = ok ? x + (size_t)m * C + kc : x;
            if constexpr (sizeof(T) == 4) {
                cp_async4(smem_u32(sA + r * G::LDA + kk), src, ok);
            } else {
                sA[r * G::LDA + kk] = ok ? *src : T(0.f);
            }
        }
        for (int i = tid; i < BK * BN; i += THREADS) {
            const int kk = i / BN, n = i % BN;
            const int kc = k0 + kk, f = f0 + n;
            const bool ok = kc < k_end && f < F;
            const T* src = ok ? w + (size_t)kc * F + f : w;
            if constexpr (sizeof(T) == 4) {
                cp_async4(smem_u32(sB + kk * G::LDB + n), src, ok);
            } else {
                sB[kk * G::LDB + n] = ok ? *src : T(0.f);
            }
        }
    }
}

template <typename T, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv1x1_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ b, T* __restrict__ out, int M, int C,
               int F, int k_per) {
    using G = Cfg<T, BM, BN>;
    constexpr int TM = G::TM, TY = G::TY;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* stage0 = reinterpret_cast<T*>(smem_raw);
    const int tid = threadIdx.x;
    const int tx = tid % G::TX, ty = tid / G::TX;   // columns 4tx.., rows ty + TY*i
    const int m0 = blockIdx.x * BM, f0 = blockIdx.y * BN;
    const int splits = gridDim.z, rank = blockIdx.z;
    const int k_begin = rank * k_per;
    const int k_end = min(C, k_begin + k_per);
    const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

    auto sA = [&](int s) { return stage0 + s * (G::STAGE / sizeof(T)); };
    auto sB = [&](int s) { return sA(s) + BM * G::LDA; };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk)
            load_stage<T, BM, BN, VEC>(sA(s), sB(s), x, w, M, C, F, m0, f0,
                                       k_begin + s * BK, k_end, tid);
        cp_async_commit();
    }

    float4 acc[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();     // this thread's copies of step kt
        __syncthreads();                 // everyone's; step kt - 1 consumed
        const int nxt = kt + STAGES - 1;
        if (nxt < nk)
            load_stage<T, BM, BN, VEC>(sA(nxt % STAGES), sB(nxt % STAGES), x,
                                       w, M, C, F, m0, f0,
                                       k_begin + nxt * BK, k_end, tid);
        cp_async_commit();
        const T* a_t = sA(kt % STAGES);
        const T* b_t = sB(kt % STAGES);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 4) {
            float4 a[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i)
                a[i] = ld4f(a_t + (ty + TY * i) * G::LDA + kk);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float4 bv = ld4f(b_t + (kk + u) * G::LDB + 4 * tx);
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const float av = u == 0 ? a[i].x : u == 1 ? a[i].y
                                   : u == 2 ? a[i].z : a[i].w;
                    acc[i].x = fmaf(av, bv.x, acc[i].x);
                    acc[i].y = fmaf(av, bv.y, acc[i].y);
                    acc[i].z = fmaf(av, bv.z, acc[i].z);
                    acc[i].w = fmaf(av, bv.w, acc[i].w);
                }
            }
        }
    }
    cp_async_wait<0>();

    if (splits == 1) {
        // epilogue: bias in f32, relu, one cast, one write of the tile
        const int f = f0 + 4 * tx;
        float bias[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) bias[u] = f + u < F ? to_f(b[f + u]) : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int m = m0 + ty + TY * i;
            if (m < M && f < F)
                store4(out + (size_t)m * F + f, bias_relu(acc[i], bias), f, F,
                       VEC);
        }
        return;
    }

    // split C: the partial tile into this block's shared memory, then the
    // cluster adds the partials in rank order
    __syncthreads();                     // every stage is consumed
    float* part = reinterpret_cast<float*>(smem_raw);
#pragma unroll
    for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(part + (ty + TY * i) * G::LDP + 4 * tx) =
            acc[i];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                      // every partial is written
    constexpr int QUADS = BM * BN / 4;
    for (int idx = rank * THREADS + tid; idx < QUADS;
         idx += splits * THREADS) {
        const int r = idx / (BN / 4), n = (idx % (BN / 4)) * 4;
        const int m = m0 + r, f = f0 + n;
        const int at = r * G::LDP + n;
        float4 sum = ld4f(cluster.map_shared_rank(part, 0) + at);
        for (int s = 1; s < splits; ++s) {
            const float4 p = ld4f(cluster.map_shared_rank(part, s) + at);
            sum.x += p.x;
            sum.y += p.y;
            sum.z += p.z;
            sum.w += p.w;
        }
        if (m < M && f < F) {
            float bias[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) bias[u] = f + u < F ? to_f(b[f + u]) : 0.f;
            store4(out + (size_t)m * F + f, bias_relu(sum, bias), f, F, VEC);
        }
    }
    cluster.sync();                      // no block leaves while read
}

// Sets the instantiation's dynamic shared memory limit on the current
// device, once a device: the attribute belongs to the device's context, and
// a call on the serving path must cost no more host time than the launch.
template <typename T, int BM, int BN, bool VEC>
cudaError_t allow_smem(size_t smem) {
    static std::atomic<unsigned long long> ready{0};   // bit d: device d
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(conv1x1_kernel<T, BM, BN, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
    return err;
}

// An unsplit call is a plain launch; a split one a cluster launch of the
// `splits` blocks that share each output tile.
template <typename T, int BM, int BN, bool VEC>
cudaError_t launch_tile(const void* x, const void* w, const void* b,
                        void* out, int M, int C, int F, int splits,
                        int k_per, cudaStream_t stream) {
    auto kernel = conv1x1_kernel<T, BM, BN, VEC>;
    constexpr size_t smem = Cfg<T, BM, BN>::SMEM;
    static_assert(smem <= 232448, "tiles exceed a block's shared memory");
    cudaError_t err = allow_smem<T, BM, BN, VEC>(smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((M + BM - 1) / BM, (F + BN - 1) / BN, splits);
    const T* xs = static_cast<const T*>(x);
    const T* ws = static_cast<const T*>(w);
    const T* bs = static_cast<const T*>(b);
    T* os = static_cast<T*>(out);
    if (splits == 1) {
        kernel<<<grid, THREADS, smem, stream>>>(xs, ws, bs, os, M, C, F,
                                                k_per);
        return cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, xs, ws, bs, os, M, C, F, k_per);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t by_tile(int bm, int bn, const void* x, const void* w,
                    const void* b, void* out, int M, int C, int F,
                    int splits, int k_per, cudaStream_t s) {
#define DL4J_TILE(BM_, BN_)                                                   \
    if (bm == BM_ && bn == BN_)                                               \
        return launch_tile<T, BM_, BN_, VEC>(x, w, b, out, M, C, F, splits,   \
                                             k_per, s);
    DL4J_TILE(64, 32)
    DL4J_TILE(64, 64)
    DL4J_TILE(128, 32)
#undef DL4J_TILE
    return cudaErrorInvalidValue;
}

template <typename T>
size_t smem_of(int bm, int bn) {
#define DL4J_TILE(BM_, BN_)                                                   \
    if (bm == BM_ && bn == BN_) return Cfg<T, BM_, BN_>::SMEM;
    DL4J_TILE(64, 32)
    DL4J_TILE(64, 64)
    DL4J_TILE(128, 32)
#undef DL4J_TILE
    return 0;
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). x [M, C], w [C, F], b [F] and out [M, F] are
// contiguous, all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1). The tile
// plan (ops/kernels/conv.py `tile_plan`): a bm x bn tile (64 x 32, 64 x 64
// or 128 x 32), C split into `splits` (1-8) ranges of k_per channels (a
// multiple of 32), every range but the last full and the last not empty.
extern "C" int dl4j_conv1x1_bias_relu(const void* x, const void* w,
                                      const void* b, void* out, int M, int C,
                                      int F, int is_bf16, int bm, int bn,
                                      int splits, int k_per, void* stream) {
    if (M < 1 || C < 1 || F < 1 || splits < 1 || splits > MAX_SPLITS
        || k_per < BK || k_per % BK || (long long)splits * k_per < C
        || (long long)(splits - 1) * k_per >= C || bn < 1
        || (F + bn - 1) / bn > 65535)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int per16 = is_bf16 ? 8 : 4;   // elements in 16 bytes
    const bool vec = C % per16 == 0 && F % per16 == 0 && aligned16(x)
                     && aligned16(w) && aligned16(out);
    if (is_bf16)
        return (int)(vec ? by_tile<bf16, true>(bm, bn, x, w, b, out, M, C, F,
                                               splits, k_per, s)
                         : by_tile<bf16, false>(bm, bn, x, w, b, out, M, C, F,
                                                splits, k_per, s));
    return (int)(vec ? by_tile<float, true>(bm, bn, x, w, b, out, M, C, F,
                                            splits, k_per, s)
                     : by_tile<float, false>(bm, bn, x, w, b, out, M, C, F,
                                             splits, k_per, s));
}

// Dynamic shared memory a block of the (bm, bn) tile takes, in bytes (0 for
// a tile that is not built).
extern "C" int dl4j_conv1x1_bias_relu_smem(int bm, int bn, int is_bf16) {
    return (int)(is_bf16 ? smem_of<bf16>(bm, bn) : smem_of<float>(bm, bn));
}
