// Flash-attention forward for Hopper (sm_90a), plain CUDA C++ behind a C
// interface (loaded with ctypes by deeplearning4j_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_attention.py `_fwd`
// (the pl.pallas_call) / `_fwd_body`. Same function:
//   q, k, v [BH, T, D] (f32 or bf16), optional key mask [B, T] (f32, > 0 =
//   visible, row b = bh / H);
//   O [BH, T, D] in the input dtype, lse [BH, T] f32 (the TPU kernel keeps
//   lse lane-replicated as [BH, T, 128]; this one keeps one value per row);
//   s = (q . k) * scale, causal keys above the diagonal and masked keys are
//   filled with -1e30 (so a fully masked row is uniform, not NaN), online
//   softmax with its (m, l, acc) state in f32, O = acc / l,
//   lse = m + log(l). Without a key mask, causal key tiles wholly above the
//   diagonal are skipped.
//   With bf16 inputs the dot operands are bf16 (products of bf16 values are
//   exact in f32) with f32 accumulation, and P is rounded to bf16 before the
//   P.V product, as the TPU kernel's p.astype(v.dtype) does.
//
// What bounds it on this card: the work is 4*D flops per visible query/key
// pair (about T^2/2 pairs per head when causal) against q/k/v/o bytes
// (4*BH*T*D elements). Causal f32 does T/8 flops per byte against the card's
// balance of 67 TFLOP/s / 3.35 TB/s = 20, so at the serving shapes
// (T 512-1024, D 64) f32 is bound by operations. Causal bf16 does T/4 flops
// per byte against 989 TFLOP/s / 3.35 TB/s = 295, so bf16 up to T ~ 1180 is
// bound by bytes.
//
// Design, and what it leaves for later: one thread block per (bh, 64-row
// query tile), 256 threads, four threads per query row. Q stays in shared
// memory; a loop walks 64-key tiles with K and V staged in shared memory
// (rows padded to an odd word stride so a warp's rows fall in different
// banks). Each thread scores 16 of a tile's 64 keys for its row with scalar
// FMAs, the row's four threads agree on the running max and sum with warp
// shuffles, P goes through shared memory, and each thread keeps a quarter of
// the row's f32 accumulator in registers. Ragged edges (T not a multiple of
// 64) are masked in the kernel. It uses neither tensor cores (wgmma) nor
// TMA, does not overlap the next tile's loads with this tile's math, and runs
// one block per SM at D = 256 in f32: those are the work of a later,
// faster version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per tile
constexpr int TPR = 4;              // threads per query row
constexpr int THREADS = BQ * TPR;   // 256
constexpr int KPT = BK / TPR;       // keys each thread scores per tile
constexpr int LDP = BK + 1;         // padded row stride of the P tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// Row stride in shared memory, in elements: an odd number of 32-bit words.
template <typename T, int D> struct Stride {
    static constexpr int value = D + (sizeof(T) == 4 ? 1 : 2);
};

template <typename T, int D>
constexpr size_t smem_bytes() {
    return (size_t)(BQ + 2 * BK) * Stride<T, D>::value * sizeof(T)
           + (size_t)BQ * LDP * sizeof(float) + (size_t)BK * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse,
                 int seq, int heads, int causal, float scale) {
    constexpr int LD = Stride<T, D>::value;
    constexpr int DPT = D / TPR;    // accumulator columns per thread
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sQ = reinterpret_cast<T*>(smem_raw);
    T* sK = sQ + BQ * LD;
    T* sV = sK + BK * LD;
    float* sP = reinterpret_cast<float*>(sV + BK * LD);   // [BQ][LDP]
    float* sM = sP + BQ * LDP;                             // [BK] key mask

    const int tid = threadIdx.x;
    const int r = tid / TPR;        // query row within the tile
    const int c = tid % TPR;        // this thread's share of the row
    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * BQ;
    const int qrow = q0 + r;
    const size_t base = (size_t)bh * seq * D;
    const float* mrow = mask ? mask + (size_t)(bh / heads) * seq : nullptr;
    const T zero = from_f<T>(0.f);

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int rr = i / D, dd = i % D;
        const int t = q0 + rr;
        sQ[rr * LD + dd] = t < seq ? q[base + (size_t)t * D + dd] : zero;
    }

    float acc[DPT];
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
    float m = NEG, l = 0.f;

    // causal: the tile holding the diagonal is the last one with a visible
    // key. With a key mask every tile is visited: a row whose visible keys
    // are all masked then averages over all T keys, as the plain attention
    // does (skipping would average over a tile-dependent prefix).
    const int k_end = (causal && !mrow) ? min(seq, q0 + BQ) : seq;
    for (int k0 = 0; k0 < k_end; k0 += BK) {
        __syncthreads();            // the previous tile is fully consumed
        for (int i = tid; i < BK * D; i += THREADS) {
            const int rr = i / D, dd = i % D;
            const int t = k0 + rr;
            const bool in = t < seq;
            sK[rr * LD + dd] = in ? k[base + (size_t)t * D + dd] : zero;
            sV[rr * LD + dd] = in ? v[base + (size_t)t * D + dd] : zero;
        }
        if (tid < BK) sM[tid] = (mrow && k0 + tid < seq) ? mrow[k0 + tid] : 1.f;
        __syncthreads();

        float s[KPT];
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) s[jj] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            const float qd = to_f(sQ[r * LD + d]);
#pragma unroll
            for (int jj = 0; jj < KPT; ++jj)
                s[jj] = fmaf(qd, to_f(sK[(c + TPR * jj) * LD + d]), s[jj]);
        }

        float mx = NEG;
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) {
            const int key = k0 + c + TPR * jj;
            float x = s[jj] * scale;
            if (key >= seq) {
                x = -INFINITY;      // past the ragged edge: no key at all
            } else {
                if (causal && key > qrow) x = NEG;
                if (mrow && !(sM[c + TPR * jj] > 0.f)) x = NEG;
            }
            s[jj] = x;
            mx = fmaxf(mx, x);
        }
        // the row's four threads are adjacent lanes of one warp
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m, mx);
        const float corr = expf(m - m_new);
        float rs = 0.f;
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) {
            const float p = expf(s[jj] - m_new);
            rs += p;
            // the P.V operand in the input dtype, as the TPU kernel rounds it
            sP[r * LDP + c + TPR * jj] = to_f(from_f<T>(p));
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l = l * corr + rs;
        m = m_new;
        __syncwarp();               // the row's P values, written by its own warp

#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[j] *= corr;
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            const float p = sP[r * LDP + kk];
            const T* vrow = sV + kk * LD;
#pragma unroll
            for (int j = 0; j < DPT; ++j)
                acc[j] = fmaf(p, to_f(vrow[c + TPR * j]), acc[j]);
        }
    }

    if (qrow < seq) {
        T* orow = o + base + (size_t)qrow * D;
#pragma unroll
        for (int j = 0; j < DPT; ++j) orow[c + TPR * j] = from_f<T>(acc[j] / l);
        if (c == 0) lse[(size_t)bh * seq + qrow] = m + logf(l);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* o, void* lse, int bh, int heads,
                   int seq, int causal, float scale, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<T, D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq + BQ - 1) / BQ, bh);
    flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(mask),
        static_cast<T*>(o), static_cast<float*>(lse), seq, heads, causal,
        scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int is_bf16, const void* q, const void* k,
                     const void* v, const void* mask, void* o, void* lse,
                     int bh, int heads, int seq, int causal, float scale,
                     cudaStream_t stream) {
    if (is_bf16)
        return launch<__nv_bfloat16, D>(q, k, v, mask, o, lse, bh, heads, seq,
                                        causal, scale, stream);
    return launch<float, D>(q, k, v, mask, o, lse, bh, heads, seq, causal,
                            scale, stream);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). `mask` may be null. Head dims: 64, 96, 128, 256.
extern "C" int dl4j_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* mask,
                                        void* o, void* lse, int bh, int heads,
                                        int seq, int head_dim, int is_bf16,
                                        int causal, float scale,
                                        void* stream) {
    if (bh < 1 || bh > 65535 || heads < 1 || seq < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (head_dim) {
        case 64:
            return (int)dispatch<64>(is_bf16, q, k, v, mask, o, lse, bh, heads,
                                     seq, causal, scale, s);
        case 96:
            return (int)dispatch<96>(is_bf16, q, k, v, mask, o, lse, bh, heads,
                                     seq, causal, scale, s);
        case 128:
            return (int)dispatch<128>(is_bf16, q, k, v, mask, o, lse, bh,
                                      heads, seq, causal, scale, s);
        case 256:
            return (int)dispatch<256>(is_bf16, q, k, v, mask, o, lse, bh,
                                      heads, seq, causal, scale, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
