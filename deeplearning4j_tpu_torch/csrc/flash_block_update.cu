// One ring-attention hop folded into a raw online-softmax carry, for Hopper
// (sm_90a), plain CUDA C++ behind a C interface (loaded with ctypes by
// deeplearning4j_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_attention.py
// `flash_block_update` (the pl.pallas_call) / `_fwd_carry_body`. Same
// function:
//   q [BH, Tq, D], k, v [BH, Tk, D] (f32 or bf16); the incoming carry
//   acc [BH, Tq, D], m, l [BH, Tq], all f32 (the TPU kernel keeps m and l
//   lane-replicated as [BH, Tq, 128]; this one keeps one value per row);
//   s = (q . k) * scale; with `causal` (the ring's diagonal hop, Tq == Tk)
//   key j is visible to query i iff j <= i and the others are filled with
//   -1e30; then for each query row
//     m' = max(m, rowmax s), l' = l * e^(m - m') + sum p,
//     acc' = acc * e^(m - m') + p . v,   p = e^(s - m'),
//   and (acc', m', l') are written RAW: no division by l and no lse, so the
//   ring can fold the next hop in. The first hop receives m = -1e30, l = 0,
//   acc = 0, for which e^(m - m') is exactly 0. With bf16 inputs the dot
//   operands are bf16 with f32 accumulation and p is rounded to bf16 before
//   the p . v product, as the TPU kernel's p.astype(v.dtype) does; the
//   carry stays f32. The outputs are fresh arrays: the incoming carry is
//   only read (a thread reads its own carry values before any write, so
//   passing the same pointers for in and out would also be safe).
//
// What bounds it on this card: 4 * D flops per visible query/key pair
// (Tq * Tk pairs, about half on the diagonal hop) against q, k, v read once
// and acc, m, l read and written once. At the ring's block (Tq = Tk = 2048,
// D 64) that is 256 flops a byte in f32 against the card's balance of
// 67 TFLOP/s / 3.35 TB/s = 20, so the hop is bound by operations in f32;
// in bf16 (peak 989 TFLOP/s, balance 295) it is bound by bytes.
//
// Design, and what it leaves for later: the tile loop of
// flash_attention_fwd.cu (one thread block per (bh, 64-row query tile), 256
// threads, four threads per query row, 64-key tiles of K and V staged in
// shared memory, scalar FMAs, the row's four threads agreeing on max and
// sum with warp shuffles, P through shared memory, a quarter of the row's
// f32 accumulator in each thread's registers) with the running (acc, m, l)
// loaded from the carry before the loop and stored raw after it. Causal
// key tiles wholly above the diagonal are skipped. Ragged edges (Tq or Tk
// not a multiple of 64) are masked in the kernel. Neither tensor cores
// (wgmma) nor TMA, no overlap of loads with math: later work, shared with
// the forward kernel.
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
           + (size_t)BQ * LDP * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
block_update_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* acc_in,
                    const float* m_in, const float* l_in, float* acc_out,
                    float* m_out, float* l_out, int tq, int tk, int causal,
                    float scale) {
    constexpr int LD = Stride<T, D>::value;
    constexpr int DPT = D / TPR;    // accumulator columns per thread
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sQ = reinterpret_cast<T*>(smem_raw);
    T* sK = sQ + BQ * LD;
    T* sV = sK + BK * LD;
    float* sP = reinterpret_cast<float*>(sV + BK * LD);   // [BQ][LDP]

    const int tid = threadIdx.x;
    const int r = tid / TPR;        // query row within the tile
    const int c = tid % TPR;        // this thread's share of the row
    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * BQ;
    const int qrow = q0 + r;
    const bool live = qrow < tq;
    const size_t qbase = (size_t)bh * tq * D;
    const size_t kbase = (size_t)bh * tk * D;
    const size_t row = (size_t)bh * tq + qrow;
    const T zero = from_f<T>(0.f);

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int rr = i / D, dd = i % D;
        const int t = q0 + rr;
        sQ[rr * LD + dd] = t < tq ? q[qbase + (size_t)t * D + dd] : zero;
    }

    // the incoming carry of this row
    float acc[DPT];
#pragma unroll
    for (int j = 0; j < DPT; ++j)
        acc[j] = live ? acc_in[row * D + c + TPR * j] : 0.f;
    float m = live ? m_in[row] : NEG;
    float l = live ? l_in[row] : 0.f;

    // causal: the tile holding the diagonal is the last one with a visible key
    const int k_end = causal ? min(tk, q0 + BQ) : tk;
    for (int k0 = 0; k0 < k_end; k0 += BK) {
        __syncthreads();            // the previous tile is fully consumed
        for (int i = tid; i < BK * D; i += THREADS) {
            const int rr = i / D, dd = i % D;
            const int t = k0 + rr;
            const bool in = t < tk;
            sK[rr * LD + dd] = in ? k[kbase + (size_t)t * D + dd] : zero;
            sV[rr * LD + dd] = in ? v[kbase + (size_t)t * D + dd] : zero;
        }
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
            if (key >= tk) x = -INFINITY;       // past the ragged edge: no key
            else if (causal && key > qrow) x = NEG;
            s[jj] = x;
            mx = fmaxf(mx, x);
        }
        // the row's four threads are adjacent lanes of one warp
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m, mx);
        const float corr = expf(m - m_new);     // 0 when m is the first hop's -1e30
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

    if (live) {
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc_out[row * D + c + TPR * j] = acc[j];
        if (c == 0) {
            m_out[row] = m;
            l_out[row] = l;
        }
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* acc_in, const void* m_in, const void* l_in,
                   void* acc_out, void* m_out, void* l_out, int bh, int tq,
                   int tk, int causal, float scale, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<T, D>();
    cudaError_t err = cudaFuncSetAttribute(
        block_update_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((tq + BQ - 1) / BQ, bh);
    block_update_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(acc_in),
        static_cast<const float*>(m_in), static_cast<const float*>(l_in),
        static_cast<float*>(acc_out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), tq, tk, causal, scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int is_bf16, const void* q, const void* k,
                     const void* v, const void* acc_in, const void* m_in,
                     const void* l_in, void* acc_out, void* m_out,
                     void* l_out, int bh, int tq, int tk, int causal,
                     float scale, cudaStream_t stream) {
    if (is_bf16)
        return launch<__nv_bfloat16, D>(q, k, v, acc_in, m_in, l_in, acc_out,
                                        m_out, l_out, bh, tq, tk, causal,
                                        scale, stream);
    return launch<float, D>(q, k, v, acc_in, m_in, l_in, acc_out, m_out,
                            l_out, bh, tq, tk, causal, scale, stream);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). Head dims: 64, 96, 128, 256. `causal` needs
// tq == tk.
extern "C" int dl4j_flash_block_update(const void* q, const void* k,
                                       const void* v, const void* acc_in,
                                       const void* m_in, const void* l_in,
                                       void* acc_out, void* m_out,
                                       void* l_out, int bh, int tq, int tk,
                                       int head_dim, int is_bf16, int causal,
                                       float scale, void* stream) {
    if (bh < 1 || bh > 65535 || tq < 1 || tk < 1 || (causal && tq != tk))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DL4J_CASE(DIM)                                                        \
    case DIM:                                                                 \
        return (int)dispatch<DIM>(is_bf16, q, k, v, acc_in, m_in, l_in,       \
                                  acc_out, m_out, l_out, bh, tq, tk, causal,  \
                                  scale, s);
    switch (head_dim) {
        DL4J_CASE(64)
        DL4J_CASE(96)
        DL4J_CASE(128)
        DL4J_CASE(256)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef DL4J_CASE
}
