// Flash-attention backward, the dq pass, for Hopper (sm_90a): plain CUDA
// C++ behind a C interface (loaded with ctypes by
// deeplearning4j_tpu_torch/ops/flash_attention.py). The dk/dv pass (K3) is
// csrc/flash_attention_bwd_dkv.cu.
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_attention.py `_bwd`
// -> `_dq_body` (the pl.pallas_call at :345). Same function, the dq half of
// the FlashAttention-2 backward that recomputes P from the forward's lse:
//   inputs q, k, v, dO [BH, T, D] (f32 or bf16), lse [BH, T] f32 (K1's, one
//   value per row; the TPU keeps it lane-replicated as [BH, T, 128]),
//   delta = rowsum(dO * O) [BH, T] f32 (computed by the caller, as the
//   reference computes it outside its kernels), optional key mask [B, T]
//   (f32, > 0 = visible, row b = bh / H);
//   s = (q . k) * scale, causal keys above the diagonal and masked keys
//   filled with -1e30 as K1 fills them, p = exp(s - lse),
//   dS = p * (dO . v - delta) * scale; dq = sum_k dS . k (6*D flops a
//   pair), stored in the input dtype. With bf16 inputs the dot operands are
//   bf16 (products of bf16 values are exact in f32) with f32 accumulation,
//   and dS is rounded to bf16 before the product that takes it, as the
//   reference's ds.astype(k.dtype) does.
//
// A row with no visible key (lse at or below -1e29: K1 filled every score
// with -1e30) passes no gradient to q (dS = 0), which is what autograd
// gives through the plain forward. Keys past a ragged edge get p = 0.
//
// Order of sums. Each output row is summed by one thread in a fixed order,
// with no atomics, so results are the same from run to run.
//
// What bounds it on this card: three D-long products a visible pair
// against q/k/v/dO reads and the dq write (5 * BH*T*D elements). Causal at
// T 1024, D 64 that is about 150 flops per f32 byte, far above the card's
// f32 balance of 67 TFLOP/s / 3.35 TB/s = 20; in bf16 about 300 against
// 295: bound by operations.
//
// Design, and what it leaves for later: one thread block of 256 threads
// owns 64 query rows, four threads to a row, and loops over key tiles
// itself (the TPU's sequential grid axis becomes that loop). The owned rows
// and the streamed tiles are staged in shared memory with rows padded to an
// odd word stride; each thread computes 1/4 of the scores of its row with
// scalar FMAs, writes dS to shared memory for the row's own warp, and keeps
// 1/4 of the row's f32 accumulator in registers. Key tiles are 64 rows, or
// 32 for f32 at D = 256. Without a key mask, causal tiles that hold no
// visible pair are skipped. No tensor cores (wgmma), no TMA, no overlap of
// the next tile's loads with this tile's math: the work of a later, faster
// version (the design of csrc/flash_attention_bwd_dkv.cu).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int TPR = 4;                // threads per owned row
constexpr int ROWS = 64;              // rows a block owns
constexpr int THREADS = ROWS * TPR;   // 256
constexpr float NEG = -1e30f;
constexpr float DEAD = -1e29f;        // lse at or below: no visible key

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

// Rows of a streamed key tile.
template <typename T, int D> struct Tile {
    static constexpr int value = (sizeof(T) == 4 && D == 256) ? 32 : 64;
};

// The kernel stages 2*ROWS owned and 2*BK streamed rows of D elements.
template <typename T, int D>
constexpr size_t tiles_bytes() {
    return (size_t)(2 * ROWS + 2 * Tile<T, D>::value) * Stride<T, D>::value
           * sizeof(T);
}

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
    constexpr int BK = Tile<T, D>::value;
    return tiles_bytes<T, D>() + (size_t)ROWS * (BK + 1) * sizeof(float)
           + (size_t)BK * sizeof(float);
}

// rows [t0, t0 + n) of a [seq, D] slab into shared memory, zero past seq
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int t0, int n, int seq) {
    constexpr int LD = Stride<T, D>::value;
    const T zero = from_f<T>(0.f);
    for (int i = threadIdx.x; i < n * D; i += THREADS) {
        const int rr = i / D, dd = i % D;
        const int t = t0 + rr;
        dst[rr * LD + dd] = t < seq ? src[(size_t)t * D + dd] : zero;
    }
}

// ------------------------------------------------------------------ K2: dq
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ mask, T* __restrict__ dq,
                    int seq, int heads, int causal, float scale) {
    constexpr int LD = Stride<T, D>::value;
    constexpr int BK = Tile<T, D>::value;
    constexpr int KPT = BK / TPR;       // keys each thread scores per tile
    constexpr int DPT = D / TPR;        // accumulator columns per thread
    constexpr int LDS = BK + 1;         // padded row stride of the dS tile
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sQ = reinterpret_cast<T*>(smem_raw);
    T* sDO = sQ + ROWS * LD;
    T* sK = sDO + ROWS * LD;
    T* sV = sK + BK * LD;
    float* sDS = reinterpret_cast<float*>(sV + BK * LD);  // [ROWS][LDS]
    float* sM = sDS + ROWS * LDS;                          // [BK] key mask

    const int tid = threadIdx.x;
    const int r = tid / TPR;            // query row within the tile
    const int c = tid % TPR;            // this thread's share of the row
    const int bh = blockIdx.y;
    const int q0 = blockIdx.x * ROWS;
    const int qrow = q0 + r;
    const size_t base = (size_t)bh * seq * D;
    const float* mrow = mask ? mask + (size_t)(bh / heads) * seq : nullptr;

    stage<T, D>(sQ, q + base, q0, ROWS, seq);
    stage<T, D>(sDO, dout + base, q0, ROWS, seq);
    const bool live = qrow < seq;
    const float row_lse = live ? lse[(size_t)bh * seq + qrow] : 0.f;
    const float row_delta = live ? delta[(size_t)bh * seq + qrow] : 0.f;
    // a row with no visible key passes no gradient to q or k (dS = 0)
    const bool scored = live && row_lse > DEAD;

    float acc[DPT];
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

    const int k_end = (causal && !mrow) ? min(seq, q0 + ROWS) : seq;
    for (int k0 = 0; k0 < k_end; k0 += BK) {
        __syncthreads();                // the previous tile is fully consumed
        stage<T, D>(sK, k + base, k0, BK, seq);
        stage<T, D>(sV, v + base, k0, BK, seq);
        if (tid < BK) sM[tid] = (mrow && k0 + tid < seq) ? mrow[k0 + tid] : 1.f;
        __syncthreads();

        float s[KPT], dp[KPT];
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            const float qd = to_f(sQ[r * LD + d]);
            const float od = to_f(sDO[r * LD + d]);
#pragma unroll
            for (int jj = 0; jj < KPT; ++jj) {
                const int at = (c + TPR * jj) * LD + d;
                s[jj] = fmaf(qd, to_f(sK[at]), s[jj]);
                dp[jj] = fmaf(od, to_f(sV[at]), dp[jj]);
            }
        }
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) {
            const int key = k0 + c + TPR * jj;
            float ds = 0.f;
            if (scored && key < seq) {
                float x = s[jj] * scale;
                if (causal && key > qrow) x = NEG;
                if (mrow && !(sM[c + TPR * jj] > 0.f)) x = NEG;
                const float p = expf(x - row_lse);
                ds = p * (dp[jj] - row_delta) * scale;
            }
            // the dS.K operand in the input dtype, as ds.astype(k.dtype)
            sDS[r * LDS + c + TPR * jj] = to_f(from_f<T>(ds));
        }
        __syncwarp();                   // the row's dS, written by its own warp

#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            const float g = sDS[r * LDS + kk];
            const T* krow = sK + kk * LD;
#pragma unroll
            for (int j = 0; j < DPT; ++j)
                acc[j] = fmaf(g, to_f(krow[c + TPR * j]), acc[j]);
        }
    }

    if (live) {
        T* out = dq + base + (size_t)qrow * D;
#pragma unroll
        for (int j = 0; j < DPT; ++j) out[c + TPR * j] = from_f<T>(acc[j]);
    }
}

struct Args {
    const void *q, *k, *v, *dout, *lse, *delta, *mask;
    void *dq;
    int bh, heads, seq, causal;
    float scale;
    cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
    constexpr size_t smem = dq_smem_bytes<T, D>();
    static_assert(smem <= 232448, "dq tiles exceed a block's shared memory");
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.seq + ROWS - 1) / ROWS, a.bh);
    flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const float*>(a.mask), static_cast<T*>(a.dq), a.seq,
        a.heads, a.causal, a.scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t by_dtype(int is_bf16, const Args& a) {
    return is_bf16 ? launch_dq<__nv_bfloat16, D>(a) : launch_dq<float, D>(a);
}

int dispatch(int head_dim, int is_bf16, const Args& a) {
    if (a.bh < 1 || a.bh > 65535 || a.heads < 1 || a.seq < 1)
        return (int)cudaErrorInvalidValue;
    switch (head_dim) {
        case 64: return (int)by_dtype<64>(is_bf16, a);
        case 96: return (int)by_dtype<96>(is_bf16, a);
        case 128: return (int)by_dtype<128>(is_bf16, a);
        case 256: return (int)by_dtype<256>(is_bf16, a);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). `mask` may be null. Head dims: 64, 96, 128, 256.
extern "C" int dl4j_flash_attention_bwd_dq(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* mask, void* dq,
        int bh, int heads, int seq, int head_dim, int is_bf16, int causal,
        float scale, void* stream) {
    const Args a{q, k, v, dout, lse, delta, mask, dq,
                 bh, heads, seq, causal, scale,
                 static_cast<cudaStream_t>(stream)};
    return dispatch(head_dim, is_bf16, a);
}
