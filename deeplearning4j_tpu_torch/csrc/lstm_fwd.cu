// LSTM time loop, forward, for Hopper (sm_90a): plain CUDA C++ behind a C
// interface (loaded with ctypes by deeplearning4j_tpu_torch/ops/lstm.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_lstm.py `_fwd_call`
// (the pl.pallas_call) / `_fwd_body`. Same function, for every step t of one
// call:
//   gates = x_proj[t] + h_{t-1} . R        x_proj [T,B,4H], R [H,4H], order [i,f,o,g]
//   zi += c_{t-1} * pi,  zf += c_{t-1} * pf            (Graves peepholes, optional)
//   i, f = sigmoid(zi, zf), g = tanh(zg), c_new = f * c_{t-1} + i * g
//   zo += c_new * po,  o = sigmoid(zo), h_new = o * tanh(c_new)
//   masked steps (mask [T,B] f32, optional) carry state through:
//   h = m * h_new + (1 - m) * h_{t-1},  c = m * c_new + (1 - m) * c_{t-1}
// Outputs, all in the I/O type (f32 or bf16): hs, gates (post-activation),
// cs (c_new), c_prev and h_prev [T,B,*] (the backward's residuals) and hT, cT
// [B,H]. The carries h and c stay f32; with bf16 I/O the product's operands
// are bf16 (h rounded, as the TPU kernel's h_prev.astype(R.dtype)) and the
// product accumulates in f32 (products of bf16 values are exact in f32).
//
// What bounds it on this card: the product is 2*B*H*4H flops a step against
// R (16*H^2 bytes in f32) and the step's x_proj and outputs. At the training
// shape (T 64, B 32, H 512, f32) that is 4.3 GFLOP against ~54 MB, bound by
// operations (0.064 ms at 67 TFLOP/s). But the steps are a chain: step t needs
// all of h_{t-1}, so the T steps cannot overlap, and each step ends with a
// grid-wide barrier. T barriers of a few microseconds each are a floor of
// their own, apart from the bound.
//
// Design. The TPU kernel keeps the whole of R in one core's VMEM; at H 512
// f32 R is 4 MiB and one SM holds at most 227 KB. So R is spread over SMs:
// a persistent cooperative grid (cudaLaunchCooperativeKernel), one block per
// 8 hidden units, which keeps the R columns of all four gates of its units
// ([H, 32], 64 KB f32 at H 512) in shared memory for the whole loop. A block
// owns all four gates of its units, so the cell update and the c carry are
// local to it; h_t goes through a double-buffered f32 [2,B,H] buffer in
// device memory (L2-resident), and one grid.sync() a step publishes it. Each
// step a block stages 16 rows of h_{t-1} at a time in shared memory, its 256
// threads each compute two rows of one gate column with scalar FMAs over the
// full H (a fixed order of sums: the same result every run; h read four
// values at a time, a warp skipping rows past the batch's end), and the
// block's first 128 threads update one (row, unit) cell each. The grid
// (H/8 blocks) must be co-resident: the launch checks occupancy x SM count
// and returns cudaErrorCooperativeLaunchTooLarge when it is not. It uses
// neither tensor cores nor TMA, and a block's 8 units leave most of the
// card's FMA units idle at small B: a faster version is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int U = 8;                    // hidden units per block
constexpr int COLS = 4 * U;             // the block's gate columns, [i f o g] x U
constexpr int THREADS = 256;
constexpr int BB = 16;                  // batch rows per tile of the product
constexpr int ROW_STEP = THREADS / COLS;    // 8 row groups
constexpr int RPT = BB / ROW_STEP;          // rows per thread: 2

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T>
size_t smem_bytes(int H) {
    return (size_t)H * COLS * sizeof(T)         // R columns of the block's units
           + (size_t)BB * H * sizeof(float)     // a tile of h_{t-1}
           + (size_t)BB * COLS * sizeof(float); // the tile's gate pre-activations
}

// acc[j] += sum_k h[j][k] * R[k][col] for the thread's NR rows
// (h rows ROW_STEP*H floats apart), one FMA chain per row in order of k.
// With H % 4 == 0 the h values come four at a time: a warp's lanes all read
// the same row, so a 16-byte load is one broadcast.
template <typename T, int NR>
__device__ __forceinline__ void dot_rows(const float* h, const T* sR, int col,
                                         int H, float* acc) {
    int k = 0;
    if ((H & 3) == 0) {
#pragma unroll 2
        for (; k < H; k += 4) {
            const float w0 = to_f(sR[(k + 0) * COLS + col]);
            const float w1 = to_f(sR[(k + 1) * COLS + col]);
            const float w2 = to_f(sR[(k + 2) * COLS + col]);
            const float w3 = to_f(sR[(k + 3) * COLS + col]);
#pragma unroll
            for (int j = 0; j < NR; ++j) {
                const float4 hv = *reinterpret_cast<const float4*>(
                    h + (size_t)ROW_STEP * j * H + k);
                acc[j] = fmaf(hv.x, w0, acc[j]);
                acc[j] = fmaf(hv.y, w1, acc[j]);
                acc[j] = fmaf(hv.z, w2, acc[j]);
                acc[j] = fmaf(hv.w, w3, acc[j]);
            }
        }
    }
    for (; k < H; ++k) {
        const float w = to_f(sR[k * COLS + col]);
#pragma unroll
        for (int j = 0; j < NR; ++j)
            acc[j] = fmaf(h[(size_t)ROW_STEP * j * H + k], w, acc[j]);
    }
}

template <typename T, bool PEEP, bool MASKED>
__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ R,
                const T* __restrict__ h0, const T* __restrict__ c0,
                const float* __restrict__ mask, const T* __restrict__ pi,
                const T* __restrict__ pf, const T* __restrict__ po,
                T* __restrict__ hs, T* __restrict__ gates, T* __restrict__ cs,
                T* __restrict__ cprev_out, T* __restrict__ hprev_out,
                T* __restrict__ hT, T* __restrict__ cT, float* hbuf,
                float* cbuf, int seq, int batch, int H) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sR = reinterpret_cast<T*>(smem_raw);                        // [H][COLS]
    float* sH = reinterpret_cast<float*>(sR + (size_t)H * COLS);   // [BB][H]
    float* sZ = sH + (size_t)BB * H;                               // [BB][COLS]

    const int tid = threadIdx.x;
    const int u0 = blockIdx.x * U;
    const size_t H4 = 4 * (size_t)H;
    const size_t BH = (size_t)batch * H;

    for (int i = tid; i < H * COLS; i += THREADS) {
        const int k = i / COLS, col = i % COLS;
        const int u = u0 + col % U;
        sR[i] = u < H ? R[(size_t)k * H4 + (size_t)(col / U) * H + u]
                      : from_f<T>(0.f);
    }

    const int col = tid % COLS;         // this thread's gate column
    const int r0 = tid / COLS;          // its rows in a tile: r0, r0 + 8
    const int ucol = u0 + col % U;
    const size_t gcol = (size_t)(col / U) * H + ucol;

    for (int t = 0; t < seq; ++t) {
        const float* hin = hbuf + (size_t)(t & 1) * BH;
        float* hout = hbuf + (size_t)((t + 1) & 1) * BH;
        const T* xt = xp + (size_t)t * batch * H4;
        for (int b0 = 0; b0 < batch; b0 += BB) {
            const int nb = min(BB, batch - b0);
            __syncthreads();            // the previous tile is consumed
            for (int i = tid; i < nb * H; i += THREADS) {
                const size_t off = (size_t)b0 * H + i;
                const float hv = t == 0 ? to_f(h0[off]) : hin[off];
                sH[i] = to_f(from_f<T>(hv));   // the product's operand type
            }
            __syncthreads();

            // a warp's rows are r0, r0 + 8: rows past the tile's end are
            // skipped whole (warp-uniform), which is what small batches
            // (decode, prefill) gain from
            float acc[RPT] = {0.f, 0.f};
            const int rows = (r0 < nb) + (r0 + ROW_STEP < nb);
            if (rows == 2)
                dot_rows<T, 2>(sH + (size_t)r0 * H, sR, col, H, acc);
            else if (rows == 1)
                dot_rows<T, 1>(sH + (size_t)r0 * H, sR, col, H, acc);
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                const int rr = r0 + ROW_STEP * j;
                if (rr < nb && ucol < H)
                    sZ[rr * COLS + col] =
                        to_f(xt[(size_t)(b0 + rr) * H4 + gcol]) + acc[j];
            }
            __syncthreads();

            // the cell update: one thread per (row, unit) of the tile
            if (tid < BB * U) {
                const int rr = tid / U, j = tid % U, u = u0 + j;
                if (rr < nb && u < H) {
                    const int b = b0 + rr;
                    const size_t off = (size_t)b * H + u;
                    const float c_prev = t == 0 ? to_f(c0[off]) : cbuf[off];
                    const float h_prev = t == 0 ? to_f(h0[off]) : hin[off];
                    const float* z = sZ + rr * COLS;
                    float zi = z[j], zf = z[U + j], zo = z[2 * U + j];
                    const float zg = z[3 * U + j];
                    if (PEEP) {
                        zi = zi + c_prev * to_f(pi[u]);
                        zf = zf + c_prev * to_f(pf[u]);
                    }
                    const float ig = sigm(zi), fg = sigm(zf), gg = tanhf(zg);
                    const float cn = fg * c_prev + ig * gg;
                    if (PEEP) zo = zo + cn * to_f(po[u]);
                    const float og = sigm(zo);
                    const float hn = og * tanhf(cn);
                    float h = hn, c = cn;
                    if (MASKED) {
                        const float m = mask[(size_t)t * batch + b];
                        h = m * hn + (1.f - m) * h_prev;
                        c = m * cn + (1.f - m) * c_prev;
                    }
                    const size_t o1 = (size_t)t * BH + off;
                    hs[o1] = from_f<T>(h);
                    cs[o1] = from_f<T>(cn);
                    cprev_out[o1] = from_f<T>(c_prev);
                    hprev_out[o1] = from_f<T>(h_prev);
                    T* grow = gates + (size_t)t * batch * H4 + (size_t)b * H4;
                    grow[u] = from_f<T>(ig);
                    grow[H + u] = from_f<T>(fg);
                    grow[2 * (size_t)H + u] = from_f<T>(og);
                    grow[3 * (size_t)H + u] = from_f<T>(gg);
                    hout[off] = h;
                    cbuf[off] = c;
                    if (t == seq - 1) {
                        hT[off] = from_f<T>(h);
                        cT[off] = from_f<T>(c);
                    }
                }
            }
        }
        if (t + 1 < seq) grid.sync();   // h_t is whole before step t+1 reads it
    }
}

template <typename T, bool PEEP, bool MASKED>
cudaError_t launch(const void* xp, const void* R, const void* h0,
                   const void* c0, const void* mask, const void* pi,
                   const void* pf, const void* po, void* hs, void* gates,
                   void* cs, void* cprev, void* hprev, void* hT, void* cT,
                   void* hbuf, void* cbuf, int seq, int batch, int H,
                   cudaStream_t stream) {
    auto kern = lstm_fwd_kernel<T, PEEP, MASKED>;
    const size_t smem = smem_bytes<T>(H);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, THREADS, smem)) != cudaSuccess)
        return err;
    const int blocks = (H + U - 1) / U;
    if (blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;

    const T* a_xp = static_cast<const T*>(xp);
    const T* a_R = static_cast<const T*>(R);
    const T* a_h0 = static_cast<const T*>(h0);
    const T* a_c0 = static_cast<const T*>(c0);
    const float* a_mask = static_cast<const float*>(mask);
    const T* a_pi = static_cast<const T*>(pi);
    const T* a_pf = static_cast<const T*>(pf);
    const T* a_po = static_cast<const T*>(po);
    T* a_hs = static_cast<T*>(hs);
    T* a_gates = static_cast<T*>(gates);
    T* a_cs = static_cast<T*>(cs);
    T* a_cprev = static_cast<T*>(cprev);
    T* a_hprev = static_cast<T*>(hprev);
    T* a_hT = static_cast<T*>(hT);
    T* a_cT = static_cast<T*>(cT);
    float* a_hbuf = static_cast<float*>(hbuf);
    float* a_cbuf = static_cast<float*>(cbuf);
    void* args[] = {&a_xp, &a_R, &a_h0, &a_c0, &a_mask, &a_pi, &a_pf,
                    &a_po, &a_hs, &a_gates, &a_cs, &a_cprev, &a_hprev,
                    &a_hT, &a_cT, &a_hbuf, &a_cbuf, &seq, &batch, &H};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                      dim3(blocks), dim3(THREADS), args, smem,
                                      stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* xp, const void* R, const void* h0,
                     const void* c0, const void* mask, const void* pi,
                     const void* pf, const void* po, void* hs, void* gates,
                     void* cs, void* cprev, void* hprev, void* hT, void* cT,
                     void* hbuf, void* cbuf, int seq, int batch, int H,
                     cudaStream_t s) {
    const bool peep = pi != nullptr, masked = mask != nullptr;
#define DL4J_LSTM_FWD(P, M)                                                   \
    return launch<T, P, M>(xp, R, h0, c0, mask, pi, pf, po, hs, gates, cs,   \
                           cprev, hprev, hT, cT, hbuf, cbuf, seq, batch, H, s)
    if (peep && masked) DL4J_LSTM_FWD(true, true);
    if (peep) DL4J_LSTM_FWD(true, false);
    if (masked) DL4J_LSTM_FWD(false, true);
    DL4J_LSTM_FWD(false, false);
#undef DL4J_LSTM_FWD
}

}  // namespace

// Runs the whole time loop of one call in one cooperative launch on `stream`
// and returns the CUDA error code (0 = launched). `mask` may be null; `pi`,
// `pf` and `po` are all null (plain LSTM) or all set (peepholes). `hbuf`
// ([2,B,H] f32) and `cbuf` ([B,H] f32) are scratch the caller allocates.
extern "C" int dl4j_lstm_fwd(const void* xp, const void* R, const void* h0,
                             const void* c0, const void* mask, const void* pi,
                             const void* pf, const void* po, void* hs,
                             void* gates, void* cs, void* cprev, void* hprev,
                             void* hT, void* cT, void* hbuf, void* cbuf,
                             int seq, int batch, int hidden, int is_bf16,
                             void* stream) {
    if (seq < 1 || batch < 1 || hidden < 1) return (int)cudaErrorInvalidValue;
    if ((pi == nullptr) != (pf == nullptr) || (pi == nullptr) != (po == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return (int)dispatch<__nv_bfloat16>(xp, R, h0, c0, mask, pi, pf, po,
                                            hs, gates, cs, cprev, hprev, hT,
                                            cT, hbuf, cbuf, seq, batch,
                                            hidden, s);
    return (int)dispatch<float>(xp, R, h0, c0, mask, pi, pf, po, hs, gates,
                                cs, cprev, hprev, hT, cT, hbuf, cbuf, seq,
                                batch, hidden, s);
}
