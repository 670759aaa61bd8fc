// LSTM time loop, backward, for Hopper (sm_90a): plain CUDA C++ behind a C
// interface (loaded with ctypes by deeplearning4j_tpu_torch/ops/lstm.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_lstm.py `_bwd_call`
// (the pl.pallas_call) / `_bwd_body`. Same function, for t = T-1 down to 0,
// from the forward's residuals (gates [T,B,4H] post-activation, cs = c_new,
// c_prev, h_prev [T,B,H]) and the incoming dhs [T,B,H], dhT, dcT [B,H]:
//   dh_tot = dh + dhs[t], dc_tot = dc         (dh = dhT, dc = dcT at t = T-1)
//   masked steps (mask [T,B] f32): dh_new = m * dh_tot, dc_in = m * dc_tot
//   dzo = dh_new * tanh(c) * o(1-o)
//   dc' = dc_in + dh_new * o * (1 - tanh(c)^2) [+ dzo * po]
//   dzi = dc' g i(1-i), dzf = dc' c_prev f(1-f), dzg = dc' i (1-g^2)
//   dx_proj[t] = dz = [dzi dzf dzo dzg], rounded to the I/O type
//   dh <- dz . R^T [+ (1-m) dh_tot],  dc <- dc' f [+ (1-m) dc_tot] [+ dzi pi + dzf pf]
//   dR = sum_t h_prev[t]^T . dz[t],  dpi/dpf/dpo = sums of dzi c_prev, dzf c_prev, dzo c
// Outputs in the I/O type: dx_proj [T,B,4H], dh0, dc0 [B,H] (the carries
// after step 0), dR [H,4H] and, with peepholes, dpi, dpf, dpo [H]. Carries and
// sums are f32; with bf16 I/O the products take bf16 operands (dz as stored
// in dx_proj, h_prev, R) and accumulate in f32, as the TPU kernel does.
//
// What bounds it on this card: the two products (dz . R^T and h_prev^T . dz)
// are 2 * 2*T*B*H*4H flops: 8.6 GFLOP at T 64, B 32, H 512 f32, bound by
// operations (0.128 ms at 67 TFLOP/s). The dh chain is sequential: T steps,
// one grid-wide barrier each, a floor of its own apart from the bound.
//
// Design: one cooperative launch runs the reverse loop, then a second,
// ordinary launch computes dR.
// - The loop: a persistent grid of one block per 8 hidden units; a block
//   keeps R's rows for its units ([8, 4H], 64 KB f32 at H 512) in shared
//   memory. Each step has two phases and one grid.sync() between them:
//   (a) each block computes dz for its own units (elementwise; it owns their
//       dh and dc carries, kept in f32 scratch in device memory) and writes
//       it into dx_proj[t], a separate buffer for every t;
//   (b) after the barrier, each block computes dh_{t-1} for its own units
//       as dz_t [B,4H] . R[own,:]^T, one warp per two batch rows (an R value
//       read from shared memory serves both), reading dz_t from L2; its
//       lanes sum strided columns and a butterfly of shuffles joins them,
//       a fixed order: the same result every run.
//   Peephole sums stay in each thread's registers (a thread always holds the
//   same unit) and are joined in a fixed order after the loop.
// - dR: h_prev viewed as [T*B, H] transposed times dx_proj [T*B, 4H], a
//   64x64 output tile per block of 256 threads staged through shared memory
//   in K-slices of 16, each output one sequential FMA chain over (t, b).
// The grid of the loop (H/8 blocks) must be co-resident: the launch checks
// occupancy x SM count and returns cudaErrorCooperativeLaunchTooLarge when it
// is not. Neither part uses tensor cores or TMA; that is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int U = 8;                    // hidden units per block of the loop
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;                // dR output tile
constexpr int KT = 16;                  // dR K-slice

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

template <typename T>
size_t loop_smem_bytes(int H) {
    return (size_t)U * 4 * H * sizeof(T) + (size_t)3 * THREADS * sizeof(float);
}

template <typename T, bool PEEP, bool MASKED>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_loop(const T* __restrict__ gates, const T* __restrict__ cs,
              const T* __restrict__ cprev, const T* __restrict__ dhs,
              const T* __restrict__ R, const T* __restrict__ dhT,
              const T* __restrict__ dcT, const float* __restrict__ mask,
              const T* __restrict__ pi, const T* __restrict__ pf,
              const T* __restrict__ po, T* dxp, T* __restrict__ dh0,
              T* __restrict__ dc0, T* __restrict__ dpi, T* __restrict__ dpf,
              T* __restrict__ dpo, float* dh, float* dc, float* dhtot,
              int seq, int batch, int H) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const size_t H4 = 4 * (size_t)H;
    T* sR = reinterpret_cast<T*>(smem_raw);                        // [U][4H]
    float* sP = reinterpret_cast<float*>(sR + (size_t)U * H4);     // [3][THREADS]

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int u0 = blockIdx.x * U;
    const size_t BH = (size_t)batch * H;
    for (size_t i = tid; i < (size_t)U * H4; i += THREADS) {
        const int j = (int)(i / H4);
        sR[i] = u0 + j < H ? R[(size_t)(u0 + j) * H4 + i % H4] : from_f<T>(0.f);
    }
    __syncthreads();

    // phase (a): THREADS is a multiple of U, so a thread keeps one unit
    const int ja = tid % U, ua = u0 + ja;
    float acc_pi = 0.f, acc_pf = 0.f, acc_po = 0.f;

    for (int r = 0; r < seq; ++r) {
        const int t = seq - 1 - r;
        T* zt = dxp + (size_t)t * batch * H4;
        if (ua < H) {
            for (int b = tid / U; b < batch; b += THREADS / U) {
                const size_t off = (size_t)b * H + ua;
                const size_t o1 = (size_t)t * BH + off;
                const T* grow = gates + (size_t)t * batch * H4 + (size_t)b * H4;
                const float ig = to_f(grow[ua]), fg = to_f(grow[H + ua]);
                const float og = to_f(grow[2 * (size_t)H + ua]);
                const float gg = to_f(grow[3 * (size_t)H + ua]);
                const float c = to_f(cs[o1]), c_prev = to_f(cprev[o1]);
                const float tc = tanhf(c);
                const float dh_tot =
                    (r == 0 ? to_f(dhT[off]) : dh[off]) + to_f(dhs[o1]);
                const float dc_tot = r == 0 ? to_f(dcT[off]) : dc[off];
                float m = 1.f, dh_new = dh_tot, dc_in = dc_tot;
                if (MASKED) {
                    m = mask[(size_t)t * batch + b];
                    dh_new = m * dh_tot;
                    dc_in = m * dc_tot;
                }
                const float dzo = dh_new * tc * og * (1.f - og);
                float dcv = dc_in + dh_new * og * (1.f - tc * tc);
                if (PEEP) dcv = dcv + dzo * to_f(po[ua]);
                const float dzi = dcv * gg * ig * (1.f - ig);
                const float dzf = dcv * c_prev * fg * (1.f - fg);
                const float dzg = dcv * ig * (1.f - gg * gg);
                T* drow = zt + (size_t)b * H4;
                drow[ua] = from_f<T>(dzi);
                drow[H + ua] = from_f<T>(dzf);
                drow[2 * (size_t)H + ua] = from_f<T>(dzo);
                drow[3 * (size_t)H + ua] = from_f<T>(dzg);
                float ndc = dcv * fg;
                if (MASKED) ndc = ndc + (1.f - m) * dc_tot;
                if (PEEP) {
                    acc_pi += dzi * c_prev;
                    acc_pf += dzf * c_prev;
                    acc_po += dzo * c;
                    ndc = ndc + dzi * to_f(pi[ua]) + dzf * to_f(pf[ua]);
                }
                dc[off] = ndc;
                if (MASKED) dhtot[off] = dh_tot;
                if (t == 0) dc0[off] = from_f<T>(ndc);
            }
        }
        grid.sync();                    // dz_t is whole before (b) reads it

        // phase (b): dh_{t-1}[b, own units] = dz_t[b, :] . R[own, :]^T, a
        // warp taking rows b and b + WARPS together so that each R value
        // read from shared memory serves both
        for (int b = warp; b < batch; b += 2 * WARPS) {
            const bool two = b + WARPS < batch;     // warp-uniform
            float acc[2][U];
#pragma unroll
            for (int j = 0; j < U; ++j) acc[0][j] = acc[1][j] = 0.f;
            const T* z0 = zt + (size_t)b * H4;
            const T* z1 = zt + (size_t)(two ? b + WARPS : b) * H4;
            for (size_t cc = lane; cc < H4; cc += 32) {
                const float za = to_f(z0[cc]), zb = to_f(z1[cc]);
#pragma unroll
                for (int j = 0; j < U; ++j) {
                    const float w = to_f(sR[j * H4 + cc]);
                    acc[0][j] = fmaf(za, w, acc[0][j]);
                    acc[1][j] = fmaf(zb, w, acc[1][j]);
                }
            }
            for (int q = 0; q < (two ? 2 : 1); ++q) {
                float mine = 0.f;
#pragma unroll
                for (int j = 0; j < U; ++j) {
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
                        acc[q][j] += __shfl_xor_sync(0xffffffffu, acc[q][j], o);
                    if (lane == j) mine = acc[q][j];
                }
                const int bq = b + q * WARPS;
                if (lane < U && u0 + lane < H) {
                    const size_t off = (size_t)bq * H + u0 + lane;
                    float nd = mine;
                    if (MASKED)
                        nd = nd + (1.f - mask[(size_t)t * batch + bq]) * dhtot[off];
                    dh[off] = nd;
                    if (t == 0) dh0[off] = from_f<T>(nd);
                }
            }
        }
        __syncthreads();                // (a) of the next step reads dh
    }

    if (PEEP) {
        sP[tid] = acc_pi;
        sP[THREADS + tid] = acc_pf;
        sP[2 * THREADS + tid] = acc_po;
        __syncthreads();
        if (tid < U && u0 + tid < H) {
            float s0 = 0.f, s1 = 0.f, s2 = 0.f;
            for (int i = tid; i < THREADS; i += U) {
                s0 += sP[i];
                s1 += sP[THREADS + i];
                s2 += sP[2 * THREADS + i];
            }
            dpi[u0 + tid] = from_f<T>(s0);
            dpf[u0 + tid] = from_f<T>(s1);
            dpo[u0 + tid] = from_f<T>(s2);
        }
    }
}

// dR [H,4H] = hprev[N,H]^T . dz[N,4H], N = T*B, f32 sums in order of n.
template <typename T>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_dr(const T* __restrict__ hprev, const T* __restrict__ dz,
            T* __restrict__ dR, int N, int H) {
    __shared__ float sA[KT][TILE];
    __shared__ float sZ[KT][TILE];
    const size_t H4 = 4 * (size_t)H;
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int i0 = blockIdx.y * TILE;           // rows of dR (units of h)
    const size_t j0 = (size_t)blockIdx.x * TILE;   // columns of dR (gates)
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    for (int k0 = 0; k0 < N; k0 += KT) {
        __syncthreads();
        for (int i = tid; i < KT * TILE; i += THREADS) {
            const int kk = i / TILE, x = i % TILE, k = k0 + kk;
            sA[kk][x] = (k < N && i0 + x < H)
                            ? to_f(hprev[(size_t)k * H + i0 + x]) : 0.f;
            sZ[kk][x] = (k < N && j0 + x < H4)
                            ? to_f(dz[(size_t)k * H4 + j0 + x]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const float av = sA[kk][ty + 16 * a];
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    acc[a][c] = fmaf(av, sZ[kk][tx + 16 * c], acc[a][c]);
            }
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int row = i0 + ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const size_t cj = j0 + tx + 16 * c;
            if (row < H && cj < H4) dR[(size_t)row * H4 + cj] = from_f<T>(acc[a][c]);
        }
    }
}

template <typename T, bool PEEP, bool MASKED>
cudaError_t launch_loop(void** ptrs, float* dh, float* dc, float* dhtot,
                        int seq, int batch, int H, cudaStream_t stream) {
    auto kern = lstm_bwd_loop<T, PEEP, MASKED>;
    const size_t smem = loop_smem_bytes<T>(H);
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

    // ptrs: gates cs cprev dhs R dhT dcT mask pi pf po dxp dh0 dc0 dpi dpf dpo
    const T* a_gates = static_cast<const T*>(ptrs[0]);
    const T* a_cs = static_cast<const T*>(ptrs[1]);
    const T* a_cprev = static_cast<const T*>(ptrs[2]);
    const T* a_dhs = static_cast<const T*>(ptrs[3]);
    const T* a_R = static_cast<const T*>(ptrs[4]);
    const T* a_dhT = static_cast<const T*>(ptrs[5]);
    const T* a_dcT = static_cast<const T*>(ptrs[6]);
    const float* a_mask = static_cast<const float*>(ptrs[7]);
    const T* a_pi = static_cast<const T*>(ptrs[8]);
    const T* a_pf = static_cast<const T*>(ptrs[9]);
    const T* a_po = static_cast<const T*>(ptrs[10]);
    T* a_dxp = static_cast<T*>(ptrs[11]);
    T* a_dh0 = static_cast<T*>(ptrs[12]);
    T* a_dc0 = static_cast<T*>(ptrs[13]);
    T* a_dpi = static_cast<T*>(ptrs[14]);
    T* a_dpf = static_cast<T*>(ptrs[15]);
    T* a_dpo = static_cast<T*>(ptrs[16]);
    void* args[] = {&a_gates, &a_cs, &a_cprev, &a_dhs, &a_R, &a_dhT, &a_dcT,
                    &a_mask, &a_pi, &a_pf, &a_po, &a_dxp, &a_dh0, &a_dc0,
                    &a_dpi, &a_dpf, &a_dpo, &dh, &dc, &dhtot, &seq, &batch,
                    &H};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                      dim3(blocks), dim3(THREADS), args, smem,
                                      stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T>
cudaError_t run(void** ptrs, const void* hprev, void* dR, float* dh,
                float* dc, float* dhtot, int seq, int batch, int H,
                cudaStream_t s) {
    const bool peep = ptrs[8] != nullptr, masked = ptrs[7] != nullptr;
    cudaError_t err;
    if (peep && masked)
        err = launch_loop<T, true, true>(ptrs, dh, dc, dhtot, seq, batch, H, s);
    else if (peep)
        err = launch_loop<T, true, false>(ptrs, dh, dc, dhtot, seq, batch, H, s);
    else if (masked)
        err = launch_loop<T, false, true>(ptrs, dh, dc, dhtot, seq, batch, H, s);
    else
        err = launch_loop<T, false, false>(ptrs, dh, dc, dhtot, seq, batch, H, s);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((4 * (size_t)H + TILE - 1) / TILE),
                    (unsigned)((H + TILE - 1) / TILE));
    lstm_bwd_dr<T><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(hprev), static_cast<const T*>(ptrs[11]),
        static_cast<T*>(dR), seq * batch, H);
    return cudaGetLastError();
}

}  // namespace

// Runs the reverse loop (one cooperative launch) and then dR (one launch) on
// `stream`; returns the CUDA error code (0 = both launched). `mask` may be
// null; `pi/pf/po` and `dpi/dpf/dpo` are all null (plain LSTM) or all set.
// `dh`, `dc`, `dhtot` are [B,H] f32 scratch the caller allocates.
extern "C" int dl4j_lstm_bwd(const void* gates, const void* cs,
                             const void* cprev, const void* hprev,
                             const void* dhs, const void* R, const void* dhT,
                             const void* dcT, const void* mask,
                             const void* pi, const void* pf, const void* po,
                             void* dxp, void* dh0, void* dc0, void* dR,
                             void* dpi, void* dpf, void* dpo, void* dh,
                             void* dc, void* dhtot, int seq, int batch,
                             int hidden, int is_bf16, void* stream) {
    if (seq < 1 || batch < 1 || hidden < 1) return (int)cudaErrorInvalidValue;
    const bool peep = pi != nullptr;
    if (pf == nullptr || po == nullptr || dpi == nullptr || dpf == nullptr ||
        dpo == nullptr) {
        if (peep || pf || po || dpi || dpf || dpo)
            return (int)cudaErrorInvalidValue;
    }
    void* ptrs[] = {const_cast<void*>(gates), const_cast<void*>(cs),
                    const_cast<void*>(cprev), const_cast<void*>(dhs),
                    const_cast<void*>(R), const_cast<void*>(dhT),
                    const_cast<void*>(dcT), const_cast<void*>(mask),
                    const_cast<void*>(pi), const_cast<void*>(pf),
                    const_cast<void*>(po), dxp, dh0, dc0, dpi, dpf, dpo};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* fdh = static_cast<float*>(dh);
    float* fdc = static_cast<float*>(dc);
    float* fht = static_cast<float*>(dhtot);
    if (is_bf16)
        return (int)run<__nv_bfloat16>(ptrs, hprev, dR, fdh, fdc, fht, seq,
                                       batch, hidden, s);
    return (int)run<float>(ptrs, hprev, dR, fdh, fdc, fht, seq, batch,
                           hidden, s);
}
