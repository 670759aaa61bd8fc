// Flash-attention forward for Hopper (sm_90a), CUDA C++ behind a C
// interface (loaded with ctypes by deeplearning4j_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_attention.py `_fwd`
// (the pl.pallas_call) / `_fwd_body`. Same function:
//   q, k, v [BH, T, D] (f32 or bf16), optional key mask [B, T] (f32, > 0 =
//   visible, row b = bh / H);
//   O [BH, T, D] in the input dtype, lse [BH, T] f32 (the TPU kernel keeps
//   lse lane-replicated as [BH, T, 128]; this one keeps one value per row);
//   s = (q . k) * scale, causal keys above the diagonal and masked keys are
//   filled with -1e30 (so a fully masked row is uniform, not NaN), keys past
//   a ragged edge with -inf; online softmax with its (m, l, acc) state in
//   f32, O = acc / l, lse = m + log(l). With a key mask every key tile is
//   visited; without one, causal key tiles wholly above the diagonal are
//   skipped. With bf16 inputs the products take bf16 operands with f32
//   accumulation, and P is rounded to bf16 before the P.V product, as the
//   TPU kernel's p.astype(v.dtype) does.
//
// What bounds it on this card: 4*D flops per visible query/key pair (about
// T^2/2 pairs a head when causal) against 4*BH*T*D elements of q/k/v/O.
// Causal f32 does T/8 flops a byte against the card's balance of 67 TFLOP/s
// / 3.35 TB/s = 20: bound by operations at T 512-1024. Causal bf16 does T/4
// against 989 / 3.35 = 295: bound by bytes up to T ~ 1180. The earlier,
// scalar design reached 10-20 % of either bound: one shared-memory load per
// FMA, bf16 widened onto the FMA pipe, synchronous staging, P through
// shared memory in f32.
//
// bf16 design: tensor cores through wgmma. One block of two warpgroups per
// (bh, 128-query tile), 64 query rows a warpgroup. Q is staged once into
// 128-byte-swizzled panels; K and V tiles of 64 keys stream through a ring
// of two stages filled by 16-byte cp.async copies, so the next tile's loads
// overlap this tile's math (every thread copies its share, then waits on
// its own copy group and a block barrier: every thread is a producer, so
// the group wait stands where a warp-specialised kernel would wait on an
// mbarrier). S = Q.K^T is an m64n64k16 wgmma per 16 columns of D with both
// operands in shared memory; the online softmax runs on the accumulator
// fragment in registers, a row's four lanes agreeing through quad shuffles;
// P is rounded to bf16 in registers and fed as the register A operand of
// O += P.V, V being the MN-major B operand in shared memory. P never
// touches shared memory; O, m and l stay in registers until the epilogue.
// D = 96 runs as 128 with zero columns. Shared memory: 49 KB at D 64, 193
// KB at D 256 (one block an SM there).
//
// f32 design: full f32 FMAs (no TF32: the pin is atol 2e-5). A block of 256
// threads owns 64 query rows; each thread owns a 4-row x 4-key micro-tile
// of S and a 4-row x 4-column micro-tile of O per 64 columns of D. Operands
// are read from shared memory as float4, so one load feeds 4 FMAs and a
// warp's loads are broadcasts or conflict-free (rows padded to 4 words past
// a multiple of 32). K/V tiles are double-buffered with cp.async (single-
// buffered at D 256, where two stages exceed 227 KB). P goes through shared
// memory in f32, read back as float4 by the warp that wrote it.
//
// Both: causal query tiles are scheduled heaviest first (the grid walks
// query tiles from the last), and ragged edges are masked in the kernel.
// Left for later: a producer warp with TMA and mbarriers (warp
// specialisation), a persistent grid, larger key tiles, fp8.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper_mma.cuh"

namespace {

using namespace dl4j_sm90;
using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr int THREADS = 256;
constexpr int BK = 64;                  // keys per streamed tile

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------ bf16, wgmma
template <int D> struct Bf16Cfg {
    static constexpr int NC = (D + PANEL - 1) / PANEL;   // 64-column panels
    static constexpr int BQ = 128;                       // two warpgroups
    static constexpr uint32_t Q_BYTES = NC * BQ * ROW_BYTES;
    static constexpr uint32_t KV_BYTES = NC * BK * ROW_BYTES;
    static constexpr size_t SMEM = 1024 + Q_BYTES + 4 * (size_t)KV_BYTES;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ mask,
               bf16* __restrict__ o, float* __restrict__ lse, int seq,
               int heads, int causal, float scale) {
    using C = Bf16Cfg<D>;
    constexpr int NC = C::NC;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sKV = sQ + C::Q_BYTES;   // stage s: K at s*2*KV, V after

    const int tid = threadIdx.x;
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;   // heaviest first
    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    const size_t base = (size_t)bh * seq * D;
    const float* mrow = mask ? mask + (size_t)(bh / heads) * seq : nullptr;
    const bool skip_above = causal && !mrow;
    const int k_end = skip_above ? min(seq, q0 + C::BQ) : seq;
    const int ntiles = (k_end + BK - 1) / BK;
    const int wg_last = q0 + wg * 64 + 63;   // this warpgroup's last row

    load_panels<D, C::BQ>(sQ, q + base, q0, seq, tid, THREADS);
    load_panels<D, BK>(sKV, k + base, 0, seq, tid, THREADS);
    load_panels<D, BK>(sKV + C::KV_BYTES, v + base, 0, seq, tid, THREADS);
    cp_async_commit();

    float acc[NC][32];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

    for (int j = 0; j < ntiles; ++j) {
        __syncthreads();                 // stage (j + 1) % 2 is consumed
        if (j + 1 < ntiles) {
            const uint32_t nxt = sKV + ((j + 1) & 1) * 2 * C::KV_BYTES;
            load_panels<D, BK>(nxt, k + base, (j + 1) * BK, seq, tid, THREADS);
            load_panels<D, BK>(nxt + C::KV_BYTES, v + base, (j + 1) * BK, seq,
                               tid, THREADS);
        }
        cp_async_commit();
        cp_async_wait<1>();              // this thread's copies of tile j
        fence_async_shared();
        __syncthreads();                 // everyone's copies of tile j
        const int k0 = j * BK;
        if (skip_above && k0 > wg_last) continue;   // no visible pair
        const uint32_t sK = sKV + (j & 1) * 2 * C::KV_BYTES;
        const uint32_t sV = sK + C::KV_BYTES;

        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_regs(s);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < NC * 4; ++kk) {
            const uint32_t off = (uint32_t)(kk % 4) * 32;   // 16 columns
            wgmma_ss(s,
                     desc(sQ + (kk / 4) * (C::BQ * ROW_BYTES)
                          + wg * 64 * ROW_BYTES + off, 16, 1024),
                     desc(sK + (kk / 4) * (BK * ROW_BYTES) + off, 16, 1024),
                     kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(s);

        // scores of rows r0 (s[4j + e]) and r1 (s[4j + 2 + e]), key
        // k0 + 8j + 2c + e
        float mx0 = NEG, mx1 = NEG;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int row = (i & 2) ? r1 : r0;
            const int key = k0 + 8 * (i / 4) + 2 * c + (i & 1);
            float x = s[i] * scale;
            if (key >= seq) {
                x = -INFINITY;           // past the ragged edge: no key
            } else {
                if (causal && key > row) x = NEG;
                if (mrow && !(mrow[key] > 0.f)) x = NEG;
            }
            s[i] = x;
            if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
        }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const float p = expf(s[i] - ((i & 2) ? mn1 : mn0));
            s[i] = p;
            if (i & 2) rs1 += p; else rs0 += p;
        }
        l0 = l0 * corr0 + quad_sum(rs0);
        l1 = l1 * corr1 + quad_sum(rs1);
        m0 = mn0;
        m1 = mn1;

        uint32_t a[4][4];                // P in bf16, the A operand
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) frag_to_a(s, kk, a[kk]);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[n][i] *= (i & 2) ? corr1 : corr0;
            fence_regs(acc[n]);
        }
        wg_fence();
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_rs(acc[n], a[kk],
                         desc(sV + n * (BK * ROW_BYTES) + kk * 16 * ROW_BYTES,
                              BK * ROW_BYTES, 1024));
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int n = 0; n < NC; ++n) fence_regs(acc[n]);
    }
    cp_async_wait<0>();

    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
        const int row = hi ? r1 : r0;
        if (row >= seq) continue;
        const float inv = hi ? inv1 : inv0;
        bf16* orow = o + base + (size_t)row * D;
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                const int col = n * PANEL + 8 * jj + 2 * c;
                if (col < D)
                    *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                        __floats2bfloat162_rn(acc[n][4 * jj + 2 * hi] * inv,
                                              acc[n][4 * jj + 2 * hi + 1] * inv);
            }
        if (c == 0)
            lse[(size_t)bh * seq + row] = (hi ? m1 : m0)
                                          + logf(hi ? l1 : l0);
    }
}

// --------------------------------------------------- f32, register tiles
template <int D> struct F32Cfg {
    static constexpr int DP = F32Rows<D>::DP;   // padded head dim
    static constexpr int LD = F32Rows<D>::LD;   // row stride, floats
    static constexpr int LDP = BK + 4;      // P row stride
    static constexpr int BQ = 64;
    static constexpr int STAGES = DP > 128 ? 1 : 2;
    static constexpr size_t SMEM =
        ((size_t)(BQ + 2 * BK * STAGES) * LD + (size_t)BQ * LDP)
        * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              float* __restrict__ o, float* __restrict__ lse, int seq,
              int heads, int causal, float scale) {
    using C = F32Cfg<D>;
    constexpr int LD = C::LD, LDP = C::LDP, NC = C::DP / 64;
    extern __shared__ __align__(16) float smf[];
    float* sQ = smf;
    float* sKV = sQ + C::BQ * LD;            // stage s: K at s*2*BK*LD
    float* sP = sKV + 2 * BK * C::STAGES * LD;

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;  // rows 4ty.., keys tx + 16j
    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
    const size_t base = (size_t)bh * seq * D;
    const float* mrow = mask ? mask + (size_t)(bh / heads) * seq : nullptr;
    const int k_end = (causal && !mrow) ? min(seq, q0 + C::BQ) : seq;
    const int ntiles = (k_end + BK - 1) / BK;

    // K and V rows [t0, t0 + BK) into the stage at dst
    auto load_kv = [&](float* dst, int t0) {
        load_rows_f32<D, BK>(dst, k + base, t0, seq, tid, THREADS);
        load_rows_f32<D, BK>(dst + BK * LD, v + base, t0, seq, tid, THREADS);
    };
    load_rows_f32<D, C::BQ>(sQ, q + base, q0, seq, tid, THREADS);
    if constexpr (C::STAGES == 2) load_kv(sKV, 0);
    cp_async_commit();

    float acc[4][NC][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) { m[i] = NEG; l[i] = 0.f; }

    for (int j = 0; j < ntiles; ++j) {
        __syncthreads();
        const float* sK;
        if constexpr (C::STAGES == 2) {
            if (j + 1 < ntiles)
                load_kv(sKV + ((j + 1) & 1) * 2 * BK * LD, (j + 1) * BK);
            cp_async_commit();
            cp_async_wait<1>();
            sK = sKV + (j & 1) * 2 * BK * LD;
        } else {
            load_kv(sKV, j * BK);
            cp_async_commit();
            cp_async_wait<0>();
            sK = sKV;
        }
        __syncthreads();
        const float* sV = sK + BK * LD;
        const int k0 = j * BK;

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
        for (int d = 0; d < C::DP; d += 4) {
            float4 qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qv[i] = ld4(sQ + (4 * ty + i) * LD + d);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
                kv[jj] = ld4(sK + (tx + 16 * jj) * LD + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    float t = s[i][jj];
                    t = fmaf(qv[i].x, kv[jj].x, t);
                    t = fmaf(qv[i].y, kv[jj].y, t);
                    t = fmaf(qv[i].z, kv[jj].z, t);
                    s[i][jj] = fmaf(qv[i].w, kv[jj].w, t);
                }
        }

        float corr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + 4 * ty + i;
            float mx = NEG;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const int key = k0 + tx + 16 * jj;
                float x = s[i][jj] * scale;
                if (key >= seq) {
                    x = -INFINITY;
                } else {
                    if (causal && key > row) x = NEG;
                    if (mrow && !(mrow[key] > 0.f)) x = NEG;
                }
                s[i][jj] = x;
                mx = fmaxf(mx, x);
            }
            // a row's 16 threads are lanes of one half-warp
#pragma unroll
            for (int w = 1; w < 16; w *= 2)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
            const float m_new = fmaxf(m[i], mx);
            corr[i] = expf(m[i] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const float p = expf(s[i][jj] - m_new);
                rs += p;
                sP[(4 * ty + i) * LDP + tx + 16 * jj] = p;
            }
#pragma unroll
            for (int w = 1; w < 16; w *= 2)
                rs += __shfl_xor_sync(0xffffffffu, rs, w);
            l[i] = l[i] * corr[i] + rs;
            m[i] = m_new;
        }
        __syncwarp();                    // P rows, written by this half-warp

#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < NC; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][n][e] *= corr[i];
#pragma unroll 2
        for (int kk = 0; kk < BK; kk += 4) {
            float4 pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                pv[i] = ld4(sP + (4 * ty + i) * LDP + kk);
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                float4 vv[4];
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    vv[u] = ld4(sV + (kk + u) * LD + n * 64 + 4 * tx);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p4[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        acc[i][n][0] = fmaf(p4[u], vv[u].x, acc[i][n][0]);
                        acc[i][n][1] = fmaf(p4[u], vv[u].y, acc[i][n][1]);
                        acc[i][n][2] = fmaf(p4[u], vv[u].z, acc[i][n][2]);
                        acc[i][n][3] = fmaf(p4[u], vv[u].w, acc[i][n][3]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ty + i;
        if (row >= seq) continue;
        const float inv = 1.f / l[i];
        float* orow = o + base + (size_t)row * D;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
            const int col = n * 64 + 4 * tx;
            if (col < D)
                *reinterpret_cast<float4*>(orow + col) = make_float4(
                    acc[i][n][0] * inv, acc[i][n][1] * inv,
                    acc[i][n][2] * inv, acc[i][n][3] * inv);
        }
        if (tx == 0) lse[(size_t)bh * seq + row] = m[i] + logf(l[i]);
    }
}

template <int D>
cudaError_t dispatch(int is_bf16, const void* q, const void* k,
                     const void* v, const void* mask, void* o, void* lse,
                     int bh, int heads, int seq, int causal, float scale,
                     cudaStream_t stream) {
    const float* m = static_cast<const float*>(mask);
    float* ls = static_cast<float*>(lse);
    if (is_bf16) {
        constexpr size_t smem = Bf16Cfg<D>::SMEM;
        static_assert(smem <= 232448, "bf16 tiles exceed a block's shared memory");
        cudaError_t err = cudaFuncSetAttribute(
            flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return err;
        const dim3 grid(bh, (seq + Bf16Cfg<D>::BQ - 1) / Bf16Cfg<D>::BQ);
        flash_fwd_bf16<D><<<grid, THREADS, smem, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), m, static_cast<bf16*>(o), ls, seq,
            heads, causal, scale);
        return cudaGetLastError();
    }
    constexpr size_t smem = F32Cfg<D>::SMEM;
    static_assert(smem <= 232448, "f32 tiles exceed a block's shared memory");
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (seq + F32Cfg<D>::BQ - 1) / F32Cfg<D>::BQ);
    flash_fwd_f32<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), m, static_cast<float*>(o), ls, seq,
        heads, causal, scale);
    return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). `mask` may be null. Head dims: 64, 96, 128, 256.
// Every tensor must start on a 16-byte boundary.
extern "C" int dl4j_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, const void* mask,
                                        void* o, void* lse, int bh, int heads,
                                        int seq, int head_dim, int is_bf16,
                                        int causal, float scale,
                                        void* stream) {
    if (bh < 1 || heads < 1 || seq < 1 || seq > 65535 * 64)
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

// Dynamic shared memory a block of the kernel for (head_dim, dtype) takes,
// in bytes (0 for a head dim it is not built for).
extern "C" int dl4j_flash_attention_fwd_smem(int head_dim, int is_bf16) {
    switch (head_dim) {
        case 64: return (int)(is_bf16 ? Bf16Cfg<64>::SMEM : F32Cfg<64>::SMEM);
        case 96: return (int)(is_bf16 ? Bf16Cfg<96>::SMEM : F32Cfg<96>::SMEM);
        case 128: return (int)(is_bf16 ? Bf16Cfg<128>::SMEM : F32Cfg<128>::SMEM);
        case 256: return (int)(is_bf16 ? Bf16Cfg<256>::SMEM : F32Cfg<256>::SMEM);
        default: return 0;
    }
}
