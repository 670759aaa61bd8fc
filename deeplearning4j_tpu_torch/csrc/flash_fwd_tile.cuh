// The flash-attention forward's tile loop for Hopper (sm_90a), shared by
// the forward kernel (csrc/flash_attention_fwd.cu, K1) and the ring hop's
// carry kernel (csrc/flash_block_update.cu, K4). The two differ only in
// where the online-softmax state (acc, m, l) comes from and goes to (K1
// starts empty and normalises into O and lse; K4 loads the incoming carry
// and stores it raw) and in how query tiles are scheduled; the key loop
// is this header's.
//
// Both take scores s = (q . k) * scale with keys past `kv_len` at -inf and
// causal keys above the diagonal (key > row, positions counted from 0 in
// both q and k) and masked keys (mask[key] <= 0) at -1e30, and update the
// state of each query row by one 64-key tile:
//   m' = max(m, rowmax s), corr = e^(m - m'), l' = l * corr + sum p,
//   acc' = acc * corr + p . v, p = e^(s - m').
//
// bf16 (`bf16_key_tile`): one warpgroup's 64 query rows against one key
// tile, on wgmma (csrc/hopper_mma.cuh). S = Q.K^T is an m64n64k16 wgmma per
// 16 columns of D with both operands in 128-byte-swizzled shared-memory
// panels; the softmax runs on the accumulator fragment, a row's four lanes
// agreeing through quad shuffles; P is rounded to bf16 in registers and is
// the register A operand of acc += P.V, V the MN-major B operand. acc is
// [NC][32] fragment registers (NC 64-column panels; D 96 runs as 128 with
// zero columns), m and l the thread's two fragment rows r0 and r0 + 8.
//
// f32 (`f32_pass`): a group of 256 threads and 64 query rows over key
// tiles below k_end (all of them, or every step-th: the ring hop's kernel
// runs two groups a block on alternate tiles), full f32 FMAs (no TF32).
// Each thread owns a 4-row x 4-key micro-tile of S and a 4-row x 4-column
// micro-tile of acc per 64 columns of D, reading operands from shared
// memory as float4 (rows padded to 4 words past a multiple of 32:
// broadcasts or conflict-free). K/V tiles are double-buffered with 16-byte
// cp.async copies (single-buffered at D 256, where two stages exceed
// 227 KB); P goes through shared memory in f32, read back by the half-warp
// that wrote it.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper_mma.cuh"

namespace dl4j_fwd {

using namespace dl4j_sm90;

constexpr float NEG = -1e30f;
constexpr int THREADS = 256;
constexpr int BK = 64;                  // keys a tile

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------ bf16, wgmma
template <int D> struct Panels {
    static constexpr int NC = (D + PANEL - 1) / PANEL;   // 64-column panels
    static constexpr uint32_t TILE_BYTES = NC * BK * ROW_BYTES;   // 64 rows
};

// One warpgroup's 64 query rows against the 64 keys [k0, k0 + 64): Q panel
// p at sQ + p * q_panel (sQ: the warpgroup's first row), K and V tiles of
// NC panels at sK and sV. r0, r1: the thread's fragment rows; c = lane % 4.
template <int D>
__device__ __forceinline__ void bf16_key_tile(
        float (&acc)[Panels<D>::NC][32], float& m0, float& m1, float& l0,
        float& l1, uint32_t sQ, uint32_t q_panel, uint32_t sK, uint32_t sV,
        int k0, int r0, int r1, int c, int kv_len, int causal,
        const float* mrow, float scale) {
    constexpr int NC = Panels<D>::NC;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NC * 4; ++kk) {
        const uint32_t off = (uint32_t)(kk % 4) * 32;   // 16 columns
        wgmma_ss(s, desc(sQ + (kk / 4) * q_panel + off, 16, 1024),
                 desc(sK + (kk / 4) * (BK * ROW_BYTES) + off, 16, 1024),
                 kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    // scores of rows r0 (s[4j + e]) and r1 (s[4j + 2 + e]), key
    // k0 + 8j + 2c + e; a tile below the diagonal, inside the keys and
    // without a mask needs no masking
    float mx0 = NEG, mx1 = NEG;
    const bool edge = k0 + BK > kv_len || (causal && k0 + BK - 1 > r0) ||
                      mrow != nullptr;
    if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int row = (i & 2) ? r1 : r0;
            const int key = k0 + 8 * (i / 4) + 2 * c + (i & 1);
            float x = s[i] * scale;
            if (key >= kv_len) {
                x = -INFINITY;           // past the ragged edge: no key
            } else {
                if (causal && key > row) x = NEG;
                if (mrow && !(mrow[key] > 0.f)) x = NEG;
            }
            s[i] = x;
            if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
        }
    } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            s[i] *= scale;
            if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
        }
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

    uint32_t a[4][4];                    // P in bf16, the A operand
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

// --------------------------------------------------- f32, register tiles
template <int D> struct F32Fwd {
    static constexpr int DP = F32Rows<D>::DP;   // padded head dim
    static constexpr int LD = F32Rows<D>::LD;   // row stride, floats
    static constexpr int NC = DP / 64;
    static constexpr int LDP = BK + 4;      // P row stride
    static constexpr int BQ = 64;
    static constexpr int STAGES = DP > 128 ? 1 : 2;
    static constexpr size_t SMEM =
        ((size_t)(BQ + 2 * BK * STAGES) * LD + (size_t)BQ * LDP)
        * sizeof(float);
};

// A barrier of the `n` threads that use barrier `id` (0: __syncthreads's,
// when n is the block's size)
__device__ __forceinline__ void group_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// One group of 256 threads' pass of the 64 query rows [q0, q0 + 64) of the
// [q_len, D] slab qb over the key tiles tile0, tile0 + step, ... below k_end
// of the [kv_len, D] slabs kb and vb, into the state (acc, m, l) the caller
// initialised: thread (ty, tx) = (tid / 16, tid % 16) of the group owns
// rows q0 + 4ty + i and, per 64 columns n, columns 64n + 4tx.. of acc. smf:
// the group's F32Fwd<D>::SMEM bytes of shared memory; `bar`: the group's
// barrier (0 with step 1 for a block that is one group). Ends with every
// copy waited for; the caller synchronises before reusing the shared
// memory.
template <int D>
__device__ __forceinline__ void f32_pass(
        float (&acc)[4][F32Fwd<D>::NC][4], float (&m)[4], float (&l)[4],
        float* smf, const float* qb, const float* kb, const float* vb,
        int q0, int q_len, int kv_len, int k_end, int causal,
        const float* mrow, float scale, int tid, int bar = 0, int tile0 = 0,
        int step = 1) {
    using C = F32Fwd<D>;
    constexpr int LD = C::LD, LDP = C::LDP, NC = C::NC;
    float* sQ = smf;
    float* sKV = sQ + C::BQ * LD;            // stage s: K at s*2*BK*LD
    float* sP = sKV + 2 * BK * C::STAGES * LD;
    const int ty = tid / 16, tx = tid % 16;  // rows 4ty.., keys tx + 16j
    const int ntiles = (k_end + BK - 1) / BK;

    // K and V rows [t0, t0 + BK) into the stage at dst
    auto load_kv = [&](float* dst, int t0) {
        load_rows_f32<D, BK>(dst, kb, t0, kv_len, tid, THREADS);
        load_rows_f32<D, BK>(dst + BK * LD, vb, t0, kv_len, tid, THREADS);
    };
    load_rows_f32<D, C::BQ>(sQ, qb, q0, q_len, tid, THREADS);
    if constexpr (C::STAGES == 2)
        if (tile0 < ntiles) load_kv(sKV, tile0 * BK);
    cp_async_commit();

    for (int j = tile0, it = 0; j < ntiles; j += step, ++it) {
        group_sync(bar, THREADS);
        const float* sK;
        if constexpr (C::STAGES == 2) {
            if (j + step < ntiles)
                load_kv(sKV + ((it + 1) & 1) * 2 * BK * LD, (j + step) * BK);
            cp_async_commit();
            cp_async_wait<1>();
            sK = sKV + (it & 1) * 2 * BK * LD;
        } else {
            load_kv(sKV, j * BK);
            cp_async_commit();
            cp_async_wait<0>();
            sK = sKV;
        }
        group_sync(bar, THREADS);
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
                if (key >= kv_len) {
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
}

}  // namespace dl4j_fwd
