// One ring-attention hop folded into a raw online-softmax carry, for Hopper
// (sm_90a), CUDA C++ behind a C interface (loaded with ctypes by
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
//   only read.
//
// What bounds it on this card: 4 * D flops per visible query/key pair
// (Tq * Tk pairs, about half on the diagonal hop) against q, k, v read once
// and acc, m, l read and written once. At the ring's block (Tq = Tk = 2048,
// D 64) that is 256 flops a byte in f32 against the card's balance of
// 67 TFLOP/s / 3.35 TB/s = 20, so the hop is bound by operations in f32;
// in bf16 (peak 989 TFLOP/s, balance 295) it is bound by bytes. The earlier
// design (scalar FMAs, four threads a row, P through shared memory) took
// the same time in both dtypes, 19 % of the f32 bound, and its diagonal
// hop cost a full one.
//
// Design: the forward's key loop (csrc/flash_fwd_tile.cuh, shared with
// K1) with the carry loaded into the loop's state before it and stored raw
// after it.
// - A block owns 64 query rows at a time. At D 64 it holds two groups of
//   256 threads that take alternate key tiles (bf16: chunks of two), each
//   with its own copy of Q, its own stages and its own barrier; above D 64
//   it is one group. Warpgroup 0 starts from the carry, the others empty;
//   at the end the others hand their (acc, m, l) to it through shared
//   memory, and it merges them (m = max, each part scaled by e^(m_i - m),
//   always in the same order, so every run gives the same bits) and stores
//   the carry.
// - bf16: a group's two warpgroups share its Q, staged once into
//   128-byte-swizzled panels, and split its key tiles, each step a
//   two-stage ring of 16-byte cp.async copies bringing 128 keys of K and V
//   (one stage at D 256); each runs the wgmma tile loop on its 64 keys.
// - f32: K1's register-tiled FMA pass, one a group.
// - Both: on the diagonal hop a block takes two query tiles, i and n-1-i
//   (the heavier first), as the dq kernel (K2) pairs them, so every block
//   does n+1 key tiles and the grid of n/2 pairs has no block that carries
//   a whole row of key tiles while the others idle: the diagonal hop costs
//   about half of a full one. Key tiles wholly above a query tile's
//   diagonal are skipped; ragged Tq and Tk are masked in the kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "flash_fwd_tile.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace dl4j_sm90;
using dl4j_fwd::BK;
using dl4j_fwd::NEG;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;                  // query rows a block owns at a time

// The block's query tiles: tile `item`, or with causal attention the pair
// (n-1-item, item), heavier first; returns the tile of `pass` or -1.
__device__ __forceinline__ int query_tile(int pass, int item, int ntq,
                                          int causal) {
    if (!causal) return pass == 0 ? item : -1;
    const int hi = ntq - 1 - item;
    if (pass == 0) return hi;
    return item < hi ? item : -1;
}

struct Args {
    const void *q, *k, *v, *acc_in, *m_in, *l_in;
    void *acc_out, *m_out, *l_out;
    int bh, tq, tk, causal;
    float scale;
    cudaStream_t stream;
};

// Groups: at D 64 (the ring's head dim) a block holds two independent
// groups of 256 threads that take alternate chunks of key tiles, each with
// its own copy of Q, its own ring of stages and its own barrier, so that
// the diagonal hop's n/2 pair blocks keep as many warps busy on each SM as
// the full hop's n blocks do; the groups' states are merged at the end of
// each query tile. Above D 64 the accumulators need more than 128
// registers a thread and a block is one group.
template <int D> constexpr int groups_for() { return D == 64 ? 2 : 1; }

// The other warpgroups' states (acc [WG-1][BQ][LDR], then m and l
// [WG-1][BQ]) go through shared memory to warpgroup 0, which merges them
// into its own in warpgroup order (m = max, each part scaled by
// e^(m_i - m)), so every run gives the same bits.

// ------------------------------------------------------------ bf16, wgmma
template <int D> struct Bf16Cfg {
    static constexpr int GROUPS = groups_for<D>();
    static constexpr int WGG = 2;                  // warpgroups a group
    static constexpr int WG = GROUPS * WGG;
    static constexpr int THREADS = 128 * WG;
    static constexpr int NC = dl4j_fwd::Panels<D>::NC;
    static constexpr uint32_t TILE_BYTES = dl4j_fwd::Panels<D>::TILE_BYTES;
    static constexpr int STAGES = NC > 2 ? 1 : 2;
    // K and V, a 64-key tile of each for each warpgroup of a group
    static constexpr uint32_t STAGE_BYTES = 2 * WGG * TILE_BYTES;
    // a group's Q panels, then its stages
    static constexpr uint32_t GROUP_BYTES = TILE_BYTES + STAGES * STAGE_BYTES;
    static constexpr int LDR = NC * PANEL + 8;   // handed-over acc row, floats
    static constexpr size_t SMEM = 1024 + (size_t)GROUPS * GROUP_BYTES;
    static_assert((size_t)(WG - 1) * BQ * (LDR + 2) * sizeof(float)
                      <= (size_t)GROUPS * GROUP_BYTES,
                  "the other warpgroups' states must fit in shared memory");
};

template <int D>
__global__ void __launch_bounds__(Bf16Cfg<D>::THREADS)
block_update_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v,
                  const float* __restrict__ acc_in,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in, float* __restrict__ acc_out,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  int tq, int tk, int causal, float scale) {
    using C = Bf16Cfg<D>;
    constexpr int NC = C::NC, WG = C::WG, WGG = C::WGG, GROUPS = C::GROUPS;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const uint32_t sBase = (smem_u32(smem_raw) + 1023u) & ~1023u;
    // after the key loop: the other warpgroups' states
    float* sPart =
        reinterpret_cast<float*>(smem_raw + (sBase - smem_u32(smem_raw)));
    float* sM = sPart + (WG - 1) * BQ * C::LDR;
    float* sL = sM + (WG - 1) * BQ;

    const int tid = threadIdx.x;
    const int grp = tid / 256, gtid = tid % 256;   // group, thread in it
    const int wg = tid / 128, wl = wg % WGG;       // warpgroup, in the group
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int bar = 1 + grp;                       // the group's barrier
    const uint32_t sQ = sBase + grp * C::GROUP_BYTES;
    const uint32_t sSt = sQ + C::TILE_BYTES;
    const int bh = blockIdx.x;
    const int ntq = (tq + BQ - 1) / BQ;
    const bf16* qb = q + (size_t)bh * tq * D;
    const bf16* kb = k + (size_t)bh * tk * D;
    const bf16* vb = v + (size_t)bh * tk * D;

    for (int pass = 0; pass < 2; ++pass) {
        const int qt = query_tile(pass, blockIdx.y, ntq, causal);
        if (qt < 0) break;
        const int q0 = qt * BQ;
        // keys [0, k_end): causal tiles above the diagonal hold no pair
        const int k_end = causal ? min(tk, q0 + BQ) : tk;
        // chunks of WGG key tiles; the group takes chunks grp, grp + GROUPS..
        const int nchunks = (k_end + WGG * BK - 1) / (WGG * BK);
        const int nsteps = nchunks > grp ? (nchunks - grp + GROUPS - 1)
                                                / GROUPS : 0;
        // K and V rows of chunk ch into a stage, zeros from k_end on
        auto load_step = [&](uint32_t st, int ch) {
#pragma unroll
            for (int w = 0; w < WGG; ++w) {
                const int t0 = (ch * WGG + w) * BK;
                load_panels<D, BK>(st + w * C::TILE_BYTES, kb, t0, k_end,
                                   gtid, 256);
                load_panels<D, BK>(st + (WGG + w) * C::TILE_BYTES, vb, t0,
                                   k_end, gtid, 256);
            }
        };
        __syncthreads();                 // the last pass is done with smem
        load_panels<D, BQ>(sQ, qb, q0, tq, gtid, 256);
        if constexpr (C::STAGES == 2)
            if (nsteps > 0) load_step(sSt, grp);
        cp_async_commit();

        // this thread's fragment rows; warpgroup 0 starts from the carry,
        // the others empty
        const int lr0 = warp * 16 + g;
        const int r0 = q0 + lr0, r1 = r0 + 8;
        float acc[NC][32];
        float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;
        if (wg == 0) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
                const int row = hi ? r1 : r0;
                if (row >= tq) continue;
                const size_t at = (size_t)bh * tq + row;
#pragma unroll
                for (int n = 0; n < NC; ++n)
#pragma unroll
                    for (int jj = 0; jj < 8; ++jj) {
                        const int col = n * PANEL + 8 * jj + 2 * c;
                        if (col < D) {
                            const float2 a = *reinterpret_cast<const float2*>(
                                acc_in + at * D + col);
                            acc[n][4 * jj + 2 * hi] = a.x;
                            acc[n][4 * jj + 2 * hi + 1] = a.y;
                        }
                    }
                if (hi) { m1 = m_in[at]; l1 = l_in[at]; }
                else { m0 = m_in[at]; l0 = l_in[at]; }
            }
        }

        for (int s = 0; s < nsteps; ++s) {
            const int ch = grp + s * GROUPS;
            dl4j_fwd::group_sync(bar, 256);   // the stage to fill is consumed
            uint32_t st;
            if constexpr (C::STAGES == 2) {
                if (s + 1 < nsteps)
                    load_step(sSt + ((s + 1) & 1) * C::STAGE_BYTES,
                              ch + GROUPS);
                cp_async_commit();
                cp_async_wait<1>();      // this thread's copies of step s
                st = sSt + (s & 1) * C::STAGE_BYTES;
            } else {
                load_step(sSt, ch);
                cp_async_commit();
                cp_async_wait<0>();
                st = sSt;
            }
            fence_async_shared();
            dl4j_fwd::group_sync(bar, 256);   // the group's copies of step s
            const int k0 = (ch * WGG + wl) * BK;   // this warpgroup's keys
            if (k0 >= k_end) continue;
            dl4j_fwd::bf16_key_tile<D>(acc, m0, m1, l0, l1, sQ,
                                       BQ * ROW_BYTES,
                                       st + wl * C::TILE_BYTES,
                                       st + (WGG + wl) * C::TILE_BYTES, k0,
                                       r0, r1, c, tk, causal, nullptr, scale);
        }
        cp_async_wait<0>();
        __syncthreads();                 // every group is done with its smem

        if (wg > 0) {
            float* part = sPart + (wg - 1) * BQ * C::LDR;
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
                const int lr = lr0 + 8 * hi;
#pragma unroll
                for (int n = 0; n < NC; ++n)
#pragma unroll
                    for (int jj = 0; jj < 8; ++jj) {
                        const int i = 4 * jj + 2 * hi;
                        *reinterpret_cast<float2*>(
                            part + lr * C::LDR + n * PANEL + 8 * jj + 2 * c) =
                            make_float2(acc[n][i], acc[n][i + 1]);
                    }
                if (c == 0) {
                    sM[(wg - 1) * BQ + lr] = hi ? m1 : m0;
                    sL[(wg - 1) * BQ + lr] = hi ? l1 : l0;
                }
            }
        }
        __syncthreads();
        if (wg == 0) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
                const int row = hi ? r1 : r0, lr = lr0 + 8 * hi;
                if (row >= tq) continue;
                const float mw = hi ? m1 : m0, lw = hi ? l1 : l0;
                float mn = mw;
#pragma unroll
                for (int w = 1; w < WG; ++w)
                    mn = fmaxf(mn, sM[(w - 1) * BQ + lr]);
                const float a = expf(mw - mn);
                float b[WG];                 // b[w]: warpgroup w's scale
                float l = lw * a;
#pragma unroll
                for (int w = 1; w < WG; ++w) {
                    b[w] = expf(sM[(w - 1) * BQ + lr] - mn);
                    l += sL[(w - 1) * BQ + lr] * b[w];
                }
                const size_t at = (size_t)bh * tq + row;
#pragma unroll
                for (int n = 0; n < NC; ++n)
#pragma unroll
                    for (int jj = 0; jj < 8; ++jj) {
                        const int col = n * PANEL + 8 * jj + 2 * c;
                        const int i = 4 * jj + 2 * hi;
                        float x = acc[n][i] * a, y = acc[n][i + 1] * a;
#pragma unroll
                        for (int w = 1; w < WG; ++w) {
                            const float2 o = *reinterpret_cast<const float2*>(
                                sPart + ((w - 1) * BQ + lr) * C::LDR
                                + n * PANEL + 8 * jj + 2 * c);
                            x += o.x * b[w];
                            y += o.y * b[w];
                        }
                        if (col < D)
                            *reinterpret_cast<float2*>(acc_out + at * D + col) =
                                make_float2(x, y);
                    }
                if (c == 0) {
                    m_out[at] = mn;
                    l_out[at] = l;
                }
            }
        }
    }
}

// --------------------------------------------------- f32, register tiles
template <int D> struct F32Cfg {
    using P = dl4j_fwd::F32Fwd<D>;
    static constexpr int GROUPS = groups_for<D>();
    static constexpr int THREADS = 256 * GROUPS;
    static constexpr int NC = P::NC;
    static constexpr size_t SMEM = GROUPS * P::SMEM;   // a pass's each group
    // group 1's state, thread-major: acc, then m and l
    static constexpr int PART = 4 * NC * 4 + 8;
    static_assert(GROUPS == 1 || (size_t)PART * 256 * sizeof(float)
                                     <= P::SMEM, "group 1's state must fit");
};

template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::THREADS)
block_update_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ acc_in,
                 const float* __restrict__ m_in,
                 const float* __restrict__ l_in, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int tq, int tk, int causal, float scale) {
    using C = F32Cfg<D>;
    constexpr int NC = C::NC, GROUPS = C::GROUPS;
    extern __shared__ __align__(16) float smf[];
    const int tid = threadIdx.x;
    const int grp = tid / 256, gtid = tid % 256;   // group, thread in it
    const int ty = gtid / 16, tx = gtid % 16;      // rows 4ty.., cols 4tx..
    float* sG = smf + grp * (C::P::SMEM / sizeof(float));   // the group's
    float* sPart = smf + C::P::SMEM / sizeof(float);        // group 1's
    const int bh = blockIdx.x;
    const int ntq = (tq + BQ - 1) / BQ;

    for (int pass = 0; pass < 2; ++pass) {
        const int qt = query_tile(pass, blockIdx.y, ntq, causal);
        if (qt < 0) break;
        const int q0 = qt * BQ;
        const int k_end = causal ? min(tk, q0 + BQ) : tk;
        __syncthreads();                 // the last pass is done with smem

        // group 0 starts from the incoming carry of its rows and columns,
        // group 1 empty
        float acc[4][NC][4], m[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + 4 * ty + i;
            const bool live = grp == 0 && row < tq;
            const size_t at = (size_t)bh * tq + row;
            m[i] = live ? m_in[at] : NEG;
            l[i] = live ? l_in[at] : 0.f;
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                const int col = n * 64 + 4 * tx;
                float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
                if (live && col < D)
                    a = *reinterpret_cast<const float4*>(acc_in + at * D + col);
                acc[i][n][0] = a.x;
                acc[i][n][1] = a.y;
                acc[i][n][2] = a.z;
                acc[i][n][3] = a.w;
            }
        }

        dl4j_fwd::f32_pass<D>(acc, m, l, sG, q + (size_t)bh * tq * D,
                              k + (size_t)bh * tk * D,
                              v + (size_t)bh * tk * D, q0, tq, tk, k_end,
                              causal, nullptr, scale, gtid, 1 + grp, grp,
                              GROUPS);

        if constexpr (GROUPS == 2) {
            // group 1 hands its state to group 0 through its own stages
            dl4j_fwd::group_sync(1 + grp, 256);   // its smem is read
            if (grp == 1) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
#pragma unroll
                    for (int n = 0; n < NC; ++n)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            sPart[((i * NC + n) * 4 + e) * 256 + gtid] =
                                acc[i][n][e];
                    sPart[(4 * NC * 4 + i) * 256 + gtid] = m[i];
                    sPart[(4 * NC * 4 + 4 + i) * 256 + gtid] = l[i];
                }
            }
            __syncthreads();
            if (grp == 1) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float mo = sPart[(4 * NC * 4 + i) * 256 + gtid];
                const float lo = sPart[(4 * NC * 4 + 4 + i) * 256 + gtid];
                const float mn = fmaxf(m[i], mo);
                const float a = expf(m[i] - mn), b = expf(mo - mn);
#pragma unroll
                for (int n = 0; n < NC; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[i][n][e] = acc[i][n][e] * a
                            + sPart[((i * NC + n) * 4 + e) * 256 + gtid] * b;
                m[i] = mn;
                l[i] = l[i] * a + lo * b;
            }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + 4 * ty + i;
            if (row >= tq) continue;
            const size_t at = (size_t)bh * tq + row;
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                const int col = n * 64 + 4 * tx;
                if (col < D)
                    *reinterpret_cast<float4*>(acc_out + at * D + col) =
                        make_float4(acc[i][n][0], acc[i][n][1], acc[i][n][2],
                                    acc[i][n][3]);
            }
            if (tx == 0) {
                m_out[at] = m[i];
                l_out[at] = l[i];
            }
        }
    }
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int threads, const Args& a) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int ntq = (a.tq + BQ - 1) / BQ;
    const dim3 grid(a.bh, a.causal ? (ntq + 1) / 2 : ntq);
    kernel<<<grid, threads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const float*>(a.acc_in),
        static_cast<const float*>(a.m_in), static_cast<const float*>(a.l_in),
        static_cast<float*>(a.acc_out), static_cast<float*>(a.m_out),
        static_cast<float*>(a.l_out), a.tq, a.tk, a.causal, a.scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int is_bf16, const Args& a) {
    if (is_bf16) {
        using C = Bf16Cfg<D>;
        static_assert(C::SMEM <= 232448, "bf16 tiles exceed a block's shared memory");
        return launch<bf16>(block_update_bf16<D>, C::SMEM, C::THREADS, a);
    }
    using C = F32Cfg<D>;
    static_assert(C::SMEM <= 232448, "f32 tiles exceed a block's shared memory");
    return launch<float>(block_update_f32<D>, C::SMEM, C::THREADS, a);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). Head dims: 64, 96, 128, 256. `causal` needs
// tq == tk. q, k, v and acc_in/acc_out must start on a 16-byte boundary.
extern "C" int dl4j_flash_block_update(const void* q, const void* k,
                                       const void* v, const void* acc_in,
                                       const void* m_in, const void* l_in,
                                       void* acc_out, void* m_out,
                                       void* l_out, int bh, int tq, int tk,
                                       int head_dim, int is_bf16, int causal,
                                       float scale, void* stream) {
    if (bh < 1 || bh > 65535 || tq < 1 || tk < 1 || tq > 65535 * BQ ||
        (causal && tq != tk))
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, acc_in, m_in, l_in, acc_out, m_out, l_out,
                 bh, tq, tk, causal, scale,
                 static_cast<cudaStream_t>(stream)};
    switch (head_dim) {
        case 64: return (int)dispatch<64>(is_bf16, a);
        case 96: return (int)dispatch<96>(is_bf16, a);
        case 128: return (int)dispatch<128>(is_bf16, a);
        case 256: return (int)dispatch<256>(is_bf16, a);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Dynamic shared memory a block of the kernel for (head_dim, dtype) takes,
// in bytes (0 for a head dim it is not built for).
extern "C" int dl4j_flash_block_update_smem(int head_dim, int is_bf16) {
    switch (head_dim) {
        case 64: return (int)(is_bf16 ? Bf16Cfg<64>::SMEM : F32Cfg<64>::SMEM);
        case 96: return (int)(is_bf16 ? Bf16Cfg<96>::SMEM : F32Cfg<96>::SMEM);
        case 128: return (int)(is_bf16 ? Bf16Cfg<128>::SMEM : F32Cfg<128>::SMEM);
        case 256: return (int)(is_bf16 ? Bf16Cfg<256>::SMEM : F32Cfg<256>::SMEM);
        default: return 0;
    }
}
