// Flash-attention backward, the dk/dv pass, for Hopper (sm_90a): CUDA C++
// behind a C interface (loaded with ctypes by
// deeplearning4j_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/pallas_attention.py `_bwd`
// -> `_dkv_body` (the pl.pallas_call at :376). Same function, the dk/dv half
// of the FlashAttention-2 backward that recomputes P from the forward's lse:
//   inputs q, k, v, dO [BH, T, D] (f32 or bf16), lse [BH, T] f32 (K1's, one
//   value per row), delta = rowsum(dO * O) [BH, T] f32, optional key mask
//   [B, T] (f32, > 0 = visible, row b = bh / H);
//   s = (q . k) * scale, causal keys above the diagonal and masked keys
//   filled with -1e30 as K1 fills them, p = exp(s - lse),
//   dS = p * (dO . v - delta) * scale;
//   dv = sum_q p^T . dO, dk = sum_q dS^T . q, stored in the input dtype.
//   With bf16 inputs the products take bf16 operands with f32 accumulation,
//   and p and dS are rounded to bf16 before the products that take them, as
//   the reference's p.astype(do.dtype) and ds.astype(q.dtype) do. lse and
//   delta are taken as given (a ring hop passes the whole sequence's).
//
// A row with no visible key (lse at or below -1e29: K1 filled every score
// with -1e30) takes p = 1/T for every key and dS = 0, which is autograd
// through the plain forward (the TPU kernel's exp(s - lse) = 1 gives T
// times the dv). Queries past a ragged edge give p = dS = 0. Without a key
// mask, causal query tiles that see none of a block's keys are skipped;
// with one, every tile is visited, since a row with no visible key spreads
// its dv over all T keys.
//
// Order of sums: every output element is summed in one fixed order (query
// tiles ascending, no atomics), so results are the same from run to run.
// In f32 that is the order of the plain version's products on the card:
// chip_smoke.py measures rel-to-max 0.0 at every shape it checks (pin
// 1e-4). In bf16 the tensor cores sum in their own order, so the two agree
// to rounding: about 4e-3 rel-to-max on an H100 (pin 2e-2).
//
// What bounds it on this card: four D-long products a visible query/key
// pair (8*D flops) against q/k/v/dO reads and dk/dv writes (6*BH*T*D
// elements). Causal at T 1024, D 64 that is about 170 flops a byte in f32
// (balance 20) and 340 in bf16 (balance 295): bound by operations. The
// earlier scalar design reached 10-20 % of the f32 bound: two shared loads
// per two FMAs, p and dS through shared memory as f32, synchronous staging.
//
// bf16 design, after FlashAttention-3: a block of two warpgroups owns 128
// keys, 64 a warpgroup, with K and V staged once in 128-byte-swizzled
// panels, and loops over 64-query tiles (Q, dO, lse, delta) that stream
// through a two-stage ring of cp.async copies (the next tile's loads
// overlap this tile's math; every thread copies its share and waits on its
// own copy group and a block barrier). S^T = K.Q^T and dP^T = V.dO^T are
// m64n64k16 wgmmas with both operands in shared memory; keys are the M
// rows, so P^T and dS^T land in registers as accumulator fragments whose
// columns are queries (lse and delta indexed by column). Both are rounded
// to bf16 in registers and become the register A operands of dV += P^T.dO
// and dK += dS^T.Q, dO and Q being MN-major B operands in shared memory:
// neither p nor dS touches shared memory. dK and dV accumulate in f32
// registers, 2 x 32 a thread per 64 columns of D. At D 256, 2 x 128 would
// not fit: the grid's third axis splits D's four 64-column panels into two
// halves, each block recomputing S^T and dP^T over the whole D for its
// half's dK and dV (so D 256 does 1.5x the score work), with a one-stage
// ring (two would exceed 227 KB). D = 96 runs as 128 with zero columns.
//
// f32 design: full f32 FMAs (no TF32: the pin is rel-to-max 1e-4). A block
// of 256 threads owns 64 keys; each thread owns a 4-key x 4-query
// micro-tile of S^T and dP^T and a 4-key x 4-column micro-tile of dK and of
// dV per 64 columns of D, reading every operand from shared memory as
// float4 (broadcast or conflict-free). p and dS go through shared memory in
// f32, read back by the warp that wrote them. Query tiles are 64 rows
// double-buffered at D 64, single-buffered at D 96/128, and 32 rows at
// D 256 (shared memory).
//
// Both: causal key blocks are launched heaviest first (the lowest keys see
// the most queries, and the grid walks them in that order). Left for later:
// a producer warp with TMA and mbarriers, a persistent grid, dq fused in.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper_mma.cuh"

namespace {

using namespace dl4j_sm90;
using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr float DEAD = -1e29f;          // lse at or below: no visible key
constexpr int THREADS = 256;

// ------------------------------------------------------------ bf16, wgmma
template <int D> struct Bf16Cfg {
    static constexpr int NC = (D + PANEL - 1) / PANEL;   // 64-column panels
    static constexpr int NCO = NC < 2 ? NC : 2;          // output panels a block
    static constexpr int SLICES = NC / NCO;
    static constexpr int KEYS = 128;                     // two warpgroups
    static constexpr int BQ = 64;
    static constexpr int STAGES = NC > 2 ? 1 : 2;
    static constexpr uint32_t KV_BYTES = NC * KEYS * ROW_BYTES;
    static constexpr uint32_t TILE_BYTES = NC * BQ * ROW_BYTES;   // Q or dO
    static constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES + 1024;
    static constexpr size_t SMEM = 1024 + 2 * (size_t)KV_BYTES
                                   + STAGES * (size_t)STAGE_BYTES;
};

// one query tile's Q, dO, lse and delta into a stage
template <int D>
__device__ __forceinline__ void load_tile_bf16(
        uint32_t st, const bf16* q, const bf16* dout, const float* lse,
        const float* delta, int q0, int seq, int tid) {
    using C = Bf16Cfg<D>;
    load_panels<D, C::BQ>(st, q, q0, seq, tid, THREADS);
    load_panels<D, C::BQ>(st + C::TILE_BYTES, dout, q0, seq, tid, THREADS);
    if (tid < 2 * C::BQ) {
        const int i = tid % C::BQ, t = q0 + i;
        const float* src = tid < C::BQ ? lse : delta;
        cp_async4(st + 2 * C::TILE_BYTES + (tid / C::BQ) * 256 + 4 * i,
                  t < seq ? src + t : src, t < seq);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ mask, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int seq, int heads, int causal,
               float scale) {
    using C = Bf16Cfg<D>;
    constexpr int NC = C::NC, NCO = C::NCO, BQ = C::BQ;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sV = sK + C::KV_BYTES;
    const uint32_t sSt = sV + C::KV_BYTES;
    const unsigned char* gen0 = smem_raw + (sSt - smem_u32(smem_raw));

    const int tid = threadIdx.x;
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int bh = blockIdx.x;
    const int k0 = blockIdx.y * C::KEYS;
    const int pc0 = blockIdx.z * NCO;       // first output panel
    const int kw = k0 + wg * 64;            // this warpgroup's first key
    const int kr0 = kw + warp * 16 + g, kr1 = kr0 + 8;
    const size_t base = (size_t)bh * seq * D;
    const float* lrow = lse + (size_t)bh * seq;
    const float* drow = delta + (size_t)bh * seq;
    const float* mrow = mask ? mask + (size_t)(bh / heads) * seq : nullptr;
    const bool vis0 = !mrow || kr0 >= seq || mrow[kr0] > 0.f;
    const bool vis1 = !mrow || kr1 >= seq || mrow[kr1] > 0.f;
    const float uniform = 1.f / (float)seq;  // p of a row with no visible key
    const bool skip_before = causal && !mrow;
    const int q_begin = skip_before ? k0 : 0;
    const int ntiles = (seq - q_begin + BQ - 1) / BQ;

    load_panels<D, C::KEYS>(sK, k + base, k0, seq, tid, THREADS);
    load_panels<D, C::KEYS>(sV, v + base, k0, seq, tid, THREADS);
    if constexpr (C::STAGES == 2)
        load_tile_bf16<D>(sSt, q + base, dout + base, lrow, drow, q_begin,
                          seq, tid);
    cp_async_commit();

    float acc_k[NCO][32], acc_v[NCO][32];
#pragma unroll
    for (int n = 0; n < NCO; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;

    for (int j = 0; j < ntiles; ++j) {
        const int q0 = q_begin + j * BQ;
        __syncthreads();                 // the stage to fill is consumed
        uint32_t st;
        if constexpr (C::STAGES == 2) {
            if (j + 1 < ntiles)
                load_tile_bf16<D>(sSt + ((j + 1) & 1) * C::STAGE_BYTES,
                                  q + base, dout + base, lrow, drow, q0 + BQ,
                                  seq, tid);
            cp_async_commit();
            cp_async_wait<1>();
            st = sSt + (j & 1) * C::STAGE_BYTES;
        } else {
            load_tile_bf16<D>(sSt, q + base, dout + base, lrow, drow, q0, seq,
                              tid);
            cp_async_commit();
            cp_async_wait<0>();
            st = sSt;
        }
        fence_async_shared();
        __syncthreads();
        // causal, no mask: these queries see none of this warpgroup's keys
        if (skip_before && q0 + BQ - 1 < kw) continue;
        const uint32_t sQ = st, sDO = st + C::TILE_BYTES;
        const float* sL = reinterpret_cast<const float*>(
            gen0 + (st - sSt) + 2 * C::TILE_BYTES);
        const float* sDl = sL + 64;

        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        fence_regs(s);
        fence_regs(dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < NC * 4; ++kk) {
            const uint32_t off = (uint32_t)(kk % 4) * 32;   // 16 columns
            const uint32_t own = (kk / 4) * (C::KEYS * ROW_BYTES)
                                 + wg * 64 * ROW_BYTES + off;
            const uint32_t strm = (kk / 4) * (BQ * ROW_BYTES) + off;
            wgmma_ss(s, desc(sK + own, 16, 1024), desc(sQ + strm, 16, 1024),
                     kk > 0);
            wgmma_ss(dp, desc(sV + own, 16, 1024),
                     desc(sDO + strm, 16, 1024), kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // element i: key kr0 (i & 2 == 0) or kr1, query q0 + col
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int col = 8 * (i / 4) + 2 * c + (i & 1);
            const int query = q0 + col;
            const int key = (i & 2) ? kr1 : kr0;
            float p = 0.f, ds = 0.f;
            if (query < seq) {
                const float l = sL[col];
                if (l <= DEAD) {
                    p = uniform;
                } else {
                    float x = s[i] * scale;
                    if (causal && key > query) x = NEG;
                    if (!((i & 2) ? vis1 : vis0)) x = NEG;
                    p = expf(x - l);
                    ds = p * (dp[i] - sDl[col]) * scale;
                }
            }
            s[i] = p;
            dp[i] = ds;
        }
        uint32_t ap[4][4], ads[4][4];    // P^T and dS^T in bf16, A operands
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            frag_to_a(s, kk, ap[kk]);
            frag_to_a(dp, kk, ads[kk]);
        }
        wg_fence();
#pragma unroll
        for (int n = 0; n < NCO; ++n)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint32_t off = (pc0 + n) * (BQ * ROW_BYTES)
                                     + kk * 16 * ROW_BYTES;
                wgmma_rs(acc_v[n], ap[kk],
                         desc(sDO + off, BQ * ROW_BYTES, 1024));
                wgmma_rs(acc_k[n], ads[kk],
                         desc(sQ + off, BQ * ROW_BYTES, 1024));
            }
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int n = 0; n < NCO; ++n) {
            fence_regs(acc_k[n]);
            fence_regs(acc_v[n]);
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
        const int key = hi ? kr1 : kr0;
        if (key >= seq) continue;
        bf16* ok = dk + base + (size_t)key * D;
        bf16* ov = dv + base + (size_t)key * D;
#pragma unroll
        for (int n = 0; n < NCO; ++n)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                const int col = (pc0 + n) * PANEL + 8 * jj + 2 * c;
                const int i = 4 * jj + 2 * hi;
                if (col < D) {
                    *reinterpret_cast<__nv_bfloat162*>(ok + col) =
                        __floats2bfloat162_rn(acc_k[n][i], acc_k[n][i + 1]);
                    *reinterpret_cast<__nv_bfloat162*>(ov + col) =
                        __floats2bfloat162_rn(acc_v[n][i], acc_v[n][i + 1]);
                }
            }
    }
}

// --------------------------------------------------- f32, register tiles
template <int D> struct F32Cfg {
    static constexpr int DP = F32Rows<D>::DP;   // padded head dim
    static constexpr int NC = DP / 64;
    static constexpr int LD = F32Rows<D>::LD;   // row stride, floats
    static constexpr int KEYS = 64;
    static constexpr int BQ = DP > 128 ? 32 : 64;
    static constexpr int QJ = BQ / 16;       // queries a thread scores
    static constexpr int LDS = BQ + 4;       // p / dS row stride
    static constexpr int STAGES = DP > 64 ? 1 : 2;
    static constexpr int STAGE_FLOATS = 2 * BQ * LD + 2 * BQ;
    static constexpr size_t SMEM =
        ((size_t)2 * KEYS * LD + (size_t)STAGES * STAGE_FLOATS
         + (size_t)2 * KEYS * LDS) * sizeof(float);
};

template <int D>
__device__ __forceinline__ void load_tile_f32(float* st, const float* q,
                                              const float* dout,
                                              const float* lse,
                                              const float* delta, int q0,
                                              int seq) {
    using C = F32Cfg<D>;
    const int tid = threadIdx.x;
    load_rows_f32<D, C::BQ>(st, q, q0, seq, tid, THREADS);
    load_rows_f32<D, C::BQ>(st + C::BQ * C::LD, dout, q0, seq, tid, THREADS);
    if (tid < 2 * C::BQ) {
        const int i = tid % C::BQ, t = q0 + i;
        const float* src = tid < C::BQ ? lse : delta;
        cp_async4(smem_u32(st + 2 * C::BQ * C::LD + (tid / C::BQ) * C::BQ + i),
                  t < seq ? src + t : src, t < seq);
    }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ mask, float* __restrict__ dk,
              float* __restrict__ dv, int seq, int heads, int causal,
              float scale) {
    using C = F32Cfg<D>;
    constexpr int LD = C::LD, LDS = C::LDS, NC = C::NC, BQ = C::BQ,
                  QJ = C::QJ;
    extern __shared__ __align__(16) float smf[];
    float* sK = smf;
    float* sV = sK + C::KEYS * LD;
    float* sSt = sV + C::KEYS * LD;          // stage s at s * STAGE_FLOATS
    float* sP = sSt + C::STAGES * C::STAGE_FLOATS;
    float* sDS = sP + C::KEYS * LDS;

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;  // keys 4ty.., queries tx + 16j
    const int bh = blockIdx.x;
    const int k0 = blockIdx.y * C::KEYS;
    const size_t base = (size_t)bh * seq * D;
    const float* lrow = lse + (size_t)bh * seq;
    const float* drow = delta + (size_t)bh * seq;
    const float* mrow = mask ? mask + (size_t)(bh / heads) * seq : nullptr;
    const float uniform = 1.f / (float)seq;
    bool vis[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int key = k0 + 4 * ty + i;
        vis[i] = !mrow || key >= seq || mrow[key] > 0.f;
    }
    const int q_begin = (causal && !mrow) ? (k0 / BQ) * BQ : 0;
    const int ntiles = (seq - q_begin + BQ - 1) / BQ;

    load_rows_f32<D, C::KEYS>(sK, k + base, k0, seq, tid, THREADS);
    load_rows_f32<D, C::KEYS>(sV, v + base, k0, seq, tid, THREADS);
    if constexpr (C::STAGES == 2)
        load_tile_f32<D>(sSt, q + base, dout + base, lrow, drow, q_begin, seq);
    cp_async_commit();

    float acc_k[4][NC][4], acc_v[4][NC][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc_k[i][n][e] = acc_v[i][n][e] = 0.f;

    for (int j = 0; j < ntiles; ++j) {
        const int q0 = q_begin + j * BQ;
        __syncthreads();
        const float* st;
        if constexpr (C::STAGES == 2) {
            if (j + 1 < ntiles)
                load_tile_f32<D>(sSt + ((j + 1) & 1) * C::STAGE_FLOATS,
                                 q + base, dout + base, lrow, drow, q0 + BQ,
                                 seq);
            cp_async_commit();
            cp_async_wait<1>();
            st = sSt + (j & 1) * C::STAGE_FLOATS;
        } else {
            load_tile_f32<D>(sSt, q + base, dout + base, lrow, drow, q0, seq);
            cp_async_commit();
            cp_async_wait<0>();
            st = sSt;
        }
        __syncthreads();
        const float* sQ = st;
        const float* sDO = st + BQ * LD;
        const float* sL = st + 2 * BQ * LD;
        const float* sDl = sL + BQ;

        float s[4][QJ], dp[4][QJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < QJ; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 2
        for (int d = 0; d < C::DP; d += 4) {
            float4 kv[4], vv[4], qv[QJ], ov[QJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                kv[i] = ld4(sK + (4 * ty + i) * LD + d);
                vv[i] = ld4(sV + (4 * ty + i) * LD + d);
            }
#pragma unroll
            for (int jj = 0; jj < QJ; ++jj) {
                qv[jj] = ld4(sQ + (tx + 16 * jj) * LD + d);
                ov[jj] = ld4(sDO + (tx + 16 * jj) * LD + d);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int jj = 0; jj < QJ; ++jj) {
                    s[i][jj] = dot4(kv[i], qv[jj], s[i][jj]);
                    dp[i][jj] = dot4(vv[i], ov[jj], dp[i][jj]);
                }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int key = k0 + 4 * ty + i;
#pragma unroll
            for (int jj = 0; jj < QJ; ++jj) {
                const int col = tx + 16 * jj;
                const int query = q0 + col;
                float p = 0.f, ds = 0.f;
                if (query < seq) {
                    const float l = sL[col];
                    if (l <= DEAD) {
                        p = uniform;
                    } else {
                        float x = s[i][jj] * scale;
                        if (causal && key > query) x = NEG;
                        if (!vis[i]) x = NEG;
                        p = expf(x - l);
                        ds = p * (dp[i][jj] - sDl[col]) * scale;
                    }
                }
                sP[(4 * ty + i) * LDS + col] = p;
                sDS[(4 * ty + i) * LDS + col] = ds;
            }
        }
        __syncwarp();                    // p and dS rows, from this half-warp

#pragma unroll 2
        for (int qq = 0; qq < BQ; qq += 4) {
            float4 pv[4], gv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                pv[i] = ld4(sP + (4 * ty + i) * LDS + qq);
                gv[i] = ld4(sDS + (4 * ty + i) * LDS + qq);
            }
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                float4 o4[4], q4[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    o4[u] = ld4(sDO + (qq + u) * LD + n * 64 + 4 * tx);
                    q4[u] = ld4(sQ + (qq + u) * LD + n * 64 + 4 * tx);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p4[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
                    const float g4[4] = {gv[i].x, gv[i].y, gv[i].z, gv[i].w};
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        acc_v[i][n][0] = fmaf(p4[u], o4[u].x, acc_v[i][n][0]);
                        acc_v[i][n][1] = fmaf(p4[u], o4[u].y, acc_v[i][n][1]);
                        acc_v[i][n][2] = fmaf(p4[u], o4[u].z, acc_v[i][n][2]);
                        acc_v[i][n][3] = fmaf(p4[u], o4[u].w, acc_v[i][n][3]);
                        acc_k[i][n][0] = fmaf(g4[u], q4[u].x, acc_k[i][n][0]);
                        acc_k[i][n][1] = fmaf(g4[u], q4[u].y, acc_k[i][n][1]);
                        acc_k[i][n][2] = fmaf(g4[u], q4[u].z, acc_k[i][n][2]);
                        acc_k[i][n][3] = fmaf(g4[u], q4[u].w, acc_k[i][n][3]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int key = k0 + 4 * ty + i;
        if (key >= seq) continue;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
            const int col = n * 64 + 4 * tx;
            if (col < D) {
                *reinterpret_cast<float4*>(dk + base + (size_t)key * D + col) =
                    make_float4(acc_k[i][n][0], acc_k[i][n][1],
                                acc_k[i][n][2], acc_k[i][n][3]);
                *reinterpret_cast<float4*>(dv + base + (size_t)key * D + col) =
                    make_float4(acc_v[i][n][0], acc_v[i][n][1],
                                acc_v[i][n][2], acc_v[i][n][3]);
            }
        }
    }
}

struct Args {
    const void *q, *k, *v, *dout, *lse, *delta, *mask;
    void *dk, *dv;
    int bh, heads, seq, causal;
    float scale;
    cudaStream_t stream;
};

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const Args& a) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const float*>(a.mask), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.seq, a.heads, a.causal, a.scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int is_bf16, const Args& a) {
    if (is_bf16) {
        using C = Bf16Cfg<D>;
        static_assert(C::SMEM <= 232448, "bf16 tiles exceed a block's shared memory");
        const dim3 grid(a.bh, (a.seq + C::KEYS - 1) / C::KEYS, C::SLICES);
        return launch<bf16>(flash_dkv_bf16<D>, C::SMEM, grid, a);
    }
    using C = F32Cfg<D>;
    static_assert(C::SMEM <= 232448, "f32 tiles exceed a block's shared memory");
    const dim3 grid(a.bh, (a.seq + C::KEYS - 1) / C::KEYS);
    return launch<float>(flash_dkv_f32<D>, C::SMEM, grid, a);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). `mask` may be null. Head dims: 64, 96, 128, 256.
// q, k, v, dO, dk and dv must start on a 16-byte boundary.
extern "C" int dl4j_flash_attention_bwd_dkv(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* mask, void* dk,
        void* dv, int bh, int heads, int seq, int head_dim, int is_bf16,
        int causal, float scale, void* stream) {
    if (bh < 1 || heads < 1 || seq < 1 || seq > 65535 * 64)
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, dout, lse, delta, mask, dk, dv,
                 bh, heads, seq, causal, scale,
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
extern "C" int dl4j_flash_attention_bwd_dkv_smem(int head_dim, int is_bf16) {
    switch (head_dim) {
        case 64: return (int)(is_bf16 ? Bf16Cfg<64>::SMEM : F32Cfg<64>::SMEM);
        case 96: return (int)(is_bf16 ? Bf16Cfg<96>::SMEM : F32Cfg<96>::SMEM);
        case 128: return (int)(is_bf16 ? Bf16Cfg<128>::SMEM : F32Cfg<128>::SMEM);
        case 256: return (int)(is_bf16 ? Bf16Cfg<256>::SMEM : F32Cfg<256>::SMEM);
        default: return 0;
    }
}
