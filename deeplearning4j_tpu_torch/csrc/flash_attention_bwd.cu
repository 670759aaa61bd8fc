// Flash-attention backward, the dq pass, for Hopper (sm_90a): CUDA C++
// behind a C interface (loaded with ctypes by
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
//   reference's ds.astype(k.dtype) does. lse and delta are taken as given
//   (a ring hop passes the whole sequence's).
//
// A row with no visible key (lse at or below -1e29: K1 filled every score
// with -1e30) passes no gradient to q (dS = 0), which is what autograd
// gives through the plain forward. Keys past a ragged edge get p = 0.
// Causal key tiles wholly above a query tile's diagonal are skipped, with
// or without a key mask, as the reference's `compute` condition skips them:
// there p = 0 for every row that sees a key, and dS = 0 for one that sees
// none.
//
// Order of sums: every output element is summed in one fixed order (no
// atomics), so results are the same from run to run.
//
// What bounds it on this card: three D-long products a visible pair against
// q/k/v/dO reads and the dq write (5 * BH*T*D elements). Causal at T 1024,
// D 64 that is about 150 flops per f32 byte, far above the card's f32
// balance of 67 TFLOP/s / 3.35 TB/s = 20; in bf16 about 300 against 295:
// bound by operations. The earlier scalar design (four threads a row, dS
// through shared memory) reached 1 % of the bf16 and 16 % of the f32 bound.
//
// Causal balance, both dtypes: a block owns 64 query rows at a time. With
// causal attention it takes two query tiles, i and n-1-i, the heavier one
// first, so every block does n+1 key tiles' work and the grid of n/2 pairs
// holds no block that carries a whole row of key tiles while the others
// idle (a ring's diagonal hop then costs about half of a full hop).
//
// bf16 design: tensor cores through wgmma (csrc/hopper_mma.cuh). Two
// warpgroups share the block's 64 query rows, whose Q and dO are staged
// once into 128-byte-swizzled panels, and split the key tiles between them
// (even tiles to warpgroup 0, odd to 1): each step a two-stage ring of
// cp.async copies brings 128 keys of K and V, 64 for each warpgroup, and
// the next step's copies overlap this step's math. S = Q.K^T and
// dP = dO.V^T are m64n64k16 wgmmas with both operands in shared memory (K
// and V K-major); dS = P o (dP - delta) * scale is formed on the
// accumulator fragments in registers (lse and delta read by fragment row),
// rounded to bf16 and fed as the register A operand of dq += dS.K, where
// the same K panel serves as the MN-major B operand. dS never touches
// shared memory. At the end warpgroup 1 hands its f32 partial dq to
// warpgroup 0 through shared memory, which adds it to its own (always in
// that order) and stores. At D 256 the dq accumulator (128 registers) and
// S and dP do not fit: the grid's third axis splits the output columns in
// two halves, each block recomputing S and dP over the whole D, with a
// one-stage ring (two would exceed 227 KB). D = 96 runs as 128 with zero
// columns.
//
// f32 design: full f32 FMAs (no TF32: the pin is rel-to-max 1e-4). A block
// of 256 threads; each thread owns a 4-row x 4-key micro-tile of S and of
// dP (4 x 2 at D 256, where key tiles are 32 rows) and a 4-row x 4-column
// micro-tile of dq per 64 columns of D, reading every operand from shared
// memory as float4 (rows padded to 4 words past a multiple of 64, so the
// reads are broadcasts or conflict-free). dS goes through shared memory in
// f32, read back by the half-warp that wrote it. K/V tiles are
// double-buffered with cp.async (single-buffered at D 256).
//
// Left for later: a producer warp with TMA and mbarriers, a persistent
// grid, dq fused into the dk/dv pass.
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

// ------------------------------------------------------------ bf16, wgmma
template <int D> struct Bf16Cfg {
    static constexpr int NC = (D + PANEL - 1) / PANEL;   // 64-column panels
    static constexpr int NCO = NC < 2 ? NC : 2;          // output panels a block
    static constexpr int SLICES = NC / NCO;
    static constexpr int BK = 64;                        // keys a warpgroup a step
    static constexpr int STAGES = NC > 2 ? 1 : 2;
    static constexpr uint32_t TILE_BYTES = NC * 64 * ROW_BYTES;   // 64 rows
    // K and V, a tile of each for each warpgroup
    static constexpr uint32_t STAGE_BYTES = 4 * TILE_BYTES;
    static constexpr int LDR = NCO * PANEL + 8;          // partial dq row, floats
    static constexpr size_t SMEM = 1024 + 2 * (size_t)TILE_BYTES
                                   + STAGES * (size_t)STAGE_BYTES;
    static_assert((size_t)BQ * LDR * sizeof(float) <= STAGE_BYTES,
                  "the partial dq must fit in a stage");
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ mask, bf16* __restrict__ dq, int seq,
              int heads, int causal, float scale) {
    using C = Bf16Cfg<D>;
    constexpr int NC = C::NC, NCO = C::NCO, BK = C::BK;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sDO = sQ + C::TILE_BYTES;
    const uint32_t sSt = sDO + C::TILE_BYTES;
    // the stages' generic address: the partial dq after the key loop
    float* sPart =
        reinterpret_cast<float*>(smem_raw + (sSt - smem_u32(smem_raw)));

    const int tid = threadIdx.x;
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int bh = blockIdx.x;
    const int pc0 = blockIdx.z * NCO;       // first output panel
    const int ntq = (seq + BQ - 1) / BQ;
    const size_t base = (size_t)bh * seq * D;
    const float* lrow = lse + (size_t)bh * seq;
    const float* drow = delta + (size_t)bh * seq;
    const float* mrow = mask ? mask + (size_t)(bh / heads) * seq : nullptr;

    for (int pass = 0; pass < 2; ++pass) {
        const int qt = query_tile(pass, blockIdx.y, ntq, causal);
        if (qt < 0) break;
        const int q0 = qt * BQ;
        // keys [0, k_end): causal tiles above the diagonal hold no pair
        const int k_end = causal ? min(seq, q0 + BQ) : seq;
        const int nsteps = (k_end + 2 * BK - 1) / (2 * BK);
        // K and V rows [t0, t0 + 128) into a stage, zeros from k_end on
        auto load_step = [&](uint32_t st, int t0) {
#pragma unroll
            for (int w = 0; w < 2; ++w) {
                load_panels<D, BK>(st + w * C::TILE_BYTES, k + base,
                                   t0 + w * BK, k_end, tid, THREADS);
                load_panels<D, BK>(st + (2 + w) * C::TILE_BYTES, v + base,
                                   t0 + w * BK, k_end, tid, THREADS);
            }
        };
        __syncthreads();                 // the last pass is done with smem
        load_panels<D, BQ>(sQ, q + base, q0, seq, tid, THREADS);
        load_panels<D, BQ>(sDO, dout + base, q0, seq, tid, THREADS);
        if constexpr (C::STAGES == 2) load_step(sSt, 0);
        cp_async_commit();

        // this thread's fragment rows, their lse and delta
        const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
        const float l0 = r0 < seq ? lrow[r0] : 0.f;
        const float l1 = r1 < seq ? lrow[r1] : 0.f;
        const float d0 = r0 < seq ? drow[r0] : 0.f;
        const float d1 = r1 < seq ? drow[r1] : 0.f;
        // a row with no visible key passes no gradient (dS = 0)
        const bool live0 = r0 < seq && l0 > DEAD;
        const bool live1 = r1 < seq && l1 > DEAD;

        float acc[NCO][32];
#pragma unroll
        for (int n = 0; n < NCO; ++n)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;

        for (int s = 0; s < nsteps; ++s) {
            __syncthreads();             // the stage to fill is consumed
            uint32_t st;
            if constexpr (C::STAGES == 2) {
                if (s + 1 < nsteps)
                    load_step(sSt + ((s + 1) & 1) * C::STAGE_BYTES,
                              (s + 1) * 2 * BK);
                cp_async_commit();
                cp_async_wait<1>();      // this thread's copies of step s
                st = sSt + (s & 1) * C::STAGE_BYTES;
            } else {
                load_step(sSt, s * 2 * BK);
                cp_async_commit();
                cp_async_wait<0>();
                st = sSt;
            }
            fence_async_shared();
            __syncthreads();             // everyone's copies of step s
            const int k0 = s * 2 * BK + wg * BK;   // this warpgroup's keys
            if (k0 >= k_end) continue;
            const uint32_t sK = st + wg * C::TILE_BYTES;
            const uint32_t sV = st + (2 + wg) * C::TILE_BYTES;

            float sc[32], dp[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
            fence_regs(sc);
            fence_regs(dp);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < NC * 4; ++kk) {
                const uint32_t off = (kk / 4) * (64 * ROW_BYTES)
                                     + (uint32_t)(kk % 4) * 32;   // 16 columns
                wgmma_ss(sc, desc(sQ + off, 16, 1024), desc(sK + off, 16, 1024),
                         kk > 0);
                wgmma_ss(dp, desc(sDO + off, 16, 1024),
                         desc(sV + off, 16, 1024), kk > 0);
            }
            wg_commit();
            wg_wait<0>();
            fence_regs(sc);
            fence_regs(dp);

            // element i: row r0 (i & 2 == 0) or r1, key k0 + col
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int key = k0 + 8 * (i / 4) + 2 * c + (i & 1);
                const bool hi = i & 2;
                float ds = 0.f;
                if ((hi ? live1 : live0) && key < seq) {
                    float x = sc[i] * scale;
                    if (causal && key > (hi ? r1 : r0)) x = NEG;
                    if (mrow && !(mrow[key] > 0.f)) x = NEG;
                    const float p = expf(x - (hi ? l1 : l0));
                    ds = p * (dp[i] - (hi ? d1 : d0)) * scale;
                }
                sc[i] = ds;
            }
            uint32_t a[4][4];            // dS in bf16, the A operand
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) frag_to_a(sc, kk, a[kk]);
            wg_fence();
#pragma unroll
            for (int n = 0; n < NCO; ++n)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_rs(acc[n], a[kk],
                             desc(sK + (pc0 + n) * (64 * ROW_BYTES)
                                  + kk * 16 * ROW_BYTES,
                                  64 * ROW_BYTES, 1024));
            wg_commit();
            wg_wait<0>();
#pragma unroll
            for (int n = 0; n < NCO; ++n) fence_regs(acc[n]);
        }
        cp_async_wait<0>();
        __syncthreads();                 // every stage is consumed

        // warpgroup 1's partial through shared memory; warpgroup 0 adds it
        // to its own and stores
        const int lr0 = warp * 16 + g;   // fragment rows within the tile
        if (wg == 1) {
#pragma unroll
            for (int n = 0; n < NCO; ++n)
#pragma unroll
                for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                    for (int hi = 0; hi < 2; ++hi) {
                        const int i = 4 * jj + 2 * hi;
                        *reinterpret_cast<float2*>(
                            sPart + (lr0 + 8 * hi) * C::LDR + n * PANEL + 8 * jj
                            + 2 * c) = make_float2(acc[n][i], acc[n][i + 1]);
                    }
        }
        __syncthreads();
        if (wg == 0) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
                const int row = hi ? r1 : r0;
                if (row >= seq) continue;
                bf16* out = dq + base + (size_t)row * D;
#pragma unroll
                for (int n = 0; n < NCO; ++n)
#pragma unroll
                    for (int jj = 0; jj < 8; ++jj) {
                        const int col = (pc0 + n) * PANEL + 8 * jj + 2 * c;
                        const int i = 4 * jj + 2 * hi;
                        const float2 o = *reinterpret_cast<const float2*>(
                            sPart + (lr0 + 8 * hi) * C::LDR + n * PANEL
                            + 8 * jj + 2 * c);
                        if (col < D)
                            *reinterpret_cast<__nv_bfloat162*>(out + col) =
                                __floats2bfloat162_rn(acc[n][i] + o.x,
                                                      acc[n][i + 1] + o.y);
                    }
            }
        }
    }
}

// --------------------------------------------------- f32, register tiles
template <int D> struct F32Cfg {
    static constexpr int DP = F32Rows<D>::DP;   // padded head dim
    static constexpr int NC = DP / 64;
    static constexpr int LD = F32Rows<D>::LD;   // row stride, floats
    static constexpr int BK = DP > 128 ? 32 : 64;   // keys a tile
    static constexpr int KJ = BK / 16;       // keys a thread scores
    static constexpr int LDS = BK + 4;       // dS row stride
    static constexpr int STAGES = DP > 128 ? 1 : 2;
    static constexpr size_t SMEM =
        ((size_t)(2 * BQ + 2 * BK * STAGES) * LD + (size_t)BQ * LDS)
        * sizeof(float);
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ mask, float* __restrict__ dq, int seq,
             int heads, int causal, float scale) {
    using C = F32Cfg<D>;
    constexpr int LD = C::LD, LDS = C::LDS, NC = C::NC, BK = C::BK,
                  KJ = C::KJ;
    extern __shared__ __align__(16) float smf[];
    float* sQ = smf;
    float* sDO = sQ + BQ * LD;
    float* sKV = sDO + BQ * LD;              // stage s: K at s*2*BK*LD, V after
    float* sDS = sKV + 2 * BK * C::STAGES * LD;

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;  // rows 4ty.., keys tx + 16j
    const int bh = blockIdx.x;
    const int ntq = (seq + BQ - 1) / BQ;
    const size_t base = (size_t)bh * seq * D;
    const float* lrow = lse + (size_t)bh * seq;
    const float* drow = delta + (size_t)bh * seq;
    const float* mrow = mask ? mask + (size_t)(bh / heads) * seq : nullptr;

    for (int pass = 0; pass < 2; ++pass) {
        const int qt = query_tile(pass, blockIdx.y, ntq, causal);
        if (qt < 0) break;
        const int q0 = qt * BQ;
        const int k_end = causal ? min(seq, q0 + BQ) : seq;
        const int ntiles = (k_end + BK - 1) / BK;
        // K and V rows [t0, t0 + BK) into the stage at dst
        auto load_kv = [&](float* dst, int t0) {
            load_rows_f32<D, BK>(dst, k + base, t0, k_end, tid, THREADS);
            load_rows_f32<D, BK>(dst + BK * LD, v + base, t0, k_end, tid,
                                 THREADS);
        };
        __syncthreads();                 // the last pass is done with smem
        load_rows_f32<D, BQ>(sQ, q + base, q0, seq, tid, THREADS);
        load_rows_f32<D, BQ>(sDO, dout + base, q0, seq, tid, THREADS);
        if constexpr (C::STAGES == 2) load_kv(sKV, 0);
        cp_async_commit();

        float rl[4], rd[4];
        bool live[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + 4 * ty + i;
            rl[i] = row < seq ? lrow[row] : 0.f;
            rd[i] = row < seq ? drow[row] : 0.f;
            live[i] = row < seq && rl[i] > DEAD;
        }
        float acc[4][NC][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < NC; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

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

            float s[4][KJ], dp[4][KJ];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int jj = 0; jj < KJ; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 2
            for (int d = 0; d < C::DP; d += 4) {
                float4 qv[4], ov[4], kv[KJ], vv[KJ];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    qv[i] = ld4(sQ + (4 * ty + i) * LD + d);
                    ov[i] = ld4(sDO + (4 * ty + i) * LD + d);
                }
#pragma unroll
                for (int jj = 0; jj < KJ; ++jj) {
                    kv[jj] = ld4(sK + (tx + 16 * jj) * LD + d);
                    vv[jj] = ld4(sV + (tx + 16 * jj) * LD + d);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int jj = 0; jj < KJ; ++jj) {
                        s[i][jj] = dot4(qv[i], kv[jj], s[i][jj]);
                        dp[i][jj] = dot4(ov[i], vv[jj], dp[i][jj]);
                    }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int row = q0 + 4 * ty + i;
#pragma unroll
                for (int jj = 0; jj < KJ; ++jj) {
                    const int key = k0 + tx + 16 * jj;
                    float ds = 0.f;
                    if (live[i] && key < seq) {
                        float x = s[i][jj] * scale;
                        if (causal && key > row) x = NEG;
                        if (mrow && !(mrow[key] > 0.f)) x = NEG;
                        const float p = expf(x - rl[i]);
                        ds = p * (dp[i][jj] - rd[i]) * scale;
                    }
                    sDS[(4 * ty + i) * LDS + tx + 16 * jj] = ds;
                }
            }
            __syncwarp();                // dS rows, from this half-warp

#pragma unroll 2
            for (int kk = 0; kk < BK; kk += 4) {
                float4 gv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    gv[i] = ld4(sDS + (4 * ty + i) * LDS + kk);
#pragma unroll
                for (int n = 0; n < NC; ++n) {
                    float4 k4[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        k4[u] = ld4(sK + (kk + u) * LD + n * 64 + 4 * tx);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float g4[4] = {gv[i].x, gv[i].y, gv[i].z,
                                             gv[i].w};
#pragma unroll
                        for (int u = 0; u < 4; ++u) {
                            acc[i][n][0] = fmaf(g4[u], k4[u].x, acc[i][n][0]);
                            acc[i][n][1] = fmaf(g4[u], k4[u].y, acc[i][n][1]);
                            acc[i][n][2] = fmaf(g4[u], k4[u].z, acc[i][n][2]);
                            acc[i][n][3] = fmaf(g4[u], k4[u].w, acc[i][n][3]);
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
            float* out = dq + base + (size_t)row * D;
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                const int col = n * 64 + 4 * tx;
                if (col < D)
                    *reinterpret_cast<float4*>(out + col) = make_float4(
                        acc[i][n][0], acc[i][n][1], acc[i][n][2],
                        acc[i][n][3]);
            }
        }
    }
}

struct Args {
    const void *q, *k, *v, *dout, *lse, *delta, *mask;
    void *dq;
    int bh, heads, seq, causal;
    float scale;
    cudaStream_t stream;
};

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int slices, const Args& a) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int ntq = (a.seq + BQ - 1) / BQ;
    const dim3 grid(a.bh, a.causal ? (ntq + 1) / 2 : ntq, slices);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const float*>(a.mask), static_cast<T*>(a.dq), a.seq,
        a.heads, a.causal, a.scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int is_bf16, const Args& a) {
    if (is_bf16) {
        using C = Bf16Cfg<D>;
        static_assert(C::SMEM <= 232448, "bf16 tiles exceed a block's shared memory");
        return launch<bf16>(flash_dq_bf16<D>, C::SMEM, C::SLICES, a);
    }
    using C = F32Cfg<D>;
    static_assert(C::SMEM <= 232448, "f32 tiles exceed a block's shared memory");
    return launch<float>(flash_dq_f32<D>, C::SMEM, 1, a);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). `mask` may be null. Head dims: 64, 96, 128, 256.
// q, k, v, dO and dq must start on a 16-byte boundary.
extern "C" int dl4j_flash_attention_bwd_dq(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* mask, void* dq,
        int bh, int heads, int seq, int head_dim, int is_bf16, int causal,
        float scale, void* stream) {
    if (bh < 1 || heads < 1 || seq < 1 || seq > 65535 * BQ)
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, dout, lse, delta, mask, dq,
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
extern "C" int dl4j_flash_attention_bwd_dq_smem(int head_dim, int is_bf16) {
    switch (head_dim) {
        case 64: return (int)(is_bf16 ? Bf16Cfg<64>::SMEM : F32Cfg<64>::SMEM);
        case 96: return (int)(is_bf16 ? Bf16Cfg<96>::SMEM : F32Cfg<96>::SMEM);
        case 128: return (int)(is_bf16 ? Bf16Cfg<128>::SMEM : F32Cfg<128>::SMEM);
        case 256: return (int)(is_bf16 ? Bf16Cfg<256>::SMEM : F32Cfg<256>::SMEM);
        default: return 0;
    }
}
