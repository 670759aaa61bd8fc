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
// Both: the key loop (S, the online softmax, P.V) is csrc/flash_fwd_tile.cuh,
// shared with the ring hop's carry kernel (csrc/flash_block_update.cu);
// this file holds the scheduling, the empty start and the normalising
// epilogue. Causal query tiles are scheduled heaviest first (the grid walks
// query tiles from the last), and ragged edges are masked in the kernel.
// Left for later: a producer warp with TMA and mbarriers (warp
// specialisation), a persistent grid, larger key tiles, fp8.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "flash_fwd_tile.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace dl4j_sm90;
using dl4j_fwd::BK;
using dl4j_fwd::NEG;
using dl4j_fwd::THREADS;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bf16, wgmma
template <int D> struct Bf16Cfg {
    static constexpr int NC = dl4j_fwd::Panels<D>::NC;   // 64-column panels
    static constexpr int BQ = 128;                       // two warpgroups
    static constexpr uint32_t Q_BYTES = NC * BQ * ROW_BYTES;
    static constexpr uint32_t KV_BYTES = dl4j_fwd::Panels<D>::TILE_BYTES;
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
        dl4j_fwd::bf16_key_tile<D>(acc, m0, m1, l0, l1,
                                   sQ + wg * 64 * ROW_BYTES,
                                   C::BQ * ROW_BYTES, sK, sK + C::KV_BYTES,
                                   k0, r0, r1, c, seq, causal, mrow, scale);
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
template <int D> using F32Cfg = dl4j_fwd::F32Fwd<D>;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              float* __restrict__ o, float* __restrict__ lse, int seq,
              int heads, int causal, float scale) {
    using C = F32Cfg<D>;
    constexpr int NC = C::NC;
    extern __shared__ __align__(16) float smf[];

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;  // rows 4ty.., columns 4tx..
    const int bh = blockIdx.x;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
    const size_t base = (size_t)bh * seq * D;
    const float* mrow = mask ? mask + (size_t)(bh / heads) * seq : nullptr;
    const int k_end = (causal && !mrow) ? min(seq, q0 + C::BQ) : seq;

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

    dl4j_fwd::f32_pass<D>(acc, m, l, smf, q + base, k + base, v + base, q0,
                          seq, seq, k_end, causal, mrow, scale, tid);

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
