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
// each one grid-wide barrier (~1.2 us on an H100) and a trip through L2, a
// floor of its own apart from the bound.
//
// Design: ONE cooperative launch of thread-block clusters does the whole
// call, dR included. The grid is a plan per shape (ops/lstm.py `loop_plan`):
// P clusters of Q blocks; cluster p owns U hidden units, block (p, q) the
// columns [q W, (q+1) W) of the 4H gate axis (W = 4H/Q). The plans take
// Q = 2 (two gates a block): an H100 holds 30 clusters of 4 blocks at this
// kernel's shared memory, too few for H 512 at 16 units a cluster, and 4
// blocks of 20 units measured slower than 2 of 8. The block keeps R[p's
// units, its columns] in shared memory for the whole call. Each step t:
//   (a) the cluster's B x U cells, split over its Q blocks (a thread a
//       cell), compute dz from residuals loaded before the previous barrier
//       and from dh, dc carries that never leave the cluster; dz goes to
//       dx_proj[t], the exchange buffer (one slice a step).
//   One grid barrier (split: arrive, work, wait).
//   (b) the block copies dz_t[:, its columns] from L2 into shared memory
//       (16-byte cp.async in four column panels, the product starting on the
//       first while the others land) and forms its partial dh[B, U] over its
//       columns as register tiles (a thread 4 rows x U/4 units, each float4
//       read from shared memory serving 4 FMAs a value; the 8 warps split
//       the columns and are summed in warp order). The Q partials are added
//       over distributed shared memory in rank order, each block for the
//       cells it owns: the same bits every run.
//   dR folded in: block (p, q) holds dz_t[:, its columns] and h_prev[t, :,
//   p's units] in shared memory, so it adds their product to its dR rows
//   (f32, shared memory or scratch) while the NEXT step's grid barrier is
//   pending, and writes them once after the loop: no second launch, no
//   second read of dx_proj and h_prev. Where B is too large for one chunk
//   of rows in shared memory, rows go in chunks and dR is added per chunk.
//   Peephole sums stay in each thread's registers (a thread always holds
//   the same unit) and are joined in a fixed order after the loop.
// The grid must be co-resident: the launch asks cudaOccupancyMaxActiveClusters
// and returns cudaErrorCooperativeLaunchTooLarge (720) when the plan's
// clusters do not fit. No tensor cores (f32 FMAs; bf16 widened to f32) and
// no TMA: that is later work, as is a deeper overlap of the copy of dz_t.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>
#include <utility>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;
using dl4j_sm90::cp_async16;
using dl4j_sm90::cp_async_commit;
using dl4j_sm90::smem_u32;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PANELS = 4;               // column panels of a chunk's copy
constexpr size_t SMEM_LIMIT = 232448;   // a block's opt-in shared memory
// the points of a step block 0's thread 0 stamps when tracing: the step's
// start, (a) done, the barrier's arrival and what it hides done, the wait
// over, the copy issued, the partials reduced in the block, the cluster
// barrier passed, the step's end
constexpr int TRACE_MARKS = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// four consecutive values from shared memory (16 bytes f32, 8 bytes bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async_wait_dyn(int n) {
    switch (n) {
    case 0: dl4j_sm90::cp_async_wait<0>(); break;
    case 1: dl4j_sm90::cp_async_wait<1>(); break;
    case 2: dl4j_sm90::cp_async_wait<2>(); break;
    default: dl4j_sm90::cp_async_wait<3>(); break;
    }
}

// How a block of a plan lays out its shared memory; the host computes it
// (make_layout) and hands it to the kernel.
struct Layout {
    int W;            // columns of the block's gate slice (4H / Q)
    int ldw;          // row stride of sR and sZ (elements): 16 mod 128 bytes
    int ng;           // groups of 4 columns (ceil(W / 4))
    int bc;           // batch rows a chunk (a multiple of 8 RPT)
    int nchunk;       // chunks of rows a step
    int cpb;          // cells a block owns a chunk (bc U / Q <= THREADS)
    int carry_smem;   // dh, dc, (1-m) dh_tot carries in shared memory (else scratch)
    int dr_smem;      // the dR accumulator in shared memory (else scratch)
    unsigned off_z, off_h, off_red, off_part, off_pp, off_carry, off_dr;
    unsigned smem;    // dynamic shared memory bytes; 0: the plan does not fit
    long long scratch;   // f32 scratch elements a block
};

struct Args {
    const void *gates, *cs, *cprev, *hprev, *dhs, *R, *dhT, *dcT;
    const float* mask;
    const void *pi, *pf, *po;
    void *dxp, *dh0, *dc0, *dR, *dpi, *dpf, *dpo;
    float* scratch;
    long long* trace;     // null, or [seq][TRACE_MARKS] clock64 of block 0
    int seq, batch, H;
};

size_t up16(size_t x) { return (x + 15) & ~(size_t)15; }

Layout make_layout(int H, int B, int Q, int U, int rg, int esize) {
    Layout L = {};
    L.W = 4 * H / Q;
    L.ng = (L.W + 3) / 4;
    const int align = 128 / esize;             // elements in 128 bytes
    L.ldw = (L.W + align - 1) / align * align + 16 / esize;
    const size_t sR = up16((size_t)U * L.ldw * esize);
    const size_t pp = up16((size_t)(3 * THREADS + 3 * U) * 4);
    auto rows_bytes = [&](int bc) {
        return up16((size_t)bc * L.ldw * esize) + up16((size_t)bc * U * esize)
             + up16((size_t)WARPS * bc * U * 4) + up16((size_t)bc * U * 4);
    };
    const int bpad = (B + rg - 1) / rg * rg;
    int bc = (THREADS * Q / U) / rg * rg;       // at most a cell a thread
    if (bc > bpad) bc = bpad;
    while (bc >= rg && sR + rows_bytes(bc) + pp > SMEM_LIMIT) bc -= rg;
    if (bc < rg) return L;                      // smem = 0: does not fit
    L.nchunk = (B + bc - 1) / bc;
    const int per = (B + L.nchunk - 1) / L.nchunk;
    L.bc = (per + rg - 1) / rg * rg;
    L.cpb = L.bc * U / Q;
    size_t off = sR;
    L.off_z = (unsigned)off;     off += up16((size_t)L.bc * L.ldw * esize);
    L.off_h = (unsigned)off;     off += up16((size_t)L.bc * U * esize);
    L.off_red = (unsigned)off;   off += up16((size_t)WARPS * L.bc * U * 4);
    L.off_part = (unsigned)off;  off += up16((size_t)L.bc * U * 4);
    L.off_pp = (unsigned)off;    off += pp;
    const size_t carry = (size_t)3 * L.nchunk * L.cpb * 4;
    const size_t dr = (size_t)U * L.ng * 4 * 4;
    L.carry_smem = off + up16(carry) <= SMEM_LIMIT;
    if (L.carry_smem) { L.off_carry = (unsigned)off; off += up16(carry); }
    L.dr_smem = off + up16(dr) <= SMEM_LIMIT;
    if (L.dr_smem) { L.off_dr = (unsigned)off; off += up16(dr); }
    L.smem = (unsigned)off;
    L.scratch = (L.carry_smem ? 0 : carry / 4) + (L.dr_smem ? 0 : dr / 4);
    return L;
}

// a cell's residuals for one step
struct Resid {
    float i, f, o, g, c, cp, dhs, m;
};

template <typename T>
__device__ __forceinline__ Resid load_resid(const Args& a, int t, int b, int u,
                                            bool masked) {
    const int H = a.H;
    const size_t o1 = ((size_t)t * a.batch + b) * H + u;
    const T* grow = static_cast<const T*>(a.gates)
                    + ((size_t)t * a.batch + b) * 4 * (size_t)H;
    Resid r;
    r.i = to_f(grow[u]);
    r.f = to_f(grow[H + u]);
    r.o = to_f(grow[2 * (size_t)H + u]);
    r.g = to_f(grow[3 * (size_t)H + u]);
    r.c = to_f(static_cast<const T*>(a.cs)[o1]);
    r.cp = to_f(static_cast<const T*>(a.cprev)[o1]);
    r.dhs = to_f(static_cast<const T*>(a.dhs)[o1]);
    r.m = masked ? a.mask[(size_t)t * a.batch + b] : 1.f;
    return r;
}

template <typename T, int UPT, int RPT>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(Args a, Layout L, bool peep, bool masked) {
    constexpr int U = 4 * UPT, RG = 8 * RPT;
    cg::grid_group grid = cg::this_grid();
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ __align__(16) unsigned char smem[];
    const int Q = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
    const int H = a.H, B = a.batch, W = L.W, ldw = L.ldw, ng = L.ng;
    const int bc = L.bc, nchunk = L.nchunk, cpb = L.cpb;
    const size_t H4 = 4 * (size_t)H;
    const int u0 = (int)(blockIdx.x / Q) * U, col0 = q * W;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    T* sR = reinterpret_cast<T*>(smem);                       // [U][ldw]
    T* sZ = reinterpret_cast<T*>(smem + L.off_z);             // [bc][ldw]
    T* sH = reinterpret_cast<T*>(smem + L.off_h);             // [bc][U]
    float* red = reinterpret_cast<float*>(smem + L.off_red);  // [WARPS][bc][U]
    float* part = reinterpret_cast<float*>(smem + L.off_part);   // [bc][U]
    float* pp = reinterpret_cast<float*>(smem + L.off_pp);    // [3][THREADS] + [3][U]
    float* scr = a.scratch + (size_t)blockIdx.x * L.scratch;
    float* carry = L.carry_smem ? reinterpret_cast<float*>(smem + L.off_carry) : scr;
    float* dracc = L.dr_smem ? reinterpret_cast<float*>(smem + L.off_dr)
                             : scr + (L.carry_smem ? 0 : (size_t)3 * nchunk * cpb);
    const int ldr = 4 * ng;                                   // dracc [U][ldr]
    float* c_dh = carry;                                      // [nchunk][cpb] each
    float* c_dc = carry + (size_t)nchunk * cpb;
    float* c_ht = carry + (size_t)2 * nchunk * cpb;           // (1-m) dh_tot

    auto mark = [&](int r, int k) {
        if (a.trace != nullptr && tid == 0 && blockIdx.x == 0)
            a.trace[(size_t)r * TRACE_MARKS + k] = clock64();
    };
    const T* R = static_cast<const T*>(a.R);
    const T* hprev = static_cast<const T*>(a.hprev);
    T* dxp = static_cast<T*>(a.dxp);

    for (int i = tid; i < U * ldw; i += THREADS) {
        const int j = i / ldw, k = i % ldw;
        sR[i] = (k < W && u0 + j < H) ? R[(size_t)(u0 + j) * H4 + col0 + k]
                                      : from_f<T>(0.f);
    }
    for (int i = tid; i < U * ldr; i += THREADS) dracc[i] = 0.f;

    // the cell a thread owns in each chunk: row (q cpb + tid) / U of the
    // chunk, unit tid % U (cpb is a multiple of U)
    const bool owner = tid < cpb;
    const int jo = tid % U, uo = u0 + jo;
    const int ro = (q * cpb + tid) / U;
    float p_i = 0.f, p_f = 0.f, p_o = 0.f;
    if (peep && owner && uo < H) {
        p_i = to_f(static_cast<const T*>(a.pi)[uo]);
        p_f = to_f(static_cast<const T*>(a.pf)[uo]);
        p_o = to_f(static_cast<const T*>(a.po)[uo]);
    }
    for (int ch = 0; ch < nchunk && owner; ++ch) {
        const int b = ch * bc + ro;
        const bool ok = b < B && uo < H;
        c_dh[ch * cpb + tid] = ok ? to_f(static_cast<const T*>(a.dhT)[(size_t)b * H + uo]) : 0.f;
        c_dc[ch * cpb + tid] = ok ? to_f(static_cast<const T*>(a.dcT)[(size_t)b * H + uo]) : 0.f;
    }
    Resid pre = {};
    if (owner && ro < B && uo < H) pre = load_resid<T>(a, a.seq - 1, ro, uo, masked);
    float acc_pi = 0.f, acc_pf = 0.f, acc_po = 0.f;
    const bool vec = (reinterpret_cast<uintptr_t>(dxp) % 16 == 0)
                     && (H4 * sizeof(T)) % 16 == 0
                     && ((size_t)col0 * sizeof(T)) % 16 == 0
                     && ((size_t)W * sizeof(T)) % 16 == 0;
    // columns of panel s: [pc * s, min(W, pc * (s + 1))), pc a multiple of 8
    const int pc = ((W + PANELS - 1) / PANELS + 7) / 8 * 8;
    __syncthreads();

    // dR rows of the block += sH^T . sZ over the first `rows` rows
    auto dr_update = [&](int rows) {
        for (int tile = tid; tile < UPT * ng; tile += THREADS) {
            const int ju = tile % UPT, g = tile / UPT;
            float acc[4][4] = {};
#pragma unroll 4
            for (int r = 0; r < rows; ++r) {
                const float4 z = ld4(sZ + (size_t)r * ldw + 4 * g);
                const float4 h = ld4(sH + r * U + 4 * ju);
                const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    acc[e][0] = fmaf(hv[e], z.x, acc[e][0]);
                    acc[e][1] = fmaf(hv[e], z.y, acc[e][1]);
                    acc[e][2] = fmaf(hv[e], z.z, acc[e][2]);
                    acc[e][3] = fmaf(hv[e], z.w, acc[e][3]);
                }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float4* d = reinterpret_cast<float4*>(dracc + (size_t)(4 * ju + e) * ldr + 4 * g);
                float4 v = *d;
                v.x += acc[e][0];
                v.y += acc[e][1];
                v.z += acc[e][2];
                v.w += acc[e][3];
                *d = v;
            }
        }
    };

    for (int r = 0; r < a.seq; ++r) {
        const int t = a.seq - 1 - r;
        mark(r, 0);
        // (a) dz for the cells this block owns
        for (int ch = 0; ch < nchunk && owner; ++ch) {
            const int b = ch * bc + ro;
            if (b >= B || uo >= H) continue;
            const Resid rs = ch == 0 ? pre : load_resid<T>(a, t, b, uo, masked);
            const int ci = ch * cpb + tid;
            const float tc = tanhf(rs.c);
            const float dh_tot = c_dh[ci] + rs.dhs;
            const float dc_tot = c_dc[ci];
            float dh_new = dh_tot, dc_in = dc_tot;
            if (masked) {
                dh_new = rs.m * dh_tot;
                dc_in = rs.m * dc_tot;
            }
            const float dzo = dh_new * tc * rs.o * (1.f - rs.o);
            float dcv = dc_in + dh_new * rs.o * (1.f - tc * tc);
            if (peep) dcv = dcv + dzo * p_o;
            const float dzi = dcv * rs.g * rs.i * (1.f - rs.i);
            const float dzf = dcv * rs.cp * rs.f * (1.f - rs.f);
            const float dzg = dcv * rs.i * (1.f - rs.g * rs.g);
            T* drow = dxp + ((size_t)t * B + b) * H4;
            drow[uo] = from_f<T>(dzi);
            drow[H + uo] = from_f<T>(dzf);
            drow[2 * (size_t)H + uo] = from_f<T>(dzo);
            drow[3 * (size_t)H + uo] = from_f<T>(dzg);
            float ndc = dcv * rs.f;
            if (masked) {
                ndc = ndc + (1.f - rs.m) * dc_tot;
                c_ht[ci] = (1.f - rs.m) * dh_tot;
            }
            if (peep) {
                acc_pi += dzi * rs.cp;
                acc_pf += dzf * rs.cp;
                acc_po += dzo * rs.c;
                ndc = ndc + dzi * p_i + dzf * p_f;
            }
            c_dc[ci] = ndc;
            if (t == 0) static_cast<T*>(a.dc0)[(size_t)b * H + uo] = from_f<T>(ndc);
        }

        // the grid barrier: dz_t is whole once every block has arrived; the
        // wait hides the next residuals' loads and the last step's dR
        mark(r, 1);
        auto token = grid.barrier_arrive();
        if (t > 0 && owner && ro < B && uo < H)
            pre = load_resid<T>(a, t - 1, ro, uo, masked);
        if (nchunk == 1 && r > 0) dr_update(B);
        mark(r, 2);
        grid.barrier_wait(std::move(token));
        mark(r, 3);

        // (b) dh_{t-1} for the cluster's cells: dz_t . R^T
        for (int ch = 0; ch < nchunk; ++ch) {
            const int b0 = ch * bc, rows = min(bc, B - b0);
            const T* src = dxp + ((size_t)t * B + b0) * H4 + col0;
            for (int s = 0; s < PANELS; ++s) {
                const int k0 = min(W, s * pc), k1 = min(W, (s + 1) * pc);
                if (vec) {
                    constexpr int per = 16 / (int)sizeof(T);
                    const int pieces = (k1 - k0) / per;
                    for (int i = tid; i < rows * pieces; i += THREADS) {
                        const int rr = i / pieces, k = k0 + (i % pieces) * per;
                        cp_async16(smem_u32(sZ + (size_t)rr * ldw + k),
                                   src + (size_t)rr * H4 + k, true);
                    }
                } else {
                    // any alignment: element copies (through L2, not L1),
                    // zeros in the last group's columns past W
                    const int kend = s == PANELS - 1 ? 4 * ng : k1;
                    const int wid = kend - k0;
                    for (int i = tid; i < rows * wid; i += THREADS) {
                        const int rr = i / wid, k = k0 + i % wid;
                        sZ[(size_t)rr * ldw + k] =
                            k < W ? __ldcg(src + (size_t)rr * H4 + k) : from_f<T>(0.f);
                    }
                }
                cp_async_commit();
            }
            for (int i = tid; i < bc * U; i += THREADS) {
                const int rr = i / U, j = i % U;
                sH[i] = (rr < rows && u0 + j < H)
                            ? hprev[((size_t)t * B + b0 + rr) * H + u0 + j]
                            : from_f<T>(0.f);
            }
            mark(r, 4);
            // the product, a thread rows tr + 8i, units tu + 4j of a row
            // group; warp w takes the column groups w, w + 8, ... of each
            // panel
            const int tr = lane & 7, tu = lane >> 3;
            for (int g0 = 0; g0 < bc; g0 += RG) {
                float acc[RPT][UPT];
#pragma unroll
                for (int i = 0; i < RPT; ++i)
#pragma unroll
                    for (int j = 0; j < UPT; ++j) acc[i][j] = 0.f;
                for (int s = 0; s < PANELS; ++s) {
                    if (g0 == 0) {
                        cp_async_wait_dyn(PANELS - 1 - s);
                        __syncthreads();
                    }
                    const int gs = min(W, s * pc) / 4;
                    const int ge = s == PANELS - 1 ? ng : min(W, (s + 1) * pc) / 4;
                    for (int g = gs + warp; g < ge; g += WARPS) {
                        float4 z[RPT], w[UPT];
#pragma unroll
                        for (int i = 0; i < RPT; ++i)
                            z[i] = ld4(sZ + (size_t)(g0 + tr + 8 * i) * ldw + 4 * g);
#pragma unroll
                        for (int j = 0; j < UPT; ++j)
                            w[j] = ld4(sR + (size_t)(tu + 4 * j) * ldw + 4 * g);
#pragma unroll
                        for (int i = 0; i < RPT; ++i)
#pragma unroll
                            for (int j = 0; j < UPT; ++j) {
                                float v = acc[i][j];
                                v = fmaf(z[i].x, w[j].x, v);
                                v = fmaf(z[i].y, w[j].y, v);
                                v = fmaf(z[i].z, w[j].z, v);
                                v = fmaf(z[i].w, w[j].w, v);
                                acc[i][j] = v;
                            }
                    }
                }
#pragma unroll
                for (int i = 0; i < RPT; ++i)
#pragma unroll
                    for (int j = 0; j < UPT; ++j)
                        red[((size_t)warp * bc + g0 + tr + 8 * i) * U + tu + 4 * j] = acc[i][j];
            }
            __syncthreads();
            for (int o = tid; o < bc * U; o += THREADS) {
                float v = 0.f;
#pragma unroll
                for (int w = 0; w < WARPS; ++w) v += red[(size_t)w * bc * U + o];
                part[o] = v;
            }
            mark(r, 5);
            cluster.sync();             // every block's partial is whole
            mark(r, 6);
            if (owner) {
                const int b = b0 + ro, ci = ch * cpb + tid, cell = q * cpb + tid;
                float v = 0.f;
                for (int s = 0; s < Q; ++s) v += cluster.map_shared_rank(part, s)[cell];
                if (masked) v = v + c_ht[ci];
                c_dh[ci] = v;
                if (t == 0 && b < B && uo < H)
                    static_cast<T*>(a.dh0)[(size_t)b * H + uo] = from_f<T>(v);
            }
            if (nchunk > 1) {
                dr_update(rows);
                cluster.sync();         // no block rewrites `part` while read
            }
        }
        mark(r, 7);
    }
    if (nchunk == 1) dr_update(B);
    __syncthreads();
    T* dR = static_cast<T*>(a.dR);
    for (int i = tid; i < U * W; i += THREADS) {
        const int j = i / W, k = i % W;
        if (u0 + j < H) dR[(size_t)(u0 + j) * H4 + col0 + k] = from_f<T>(dracc[(size_t)j * ldr + k]);
    }
    if (peep) {
        pp[tid] = acc_pi;
        pp[THREADS + tid] = acc_pf;
        pp[2 * THREADS + tid] = acc_po;
        __syncthreads();
        float* blk = pp + 3 * THREADS;          // [3][U], read by rank 0
        if (tid < U) {
            float s0 = 0.f, s1 = 0.f, s2 = 0.f;
            for (int i = tid; i < cpb; i += U) {
                s0 += pp[i];
                s1 += pp[THREADS + i];
                s2 += pp[2 * THREADS + i];
            }
            blk[tid] = s0;
            blk[U + tid] = s1;
            blk[2 * U + tid] = s2;
        }
        cluster.sync();
        if (q == 0 && tid < U && u0 + tid < H) {
            float s0 = 0.f, s1 = 0.f, s2 = 0.f;
            for (int s = 0; s < Q; ++s) {
                const float* o = cluster.map_shared_rank(blk, s);
                s0 += o[tid];
                s1 += o[U + tid];
                s2 += o[2 * U + tid];
            }
            static_cast<T*>(a.dpi)[u0 + tid] = from_f<T>(s0);
            static_cast<T*>(a.dpf)[u0 + tid] = from_f<T>(s1);
            static_cast<T*>(a.dpo)[u0 + tid] = from_f<T>(s2);
        }
    }
    cluster.sync();                     // no block leaves while read
}

// the compiled (units a cluster, rows a thread) pairs; a plan names U
template <typename T, int UPT, int RPT>
cudaLaunchConfig_t config(const Layout& L, int Q, int H, cudaLaunchAttribute* attr) {
    const int P = (H + 4 * UPT - 1) / (4 * UPT);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(P * Q));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = L.smem;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)Q;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
    return cfg;
}

// Fills out[0..5] = (dynamic shared bytes, f32 scratch elements for the
// grid, the clusters of this shape that can be co-resident, rows a chunk,
// chunks, blocks); shared bytes 0 when the plan does not fit a block.
template <typename T, int UPT, int RPT>
cudaError_t layout_of(int H, int B, int Q, long long* out) {
    const Layout L = make_layout(H, B, Q, 4 * UPT, 8 * RPT, (int)sizeof(T));
    const int P = (H + 4 * UPT - 1) / (4 * UPT);
    out[0] = L.smem;
    out[1] = L.scratch * P * Q;
    out[2] = 0;
    out[3] = L.bc;
    out[4] = L.nchunk;
    out[5] = (long long)P * Q;
    if (L.smem == 0) return cudaSuccess;
    auto kern = lstm_bwd_kernel<T, UPT, RPT>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg = config<T, UPT, RPT>(L, Q, H, attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    out[2] = n;
    return err;
}

template <typename T, int UPT, int RPT>
cudaError_t launch(const Args& a, int Q, cudaStream_t stream) {
    const Layout L = make_layout(a.H, a.batch, Q, 4 * UPT, 8 * RPT, (int)sizeof(T));
    if (L.smem == 0) return cudaErrorInvalidConfiguration;
    if (L.scratch > 0 && a.scratch == nullptr) return cudaErrorInvalidValue;
    auto kern = lstm_bwd_kernel<T, UPT, RPT>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg = config<T, UPT, RPT>(L, Q, a.H, attr);
    cfg.stream = stream;
    int fit = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg)) != cudaSuccess)
        return err;
    if ((int)(cfg.gridDim.x / Q) > fit) return cudaErrorCooperativeLaunchTooLarge;
    const bool peep = a.pi != nullptr, masked = a.mask != nullptr;
    err = cudaLaunchKernelEx(&cfg, kern, a, L, peep, masked);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// U = 8 with 32-row groups (H 512), U = 16 with 8-row groups (up to
// H 1024, where R's slice leaves room for 8 rows of dz)
#define DL4J_BY_UNITS(U_, CALL)                                              \
    switch (U_) {                                                             \
    case 8: return CALL(2, 4);                                                \
    case 16: return CALL(4, 1);                                               \
    default: return cudaErrorInvalidValue;                                    \
    }

template <typename T>
cudaError_t layout_by_units(int H, int B, int Q, int U, long long* out) {
#define DL4J_LAYOUT(UPT_, RPT_) layout_of<T, UPT_, RPT_>(H, B, Q, out)
    DL4J_BY_UNITS(U, DL4J_LAYOUT)
#undef DL4J_LAYOUT
}

template <typename T>
cudaError_t launch_by_units(const Args& a, int Q, int U, cudaStream_t s) {
#define DL4J_LAUNCH(UPT_, RPT_) launch<T, UPT_, RPT_>(a, Q, s)
    DL4J_BY_UNITS(U, DL4J_LAUNCH)
#undef DL4J_LAUNCH
}

}  // namespace

// The layout of a plan (Q blocks a cluster, U units a cluster) at this
// shape on the current device: out[6] as layout_of fills it. Returns the
// CUDA error code.
extern "C" int dl4j_lstm_bwd_layout(int hidden, int batch, int q, int u,
                                    int is_bf16, long long* out) {
    if (hidden < 1 || batch < 1 || (q != 2 && q != 4))
        return (int)cudaErrorInvalidValue;
    if (is_bf16)
        return (int)layout_by_units<__nv_bfloat16>(hidden, batch, q, u, out);
    return (int)layout_by_units<float>(hidden, batch, q, u, out);
}

// Runs the whole backward (one cooperative cluster launch) on `stream` with
// the plan (q, u); returns the CUDA error code (0 = launched). `mask` may be
// null; `pi/pf/po` and `dpi/dpf/dpo` are all null (plain LSTM) or all set.
// `scratch` holds the f32 elements dl4j_lstm_bwd_layout asks for (may be
// null when it asks for none). `trace` is null, or [seq][8] int64 that
// block 0's thread 0 fills with clock64() at the points of each step
// TRACE_MARKS names (a study of where a step's time goes).
extern "C" int dl4j_lstm_bwd(const void* gates, const void* cs,
                             const void* cprev, const void* hprev,
                             const void* dhs, const void* R, const void* dhT,
                             const void* dcT, const void* mask,
                             const void* pi, const void* pf, const void* po,
                             void* dxp, void* dh0, void* dc0, void* dR,
                             void* dpi, void* dpf, void* dpo, void* scratch,
                             void* trace, int seq, int batch, int hidden,
                             int is_bf16, int q, int u, void* stream) {
    if (seq < 1 || batch < 1 || hidden < 1 || (q != 2 && q != 4))
        return (int)cudaErrorInvalidValue;
    const bool peep = pi != nullptr;
    if (peep != (pf != nullptr) || peep != (po != nullptr) ||
        peep != (dpi != nullptr) || peep != (dpf != nullptr) ||
        peep != (dpo != nullptr))
        return (int)cudaErrorInvalidValue;
    Args a = {gates, cs, cprev, hprev, dhs, R, dhT, dcT,
              static_cast<const float*>(mask), pi, pf, po,
              dxp, dh0, dc0, dR, dpi, dpf, dpo,
              static_cast<float*>(scratch), static_cast<long long*>(trace),
              seq, batch, hidden};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) return (int)launch_by_units<__nv_bfloat16>(a, q, u, s);
    return (int)launch_by_units<float>(a, q, u, s);
}
