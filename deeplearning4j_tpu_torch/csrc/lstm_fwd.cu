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
// operations (0.064 ms at 67 TFLOP/s); a decode step (T 1, B 8) is bound by
// reading R (4 MiB, 1.3 us). But the steps are a chain: step t needs all of
// h_{t-1}, so each step ends with a grid-wide barrier (~1.2 us), a floor of
// its own apart from the bound.
//
// Design: ONE cooperative launch of thread-block clusters does the whole
// call. The grid is a plan per shape (ops/lstm.py `fwd_plan`): P clusters
// of Q blocks; cluster p owns U hidden units, their 4U gate columns, and
// splits the product's reduction axis over its blocks: block r keeps R[its
// k-slice of K = H/Q rows (rounded up to 4), the 4U columns] in shared
// memory for the whole call (32 KB f32 at H 512, Q 2, U 8: 128 blocks, one
// an SM, fill the card). A warp owns K/8 of those rows: it stages its rows
// of R (16-byte copies of the units' runs where H and U keep them aligned,
// element by element where not) and reads only them. Each step t:
//   (a) each warp copies its k rows of h_{t-1} (h0 at t = 0) from the
//       double-buffered f32 exchange buffer with 16-byte cp.async (4-byte
//       loads where H % 4 != 0) and waits for its own copies only;
//   (b) each warp forms the partial z [rows, 4U] of its k rows as register
//       tiles: a lane holds 4 columns and 1, 2, 4 or 8 rows (a compile-
//       time count, the least that covers the batch: rows past it are
//       skipped warp-uniformly), so a float4 of h serves 16 FMAs and a
//       float4 of R 4 a row; the next 4 k rows load before this 4's FMAs.
//       The 8 warps' partials are summed in warp order;
//   (c) the block pushes each row's partial into the shared memory of the
//       block that owns the row's cells (the cluster's B x U cells, split
//       over Q by rows), one slot a rank; after one cluster.sync() the
//       owner sums the Q slots in rank order: the same bits every run;
//   (d) the owner adds x_proj[t] (loaded into registers a step ahead) and
//       the peepholes, updates the cell and writes h_t (rounded to R's
//       type: the next product's operand) to the exchange buffer; the f32
//       h and c carries never leave the block;
//   (e) split grid barrier: arrive, then store the step's five residual
//       outputs and issue the loads of x_proj[t+1] and the mask, then wait.
//       A one-step call (decode) takes no barrier at all.
// Where B is too large for one chunk of rows in shared memory, rows go in
// chunks (a cluster.sync between them), and cell state goes to f32 scratch
// when it does not fit beside them. The grid must be co-resident: the
// launch checks the plan against cudaOccupancyMaxActiveClusters (asked once
// a card, kernel, Q and shared memory, then kept) and returns
// cudaErrorCooperativeLaunchTooLarge (720) when the plan's clusters do not
// fit. No tensor cores (the f32 pin 1e-5 rules out TF32; bf16 is widened
// to f32) and no TMA.
//
// What the design leaves (lstm_study.py's step trace on an H100, T 64,
// B 32: ~7.6 us a step against ~1 us of FMA issue an SM): the copy of h
// from L2 (~1.5 us: every cluster reads all of h_{t-1}), the product at
// ~45 % of the FMA issue rate (2.3), the grid barrier with the stores it
// hides (2.2), the cluster barrier and the cell update (1.3). Small
// batches (prefill, decode) are those latencies alone. Larger clusters
// (fewer readers of h) need more co-resident 4-block clusters than an
// H100 holds (30); bf16 mma and a copy overlapped with the product are
// later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>
#include <algorithm>
#include <mutex>
#include <utility>
#include <vector>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;
using dl4j_sm90::cp_async16;
using dl4j_sm90::cp_async_commit;
using dl4j_sm90::smem_u32;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NRMAX = 8;                // rows a lane holds in one pass
constexpr int CELL = 16;                // f32 words of an owned cell's state
// a block's opt-in shared memory, less the static words of the trace
constexpr size_t SMEM_LIMIT = 232448 - 128;
// at least this much shared memory a block keeps two blocks off one SM,
// so a plan's blocks spread over as many SMs
constexpr size_t ONE_PER_SM = 232448 / 2 + 16;
// the points of a step block 0's thread 0 stamps when tracing: the step's
// start, the last warp's copy of h landed, the product done (block
// barrier passed), the block's sums pushed to their owners, the cluster
// barrier passed, the cell update done, the arrival and what it hides
// done, the wait over; and in the row after the last step, the kernel's
// start, its prologue issued (cluster barrier passed) and its end
constexpr int TRACE_MARKS = 8;

// a cell's state words: the carries, x_proj[t] of its four gates and the
// mask (loaded a step ahead, for all but a thread's first cell), then
// what the step stores after arriving
enum { S_H, S_C, S_ZI, S_ZF, S_ZO, S_ZG, S_M, O_I, O_F, O_O, O_G, O_CN, O_CP,
       O_HP };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

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

// v[c] += h * w[c] for the four columns of w
__device__ __forceinline__ void fma4(float (&v)[4], float h, const float4& w) {
    v[0] = fmaf(h, w.x, v[0]);
    v[1] = fmaf(h, w.y, v[1]);
    v[2] = fmaf(h, w.z, v[2]);
    v[3] = fmaf(h, w.w, v[3]);
}

// A lane's share of a warp's partial z over k rows [kb, ke): rows rgi +
// RG i (i < NR) from `hrow` (row rgi of the pass in sH), the four columns
// at `wcol` (sR, column 4 cgi); the next group of 4 k rows is loaded
// before this one's FMAs. Each row's sum runs in order of k.
template <typename T, int C, int NR>
__device__ __forceinline__ void lane_product(const float* hrow, const T* wcol,
                                             int ldh, int kb, int ke,
                                             float (&acc)[NR][4]) {
    constexpr int RG = 32 / (C / 4);
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    if (kb >= ke) return;
    float4 w[4], hv[NR];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) w[kk] = ld4(wcol + (size_t)(kb + kk) * C);
#pragma unroll
    for (int i = 0; i < NR; ++i) hv[i] = ld4(hrow + (size_t)RG * i * ldh + kb);
    for (int k = kb; k < ke; k += 4) {
        float4 cw[4], chv[NR];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) cw[kk] = w[kk];
#pragma unroll
        for (int i = 0; i < NR; ++i) chv[i] = hv[i];
        if (k + 4 < ke) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) w[kk] = ld4(wcol + (size_t)(k + 4 + kk) * C);
#pragma unroll
            for (int i = 0; i < NR; ++i) hv[i] = ld4(hrow + (size_t)RG * i * ldh + k + 4);
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            fma4(acc[i], chv[i].x, cw[0]);
            fma4(acc[i], chv[i].y, cw[1]);
            fma4(acc[i], chv[i].z, cw[2]);
            fma4(acc[i], chv[i].w, cw[3]);
        }
    }
}

// lane_product for NR rows, then the lane's rows below nr (of the chunk)
// into the warp's partial `rw` [bc][C]
template <typename T, int C, int NR>
__device__ __forceinline__ void lane_pass(const float* sH, const T* sR, float* rw,
                                          int ldh, int kb, int ke, int r0, int nr,
                                          int rgi, int cgi) {
    constexpr int RG = 32 / (C / 4);
    float acc[NR][4];
    lane_product<T, C, NR>(sH + (size_t)(r0 + rgi) * ldh, sR + 4 * cgi, ldh, kb,
                           ke, acc);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
        const int row = r0 + rgi + RG * i;
        if (row < nr)
            *reinterpret_cast<float4*>(rw + (size_t)row * C + 4 * cgi) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
}

// How a block of a plan lays out its shared memory; the host computes it
// (make_layout) and hands it to the kernel.
struct Layout {
    int K;            // rows of R a block holds (its k-slice), a multiple of 4
    int ldh;          // row stride of sH (floats): K + 4, rows off each other's banks
    int kw;           // k rows a warp takes, a multiple of 4
    int bc;           // batch rows a chunk, a multiple of 8
    int nchunk;       // chunks of rows a step
    int cpb;          // cells a block owns a chunk (bc U / Q)
    int cell_smem;    // cell state in shared memory (else scratch)
    unsigned off_h, off_red, off_in, off_cell;
    unsigned smem;    // dynamic shared memory bytes; 0: the plan does not fit
    long long scratch;   // f32 scratch elements a block
};

struct Args {
    const void *xp, *R, *h0, *c0;
    const float* mask;
    const void *pi, *pf, *po;
    void *hs, *gates, *cs, *cprev, *hprev, *hT, *cT;
    float* hbuf;          // [2][B][H] f32 exchange of h (null when seq == 1)
    float* scratch;
    long long* trace;     // null, or [seq + 1][TRACE_MARKS] clock64 of block 0
    int seq, batch, H;
};

size_t up16(size_t x) { return (x + 15) & ~(size_t)15; }

Layout make_layout(int H, int B, int Q, int U, int esize) {
    Layout L = {};
    const int C = 4 * U;
    L.K = ((H + Q - 1) / Q + 3) / 4 * 4;
    L.ldh = L.K + 4;
    L.kw = (L.K / 4 + WARPS - 1) / WARPS * 4;
    const size_t sR = up16((size_t)L.K * C * esize);
    // a pass covers 256 / U rows: the product may read (not use) sH rows
    // up to the pass's end
    const int pass = 256 / U;
    auto hrows = [&](int bc) { return (bc + pass - 1) / pass * pass; };
    auto rows_bytes = [&](int bc) {
        return up16((size_t)hrows(bc) * L.ldh * 4)
             + up16((size_t)WARPS * bc * C * 4) + up16((size_t)Q * bc * C * 4);
    };
    int bc = (B + 7) / 8 * 8;
    while (bc >= 8 && sR + rows_bytes(bc) > SMEM_LIMIT) bc -= 8;
    if (bc < 8) return L;                       // smem = 0: does not fit
    L.nchunk = (B + bc - 1) / bc;
    const int per = (B + L.nchunk - 1) / L.nchunk;
    L.bc = (per + 7) / 8 * 8;
    L.cpb = L.bc * U / Q;
    size_t off = sR;
    L.off_h = (unsigned)off;     off += up16((size_t)hrows(L.bc) * L.ldh * 4);
    L.off_red = (unsigned)off;   off += up16((size_t)WARPS * L.bc * C * 4);
    L.off_in = (unsigned)off;    off += up16((size_t)Q * L.bc * C * 4);
    const size_t cell = (size_t)L.nchunk * L.cpb * CELL * 4;
    L.cell_smem = off + up16(cell) <= SMEM_LIMIT;
    if (L.cell_smem) { L.off_cell = (unsigned)off; off += up16(cell); }
    L.smem = (unsigned)(off > ONE_PER_SM ? off : ONE_PER_SM);
    L.scratch = L.cell_smem ? 0 : (long long)(cell / 4);
    return L;
}

template <typename T, int U>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_kernel(Args a, Layout L, bool peep, bool masked) {
    constexpr int C = 4 * U;                // the cluster's gate columns
    constexpr int CG = C / 4;               // lanes across the columns
    constexpr int RG = 32 / CG;             // lanes across the rows
    cg::grid_group grid = cg::this_grid();
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ long long wclk[WARPS];       // each warp's copy landed (trace)
    const int Q = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
    const int H = a.H, B = a.batch, K = L.K, ldh = L.ldh;
    const int bc = L.bc, nchunk = L.nchunk, cpb = L.cpb, rpo = bc / Q;
    const size_t H4 = 4 * (size_t)H;
    const int u0 = (int)(blockIdx.x / Q) * U, k0 = q * K;
    const int ks = max(0, min(K, H - k0));  // the k rows this block holds
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cgi = lane % CG, rgi = lane / CG;
    // this warp's k rows of the slice, [kb, ke), whole groups of 4: the
    // warp stages and reads these rows of R and of h alone
    const int ks4 = (ks + 3) / 4 * 4;
    const int kb = min(ks4, warp * L.kw);
    const int ke = min(ks4, (warp + 1) * L.kw);

    T* sR = reinterpret_cast<T*>(smem);                          // [K][C]
    float* sH = reinterpret_cast<float*>(smem + L.off_h);        // [whole passes][ldh]
    float* red = reinterpret_cast<float*>(smem + L.off_red);     // [WARPS][bc][C]
    float* inbox = reinterpret_cast<float*>(smem + L.off_in);    // [Q][bc][C]
    float* cst = L.cell_smem ? reinterpret_cast<float*>(smem + L.off_cell)
                             : a.scratch + (size_t)blockIdx.x * L.scratch;

    const bool tracing = a.trace != nullptr && blockIdx.x == 0;
    auto mark = [&](int t, int k) {
        if (tracing && tid == 0) a.trace[(size_t)t * TRACE_MARKS + k] = clock64();
    };
    mark(a.seq, 0);
    const T* R = static_cast<const T*>(a.R);
    const T* xp = static_cast<const T*>(a.xp);

    // this warp's rows of R: R[k0 + k][g H + u0 + j] -> sR[k][g U + j],
    // 16-byte copies of the units' runs where H and U keep them aligned,
    // else element by element; zeros past H in both axes
    {
        constexpr int per = 16 / (int)sizeof(T);
        const bool rvec = (H * sizeof(T)) % 16 == 0 && (U * sizeof(T)) % 16 == 0
                          && reinterpret_cast<uintptr_t>(R) % 16 == 0;
        if (rvec) {
            constexpr int pieces = C / per;
            for (int i = lane; i < (ke - kb) * pieces; i += 32) {
                const int k = kb + i / pieces, c = (i % pieces) * per;
                const int g = c / U, u = u0 + c % U;
                const bool ok = k < ks && u < H;
                cp_async16(smem_u32(sR + (size_t)k * C + c),
                           ok ? R + (size_t)(k0 + k) * H4 + (size_t)g * H + u : R, ok);
            }
            cp_async_commit();
        } else {
            for (int i = lane; i < (ke - kb) * C; i += 32) {
                const int k = kb + i / C, c = i % C;
                const int g = c / U, u = u0 + c % U;
                sR[(size_t)k * C + c] =
                    (k < ks && u < H) ? R[(size_t)(k0 + k) * H4 + (size_t)g * H + u]
                                      : from_f<T>(0.f);
            }
        }
    }

    // the cells a thread owns: in each chunk, cells q cpb + tid + m THREADS
    // (row = cell / U of the chunk, unit j = cell % U = tid % U)
    const int jo = tid % U, uo = u0 + jo;
    float p_i = 0.f, p_f = 0.f, p_o = 0.f;
    if (peep && uo < H) {
        p_i = to_f(static_cast<const T*>(a.pi)[uo]);
        p_f = to_f(static_cast<const T*>(a.pf)[uo]);
        p_o = to_f(static_cast<const T*>(a.po)[uo]);
    }
    // x_proj[t] and the mask of the owned cells: the thread's first cell's
    // into registers (loads in flight across the grid barrier), the
    // others' into their state
    float px[4] = {0.f, 0.f, 0.f, 0.f}, pm = 1.f;
    auto load_step = [&](int t) {
        for (int ch = 0; ch < nchunk; ++ch)
            for (int i = tid; i < cpb; i += THREADS) {
                const int b = ch * bc + (q * cpb + i) / U;
                if (b >= B || uo >= H) continue;
                const T* row = xp + ((size_t)t * B + b) * H4 + uo;
                const float m = masked ? a.mask[(size_t)t * B + b] : 1.f;
                if (ch == 0 && i == tid) {
                    px[0] = to_f(row[0]);
                    px[1] = to_f(row[H]);
                    px[2] = to_f(row[2 * (size_t)H]);
                    px[3] = to_f(row[3 * (size_t)H]);
                    pm = m;
                } else {
                    float* s = cst + (size_t)(ch * cpb + i) * CELL;
                    s[S_ZI] = to_f(row[0]);
                    s[S_ZF] = to_f(row[H]);
                    s[S_ZO] = to_f(row[2 * (size_t)H]);
                    s[S_ZG] = to_f(row[3 * (size_t)H]);
                    s[S_M] = m;
                }
            }
    };
    for (int ch = 0; ch < nchunk; ++ch)
        for (int i = tid; i < cpb; i += THREADS) {
            const int b = ch * bc + (q * cpb + i) / U;
            if (b >= B || uo >= H) continue;
            float* s = cst + (size_t)(ch * cpb + i) * CELL;
            s[S_H] = to_f(static_cast<const T*>(a.h0)[(size_t)b * H + uo]);
            s[S_C] = to_f(static_cast<const T*>(a.c0)[(size_t)b * H + uo]);
        }
    load_step(0);
    // every block of the cluster runs before any writes another's inbox
    cluster.sync();
    mark(a.seq, 1);

    // the step's stores of the owned cells, from their state
    auto store_step = [&](int t) {
        for (int ch = 0; ch < nchunk; ++ch)
            for (int i = tid; i < cpb; i += THREADS) {
                const int b = ch * bc + (q * cpb + i) / U;
                if (b >= B || uo >= H) continue;
                const float* s = cst + (size_t)(ch * cpb + i) * CELL;
                const size_t o1 = ((size_t)t * B + b) * H + uo;
                static_cast<T*>(a.hs)[o1] = from_f<T>(s[S_H]);
                static_cast<T*>(a.cs)[o1] = from_f<T>(s[O_CN]);
                static_cast<T*>(a.cprev)[o1] = from_f<T>(s[O_CP]);
                static_cast<T*>(a.hprev)[o1] = from_f<T>(s[O_HP]);
                T* grow = static_cast<T*>(a.gates) + ((size_t)t * B + b) * H4 + uo;
                grow[0] = from_f<T>(s[O_I]);
                grow[H] = from_f<T>(s[O_F]);
                grow[2 * (size_t)H] = from_f<T>(s[O_O]);
                grow[3 * (size_t)H] = from_f<T>(s[O_G]);
                if (t == a.seq - 1) {
                    static_cast<T*>(a.hT)[(size_t)b * H + uo] = from_f<T>(s[S_H]);
                    static_cast<T*>(a.cT)[(size_t)b * H + uo] = from_f<T>(s[S_C]);
                }
            }
    };

    const bool hvec = H % 4 == 0;
    const size_t BH = (size_t)B * H;
    for (int t = 0; t < a.seq; ++t) {
        const float* hin = a.hbuf + (size_t)(t & 1) * BH;
        float* hout = a.hbuf + (size_t)((t + 1) & 1) * BH;
        mark(t, 0);
        for (int ch = 0; ch < nchunk; ++ch) {
            const int b0 = ch * bc, nr = min(bc, B - b0);
            // (a) this warp's k rows of h_{t-1} (h0 at t = 0) for the
            // chunk's rows
            const float* src = t > 0 ? hin
                             : sizeof(T) == 4 ? reinterpret_cast<const float*>(a.h0)
                                              : nullptr;
            if (src == nullptr) {
                const T* h0 = static_cast<const T*>(a.h0);
                const int wid = ke - kb;
                for (int i = lane; i < nr * wid; i += 32) {
                    const int rr = i / wid, k = kb + i % wid;
                    sH[(size_t)rr * ldh + k] =
                        k < ks ? to_f(h0[(size_t)(b0 + rr) * H + k0 + k]) : 0.f;
                }
            } else if (hvec && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
                const int pieces = (ke - kb) / 4;
                for (int i = lane; i < nr * pieces; i += 32) {
                    const int rr = i / pieces, k = kb + 4 * (i % pieces);
                    const bool ok = k < ks;
                    cp_async16(smem_u32(sH + (size_t)rr * ldh + k),
                               ok ? src + (size_t)(b0 + rr) * H + k0 + k : src, ok);
                }
                cp_async_commit();
            } else {
                // any H: element loads through L2 (not L1: the buffer is
                // rewritten every other step)
                const int wid = ke - kb;
                for (int i = lane; i < nr * wid; i += 32) {
                    const int rr = i / wid, k = kb + i % wid;
                    sH[(size_t)rr * ldh + k] =
                        k < ks ? __ldcg(src + (size_t)(b0 + rr) * H + k0 + k) : 0.f;
                }
            }
            dl4j_sm90::cp_async_wait<0>();  // R's rows too, at the first step
            __syncwarp();
            if (tracing && lane == 0) wclk[warp] = clock64();

            // (b) the partial z of this warp's k rows, passes of up to
            // RG x 8 rows; a lane takes rows rgi + RG i, columns 4 cgi..+3.
            // A pass's row count is a compile-time 1, 2, 4 or 8 a lane
            // (the least that covers the rows left): rows past the batch
            // are skipped warp-uniformly
            float* rw = red + (size_t)warp * bc * C;
            for (int r0 = 0; r0 < nr; r0 += RG * NRMAX) {
                const int n = (nr - r0 + RG - 1) / RG;
                if (n <= 1)
                    lane_pass<T, C, 1>(sH, sR, rw, ldh, kb, ke, r0, nr, rgi, cgi);
                else if (n <= 2)
                    lane_pass<T, C, 2>(sH, sR, rw, ldh, kb, ke, r0, nr, rgi, cgi);
                else if (n <= 4)
                    lane_pass<T, C, 4>(sH, sR, rw, ldh, kb, ke, r0, nr, rgi, cgi);
                else
                    lane_pass<T, C, NRMAX>(sH, sR, rw, ldh, kb, ke, r0, nr, rgi, cgi);
            }
            __syncthreads();
            if (tracing && tid == 0) {
                long long last = wclk[0];
                for (int w = 1; w < WARPS; ++w) last = max(last, wclk[w]);
                a.trace[(size_t)t * TRACE_MARKS + 1] = last;
            }
            mark(t, 2);
            // (c) the block's partial, the warps' sums in warp order, pushed
            // into the inbox of the block that owns the row's cells (rows
            // [r rpo, (r + 1) rpo) of the chunk are rank r's), slot q
            for (int o = tid; o < nr * (C / 4); o += THREADS) {
                float4 v = ld4(red + 4 * (size_t)o);
#pragma unroll
                for (int w = 1; w < WARPS; ++w) {
                    const float4 x = ld4(red + (size_t)w * bc * C + 4 * (size_t)o);
                    v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
                }
                const int rr = o / (C / 4);
                float* dst = cluster.map_shared_rank(inbox, rr / rpo);
                *reinterpret_cast<float4*>(dst + (size_t)q * bc * C + 4 * (size_t)o) = v;
            }
            mark(t, 3);
            cluster.sync();             // every partial is in its owner's inbox
            mark(t, 4);

            // (d) the owned cells: the Q partials in rank order, then the
            // cell update
            for (int i = tid; i < cpb; i += THREADS) {
                const int cell = q * cpb + i, rr = cell / U;
                const int b = b0 + rr;
                if (rr >= nr || uo >= H) continue;
                float* s = cst + (size_t)(ch * cpb + i) * CELL;
                const bool first = ch == 0 && i == tid;
                float z[4];
#pragma unroll
                for (int g = 0; g < 4; ++g) z[g] = first ? px[g] : s[S_ZI + g];
                for (int r = 0; r < Q; ++r) {
                    const float* pr = inbox + ((size_t)r * bc + rr) * C + jo;
#pragma unroll
                    for (int g = 0; g < 4; ++g) z[g] += pr[g * U];
                }
                float zi = z[0], zf = z[1], zo = z[2];
                const float zg = z[3];
                const float c_prev = s[S_C], h_prev = s[S_H];
                if (peep) {
                    zi = zi + c_prev * p_i;
                    zf = zf + c_prev * p_f;
                }
                const float ig = sigm(zi), fg = sigm(zf), gg = tanhf(zg);
                const float cn = fg * c_prev + ig * gg;
                if (peep) zo = zo + cn * p_o;
                const float og = sigm(zo);
                const float hn = og * tanhf(cn);
                float h = hn, c = cn;
                if (masked) {
                    const float m = first ? pm : s[S_M];
                    h = m * hn + (1.f - m) * h_prev;
                    c = m * cn + (1.f - m) * c_prev;
                }
                if (t + 1 < a.seq)
                    hout[(size_t)b * H + uo] = to_f(from_f<T>(h));
                s[O_I] = ig; s[O_F] = fg; s[O_O] = og; s[O_G] = gg;
                s[O_CN] = cn; s[O_CP] = c_prev; s[O_HP] = h_prev;
                s[S_H] = h; s[S_C] = c;
            }
            mark(t, 5);
            if (nchunk > 1) cluster.sync();   // no block pushes into an inbox still read
        }

        // (e) h_t is whole once every block has arrived; the wait hides the
        // step's stores and the next step's loads
        if (t + 1 < a.seq) {
            auto token = grid.barrier_arrive();
            store_step(t);
            load_step(t + 1);
            mark(t, 6);
            grid.barrier_wait(std::move(token));
        } else {
            store_step(t);
            mark(t, 6);
        }
        mark(t, 7);
    }
    mark(a.seq, 2);
}

template <int U>
cudaLaunchConfig_t config(const Layout& L, int Q, int H, cudaLaunchAttribute* attr) {
    const int P = (H + U - 1) / U;
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

// What the library says of a (card, kernel, Q, shared memory): the
// clusters it holds at once. A launch checks its plan against it, so it is
// asked once and kept (a decode step launches K5 once a layer); the
// kernel's opt-in shared memory is set once a card, to the most a plan
// takes.
struct Fit {
    int dev;
    const void* kern;
    int Q;
    unsigned smem;
    int clusters;
};
std::mutex fit_mu;
std::vector<Fit> fits;
std::vector<std::pair<int, const void*>> opted_in;

template <typename T, int U>
cudaError_t co_resident(const Layout& L, int Q, int H, int* clusters) {
    auto kern = lstm_fwd_kernel<T, U>;
    const void* key = reinterpret_cast<const void*>(kern);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(fit_mu);
    for (const Fit& f : fits)
        if (f.dev == dev && f.kern == key && f.Q == Q && f.smem == L.smem) {
            *clusters = f.clusters;
            return cudaSuccess;
        }
    const std::pair<int, const void*> card(dev, key);
    if (std::find(opted_in.begin(), opted_in.end(), card) == opted_in.end()) {
        err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)SMEM_LIMIT);
        if (err != cudaSuccess) return err;
        opted_in.push_back(card);
    }
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg = config<U>(L, Q, H, attr);
    err = cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
    if (err != cudaSuccess) return err;
    fits.push_back({dev, key, Q, L.smem, *clusters});
    return cudaSuccess;
}

// Fills out[0..5] = (dynamic shared bytes, f32 scratch elements for the
// grid, the clusters of this shape that can be co-resident, rows a chunk,
// chunks, blocks); shared bytes 0 when the plan does not fit a block.
template <typename T, int U>
cudaError_t layout_of(int H, int B, int Q, long long* out) {
    const Layout L = make_layout(H, B, Q, U, (int)sizeof(T));
    const int P = (H + U - 1) / U;
    out[0] = L.smem;
    out[1] = L.scratch * P * Q;
    out[2] = 0;
    out[3] = L.bc;
    out[4] = L.nchunk;
    out[5] = (long long)P * Q;
    if (L.smem == 0) return cudaSuccess;
    int n = 0;
    const cudaError_t err = co_resident<T, U>(L, Q, H, &n);
    out[2] = n;
    return err;
}

template <typename T, int U>
cudaError_t launch(const Args& a, int Q, cudaStream_t stream) {
    const Layout L = make_layout(a.H, a.batch, Q, U, (int)sizeof(T));
    if (L.smem == 0) return cudaErrorInvalidConfiguration;
    if (L.scratch > 0 && a.scratch == nullptr) return cudaErrorInvalidValue;
    if (a.seq > 1 && a.hbuf == nullptr) return cudaErrorInvalidValue;
    int fit = 0;
    cudaError_t err = co_resident<T, U>(L, Q, a.H, &fit);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg = config<U>(L, Q, a.H, attr);
    cfg.stream = stream;
    if ((int)(cfg.gridDim.x / Q) > fit) return cudaErrorCooperativeLaunchTooLarge;
    const bool peep = a.pi != nullptr, masked = a.mask != nullptr;
    err = cudaLaunchKernelEx(&cfg, lstm_fwd_kernel<T, U>, a, L, peep, masked);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// the units a cluster the kernel is compiled for; a plan names one
#define DL4J_BY_UNITS(U_, CALL)                                              \
    switch (U_) {                                                             \
    case 8: return CALL(8);                                                   \
    case 16: return CALL(16);                                                 \
    default: return cudaErrorInvalidValue;                                    \
    }

template <typename T>
cudaError_t layout_by_units(int H, int B, int Q, int U, long long* out) {
#define DL4J_LAYOUT(U__) layout_of<T, U__>(H, B, Q, out)
    DL4J_BY_UNITS(U, DL4J_LAYOUT)
#undef DL4J_LAYOUT
}

template <typename T>
cudaError_t launch_by_units(const Args& a, int Q, int U, cudaStream_t s) {
#define DL4J_LAUNCH(U__) launch<T, U__>(a, Q, s)
    DL4J_BY_UNITS(U, DL4J_LAUNCH)
#undef DL4J_LAUNCH
}

}  // namespace

// The layout of a plan (Q blocks a cluster, U units a cluster) at this
// shape on the current device: out[6] as layout_of fills it. Returns the
// CUDA error code.
extern "C" int dl4j_lstm_fwd_layout(int hidden, int batch, int q, int u,
                                    int is_bf16, long long* out) {
    if (hidden < 1 || batch < 1 || q != 2) return (int)cudaErrorInvalidValue;
    if (is_bf16)
        return (int)layout_by_units<__nv_bfloat16>(hidden, batch, q, u, out);
    return (int)layout_by_units<float>(hidden, batch, q, u, out);
}

// Runs the whole time loop of one call (one cooperative cluster launch) on
// `stream` with the plan (q, u); returns the CUDA error code (0 =
// launched). `mask` may be null; `pi`, `pf` and `po` are all null (plain
// LSTM) or all set (peepholes). `hbuf` ([2,B,H] f32, the exchange of h) may
// be null only when seq == 1; `scratch` holds the f32 elements
// dl4j_lstm_fwd_layout asks for (may be null when it asks for none).
// `trace` is null, or [seq][8] int64 that block 0's thread 0 fills with
// clock64() at the points of each step TRACE_MARKS names.
extern "C" int dl4j_lstm_fwd(const void* xp, const void* R, const void* h0,
                             const void* c0, const void* mask, const void* pi,
                             const void* pf, const void* po, void* hs,
                             void* gates, void* cs, void* cprev, void* hprev,
                             void* hT, void* cT, void* hbuf, void* scratch,
                             void* trace, int seq, int batch, int hidden,
                             int is_bf16, int q, int u, void* stream) {
    if (seq < 1 || batch < 1 || hidden < 1 || q != 2)
        return (int)cudaErrorInvalidValue;
    if ((pi == nullptr) != (pf == nullptr) || (pi == nullptr) != (po == nullptr))
        return (int)cudaErrorInvalidValue;
    Args a = {xp, R, h0, c0, static_cast<const float*>(mask), pi, pf, po,
              hs, gates, cs, cprev, hprev, hT, cT,
              static_cast<float*>(hbuf), static_cast<float*>(scratch),
              static_cast<long long*>(trace), seq, batch, hidden};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) return (int)launch_by_units<__nv_bfloat16>(a, q, u, s);
    return (int)launch_by_units<float>(a, q, u, s);
}
