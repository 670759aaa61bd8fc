// int8 x int8 -> int32 matmul with the per-row x per-column rescale, for
// Hopper (sm_90a), plain CUDA C++ behind a C interface (loaded with ctypes
// by deeplearning4j_tpu_torch/ops/kernels/quantized.py).
//
// Replaces the TPU kernel deeplearning4j_tpu/ops/kernels/quantized.py
// `int8_matmul_pallas` (the pl.pallas_call) / `_matmul_kernel`. Same
// function:
//   x_q [M, K] int8, w_q [K, N] int8, x_scale [M] f32, w_scale [N] f32;
//   acc = x_q . w_q summed exactly in int32;
//   out [M, N] f32 = (float(acc) * x_scale[m]) * w_scale[n], in that order,
//   so the result is bitwise the plain version's (the reference pins this
//   kernel at 0.0). Any order of exact int32 sums gives the same acc
//   (K * 127^2 < 2^31 for every K the wrapper admits), so split-K is free.
//
// What bounds it on this card: 2*M*K*N int8 operations against
// M*K + K*N bytes in, 4*M*N bytes out and 4*(M + N) bytes of scales. At the
// int8 serving net's widths (M 8-256, K 512, N 256-512) that is at most
// ~110 operations a byte against the card's balance of 1979 TOP/s /
// 3.35 TB/s = 590: bound by bytes, and at these sizes (0.13-0.9 MB a call)
// by the latency of one trip to memory and the fill of the card more than
// by either rate.
//
// Design: integer tensor cores through mma.sync m16n8k32 (s8 x s8 -> s32);
// wgmma's s8 form needs 64-row tiles, which at M 8-32 would be mostly
// padding. A block of four warps owns a 16-row x 32-column output tile,
// one n8 column strip a warp, and a range of K: the host's plan
// (quantized.py `tile_plan`) splits K over the S blocks of a thread-block
// cluster until a call has at least 64 blocks (M 8: 16 or 8 tiles x 4 or 8
// splits; M 256: 256 or 128 tiles, no split). The block stages its x rows
// by 16-byte cp.async copies, and its w columns transposed: w is [K, N],
// N-major, and the mma's B operand is K-major, so a thread reads four
// K-rows of 16 bytes and regroups them with __byte_perm into 16 words of
// four consecutive k for one n. Both tiles are read from shared memory by
// ldmatrix (rows padded by 16 bytes: conflict-free), two accumulator sets
// alternate over the k-steps. An unsplit block rescales its fragment and
// stores it; a split call adds the cluster's int32 partials through
// distributed shared memory (exact, in rank order), and each block rescales
// and stores a share of the tile. K is walked in chunks of 512 bytes. A K
// or N that is not a multiple of 16, or a misaligned pointer, takes the
// same kernel with byte-wise guarded staging (zeros past every edge add
// nothing to an exact sum).
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using dl4j_sm90::cp_async16;
using dl4j_sm90::cp_async_commit;
using dl4j_sm90::cp_async_wait;
using dl4j_sm90::smem_u32;

constexpr int BM = 16;              // output rows a block: one m16 tile
constexpr int BN = 32;              // output columns a block: n8 a warp
constexpr int WARPS = BN / 8;
constexpr int THREADS = 32 * WARPS;
constexpr int KSTEP = 32;           // k of one mma
constexpr int KC = 512;             // k a shared-memory chunk
constexpr int LDS = KC + 16;        // row stride in bytes
constexpr int LDP = BN + 1;         // partial tile row stride, int32
constexpr int MAX_SPLITS = 8;       // blocks of a portable cluster

struct Smem {
    alignas(16) int8_t x[BM][LDS];  // x rows, k contiguous
    alignas(16) int8_t w[BN][LDS];  // w transposed: [n][k]
    int32_t part[BM][LDP];          // this block's partial tile (split K)
};

__device__ __forceinline__ uint32_t byte_at(const int8_t* p, bool ok) {
    return ok ? (uint32_t)(uint8_t)__ldg(p) : 0u;
}

// words r0..r3 hold bytes of k rows 0..3 for four consecutive n; returns
// in o[j] the four k bytes of the n at byte j
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t (&o)[4]) {
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
    const uint32_t t1 = __byte_perm(r2, r3, 0x5140);  // r2.0 r3.0 r2.1 r3.1
    const uint32_t t2 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
    const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
    o[0] = __byte_perm(t0, t1, 0x5410);
    o[1] = __byte_perm(t0, t1, 0x7632);
    o[2] = __byte_perm(t2, t3, 0x5410);
    o[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t a) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// d += A[16x32] . B[32x8], s8 operands, exact s32 sums
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
    asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                   "r"(b[1]));
}

__device__ __forceinline__ float rescale(int32_t acc, float sx, float sw) {
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

// Stages k [c0, c0 + nsteps * 32) of the block's x rows and w columns
// (zeros from k_hi, M and N on). VEC: K and N multiples of 16 and both
// pointers 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void stage(Smem& sm, const int8_t* xq,
                                      const int8_t* wq, int M, int K, int N,
                                      int m0, int n0, int c0, int k_hi,
                                      int nsteps, int tid) {
    const int kc = nsteps * KSTEP;
    if (VEC) {
        for (int i = tid; i < BM * (kc / 16); i += THREADS) {
            const int r = i / (kc / 16), g = i % (kc / 16);
            const int m = m0 + r, k = c0 + 16 * g;
            const bool ok = m < M && k < k_hi;
            cp_async16(smem_u32(&sm.x[r][16 * g]),
                       ok ? xq + (size_t)m * K + k : xq, ok);
        }
        cp_async_commit();
        // four k rows x 16 n a thread: (k group, n half)
        for (int i = tid; i < (kc / 4) * 2; i += THREADS) {
            const int kq = i / 2, h = i % 2;
            const int k = c0 + 4 * kq, n = n0 + 16 * h;
            uint4 rows[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                rows[j] = make_uint4(0u, 0u, 0u, 0u);
                if (n < N && k + j < k_hi)
                    rows[j] = __ldg(reinterpret_cast<const uint4*>(
                        wq + (size_t)(k + j) * N + n));
            }
            const uint32_t* r0 = reinterpret_cast<const uint32_t*>(&rows[0]);
            const uint32_t* r1 = reinterpret_cast<const uint32_t*>(&rows[1]);
            const uint32_t* r2 = reinterpret_cast<const uint32_t*>(&rows[2]);
            const uint32_t* r3 = reinterpret_cast<const uint32_t*>(&rows[3]);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                uint32_t o[4];
                transpose4(r0[q], r1[q], r2[q], r3[q], o);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    *reinterpret_cast<uint32_t*>(
                        &sm.w[16 * h + 4 * q + j][4 * kq]) = o[j];
            }
        }
    } else {
        for (int i = tid; i < BM * (kc / 4); i += THREADS) {
            const int r = i / (kc / 4), kw = i % (kc / 4);
            const int m = m0 + r, k = c0 + 4 * kw;
            uint32_t word = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                word |= byte_at(xq + (size_t)m * K + k + j,
                                m < M && k + j < k_hi) << (8 * j);
            *reinterpret_cast<uint32_t*>(&sm.x[r][4 * kw]) = word;
        }
        for (int i = tid; i < BN * (kc / 4); i += THREADS) {
            const int nl = i % BN, kw = i / BN;
            const int n = n0 + nl, k = c0 + 4 * kw;
            uint32_t word = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                word |= byte_at(wq + (size_t)(k + j) * N + n,
                                n < N && k + j < k_hi) << (8 * j);
            *reinterpret_cast<uint32_t*>(&sm.w[nl][4 * kw]) = word;
        }
        cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
}

// grid (splits, column tiles, row tiles); a split call is a cluster of the
// `splits` blocks along x, block s taking k [s * k_per, (s + 1) * k_per)
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_mma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                const float* __restrict__ xs, const float* __restrict__ ws,
                float* __restrict__ out, int M, int K, int N, int k_per) {
    __shared__ Smem sm;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int splits = gridDim.x, rank = blockIdx.x;
    const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
    const int k_lo = rank * k_per, k_hi = min(K, k_lo + k_per);

    // ldmatrix row addresses: A's four 8x16-byte matrices are (rows 0-7,
    // 8-15) x (k 0-15, 16-31) of a k-step; B's two are this warp's 8
    // columns x (k 0-15, 16-31)
    const uint32_t a_addr = smem_u32(&sm.x[(lane % 8) + 8 * ((lane / 8) & 1)]
                                          [16 * (lane / 16)]);
    const uint32_t b_addr = smem_u32(&sm.w[8 * warp + (lane % 8)]
                                          [16 * ((lane / 8) & 1)]);

    int32_t d[4] = {0, 0, 0, 0}, d1[4] = {0, 0, 0, 0};
    auto step = [&](int32_t (&acc)[4], int s) {
        uint32_t a[4], b[2];
        ldmatrix_x4(a, a_addr + s * KSTEP);
        ldmatrix_x2(b, b_addr + s * KSTEP);
        mma_s8(acc, a, b);
    };
    for (int c0 = k_lo; c0 < k_hi; c0 += KC) {
        const int nsteps = (min(KC, k_hi - c0) + KSTEP - 1) / KSTEP;
        if (c0 > k_lo) __syncthreads();          // the last chunk is read
        stage<VEC>(sm, xq, wq, M, K, N, m0, n0, c0, k_hi, nsteps, tid);
        int s = 0;
#pragma unroll 2
        for (; s + 1 < nsteps; s += 2) {         // two chains of mmas
            step(d, s);
            step(d1, s + 1);
        }
        if (s < nsteps) step(d, s);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += d1[e];

    // fragment: d[e] is row g + 8 * (e / 2), column 8 * warp + 2c + e % 2
    if (splits == 1) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            const int m = m0 + g + 8 * hi;
            const int n = n0 + 8 * warp + 2 * c;
            if (m >= M || n >= N) continue;
            const float sx = xs[m];
            float* o = out + (size_t)m * N + n;
            if (VEC) {
                *reinterpret_cast<float2*>(o) =
                    make_float2(rescale(d[2 * hi], sx, ws[n]),
                                rescale(d[2 * hi + 1], sx, ws[n + 1]));
            } else {
                o[0] = rescale(d[2 * hi], sx, ws[n]);
                if (n + 1 < N) o[1] = rescale(d[2 * hi + 1], sx, ws[n + 1]);
            }
        }
        return;
    }

    // split K: the partial into shared memory, then the cluster adds the
    // partials in rank order and each block stores a share of the tile
#pragma unroll
    for (int e = 0; e < 4; ++e)
        sm.part[g + 8 * (e / 2)][8 * warp + 2 * c + e % 2] = d[e];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                              // every partial is written
    for (int i = rank * THREADS + tid; i < BM * BN; i += splits * THREADS) {
        const int r = i / BN, nl = i % BN;
        const int m = m0 + r, n = n0 + nl;
        int32_t sum = 0;
        for (int s = 0; s < splits; ++s)
            sum += cluster.map_shared_rank(&sm.part[0][0], s)[r * LDP + nl];
        if (m < M && n < N) out[(size_t)m * N + n] = rescale(sum, xs[m], ws[n]);
    }
    cluster.sync();                              // no block leaves while read
}

template <bool VEC>
cudaError_t launch(const void* xq, const void* wq, const void* xs,
                   const void* ws, void* out, int M, int K, int N,
                   int splits, int k_per, cudaStream_t stream) {
    auto kernel = int8_mma_kernel<VEC>;
    const dim3 grid(splits, (N + BN - 1) / BN, (M + BM - 1) / BM);
    const int8_t* x8 = static_cast<const int8_t*>(xq);
    const int8_t* w8 = static_cast<const int8_t*>(wq);
    const float* xf = static_cast<const float*>(xs);
    const float* wf = static_cast<const float*>(ws);
    float* of = static_cast<float*>(out);
    if (splits == 1) {
        kernel<<<grid, THREADS, 0, stream>>>(x8, w8, xf, wf, of, M, K, N,
                                             k_per);
        return cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x8, w8, xf, wf, of, M,
                                         K, N, k_per);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched). The arguments come as one array of 64-bit
// integers (one pointer for the caller to pass instead of eleven):
//   a[0..4]  x_q [M, K], w_q [K, N] (int8), x_scale [M], w_scale [N], out
//            [M, N] (f32), all contiguous;
//   a[5..7]  M, K, N;
//   a[8..9]  the plan: K split over `splits` (1-8) blocks of `k_per` k
//            each, a multiple of 32, every split holding some of K
//            (quantized.py `tile_plan`);
//   a[10]    the stream.
extern "C" int dl4j_int8_matmul(const long long* a) {
    const void* xq = reinterpret_cast<const void*>(a[0]);
    const void* wq = reinterpret_cast<const void*>(a[1]);
    const void* xs = reinterpret_cast<const void*>(a[2]);
    const void* ws = reinterpret_cast<const void*>(a[3]);
    void* out = reinterpret_cast<void*>(a[4]);
    const long long M = a[5], K = a[6], N = a[7], splits = a[8], k_per = a[9];
    if (M < 1 || K < 1 || N < 1 || M > INT32_MAX || K > INT32_MAX ||
        N > INT32_MAX || (M + BM - 1) / BM > 65535 ||
        (N + BN - 1) / BN > 65535 || splits < 1 || splits > MAX_SPLITS ||
        k_per < 1 || k_per % KSTEP != 0 || k_per * splits < K ||
        k_per * (splits - 1) >= K)
        return (int)cudaErrorInvalidValue;
    const bool vec = K % 16 == 0 && N % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(wq) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
    const cudaStream_t s = reinterpret_cast<cudaStream_t>(a[10]);
    return (int)(vec ? launch<true>(xq, wq, xs, ws, out, (int)M, (int)K,
                                    (int)N, (int)splits, (int)k_per, s)
                     : launch<false>(xq, wq, xs, ws, out, (int)M, (int)K,
                                     (int)N, (int)splits, (int)k_per, s));
}
