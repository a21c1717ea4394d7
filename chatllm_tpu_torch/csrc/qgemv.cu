// K1: fused dequant GEMV for single-row decode.
//
//   y[1, N] = x[1, K] @ dequant(W) (+ bias),  f32 accumulation
//
// Replaces chatllm_tpu/ops/pallas/gemv_kernel.py::qgemv_pallas (body
// `_kernel`).  W is the planar layout of ops/qtensor.py: int8 q [K, N] or
// nibble-packed uint8 [K/2, N] with group-local pairing (byte row j of group
// g holds rows G*g+j and G*g+j+G/2 in its low/high nibble), classic f16/f32
// group scales (+ affine b, + zero point), or the k-quant superblock layout
// (int8 sc/m per group, f16 d/dmin per superblock, s = d*sc, b = -dmin*m).
// Unlike the Pallas wrapper, the affine and zero-point terms are folded in
// here (they ride the per-group sums of x), so one call does the whole op:
// per group, s_eff * (sum_j q_j x_j - zp * sum_j x_j) + b_eff * sum_j x_j,
// all in f32.
//
// Bound on the H100: device-memory bytes.  At the Llama-3-8B q4_k shapes
// the weight is ~0.56 byte/parameter and every weight is used exactly once,
// so the floor is (weight + scale bytes) / 3.35 TB/s; arithmetic (2 flop per
// weight on the CUDA cores) is far below the 67 TFLOP/s f32 rate.
//
// Design (second version; each numbered cause is one the first version had):
//  1. The kernel is templated on (G, packed, x type, column lanes), so a
//     thread's unit of work is fully unrolled: 8 byte rows of one group for
//     16 columns (8 loads of 16 bytes, non-caching) and its scale rows, all
//     issued before any is used.  The per-group factoring is linear in the
//     sums, so the parts of a group each add their own share.  Registers
//     stay at 128 or fewer, so two blocks of 256 threads share an SM.
//  2. One launch per call: x is read in its own type (bf16 or f32), and the
//     split-K partial sums are added inside the kernel: the splits of a
//     column tile form a thread-block cluster (up to 8 blocks along K) that
//     sums the blocks' shared-memory partials through distributed shared
//     memory in rank order (no atomics, no scratch in device memory, the
//     same bits run to run).
//  3. Tiles and splits are sized by the work in flight, not by groups per
//     warp: `gemv_geometry` (ops/cuda/gemv_kernel.py) picks 8, 16 or 32
//     column lanes per block and up to 8 splits, so that small N (Qwen's k/v
//     at N 128) spreads over several blocks and one round of loads.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int CPT = 16;                      // columns per thread (one 16-byte load per row)
constexpr int MAX_TILE = 32 * CPT;           // columns per block at most
constexpr int MAX_SPLITS = 8;                // blocks per cluster (the portable limit)

struct Args {
    const void* x;
    const uint8_t* q;
    const void* s;
    const void* b;
    const __half* d;
    const __half* dm;
    const float* bias;
    float* y;
    int K, N, sb, packed, zero_point, s_kind;
};

__device__ __forceinline__ uint4 ld_stream(const uint8_t* p) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

// x[k0 .. k0+NX) as f32 (k0 a multiple of 8, NX of 8)
template <int NX, bool XBF16>
__device__ __forceinline__ void load_x(const void* x, long k0, float* xv) {
    if (XBF16) {
        const uint4* src = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(x) + k0);
#pragma unroll
        for (int i = 0; i < NX / 8; ++i) {
            const uint4 u = __ldg(src + i);
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
            for (int c = 0; c < 8; ++c) xv[8 * i + c] = __bfloat162float(e[c]);
        }
    } else {
        const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(x) + k0);
#pragma unroll
        for (int i = 0; i < NX / 4; ++i) {
            const float4 f = __ldg(src + i);
            xv[4 * i] = f.x; xv[4 * i + 1] = f.y; xv[4 * i + 2] = f.z; xv[4 * i + 3] = f.w;
        }
    }
}

template <int G, bool PACKED, bool XBF16>
struct Unit {
    static constexpr int ROWS = PACKED ? G / 2 : G;      // byte rows per group
    static constexpr int R = 8;                          // byte rows per unit of work
    static constexpr int PARTS = ROWS / R;               // units per group
};

// A thread's unit of work is (group g, part p): byte rows p*8 .. p*8+7 of
// group g for 16 columns.  The per-group factoring is linear in the sums,
// so each part adds s_eff * (t_p - zp * xs_p) + b_eff * xs_p with its own
// partial sums t_p of q * x and xs_p of x.
template <int G, bool PACKED, bool XBF16, int CL>
__global__ void __launch_bounds__(THREADS, 2) qgemv_kernel(const Args a) {
    using U = Unit<G, PACKED, XBF16>;
    constexpr int tile = CL * CPT;                          // columns per block
    constexpr int kt_lanes = THREADS / CL;                  // unit lanes
    __shared__ __align__(16) float red[THREADS * CPT];      // [unit lanes][tile columns]
    __shared__ __align__(16) float part[MAX_TILE];          // this block's column sums
    cg::cluster_group cluster = cg::this_cluster();

    const int cl = threadIdx.x % CL, kl = threadIdx.x / CL;
    const int col = blockIdx.x * tile + cl * CPT;
    const bool active = col < a.N;
    const int n_units = a.K / G * U::PARTS;
    const int splits = gridDim.y;
    const int u0 = static_cast<int>(static_cast<long>(blockIdx.y) * n_units / splits);
    const int u1 = static_cast<int>(static_cast<long>(blockIdx.y + 1) * n_units / splits);

    float acc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

    if (active) {
        for (int u = u0 + kl; u < u1; u += kt_lanes) {
            const int g = u / U::PARTS, pr = u % U::PARTS;
            const int r0 = pr * U::R;                       // first byte row of the unit
            const uint8_t* qg = a.q + (static_cast<long>(g) * U::ROWS + r0) * a.N + col;
            uint4 v[U::R];
#pragma unroll
            for (int r = 0; r < U::R; ++r) v[r] = ld_stream(qg + static_cast<long>(r) * a.N);
            float s_eff[CPT], b_eff[CPT];
            group_scales16(QWeight{a.q, a.s, a.b, a.d, a.dm, a.K, a.N, G, a.sb, a.packed,
                                   a.zero_point, a.s_kind},
                           g, col, s_eff, b_eff);
            // x at the unit's rows: k = g*G + r0 + r (and + G/2 for the high nibbles)
            float xlo[U::R], xhi[PACKED ? U::R : 1];
            load_x<U::R, XBF16>(a.x, static_cast<long>(g) * G + r0, xlo);
            if (PACKED) load_x<U::R, XBF16>(a.x, static_cast<long>(g) * G + G / 2 + r0, xhi);
            float xsum = 0.f;
#pragma unroll
            for (int r = 0; r < U::R; ++r) xsum += PACKED ? xlo[r] + xhi[PACKED ? r : 0] : xlo[r];
            float t[CPT];
#pragma unroll
            for (int c = 0; c < CPT; ++c) t[c] = 0.f;
#pragma unroll
            for (int r = 0; r < U::R; ++r) {
                const uint8_t* e = reinterpret_cast<const uint8_t*>(&v[r]);
                if (PACKED) {
#pragma unroll
                    for (int c = 0; c < CPT; ++c)
                        t[c] += static_cast<float>(e[c] & 0xF) * xlo[r]
                              + static_cast<float>(e[c] >> 4) * xhi[PACKED ? r : 0];
                } else {
#pragma unroll
                    for (int c = 0; c < CPT; ++c)
                        t[c] += static_cast<float>(static_cast<int8_t>(e[c])) * xlo[r];
                }
            }
            const float zsum = static_cast<float>(a.zero_point) * xsum;
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[c] += s_eff[c] * (t[c] - zsum) + b_eff[c] * xsum;
        }
    }

    float4* r4 = reinterpret_cast<float4*>(red + kl * tile + cl * CPT);
#pragma unroll
    for (int c = 0; c < CPT / 4; ++c)
        r4[c] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += THREADS) {
        float v[kt_lanes];
#pragma unroll
        for (int k = 0; k < kt_lanes; ++k) v[k] = red[k * tile + i];
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < kt_lanes; ++k) sum += v[k];
        part[i] = sum;
    }
    cluster.sync();

    // the cluster's blocks split the tile's columns; each adds the splits in
    // rank order (every peer's value is loaded before the first add)
    const int rank = static_cast<int>(cluster.block_rank());
    for (int i = rank * THREADS + threadIdx.x; i < tile; i += splits * THREADS) {
        const int n = blockIdx.x * tile + i;
        if (n >= a.N) continue;
        float v[MAX_SPLITS];
#pragma unroll
        for (int src = 0; src < MAX_SPLITS; ++src)
            v[src] = src < splits ? cluster.map_shared_rank(part, src)[i] : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int src = 0; src < MAX_SPLITS; ++src)
            if (src < splits) sum += v[src];
        a.y[n] = sum + (a.bias ? a.bias[n] : 0.f);
    }
    cluster.sync();              // keep this block's partials alive until every peer has read them
}

template <int G, bool PACKED, bool XBF16, int CL>
int launch(const Args& a, int n_splits, cudaStream_t st) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((a.N + CL * CPT - 1) / (CL * CPT), n_splits, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = n_splits;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, qgemv_kernel<G, PACKED, XBF16, CL>, a);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int G, bool PACKED, bool XBF16>
int launch_cl(const Args& a, int cl_lanes, int n_splits, cudaStream_t st) {
    if (cl_lanes == 8) return launch<G, PACKED, XBF16, 8>(a, n_splits, st);
    if (cl_lanes == 16) return launch<G, PACKED, XBF16, 16>(a, n_splits, st);
    return launch<G, PACKED, XBF16, 32>(a, n_splits, st);
}

template <int G>
int launch_g(const Args& a, bool xbf16, int cl_lanes, int n_splits, cudaStream_t st) {
    if (a.packed)
        return xbf16 ? launch_cl<G, true, true>(a, cl_lanes, n_splits, st)
                     : launch_cl<G, true, false>(a, cl_lanes, n_splits, st);
    return xbf16 ? launch_cl<G, false, true>(a, cl_lanes, n_splits, st)
                 : launch_cl<G, false, false>(a, cl_lanes, n_splits, st);
}

}  // namespace

// x: bf16 or f32 [K] (x_kind), 16-byte aligned; y: f32 [N].  Requires
// N % 16 == 0, K % G == 0, G in {16, 32}, cl_lanes in {8, 16, 32},
// 1 <= n_splits <= 8 groups, 16-byte aligned q/s/b/d/dm (checked by the
// Python wrapper).  One launch: ceil(N / (16 cl_lanes)) x n_splits blocks in
// clusters of n_splits along K.
CL_EXPORT int qgemv_launch(const void* x, int x_kind, const void* q, const void* s, const void* b,
                           const void* d, const void* dm, const void* bias, void* y, int K,
                           int N, int G, int sb, int packed, int zero_point, int s_kind,
                           int cl_lanes, int n_splits, void* stream) {
    if ((G != 16 && G != 32) || (x_kind != KIND_BF16 && x_kind != KIND_F32)
        || (cl_lanes != 8 && cl_lanes != 16 && cl_lanes != 32) || n_splits < 1 || n_splits > 8)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{x, static_cast<const uint8_t*>(q), s, b, static_cast<const __half*>(d),
                 static_cast<const __half*>(dm), static_cast<const float*>(bias),
                 static_cast<float*>(y), K, N, sb, packed, zero_point, s_kind};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool xb = x_kind == KIND_BF16;
    return G == 16 ? launch_g<16>(a, xb, cl_lanes, n_splits, st)
                   : launch_g<32>(a, xb, cl_lanes, n_splits, st);
}
