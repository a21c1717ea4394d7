// E6: K2's q4_k body at M <= 64 rows with cheaper dequant arithmetic.
//
//   y[M, N] = sum over k tiles of  x_bf16[:, tile] @ w_bf16[tile]   (f32 acc)
//
// Replaces experiments/qmm_unpack_variants.py: `make_kernel(unpack,
// biasdot)` (template (a), `qmm_unpack_kernel`, run by `bench_variant` and
// `check_correct`) and `make_kernel2(mode)` (template (b),
// `qmm_unpack_diag_kernel`, the five diagnostic modes).  The weight is the
// superblock q4_k layout: nibble-packed q [K/2, N] (byte row i of group g
// holds rows 32g + i and 32g + 16 + i), int8 sc / m [K/32, N], f16 d / dmin
// [K/256, N].
//
// (a) The Pallas body's numerics: s = bf16(sc * d) and w = bf16(wq * s);
//     without biasdot w = bf16(w + bf16(-(m * dmin))); with biasdot the
//     affine term is added to each k tile's product in f32, as the f32 dot
//     of the per-group sums of x (xs, passed transposed [K/32, M]) with the
//     unrounded -(m * dmin).  The unpack modes (v0 widen and mask both
//     nibbles, v1 no mask after the shift, v2 16-bit widen, v3 one float
//     conversion and floor(q / 16)) give the same values in different
//     instructions: that difference is what the probe times.
// (b) Diagnostic weights, bench-only numerics: noscale (the unpacked
//     nibbles), nounpack (each byte twice: rows j and j + TK/2 of a k tile
//     of TK rows), storeonly (the bytes in the first TK/2 rows, zeros in the
//     rest: the Pallas kernel leaves those rows of its scratch as they were;
//     here they are defined), splitstore (row j < TK/2 the low nibble of
//     byte row j, row TK/2 + j its high nibble, times the bf16 scale of the
//     row's group) and splitstore_bias (plus the bf16 affine term).
//
// Bound on the H100: bytes.  At M = 32, K = 4096, N = 14336 the weight is
// 29.4 MB of q, 3.7 MB of sc and m and 0.9 MB of d and dmin against 3.76
// GFLOP: 36 MB / 3.35 TB/s = 10.8 us, flops 3.8 us at 989 TFLOP/s.
//
// Design: the Pallas kernel dequantizes each (2048 x 512) tile once into a
// bf16 VMEM scratch and reuses it for every row.  Here a block owns 64
// columns of one k tile and walks it in 64-row chunks: each chunk is
// dequantized once into shared memory (transposed, so an mma B fragment is
// one 32-bit load) and multiplied with all M rows of x by mma.sync
// m16n8k16 (bf16 in, f32 accumulate).  The blocks of one k tile write its
// product to scratch, and a second pass adds the k tiles in order, as the
// Pallas kernel's output block accumulates them.  No pipelining: a first
// kernel that is right.
#include "common.cuh"

namespace {

constexpr int TN = 64;        // columns per block
constexpr int TKC = 64;       // rows per dequantized chunk (two groups)
constexpr int PAD = 8;
constexpr int THREADS = 128;
constexpr int GROUP = 32;
constexpr int SB = 8;
constexpr int MT_MAX = 4;     // 16-row mma tiles: M <= 64

enum Diag : int { NOSCALE = 0, NOUNPACK = 1, STOREONLY = 2, SPLITSTORE = 3, SPLITSTORE_BIAS = 4 };

struct Args {
    const float* x;           // [M, K]
    const float* xs;          // [K/32, M] per-group sums of x (biasdot only)
    const uint8_t* q;         // [K/2, N]
    const int8_t* sc;         // [K/32, N]
    const int8_t* m;          // [K/32, N]
    const __half* d;          // [K/256, N]
    const __half* dm;         // [K/256, N]
    float* out;               // [n_kt, M, N] partials, or y when n_kt == 1
    int M, K, N, tile_k;
};

__device__ __forceinline__ float bf16r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// The two rows a byte holds, as f32 (exact small integers), per variant.
template <int U>
__device__ __forceinline__ void unpack_byte(uint8_t b, float& lo, float& hi) {
    if constexpr (U == 0) {           // v0: widen to i32, & 0xF, (>> 4) & 0xF
        const int qi = b;
        lo = static_cast<float>(qi & 0xF);
        hi = static_cast<float>((qi >> 4) & 0xF);
    } else if constexpr (U == 1) {    // v1: no mask after the shift
        const int qi = b;
        lo = static_cast<float>(qi & 0xF);
        hi = static_cast<float>(qi >> 4);
    } else if constexpr (U == 2) {    // v2: widen to i16
        const short qi = b;
        lo = static_cast<float>(static_cast<short>(qi & 0xF));
        hi = static_cast<float>(static_cast<short>(qi >> 4));
    } else {                          // v3: one conversion, hi = floor(q / 16)
        const float qf = static_cast<float>(b);
        hi = floorf(qf * 0.0625f);
        lo = qf - hi * 16.f;
    }
}

// x rows [0, 16 * n_mt) of columns [k, k + TKC) as bf16, zero past M.
__device__ __forceinline__ void stage_x(const Args& a, int rows, int k,
                                        __nv_bfloat16 (*xs)[TKC + PAD]) {
    for (int idx = threadIdx.x; idx < rows * (TKC / 4); idx += THREADS) {
        const int r = idx / (TKC / 4), c = (idx % (TKC / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < a.M) v = *reinterpret_cast<const float4*>(a.x + static_cast<long>(r) * a.K + k + c);
        xs[r][c] = __float2bfloat16_rn(v.x);
        xs[r][c + 1] = __float2bfloat16_rn(v.y);
        xs[r][c + 2] = __float2bfloat16_rn(v.z);
        xs[r][c + 3] = __float2bfloat16_rn(v.w);
    }
}

// Sixteen columns' bf16(sc * d) and, if asked, -(m * dmin) (bf16-rounded
// or not) of group g.
__device__ __forceinline__ void scales16(const Args& a, int g, int n, float* s, float* bb,
                                         bool want_bias, bool round_bias) {
    float sc[16], dd[16];
    const long gi = static_cast<long>(g) * a.N + n, si = static_cast<long>(g / SB) * a.N + n;
    load16_f32(a.sc, gi, KIND_I8, sc);
    load16_f32(a.d, si, KIND_F16, dd);
#pragma unroll
    for (int c = 0; c < 16; ++c) s[c] = bf16r(sc[c] * dd[c]);
    if (want_bias) {
        float mm[16], dmn[16];
        load16_f32(a.m, gi, KIND_I8, mm);
        load16_f32(a.dm, si, KIND_F16, dmn);
#pragma unroll
        for (int c = 0; c < 16; ++c) bb[c] = round_bias ? bf16r(-(mm[c] * dmn[c])) : -(mm[c] * dmn[c]);
    }
}

// Template (a): dequantize rows [k, k + TKC) (two whole groups), columns
// [n0, n0 + TN), into wt[n][k] (transposed).
template <int U, bool BIASDOT>
__device__ __forceinline__ void stage_w(const Args& a, int k, int n0,
                                        __nv_bfloat16 (*wt)[TKC + PAD]) {
    constexpr int HALF = GROUP / 2;
    for (int idx = threadIdx.x; idx < (TKC / 2) * (TN / 16); idx += THREADS) {
        const int br = idx / (TN / 16), c16 = (idx % (TN / 16)) * 16;
        const int kl = (br / HALF) * GROUP + br % HALF;          // row of the low nibble
        const uint4 qv = *reinterpret_cast<const uint4*>(
            a.q + static_cast<long>(k / 2 + br) * a.N + n0 + c16);
        const uint8_t* e = reinterpret_cast<const uint8_t*>(&qv);
        float s[16], bb[16];
        scales16(a, (k + kl) / GROUP, n0 + c16, s, bb, !BIASDOT, true);
#pragma unroll
        for (int c = 0; c < 16; ++c) {
            float lo, hi;
            unpack_byte<U>(e[c], lo, hi);
            float wl = bf16r(lo * s[c]), wh = bf16r(hi * s[c]);
            if (!BIASDOT) {
                wl = bf16r(wl + bb[c]);
                wh = bf16r(wh + bb[c]);
            }
            wt[c16 + c][kl] = __float2bfloat16_rn(wl);
            wt[c16 + c][kl + HALF] = __float2bfloat16_rn(wh);
        }
    }
}

// Template (b): the diagnostic weight of rows [k, k + TKC) of a k tile
// starting at row kt0, one row and sixteen columns per item.
template <int MODE>
__device__ __forceinline__ void stage_w_diag(const Args& a, int kt0, int k, int n0,
                                             __nv_bfloat16 (*wt)[TKC + PAD]) {
    const int half_tile = a.tile_k / 2;
    for (int idx = threadIdx.x; idx < TKC * (TN / 16); idx += THREADS) {
        const int r = idx / (TN / 16), c16 = (idx % (TN / 16)) * 16;
        const int j = k - kt0 + r;                       // row within the k tile
        long qrow;
        bool low = true, zero = false;
        if (MODE == NOSCALE) {
            const int i = j % GROUP;
            qrow = (kt0 + j - i) / 2 + i % (GROUP / 2);
            low = i < GROUP / 2;
        } else if (MODE == NOUNPACK || MODE == STOREONLY) {
            qrow = kt0 / 2 + j % half_tile;
            zero = MODE == STOREONLY && j >= half_tile;
        } else {
            qrow = kt0 / 2 + j % half_tile;
            low = j < half_tile;
        }
        uint4 qv = make_uint4(0, 0, 0, 0);
        if (!zero) qv = *reinterpret_cast<const uint4*>(a.q + qrow * a.N + n0 + c16);
        const uint8_t* e = reinterpret_cast<const uint8_t*>(&qv);
        float s[16], bb[16];
        if (MODE == SPLITSTORE || MODE == SPLITSTORE_BIAS)
            scales16(a, (kt0 + j) / GROUP, n0 + c16, s, bb, MODE == SPLITSTORE_BIAS, true);
#pragma unroll
        for (int c = 0; c < 16; ++c) {
            float w;
            if (MODE == NOUNPACK || MODE == STOREONLY) {
                w = static_cast<float>(e[c]);
            } else {
                const int qi = e[c];
                w = static_cast<float>(low ? (qi & 0xF) : (qi >> 4));
                if (MODE != NOSCALE) w = bf16r(w * s[c]);
                if (MODE == SPLITSTORE_BIAS) w = bf16r(w + bb[c]);
            }
            wt[c16 + c][r] = __float2bfloat16_rn(w);
        }
    }
}

// acc[mt][nt] += xs[16 mt.., :] @ wt[warp's 16 columns, :]^T over one chunk.
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16 (*xs)[TKC + PAD],
                                          const __nv_bfloat16 (*wt)[TKC + PAD], int n_mt,
                                          float (*acc)[2][4]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int ks = 0; ks < TKC / 16; ++ks) {
        const int kk = ks * 16 + tig * 2;
        uint32_t bfrag[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            const int nn = warp * 16 + nt * 8 + gid;
            bfrag[nt][0] = *reinterpret_cast<const uint32_t*>(&wt[nn][kk]);
            bfrag[nt][1] = *reinterpret_cast<const uint32_t*>(&wt[nn][kk + 8]);
        }
#pragma unroll
        for (int mt = 0; mt < MT_MAX; ++mt) {
            if (mt >= n_mt) break;
            const int r = mt * 16 + gid;
            uint32_t afrag[4];
            afrag[0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk]);
            afrag[1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk]);
            afrag[2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 8]);
            afrag[3] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 8]);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) mma_bf16_16816(acc[mt][nt], afrag, bfrag[nt]);
        }
    }
}

// The k tile's [M, 64] product (plus its affine term) into a.out.
__device__ __forceinline__ void store_tile(const Args& a, int n0, int n_mt,
                                           const float (*acc)[2][4]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    float* dst = a.out + static_cast<long>(blockIdx.y) * a.M * a.N;
#pragma unroll
    for (int mt = 0; mt < MT_MAX; ++mt) {
        if (mt >= n_mt) break;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = mt * 16 + gid + (e >= 2 ? 8 : 0);
                const int n = n0 + warp * 16 + nt * 8 + tig * 2 + (e & 1);
                if (r < a.M) dst[static_cast<long>(r) * a.N + n] = acc[mt][nt][e];
            }
    }
}

// grid (N / TN, K / tile_k): block (x, y) owns 64 columns of k tile y.
template <int MODE, bool DIAG, bool BIASDOT>
__global__ void __launch_bounds__(THREADS)
qmm_unpack_kernel(Args a) {
    __shared__ __align__(16) __nv_bfloat16 xs[MT_MAX * 16][TKC + PAD];
    __shared__ __align__(16) __nv_bfloat16 wt[TN][TKC + PAD];
    const int n0 = blockIdx.x * TN, kt0 = blockIdx.y * a.tile_k;
    const int n_mt = (a.M + 15) / 16;
    float acc[MT_MAX][2][4];
#pragma unroll
    for (int i = 0; i < MT_MAX; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int k = kt0; k < kt0 + a.tile_k; k += TKC) {
        stage_x(a, n_mt * 16, k, xs);
        if constexpr (DIAG)
            stage_w_diag<MODE>(a, kt0, k, n0, wt);
        else
            stage_w<MODE, BIASDOT>(a, k, n0, wt);
        __syncthreads();
        mma_chunk(xs, wt, n_mt, acc);
        __syncthreads();
    }
    if constexpr (BIASDOT) {
        // part += xs[tile groups, :]^T @ -(m * dmin)[tile groups, :], in f32,
        // after the tile's product (the Pallas body adds the two dots)
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int gid = lane >> 2, tig = lane & 3;
        float bacc[MT_MAX][2][4];
#pragma unroll
        for (int i = 0; i < MT_MAX; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) bacc[i][j][e] = 0.f;
        for (int g = kt0 / GROUP; g < (kt0 + a.tile_k) / GROUP; ++g) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = n0 + warp * 16 + nt * 8 + tig * 2 + e;
                    const long gi = static_cast<long>(g) * a.N + n;
                    const float bb = -(static_cast<float>(a.m[gi])
                                       * __half2float(a.dm[static_cast<long>(g / SB) * a.N + n]));
#pragma unroll
                    for (int mt = 0; mt < MT_MAX; ++mt) {
                        if (mt >= n_mt) break;
                        const int r0 = mt * 16 + gid, r1 = r0 + 8;
                        const float x0 = r0 < a.M ? a.xs[static_cast<long>(g) * a.M + r0] : 0.f;
                        const float x1 = r1 < a.M ? a.xs[static_cast<long>(g) * a.M + r1] : 0.f;
                        bacc[mt][nt][e] = fmaf(x0, bb, bacc[mt][nt][e]);
                        bacc[mt][nt][2 + e] = fmaf(x1, bb, bacc[mt][nt][2 + e]);
                    }
                }
        }
#pragma unroll
        for (int i = 0; i < MT_MAX; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] += bacc[i][j][e];
    }
    store_tile(a, n0, n_mt, acc);
}

int check_args(const Args& a) {
    if (a.M < 1 || a.M > MT_MAX * 16 || a.tile_k <= 0 || a.tile_k % (GROUP * SB) ||
        a.K % a.tile_k || a.N % TN)
        return static_cast<int>(cudaErrorInvalidValue);
    return 0;
}

template <int MODE, bool DIAG, bool BIASDOT>
int launch(Args a, float* part, float* y, cudaStream_t st) {
    const int n_kt = a.K / a.tile_k;
    a.out = n_kt == 1 ? y : part;
    qmm_unpack_kernel<MODE, DIAG, BIASDOT><<<dim3(a.N / TN, n_kt), THREADS, 0, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_kt == 1) return static_cast<int>(err);
    const long MN = static_cast<long>(a.M) * a.N;
    reduce_splits_kernel<<<static_cast<unsigned>((MN + 255) / 256), 256, 0, st>>>(
        part, nullptr, y, MN, a.N, n_kt);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Template (a).  x f32 [M, K]; xs f32 [K/32, M] (read only with biasdot);
// q uint8 [K/2, N]; sc, m int8 [K/32, N]; d, dm f16 [K/256, N]; part f32
// [K/tile_k, M, N] scratch (unused when K == tile_k); y f32 [M, N].
// unpack 0-3 = v0-v3.  Requires 1 <= M <= 64, tile_k a multiple of 256
// dividing K, N % 64 == 0, 16-byte aligned rows.
CL_EXPORT int qmm_unpack_launch(const float* x, const float* xs, const uint8_t* q,
                                const int8_t* sc, const int8_t* m, const __half* d,
                                const __half* dm, float* part, float* y, int M, int K, int N,
                                int tile_k, int unpack, int biasdot, void* stream) {
    Args a{x, xs, q, sc, m, d, dm, nullptr, M, K, N, tile_k};
    if (int rc = check_args(a)) return rc;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (unpack * 2 + (biasdot ? 1 : 0)) {
        case 0: return launch<0, false, false>(a, part, y, st);
        case 1: return launch<0, false, true>(a, part, y, st);
        case 2: return launch<1, false, false>(a, part, y, st);
        case 3: return launch<1, false, true>(a, part, y, st);
        case 4: return launch<2, false, false>(a, part, y, st);
        case 5: return launch<2, false, true>(a, part, y, st);
        case 6: return launch<3, false, false>(a, part, y, st);
        case 7: return launch<3, false, true>(a, part, y, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Template (b): the diagnostic mode 0-4 (noscale, nounpack, storeonly,
// splitstore, splitstore_bias); arrays and limits as above, no xs.
CL_EXPORT int qmm_unpack_diag_launch(const float* x, const uint8_t* q, const int8_t* sc,
                                     const int8_t* m, const __half* d, const __half* dm,
                                     float* part, float* y, int M, int K, int N, int tile_k,
                                     int mode, void* stream) {
    Args a{x, nullptr, q, sc, m, d, dm, nullptr, M, K, N, tile_k};
    if (int rc = check_args(a)) return rc;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case NOSCALE: return launch<NOSCALE, true, false>(a, part, y, st);
        case NOUNPACK: return launch<NOUNPACK, true, false>(a, part, y, st);
        case STOREONLY: return launch<STOREONLY, true, false>(a, part, y, st);
        case SPLITSTORE: return launch<SPLITSTORE, true, false>(a, part, y, st);
        case SPLITSTORE_BIAS: return launch<SPLITSTORE_BIAS, true, false>(a, part, y, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
