// E4: K1's superblock q4_k GEMV body with four ways to unpack the nibbles.
//
//   out[r, n] = sum_g s_g[n] * (p[g, r, n] + p[g, r + 8, n])
//               - (r == 0) * sum_g m[g, n] * dmin[g/8, n] * (sum of x over group g)
//   p[g, j, n] = lo * x[32 g + j] + hi * x[32 g + 16 + j]   (j < 16)
//   with lo, hi the low and high nibble of q[16 g + j, n],
//   s_g = sc[g, n] * d[g/8, n], f32 arithmetic, out f32 [8, N].
//
// The modes compute lo and hi (and p) differently:
//   v0: lo = b & 15, hi = (b >> 4) & 15           (the production chain)
//   v1: lo = b & 15, hi = b >> 4                   (no mask after the shift)
//   v2: qf = f32(b), hi = floor(qf / 16), lo = qf - 16 hi   (one conversion)
//   v3: v2's lo and hi, p = qf * (x_hi / 16) + lo * (x_lo - x_hi / 16)
//       (one multiply fewer per byte; rounds differently)
//
// Replaces experiments/gemv_unpack.py::make_kernel (the body of the
// pallas_calls in `bench` and `check`).  The Pallas kernel walks K as a
// sequential grid dimension into an [8, tile_n] accumulator in scratch
// memory and subtracts the min term from row 0 at each step; here blocks
// split K, each writes its [8, N] partial, and a second pass adds the
// splits in order, so results repeat bit for bit.
//
// Bound on the H100: bytes (q, sc, m, d and dmin read once: 0.5625 + ~0.006
// byte per weight).  About eight f32 operations per weight (two per nibble
// and their sums) is far below the 67 TFLOP/s f32 rate at 3.35 TB/s.
//
// Design: a lane owns 4 consecutive columns (one 4-byte load of q per row,
// so a warp reads 128 contiguous bytes), a block is 8 warps over 128
// columns, and warp w takes every 8th group of the block's split of K,
// keeping an [8, 4] accumulator and the min term in registers.  The warps'
// partials meet in shared memory and are added in warp order.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QC = 4;                    // columns per lane
constexpr int TILE_N = 32 * QC;          // columns per block
constexpr int GROUP = 32;
constexpr int HALF = GROUP / 2;
constexpr int SB = 8;                    // groups per superblock

template <int MODE>
__device__ __forceinline__ float nibble_mac(uint32_t b, float xl, float xh) {
    if (MODE == 0) {
        return static_cast<float>(b & 15u) * xl + static_cast<float>((b >> 4) & 15u) * xh;
    } else if (MODE == 1) {
        return static_cast<float>(b & 15u) * xl + static_cast<float>(b >> 4) * xh;
    } else {
        const float qf = static_cast<float>(b);
        const float hi = floorf(qf * 0.0625f);
        const float lo = qf - hi * 16.f;
        if (MODE == 2) return lo * xl + hi * xh;
        const float xh16 = xh * 0.0625f;
        return qf * xh16 + lo * (xl - xh16);
    }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
unpack_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
                   const int8_t* __restrict__ sc, const int8_t* __restrict__ m,
                   const __half* __restrict__ d, const __half* __restrict__ dm,
                   float* __restrict__ out, int K, int N, int n_splits) {
    __shared__ float red[WARPS][8][TILE_N];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n = blockIdx.x * TILE_N + lane * QC;
    const int n_g = K / GROUP;
    const int g0 = static_cast<int>(static_cast<long>(blockIdx.y) * n_g / n_splits);
    const int g1 = static_cast<int>(static_cast<long>(blockIdx.y + 1) * n_g / n_splits);
    float acc[8][QC], bacc[QC];
#pragma unroll
    for (int c = 0; c < QC; ++c) {
        bacc[c] = 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r][c] = 0.f;
    }
    if (n < N) {
        for (int g = g0 + warp; g < g1; g += WARPS) {
            float xg[GROUP];
            const float4* xp = reinterpret_cast<const float4*>(x + static_cast<long>(g) * GROUP);
#pragma unroll
            for (int i = 0; i < GROUP / 4; ++i) {
                const float4 v = __ldg(xp + i);
                xg[4 * i] = v.x; xg[4 * i + 1] = v.y; xg[4 * i + 2] = v.z; xg[4 * i + 3] = v.w;
            }
            float xsum = 0.f;
#pragma unroll
            for (int i = 0; i < GROUP; ++i) xsum += xg[i];
            const long gi = static_cast<long>(g) * N + n;
            const long si = static_cast<long>(g / SB) * N + n;
            const uint32_t scw = __ldg(reinterpret_cast<const uint32_t*>(sc + gi));
            const uint32_t mw = __ldg(reinterpret_cast<const uint32_t*>(m + gi));
            const uint2 dw = __ldg(reinterpret_cast<const uint2*>(d + si));
            const uint2 dmw = __ldg(reinterpret_cast<const uint2*>(dm + si));
            const uint32_t dd[2] = {dw.x, dw.y}, ddm[2] = {dmw.x, dmw.y};
            float s_eff[QC];
#pragma unroll
            for (int c = 0; c < QC; ++c) {
                const float dc = __half2float(__ushort_as_half(
                    static_cast<unsigned short>(dd[c / 2] >> (16 * (c % 2)))));
                const float dmc = __half2float(__ushort_as_half(
                    static_cast<unsigned short>(ddm[c / 2] >> (16 * (c % 2)))));
                s_eff[c] = static_cast<float>(static_cast<int8_t>(scw >> (8 * c))) * dc;
                bacc[c] += static_cast<float>(static_cast<int8_t>(mw >> (8 * c))) * dmc * xsum;
            }
            const uint8_t* qb = q + static_cast<long>(g) * HALF * N + n;
            uint32_t w[HALF];
#pragma unroll
            for (int j = 0; j < HALF; ++j)
                w[j] = __ldg(reinterpret_cast<const uint32_t*>(qb + static_cast<long>(j) * N));
#pragma unroll
            for (int r = 0; r < 8; ++r) {
#pragma unroll
                for (int c = 0; c < QC; ++c) {
                    const float t =
                        nibble_mac<MODE>((w[r] >> (8 * c)) & 0xFFu, xg[r], xg[HALF + r])
                        + nibble_mac<MODE>((w[r + 8] >> (8 * c)) & 0xFFu, xg[r + 8],
                                           xg[HALF + r + 8]);
                    acc[r][c] += t * s_eff[c];
                }
            }
        }
    }
#pragma unroll
    for (int c = 0; c < QC; ++c) {
        red[warp][0][lane * QC + c] = acc[0][c] - bacc[c];
#pragma unroll
        for (int r = 1; r < 8; ++r) red[warp][r][lane * QC + c] = acc[r][c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 8 * TILE_N; i += THREADS) {
        const int r = i / TILE_N, c = i % TILE_N;
        const int col = blockIdx.x * TILE_N + c;
        if (col >= N) continue;
        float v = red[0][r][c];
#pragma unroll
        for (int wv = 1; wv < WARPS; ++wv) v += red[wv][r][c];
        out[(static_cast<long>(blockIdx.y) * 8 + r) * N + col] = v;
    }
}

}  // namespace

// x: f32 [K]; q: uint8 [K/2, N]; sc, m: int8 [K/32, N]; d, dm: f16
// [K/256, N]; part: f32 [n_splits, 8, N] scratch (unused when n_splits ==
// 1); out: f32 [8, N].  Requires K % 256 == 0, N % 16 == 0, 16-byte
// aligned arrays.  mode 0..3 = v0..v3.
CL_EXPORT int unpack_gemv_launch(const void* x, const void* q, const void* sc, const void* m,
                                 const void* d, const void* dm, void* part, void* out, int K,
                                 int N, int mode, int n_splits, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (K % (GROUP * SB) || N % 16 || n_splits < 1 || mode < 0 || mode > 3)
        return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((N + TILE_N - 1) / TILE_N, n_splits);
    using Kernel = void (*)(const float*, const uint8_t*, const int8_t*, const int8_t*,
                            const __half*, const __half*, float*, int, int, int);
    const Kernel kernels[4] = {unpack_gemv_kernel<0>, unpack_gemv_kernel<1>,
                               unpack_gemv_kernel<2>, unpack_gemv_kernel<3>};
    kernels[mode]<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(q),
        static_cast<const int8_t*>(sc), static_cast<const int8_t*>(m),
        static_cast<const __half*>(d), static_cast<const __half*>(dm),
        static_cast<float*>(n_splits == 1 ? out : part), K, N, n_splits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
    const long mn = 8L * N;
    reduce_splits_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(part), nullptr, static_cast<float*>(out), mn, N, n_splits);
    return static_cast<int>(cudaGetLastError());
}
