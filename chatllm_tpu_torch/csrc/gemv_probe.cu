// E2: two design probes over one int8 weight [K, N] that is far larger
// than the L2 cache, so every call streams it from device memory.
//
//   gemv_stream: out[r, n] = max(0, max over rows k with k % 8 == r of
//                w[k, n]) (int32 [8, N]; the Pallas kernel's accumulator
//                starts at 0): the cheapest use of every byte, a pure
//                stream with no unpacking and no arithmetic to speak of.
//   gemv_vpu:    y[n] = sum_g s[g, n] * sum_{k in group g} w[k, n] * x[k]
//                (groups of 32 rows; f32 x, s and accumulation): a GEMV on
//                the CUDA cores straight from the int8 bytes, no tensor
//                cores.
//
// Replaces experiments/gemv_probe2.py::stream_once (kernel `_stream_kernel`)
// and ::vpu_once (kernel `_vpu_kernel`).  The Pallas kernels walk K as a
// sequential grid dimension with an accumulator in scratch memory; here a
// block loops over its rows itself and blocks split K between them.
//
// Bound on the H100: bytes, for both.  gemv_vpu does 2 flops per weight
// byte, ~30x below where the f32 CUDA cores (67 TFLOP/s) would overtake
// device memory (3.35 TB/s); its int8 -> f32 conversions go through a byte
// permute and one subtraction (2^23 + u, minus 2^23 + 128) instead of the
// slower integer-to-float conversion.
//
// Design: a lane owns 16 consecutive columns and reads a row's 16 bytes in
// one load, so a warp reads 512 contiguous bytes; a block is 8 warps over
// 512 columns.  gemv_stream: warp r takes the rows of residue class r and
// keeps the running maximum packed, four int8 lanes per register
// (__vmaxs4), and hands it over through shared memory so that the warp
// writes consecutive columns; blocks that split K combine with atomicMax,
// which is order-independent.  gemv_vpu: warp r takes every 8th group;
// warps combine through shared memory in a fixed order and K splits through
// a second pass in split order, so results repeat bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 16;                 // columns per lane
constexpr int TILE_N = 32 * COLS;        // columns per block
constexpr int GROUP = 32;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS)
gemv_stream_kernel(const int8_t* __restrict__ w, int* __restrict__ out, int K, int N,
                   int n_splits) {
    const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
    const int n = blockIdx.x * TILE_N + lane * COLS;
    // rows k = r + 8 j, j in [j0, j1)
    const int n_j = K / 8;
    const int j0 = static_cast<int>(static_cast<long>(blockIdx.y) * n_j / n_splits);
    const int j1 = static_cast<int>(static_cast<long>(blockIdx.y + 1) * n_j / n_splits);
    uint4 m = make_uint4(0u, 0u, 0u, 0u);          // the accumulator starts at 0
    const int8_t* base = w + static_cast<long>(r) * N + n;
    int j = n < N ? j0 : j1;       // lanes past N load nothing
    for (; j + UNROLL <= j1; j += UNROLL) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            v[u] = __ldg(reinterpret_cast<const uint4*>(base + static_cast<long>(j + u) * 8 * N));
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            m.x = __vmaxs4(m.x, v[u].x);
            m.y = __vmaxs4(m.y, v[u].y);
            m.z = __vmaxs4(m.z, v[u].z);
            m.w = __vmaxs4(m.w, v[u].w);
        }
    }
    for (; j < j1; ++j) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(base + static_cast<long>(j) * 8 * N));
        m.x = __vmaxs4(m.x, v.x);
        m.y = __vmaxs4(m.y, v.y);
        m.z = __vmaxs4(m.z, v.z);
        m.w = __vmaxs4(m.w, v.w);
    }
    if (j0 >= j1) return;          // the whole block: j0, j1 depend on blockIdx only
    // through shared memory, so that a warp writes 32 consecutive columns
    __shared__ __align__(16) int8_t tile[WARPS][TILE_N];
    *reinterpret_cast<uint4*>(&tile[r][lane * COLS]) = m;
    __syncwarp();
    int* dst = out + static_cast<long>(r) * N + blockIdx.x * TILE_N;
    for (int c = lane; c < TILE_N && blockIdx.x * TILE_N + c < N; c += 32) {
        if (n_splits == 1)
            dst[c] = tile[r][c];
        else
            atomicMax(dst + c, static_cast<int>(tile[r][c]));
    }
}

// The four int8 lanes of `word` as f32, exactly: flip the sign bit (u = v +
// 128), place u in the low mantissa byte of 2^23 and subtract 2^23 + 128.
__device__ __forceinline__ void int8x4_to_f32(uint32_t word, float* out) {
    const uint32_t u = word ^ 0x80808080u;
    out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
    out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
    out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
    out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

__global__ void __launch_bounds__(THREADS)
gemv_vpu_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ s, float* __restrict__ out, int K, int N,
                int n_splits) {
    __shared__ float red[WARPS][TILE_N];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n = blockIdx.x * TILE_N + lane * COLS;
    const int n_g = K / GROUP;
    const int g0 = static_cast<int>(static_cast<long>(blockIdx.y) * n_g / n_splits);
    const int g1 = static_cast<int>(static_cast<long>(blockIdx.y + 1) * n_g / n_splits);
    float acc[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
    if (n < N) {
        for (int g = g0 + warp; g < g1; g += WARPS) {
            float t[COLS];
#pragma unroll
            for (int c = 0; c < COLS; ++c) t[c] = 0.f;
            const int8_t* base = w + static_cast<long>(g) * GROUP * N + n;
            for (int k0 = 0; k0 < GROUP; k0 += UNROLL) {
                uint4 v[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u)
                    v[u] = __ldg(reinterpret_cast<const uint4*>(base + static_cast<long>(k0 + u) * N));
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const float xk = __ldg(x + g * GROUP + k0 + u);
                    const uint32_t* words = reinterpret_cast<const uint32_t*>(&v[u]);
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        float f[4];
                        int8x4_to_f32(words[q], f);
#pragma unroll
                        for (int c = 0; c < 4; ++c) t[4 * q + c] = fmaf(f[c], xk, t[4 * q + c]);
                    }
                }
            }
            const float4* sp = reinterpret_cast<const float4*>(s + static_cast<long>(g) * N + n);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float4 sv = __ldg(sp + q);
                acc[4 * q + 0] = fmaf(t[4 * q + 0], sv.x, acc[4 * q + 0]);
                acc[4 * q + 1] = fmaf(t[4 * q + 1], sv.y, acc[4 * q + 1]);
                acc[4 * q + 2] = fmaf(t[4 * q + 2], sv.z, acc[4 * q + 2]);
                acc[4 * q + 3] = fmaf(t[4 * q + 3], sv.w, acc[4 * q + 3]);
            }
        }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) red[warp][lane * COLS + c] = acc[c];
    __syncthreads();
    for (int c = threadIdx.x; c < TILE_N; c += THREADS) {
        const int col = blockIdx.x * TILE_N + c;
        if (col >= N) continue;
        float v = 0.f;
#pragma unroll
        for (int wv = 0; wv < WARPS; ++wv) v += red[wv][c];
        out[static_cast<long>(blockIdx.y) * N + col] = v;
    }
}

}  // namespace

// w: int8 [K, N]; out: int32 [8, N].  Requires K % 8 == 0, N % 16 == 0,
// 16-byte aligned w.  With n_splits > 1 the output is first cleared and
// the blocks combine with atomicMax.
CL_EXPORT int gemv_stream_launch(const void* w, void* out, int K, int N, int n_splits,
                                 void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (K % 8 || N % COLS || n_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (n_splits > 1) {
        cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * 8 * static_cast<size_t>(N), st);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    dim3 grid((N + TILE_N - 1) / TILE_N, n_splits);
    gemv_stream_kernel<<<grid, THREADS, 0, st>>>(static_cast<const int8_t*>(w),
                                                 static_cast<int*>(out), K, N, n_splits);
    return static_cast<int>(cudaGetLastError());
}

// x: f32 [K]; w: int8 [K, N]; s: f32 [K/32, N]; part: f32 [n_splits, N]
// scratch (unused when n_splits == 1); y: f32 [N].  Requires K % 32 == 0,
// N % 16 == 0, 16-byte aligned w and s.
CL_EXPORT int gemv_vpu_launch(const void* x, const void* w, const void* s, void* part, void* y,
                              int K, int N, int n_splits, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (K % GROUP || N % COLS || n_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((N + TILE_N - 1) / TILE_N, n_splits);
    gemv_vpu_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(s),
        static_cast<float*>(n_splits == 1 ? y : part), K, N, n_splits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
    reduce_splits_kernel<<<(N + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(part), nullptr, static_cast<float*>(y), N, N, n_splits);
    return static_cast<int>(cudaGetLastError());
}
