// E3: the two kernels of the model-scale decode-GEMV bench, over the
// nibble-packed q4 layout (q uint8 [K/2, N], byte row j of group g holds
// rows 32 g + j (low nibble) and 32 g + 16 + j (high nibble); f16 scales
// s [K/32, N]).
//
//   stream_read: the access pattern of the q4 GEMV with almost no compute.
//     y[n] = sum_r sum_kt f32(q[kt * tile_k/2 + r, n]) * x[kt * tile_k]
//     (r < 8: the first 8 byte rows of every k-tile, each times the first
//     x of its tile; the 8 rows' sums added in order r = 0..7), and every
//     byte of q and s is loaded: digest[j] = XOR of every 32-bit word of q
//     and s that covers columns 4j..4j+3 (q's word j and s's words 2j, 2j+1
//     of every row), so that no load is dead.
//   qgemv_bf16: the q4 GEMV in bf16 arithmetic, rounded as
//     experiments/gemv_model_bench.py::_kernel_bf16 rounds: per k-tile and
//     group, p = lo * x_lo + hi * x_hi (each product and the sum rounded to
//     bf16, x rounded to bf16, no zero point), the 16 rows halved to 8
//     (t[r] = p[r] + p[r + 8]), times the f16 scale rounded to bf16, then
//     the tile's groups halved pairwise while their count is even (and any
//     odd rest added in order), all in bf16; tiles then add in f32 (kt in
//     order) and the 8 rows in f32 in order r = 0..7.
//
// Replaces experiments/gemv_model_bench.py::stream_read (kernel
// `_stream_kernel`) and ::qgemv_bf16 (kernel `_kernel_bf16`).  Both Pallas
// kernels walk K as a sequential grid dimension with an [8, tile_n]
// accumulator in scratch memory; here blocks split K and combine in a fixed
// order (qgemv_bf16) or order-free (the XOR digest), so results repeat bit
// for bit.
//
// Bound on the H100: bytes, for both (q and s, read once: 9/16 byte per
// weight).  stream_read does one XOR per 4 bytes.  qgemv_bf16 does about
// twelve f32 operations with explicit roundings per byte, still well under
// the 67 TFLOP/s f32 rate at 3.35 TB/s (~20 operations per byte).
//
// Design.  stream_read: a lane owns 16 consecutive columns (one 16-byte
// load of q per row, two of s per group), a block is 8 warps over 512
// columns, and warps take every 8th group of the block's split of K; the
// warps' digests meet in shared memory and one integer atomicXor per word
// and block combines the splits.  The blocks of split 0 also compute y:
// warp r reads byte row r of every tile for its lane's 16 columns.
// qgemv_bf16: a block owns 32 columns of one k-tile; thread t takes 16
// columns (t % 2) of groups t / 2, t / 2 + 64, ...; each thread rounds its
// group's products and halving into shared memory, the block halves the
// groups there, and a second pass adds tiles and rows in order.  Every
// bf16 operation is an f32 operation with the rounding mode fixed
// (__fmul_rn / __fadd_rn: no contraction into an FMA) and then rounded to
// bf16, which gives the correctly rounded bf16 result (f32 holds more than
// twice bf16's 8 bits, so the double rounding is harmless).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 16;                 // columns per lane
constexpr int TILE_N = 32 * COLS;        // columns per stream_read block
constexpr int GROUP = 32;
constexpr int HALF = GROUP / 2;          // byte rows per group

__global__ void __launch_bounds__(THREADS)
stream_read_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
                   const uint16_t* __restrict__ s, float* __restrict__ y,
                   unsigned* __restrict__ digest, int K, int N, int tile_k, int n_splits) {
    __shared__ unsigned red[WARPS][TILE_N / 4];
    __shared__ float val[8][TILE_N];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n = blockIdx.x * TILE_N + lane * COLS;
    const int n_g = K / GROUP;
    const int g0 = static_cast<int>(static_cast<long>(blockIdx.y) * n_g / n_splits);
    const int g1 = static_cast<int>(static_cast<long>(blockIdx.y + 1) * n_g / n_splits);
    uint4 dq = make_uint4(0u, 0u, 0u, 0u), ds0 = dq, ds1 = dq;
    if (n < N) {
        for (int g = g0 + warp; g < g1; g += WARPS) {
            const uint8_t* qb = q + static_cast<long>(g) * HALF * N + n;
            uint4 v[HALF];
#pragma unroll
            for (int j = 0; j < HALF; ++j)
                v[j] = __ldg(reinterpret_cast<const uint4*>(qb + static_cast<long>(j) * N));
            const uint4* sp = reinterpret_cast<const uint4*>(s + static_cast<long>(g) * N + n);
            const uint4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
#pragma unroll
            for (int j = 0; j < HALF; ++j) {
                dq.x ^= v[j].x; dq.y ^= v[j].y; dq.z ^= v[j].z; dq.w ^= v[j].w;
            }
            ds0.x ^= s0.x; ds0.y ^= s0.y; ds0.z ^= s0.z; ds0.w ^= s0.w;
            ds1.x ^= s1.x; ds1.y ^= s1.y; ds1.z ^= s1.z; ds1.w ^= s1.w;
        }
    }
    // word w of the lane's 16 columns: q word w, s words 2w and 2w + 1
    red[warp][lane * 4 + 0] = dq.x ^ ds0.x ^ ds0.y;
    red[warp][lane * 4 + 1] = dq.y ^ ds0.z ^ ds0.w;
    red[warp][lane * 4 + 2] = dq.z ^ ds1.x ^ ds1.y;
    red[warp][lane * 4 + 3] = dq.w ^ ds1.z ^ ds1.w;
    if (blockIdx.y == 0 && n < N) {
        // warp r: byte row r of every k-tile, times the tile's first x
        float acc[COLS];
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
        const int n_kt = K / tile_k;
        for (int kt = 0; kt < n_kt; ++kt) {
            const float xk = __ldg(x + static_cast<long>(kt) * tile_k);
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                q + (static_cast<long>(kt) * (tile_k / 2) + warp) * N + n));
            const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
            for (int c = 0; c < COLS; ++c)
                acc[c] = __fadd_rn(acc[c], __fmul_rn(static_cast<float>(b[c]), xk));
        }
#pragma unroll
        for (int c = 0; c < COLS; ++c) val[warp][lane * COLS + c] = acc[c];
    }
    __syncthreads();
    for (int w = threadIdx.x; w < TILE_N / 4; w += THREADS) {
        const int col = blockIdx.x * TILE_N + 4 * w;
        if (col >= N) continue;
        unsigned v = 0u;
#pragma unroll
        for (int r = 0; r < WARPS; ++r) v ^= red[r][w];
        atomicXor(digest + col / 4, v);
    }
    if (blockIdx.y != 0) return;
    for (int c = threadIdx.x; c < TILE_N; c += THREADS) {
        const int col = blockIdx.x * TILE_N + c;
        if (col >= N) continue;
        float v = val[0][c];
#pragma unroll
        for (int r = 1; r < 8; ++r) v = __fadd_rn(v, val[r][c]);
        y[col] = v;
    }
}

constexpr int BF_THREADS = 128;
constexpr int BF_TN = 32;                       // columns per block
constexpr int BF_SLOTS = BF_THREADS / 2;        // group slots per pass

__device__ __forceinline__ float rbf(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float mul_bf(float a, float b) { return rbf(__fmul_rn(a, b)); }
__device__ __forceinline__ float add_bf(float a, float b) { return rbf(__fadd_rn(a, b)); }

// One block: columns [32 bx, 32 bx + 32) of k-tile `by`.  part[kt, r, n]
// receives the tile's 8 bf16 rows as f32.
__global__ void __launch_bounds__(BF_THREADS)
qgemv_bf16_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
                  const uint16_t* __restrict__ s, float* __restrict__ part, int K, int N,
                  int tile_k) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int gs = tile_k / GROUP;
    float* xs = reinterpret_cast<float*>(smem);                                   // [tile_k]
    __nv_bfloat16* tv = reinterpret_cast<__nv_bfloat16*>(xs + tile_k);           // [gs][8][32]
    const int kt = blockIdx.y;
    const int n0 = blockIdx.x * BF_TN;
    for (int i = threadIdx.x; i < tile_k; i += BF_THREADS)
        xs[i] = rbf(__ldg(x + static_cast<long>(kt) * tile_k + i));
    __syncthreads();
    const int half = threadIdx.x & 1, slot = threadIdx.x >> 1;
    const int n = n0 + half * COLS;
    for (int g = slot; g < gs; g += BF_SLOTS) {
        const long grow = static_cast<long>(kt) * gs + g;            // global group
        const uint8_t* qb = q + grow * HALF * N + n;
        const uint4* sp = reinterpret_cast<const uint4*>(s + grow * N + n);
        const uint4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
        const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        float sc[COLS];          // the f16 scales rounded to bf16
#pragma unroll
        for (int c = 0; c < COLS; ++c)
            sc[c] = rbf(__half2float(__ushort_as_half(
                static_cast<unsigned short>(sw[c / 2] >> (16 * (c % 2))))));
        const float* xg = xs + g * GROUP;
#pragma unroll 2
        for (int r = 0; r < 8; ++r) {
            const uint4 va = __ldg(reinterpret_cast<const uint4*>(qb + static_cast<long>(r) * N));
            const uint4 vb = __ldg(reinterpret_cast<const uint4*>(qb + static_cast<long>(r + 8) * N));
            const uint8_t* ba = reinterpret_cast<const uint8_t*>(&va);
            const uint8_t* bb = reinterpret_cast<const uint8_t*>(&vb);
            const float xla = xg[r], xha = xg[HALF + r];
            const float xlb = xg[r + 8], xhb = xg[HALF + r + 8];
            __nv_bfloat16* dst = tv + (g * 8 + r) * BF_TN + half * COLS;
#pragma unroll
            for (int c = 0; c < COLS; ++c) {
                const float pa = add_bf(mul_bf(static_cast<float>(ba[c] & 15), xla),
                                        mul_bf(static_cast<float>(ba[c] >> 4), xha));
                const float pb = add_bf(mul_bf(static_cast<float>(bb[c] & 15), xlb),
                                        mul_bf(static_cast<float>(bb[c] >> 4), xhb));
                dst[c] = __float2bfloat16_rn(mul_bf(add_bf(pa, pb), sc[c]));
            }
        }
    }
    __syncthreads();
    int h = gs;
    while (h > 1 && h % 2 == 0) {
        const int hh = h / 2;
        for (int i = threadIdx.x; i < hh * 8 * BF_TN; i += BF_THREADS)
            tv[i] = __float2bfloat16_rn(add_bf(__bfloat162float(tv[i]),
                                               __bfloat162float(tv[i + hh * 8 * BF_TN])));
        __syncthreads();
        h = hh;
    }
    for (int i = threadIdx.x; i < 8 * BF_TN; i += BF_THREADS) {
        float v = __bfloat162float(tv[i]);
        for (int j = 1; j < h; ++j) v = add_bf(v, __bfloat162float(tv[j * 8 * BF_TN + i]));
        const int r = i / BF_TN, c = i % BF_TN;
        part[(static_cast<long>(kt) * 8 + r) * N + n0 + c] = v;
    }
}

// y[n] = sum_r (sum_kt part[kt, r, n]), kt and then r in order.
__global__ void qgemv_bf16_combine(const float* __restrict__ part, float* __restrict__ y,
                                   int N, int n_kt) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    float v = 0.f;
    for (int r = 0; r < 8; ++r) {
        float acc = 0.f;
        for (int kt = 0; kt < n_kt; ++kt)
            acc = __fadd_rn(acc, part[(static_cast<long>(kt) * 8 + r) * N + n]);
        v = r == 0 ? acc : __fadd_rn(v, acc);
    }
    y[n] = v;
}

}  // namespace

// x: f32 [K]; q: uint8 [K/2, N]; s: f16 bits [K/32, N]; y: f32 [N];
// digest: uint32 [N/4].  Requires N % 16 == 0, K % tile_k == 0, tile_k a
// multiple of 32, 16-byte aligned q and s.  The digest is cleared first.
CL_EXPORT int stream_read_launch(const void* x, const void* q, const void* s, void* y,
                                 void* digest, int K, int N, int tile_k, int n_splits,
                                 void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (N % COLS || tile_k % GROUP || tile_k <= 0 || K % tile_k || n_splits < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaMemsetAsync(digest, 0, sizeof(unsigned) * (N / 4), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + TILE_N - 1) / TILE_N, n_splits);
    stream_read_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(q),
        static_cast<const uint16_t*>(s), static_cast<float*>(y),
        static_cast<unsigned*>(digest), K, N, tile_k, n_splits);
    return static_cast<int>(cudaGetLastError());
}

// x: f32 [K]; q: uint8 [K/2, N]; s: f16 bits [K/32, N]; part: f32
// [K/tile_k, 8, N] scratch; y: f32 [N].  Requires N % 32 == 0, K % tile_k
// == 0, tile_k a multiple of 32 and at most 8192, 16-byte aligned q and s.
CL_EXPORT int qgemv_bf16_launch(const void* x, const void* q, const void* s, void* part,
                                void* y, int K, int N, int tile_k, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (N % BF_TN || tile_k % GROUP || tile_k <= 0 || tile_k > 8192 || K % tile_k)
        return static_cast<int>(cudaErrorInvalidValue);
    const int gs = tile_k / GROUP;
    const size_t smem = sizeof(float) * tile_k + sizeof(__nv_bfloat16) * gs * 8 * BF_TN;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            qgemv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int n_kt = K / tile_k;
    dim3 grid(N / BF_TN, n_kt);
    qgemv_bf16_kernel<<<grid, BF_THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(q),
        static_cast<const uint16_t*>(s), static_cast<float*>(part), K, N, tile_k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    qgemv_bf16_combine<<<(N + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part),
                                                        static_cast<float*>(y), N, n_kt);
    return static_cast<int>(cudaGetLastError());
}
