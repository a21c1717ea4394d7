// E5: a copy-only pass over K2's weight tiles: every byte of a uint8
// [R, N] array is read once and nothing is computed from it but a sum.
//
//   out[tn, tk] = f32(sum of the bytes of tile (tk, tn)) + c[0]
//   (tiles of tile_k rows by tile_n columns; out is [N / tile_n, R / tile_k])
//
// Replaces experiments/qmm_m32.py::_dma_kernel (the body of bench_dma's
// pallas_call).  The Pallas kernel writes the same scalar output at every
// grid step, so its result is the last tile's sum; this kernel keeps every
// tile's sum, so that every load is live, and the caller reads the last.
//
// Bound on the H100: bytes.  One integer add per byte (a dp4a sums four).
//
// Design: a tile is split between SUB blocks of tile_k / SUB rows each, so
// that the grid fills the card (the original's 1024 x 512 tiles give only 56
// tiles over 4096 x 14336); a block reads its rows in 16-byte loads, sums
// them with dp4a, reduces by warp shuffles and adds its count to the tile's
// 64-bit total with an integer atomic (exact and order-free).  A second
// pass converts each total to f32 and adds c.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SUB = 8;

__device__ __forceinline__ unsigned sum_bytes16(const uint4& v, unsigned acc) {
    acc = __dp4a(v.x, 0x01010101u, acc);
    acc = __dp4a(v.y, 0x01010101u, acc);
    acc = __dp4a(v.z, 0x01010101u, acc);
    return __dp4a(v.w, 0x01010101u, acc);
}

// Block (tn, tk * SUB + part): rows [tk * tile_k + part * rows, + rows) of
// columns [tn * tile_n, + tile_n).
__global__ void __launch_bounds__(THREADS)
dma_sum_kernel(const uint8_t* __restrict__ q, unsigned long long* __restrict__ totals, int N,
               int tile_k, int tile_n) {
    const int tn = blockIdx.x, tk = blockIdx.y / SUB, part = blockIdx.y % SUB;
    const int rows = tile_k / SUB, vec_per_row = tile_n / 16;
    const long row0 = static_cast<long>(tk) * tile_k + static_cast<long>(part) * rows;
    const uint8_t* base = q + row0 * N + static_cast<long>(tn) * tile_n;
    unsigned acc = 0;
    const int n_vec = rows * vec_per_row;
    for (int i = threadIdx.x; i < n_vec; i += THREADS) {
        const int r = i / vec_per_row, v = i % vec_per_row;
        acc = sum_bytes16(__ldg(reinterpret_cast<const uint4*>(base + static_cast<long>(r) * N
                                                               + 16 * v)), acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL_MASK, acc, o);
    if ((threadIdx.x & 31) == 0)
        atomicAdd(totals + static_cast<long>(tn) * (gridDim.y / SUB) + tk,
                  static_cast<unsigned long long>(acc));
}

__global__ void dma_finish_kernel(const unsigned long long* __restrict__ totals,
                                  const float* __restrict__ c, float* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = __fadd_rn(__ull2float_rn(totals[i]), c[0]);
}

}  // namespace

// q: uint8 [R, N]; c: f32 [1]; totals: uint64 [N/tile_n, R/tile_k]
// scratch; out: f32 [N/tile_n, R/tile_k].  Requires tile_k % 8 == 0, R %
// tile_k == 0, tile_n % 16 == 0, N % tile_n == 0, N % 16 == 0, 16-byte
// aligned q.
CL_EXPORT int qmm_dma_launch(const void* q, const void* c, void* totals, void* out, int R,
                             int N, int tile_k, int tile_n, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tile_k <= 0 || tile_n <= 0 || tile_k % SUB || R % tile_k || tile_n % 16 || N % tile_n
        || N % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_tiles = (N / tile_n) * (R / tile_k);
    cudaError_t err = cudaMemsetAsync(totals, 0, sizeof(unsigned long long) * n_tiles, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(N / tile_n, (R / tile_k) * SUB);
    dma_sum_kernel<<<grid, THREADS, 0, st>>>(static_cast<const uint8_t*>(q),
                                            static_cast<unsigned long long*>(totals), N,
                                            tile_k, tile_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dma_finish_kernel<<<(n_tiles + 255) / 256, 256, 0, st>>>(
        static_cast<const unsigned long long*>(totals), static_cast<const float*>(c),
        static_cast<float*>(out), n_tiles);
    return static_cast<int>(cudaGetLastError());
}
