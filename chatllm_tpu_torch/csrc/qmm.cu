// K2: fused dequant x matmul for 1..64 rows (short prefill chunks, batched
// decode).
//
//   y[M, N] = x[M, K] @ dequant(W) (+ bias),  bf16 products, f32 accumulation
//
// Replaces chatllm_tpu/ops/pallas/qmm_kernel.py::qmm_pallas (body `_kernel`).
// Same numerics as the Pallas kernel: each weight is dequantized once to
// bf16 as bf16(q * bf16(s_eff)) (zero point subtracted first), multiplied
// with x rounded to bf16, and accumulated in f32; the affine term (k-quant
// -dmin*m, or the classic per-group b) is added in f32 as a dot of the
// per-group sums of x with b_eff, exactly like the Pallas wrapper's
// group-sum dot.  The bf16 weight never reaches device memory.
//
// Bound on the H100: at M <= 64 the work is 2*M*K*N flops against ~0.56
// byte per weight, i.e. at most ~230 flop/byte, below the ~295 flop/byte
// where bf16 tensor cores (989 TFLOP/s) overtake 3.35 TB/s: device-memory
// bytes of the quantized weight bound it.
//
// Design (second version; each numbered cause is one the first version had):
//  1. Loads overlap compute: a ring of up to 4 stages in shared memory, each
//     holding the raw packed weight, its scale rows and x for one 128-deep K
//     tile, filled by cp.async (16-byte copies, zero-filled past K and N)
//     and tracked by commit groups; the loads of tile k+3 are in flight
//     while tile k is dequantized and multiplied.  G, the packing, the type
//     of x and the row count (8/16/32/64) are template parameters, so the
//     tile walk has no run-time division.
//  2. Scale rows are copied once per tile and group (sc, m, d, dmin, or s
//     and b); each lane folds s_eff = bf16(d*sc)
//     (or bf16(s)) and b_eff = -dmin*m (or b) once per (group, column) into
//     registers.
//  3. No transposed shared-memory round trip: the operands are swapped, so
//     the dequantized weight is the mma A operand (output columns are the
//     16-row dimension) and x^T the B operand (x rows are the 8-wide
//     dimension, so an 8-row step is not padded to 16; ldmatrix loads it).
//     A lane reads one 32-bit word (4 columns) of a raw byte row and unpacks
//     it straight into A fragments: nibbles become bf16 by OR-ing them into
//     the mantissa of 128.0 (exact), then one bf16 subtract of 128 + zero
//     point (exact) and one bf16 multiply by bf16(s_eff), which rounds
//     q * bf16(s_eff) once, as the Pallas kernel's f32 product rounded to
//     bf16 does (q has at most 8 significant bits, so the product is exact
//     before rounding).  The K order inside each 16-deep mma step is
//     permuted so that a byte row's low and high nibbles feed the same step.
//  4. The affine coefficients come from the tile's scale rows in shared
//     memory; the group sums of x are taken once per tile, in x's own
//     precision, into shared memory.
//  5. A block owns 128 columns (twice the first version's 64), or 256 above
//     16 rows when N is wide (ops/cuda/qmm_kernel.py::qmm_tile_n), so x is
//     read once per 128 or 256 columns; x arrives with the weight tile and
//     is rounded to bf16 as it is loaded into fragments.
//  6. Split-K runs over a thread-block cluster of up to 8 blocks along K:
//     each block leaves its partial tile in shared memory and the cluster
//     sums them through distributed shared memory in a fixed order (no
//     atomics, no scratch in device memory, one launch per call).
// 8 warps, each owning 32 columns: at 128 columns two warps share a column
// range and take half of each tile's eight 16-deep steps each (summed at the
// end); at 256 columns each warp takes all eight.
// Shared memory is sized for two blocks per SM where the stages fit.
// Like the JAX package's `matmul`, the kernel computes in bf16 only.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TK = 128;               // K rows per pipeline stage
constexpr int THREADS = 256;
constexpr int SMEM_BUDGET = 110 * 1024;   // two blocks per SM where the stages fit

struct Args {
    const void* x;
    const uint8_t* q;
    const void* s;      // classic f16/f32 scales; superblock int8 sc
    const void* b;      // classic f16/f32 b; superblock int8 m; or null
    const __half* d;    // superblock f16 d
    const __half* dm;   // superblock f16 dmin
    const float* bias;
    float* y;
    int M, K, N, sb, zero_point, s_kind;
};

template <int MT8, int G, bool PACKED, bool XBF16, int TN_>
struct Geom {
    static constexpr int TN = TN_;                       // columns per block: 128 or 256
    static constexpr int WN = TN / 32;                   // warps along N (32 columns each)
    static constexpr int WK = 8 / WN;                    // warps along a tile's K steps
    static constexpr int QSTRIDE = TN + 16;              // bytes per byte row (bank-conflict pad)
    static constexpr int SCL_GROUP = 2 * TN * 4;         // shared bytes per group of scale rows
    static constexpr int ROWS = MT8 * 8;                 // x rows held (zero past M)
    static constexpr int ESZ = XBF16 ? 2 : 4;
    static constexpr int XSTRIDE = TK * ESZ + 16;
    static constexpr int QROWS = PACKED ? TK / 2 : TK;
    static constexpr int QBYTES = QROWS * QSTRIDE;
    static constexpr int XBYTES = ROWS * XSTRIDE;
    static constexpr int NG = TK / G;                    // groups per tile
    static constexpr int STAGE = QBYTES + XBYTES + NG * SCL_GROUP;
    static constexpr int XSUM = NG * ROWS * 4;           // group sums of x of the current tile
    static constexpr int FIT = (SMEM_BUDGET - XSUM) / STAGE;
    static constexpr int STAGES = FIT >= 4 ? 4 : (FIT >= 2 ? FIT : 2);
    static constexpr int PIPE = STAGES * STAGE + XSUM;
    static constexpr int RED = WK * ROWS * TN * 4;       // the K parts' [rows, TN] f32
    static constexpr int SMEM = PIPE > RED ? PIPE : RED;
    static constexpr int STEPS = TK / 16 / WK;           // 16-deep mma steps per warp per tile
    static_assert(SMEM <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ void cp16(void* smem, const void* gmem, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// One 16-byte chunk c of row `row` of an [rows, N] array of ESZ-byte
// elements, columns from n0, into dst + 16 c; zero-filled when invalid.
template <int ESZ>
__device__ __forceinline__ void cp_row_chunk(uint8_t* dst, const void* arr, long row, int N,
                                             int n0, int c, bool row_valid) {
    const int n = n0 + c * (16 / ESZ);
    const bool v = row_valid && n < N;
    const char* src = v ? static_cast<const char*>(arr) + (row * N + n) * ESZ
                        : static_cast<const char*>(arr);
    cp16(dst + c * 16, src, v);
}

// Issue the copies of K tile kt: weight byte rows, x rows, scale rows.
template <int MT8, int G, bool PACKED, bool XBF16, int TN>
__device__ __forceinline__ void load_tile(uint8_t* st, const Args& a, int kt, int n0) {
    using Gm = Geom<MT8, G, PACKED, XBF16, TN>;
    const int tid = threadIdx.x;
    const int qrows = PACKED ? a.K / 2 : a.K;
    const int qr0 = kt * Gm::QROWS;
#pragma unroll
    for (int i = tid; i < Gm::QROWS * (Gm::TN / 16); i += THREADS) {
        const int r = i / (Gm::TN / 16), c = i % (Gm::TN / 16);
        cp_row_chunk<1>(st + r * Gm::QSTRIDE, a.q, qr0 + r, a.N, n0, c, qr0 + r < qrows);
    }
    uint8_t* xs = st + Gm::QBYTES;
    constexpr int XCH = TK * Gm::ESZ / 16;           // 16-byte chunks per x row
    const int k0 = kt * TK;
#pragma unroll
    for (int i = tid; i < Gm::ROWS * XCH; i += THREADS) {
        const int r = i / XCH, c = i % XCH;
        const int kk = k0 + c * (16 / Gm::ESZ);
        const bool v = r < a.M && kk < a.K;
        const char* src = v ? static_cast<const char*>(a.x) + (static_cast<long>(r) * a.K + kk) * Gm::ESZ
                            : static_cast<const char*>(a.x);
        cp16(xs + r * Gm::XSTRIDE + c * 16, src, v);
    }
    uint8_t* ss = xs + Gm::XBYTES;
    const int g0 = k0 / G, ng = a.K / G;
    if (a.sb) {
        // per group: sc [TN] i8 at 0, m [TN] i8 at TN, d [TN] f16 at 2TN, dm at 4TN
        constexpr int C1 = Gm::TN / 16, C2 = Gm::TN * 2 / 16;   // chunks of an i8 / f16 row
        constexpr int PER = 2 * C1 + 2 * C2;
        for (int i = tid; i < Gm::NG * PER; i += THREADS) {
            const int gl = i / PER, r = i % PER, g = g0 + gl;
            uint8_t* base = ss + gl * Gm::SCL_GROUP;
            if (r < C1) {
                cp_row_chunk<1>(base, a.s, g, a.N, n0, r, g < ng);
            } else if (r < 2 * C1) {
                if (a.b) cp_row_chunk<1>(base + Gm::TN, a.b, g, a.N, n0, r - C1, g < ng);
            } else if (r < 2 * C1 + C2) {
                cp_row_chunk<2>(base + 2 * Gm::TN, a.d, g / a.sb, a.N, n0, r - 2 * C1, g < ng);
            } else if (a.dm) {
                cp_row_chunk<2>(base + 4 * Gm::TN, a.dm, g / a.sb, a.N, n0, r - 2 * C1 - C2, g < ng);
            }
        }
    } else if (a.s_kind == KIND_F32) {
        // per group: s [TN] at 0, b [TN] at 4TN bytes
        constexpr int CH = Gm::TN * 4 / 16;
        for (int i = tid; i < Gm::NG * 2 * CH; i += THREADS) {
            const int gl = i / (2 * CH), r = i % (2 * CH), g = g0 + gl;
            uint8_t* base = ss + gl * Gm::SCL_GROUP;
            if (r < CH) cp_row_chunk<4>(base, a.s, g, a.N, n0, r, g < ng);
            else if (a.b) cp_row_chunk<4>(base + Gm::TN * 4, a.b, g, a.N, n0, r - CH, g < ng);
        }
    } else {
        constexpr int CH = Gm::TN * 2 / 16;
        for (int i = tid; i < Gm::NG * 2 * CH; i += THREADS) {
            const int gl = i / (2 * CH), r = i % (2 * CH), g = g0 + gl;
            uint8_t* base = ss + gl * Gm::SCL_GROUP;
            if (r < CH) cp_row_chunk<2>(base, a.s, g, a.N, n0, r, g < ng);
            else if (a.b) cp_row_chunk<2>(base + Gm::TN * 4, a.b, g, a.N, n0, r - CH, g < ng);
        }
    }
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t u) {
    return *reinterpret_cast<__nv_bfloat162*>(&u);
}

template <int MT8, int G, bool PACKED, bool XBF16, int TN>
__global__ void __launch_bounds__(THREADS, 2) qmm_kernel(const Args a) {
    using Gm = Geom<MT8, G, PACKED, XBF16, TN>;
    extern __shared__ __align__(16) uint8_t smem[];
    cg::cluster_group cluster = cg::this_cluster();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, t = lane & 3;
    const int wn = warp % Gm::WN, h = warp / Gm::WN;
    const int n0 = blockIdx.x * Gm::TN;
    const int cl = wn * 32 + gid * 4;              // this lane's 4 columns in the tile
    const int n_kt = (a.K + TK - 1) / TK;
    const int splits = gridDim.y;
    const int kt0 = static_cast<int>(static_cast<long>(blockIdx.y) * n_kt / splits);
    const int kt1 = static_cast<int>(static_cast<long>(blockIdx.y + 1) * n_kt / splits);
    const int nt = kt1 - kt0;
    const bool has_b = a.b != nullptr;
    float* xsum_s = reinterpret_cast<float*>(smem + Gm::STAGES * Gm::STAGE);   // [NG][ROWS]

    float acc[2][MT8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < MT8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const __nv_bfloat162 z2 = __float2bfloat162_rn(128.f + static_cast<float>(a.zero_point));
    const float zp = static_cast<float>(a.zero_point);

#pragma unroll
    for (int s = 0; s < Gm::STAGES - 1; ++s) {
        if (s < nt) load_tile<MT8, G, PACKED, XBF16, TN>(smem + s * Gm::STAGE, a, kt0 + s, n0);
        cp_commit();
    }

    for (int it = 0; it < nt; ++it) {
        cp_wait<Gm::STAGES - 2>();
        __syncthreads();
        const int nx = it + Gm::STAGES - 1;
        if (nx < nt) load_tile<MT8, G, PACKED, XBF16, TN>(smem + (nx % Gm::STAGES) * Gm::STAGE, a, kt0 + nx, n0);
        cp_commit();

        const uint8_t* qs = smem + (it % Gm::STAGES) * Gm::STAGE;
        const uint8_t* xs = qs + Gm::QBYTES;
        const uint8_t* ss = xs + Gm::XBYTES;
        if (has_b) {
            // group sums of x (its own precision, in f32), once per tile
            for (int i = threadIdx.x; i < Gm::NG * Gm::ROWS; i += THREADS) {
                const int gl = i / Gm::ROWS, r = i % Gm::ROWS;
                const uint8_t* src = xs + r * Gm::XSTRIDE + gl * G * Gm::ESZ;
                float sum = 0.f;
#pragma unroll
                for (int c = 0; c < G * Gm::ESZ / 16; ++c) {
                    const uint4 u = *reinterpret_cast<const uint4*>(src + 16 * c);
                    if (XBF16) {
                        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
                        for (int p = 0; p < 4; ++p) {
                            const float2 f = __bfloat1622float2(e[p]);
                            sum += f.x;
                            sum += f.y;
                        }
                    } else {
                        const float* e = reinterpret_cast<const float*>(&u);
#pragma unroll
                        for (int p = 0; p < 4; ++p) sum += e[p];
                    }
                }
                xsum_s[i] = sum;
            }
            __syncthreads();
        }

        __nv_bfloat162 s2[4];
        float beff[4];
#pragma unroll
        for (int si = 0; si < Gm::STEPS; ++si) {
            const int i = h * Gm::STEPS + si;      // 16-deep step of the tile
            int gl, k0b, k1b;                      // group; first k of b[0] and of b[1]
            if (PACKED) {
                gl = (i * 8) / (G / 2);
                k0b = gl * G + (i * 8) % (G / 2);
                k1b = k0b + G / 2;
            } else {
                gl = (i * 16) / G;
                k0b = i * 16;
                k1b = k0b + 8;
            }
            if ((i * 16) % G == 0) {               // first step of a group: fold its scales
                const uint8_t* base = ss + gl * Gm::SCL_GROUP;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    float se, be = 0.f;
                    if (a.sb) {
                        const float dd = __half2float(reinterpret_cast<const __half*>(base + 2 * Gm::TN)[cl + c]);
                        se = static_cast<float>(reinterpret_cast<const int8_t*>(base)[cl + c]) * dd;
                        if (has_b)
                            be = -(static_cast<float>(reinterpret_cast<const int8_t*>(base + Gm::TN)[cl + c])
                                   * __half2float(reinterpret_cast<const __half*>(base + 4 * Gm::TN)[cl + c]));
                    } else if (a.s_kind == KIND_F32) {
                        se = reinterpret_cast<const float*>(base)[cl + c];
                        if (has_b) be = reinterpret_cast<const float*>(base + Gm::TN * 4)[cl + c];
                    } else {
                        se = __half2float(reinterpret_cast<const __half*>(base)[cl + c]);
                        if (has_b) be = __half2float(reinterpret_cast<const __half*>(base + Gm::TN * 4)[cl + c]);
                    }
                    s2[c] = __float2bfloat162_rn(se);
                    beff[c] = be;
                }
            }
            // A fragments of the two 16-column mma tiles: column c of this
            // lane's four is row (c & 1 ? gid + 8 : gid) of tile c >> 1.
            uint32_t af[2][4];
            if (PACKED) {
                const int br = i * 8 + 2 * t;
                const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qs + br * Gm::QSTRIDE + cl);
                const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qs + (br + 1) * Gm::QSTRIDE + cl);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const uint32_t sel = c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12);
                    const uint32_t p = __byte_perm(w0, w1, sel);
                    const uint32_t lo = (p & 0x000F000Fu) | 0x43004300u;
                    const uint32_t hi = ((p >> 4) & 0x000F000Fu) | 0x43004300u;
                    af[c >> 1][c & 1] = bf2_bits(__hmul2(__hsub2(bits_bf2(lo), z2), s2[c]));
                    af[c >> 1][2 + (c & 1)] = bf2_bits(__hmul2(__hsub2(bits_bf2(hi), z2), s2[c]));
                }
            } else {
                const int kr = i * 16 + 2 * t;
                uint32_t w[4];
                w[0] = *reinterpret_cast<const uint32_t*>(qs + kr * Gm::QSTRIDE + cl);
                w[1] = *reinterpret_cast<const uint32_t*>(qs + (kr + 1) * Gm::QSTRIDE + cl);
                w[2] = *reinterpret_cast<const uint32_t*>(qs + (kr + 8) * Gm::QSTRIDE + cl);
                w[3] = *reinterpret_cast<const uint32_t*>(qs + (kr + 9) * Gm::QSTRIDE + cl);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const float sf = __low2float(s2[c]);
                    float v[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        v[r] = (static_cast<float>(static_cast<int8_t>(w[r] >> (8 * c))) - zp) * sf;
                    af[c >> 1][c & 1] = bf2_bits(__floats2bfloat162_rn(v[0], v[1]));
                    af[c >> 1][2 + (c & 1)] = bf2_bits(__floats2bfloat162_rn(v[2], v[3]));
                }
            }
            // B fragments (x^T): rows j*8.. of x at k0b + 2t and k1b + 2t
            uint32_t bf[MT8][2];
            if (XBF16) {
                const int mat = lane >> 3, rr = lane & 7;
                if (MT8 == 1) {
                    ldmatrix_x2(bf[0], xs + rr * Gm::XSTRIDE + ((mat & 1) ? k1b : k0b) * 2);
                } else {
#pragma unroll
                    for (int j = 0; j < MT8; j += 2) {
                        uint32_t r4[4];
                        ldmatrix_x4(r4, xs + ((j + (mat >> 1)) * 8 + rr) * Gm::XSTRIDE
                                            + ((mat & 1) ? k1b : k0b) * 2);
                        bf[j][0] = r4[0]; bf[j][1] = r4[1];
                        bf[j + 1][0] = r4[2]; bf[j + 1][1] = r4[3];
                    }
                }
            } else {
#pragma unroll
                for (int j = 0; j < MT8; ++j) {
                    const uint8_t* xr = xs + (j * 8 + gid) * Gm::XSTRIDE;
                    const float2 f0 = *reinterpret_cast<const float2*>(xr + (k0b + 2 * t) * 4);
                    const float2 f1 = *reinterpret_cast<const float2*>(xr + (k1b + 2 * t) * 4);
                    bf[j][0] = bf2_bits(__floats2bfloat162_rn(f0.x, f0.y));
                    bf[j][1] = bf2_bits(__floats2bfloat162_rn(f1.x, f1.y));
                }
            }
#pragma unroll
            for (int j = 0; j < MT8; ++j) {
                mma_bf16_16816(acc[0][j], af[0], bf[j]);
                mma_bf16_16816(acc[1][j], af[1], bf[j]);
            }
            // last step of a group: acc[c, r] += (sum of x row r over the group) * b_eff[c]
            if (has_b && ((i + 1) * 16) % G == 0) {
#pragma unroll
                for (int j = 0; j < MT8; ++j) {
                    const float2 xv = *reinterpret_cast<const float2*>(xsum_s + gl * Gm::ROWS + j * 8 + 2 * t);
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        acc[c >> 1][j][2 * (c & 1)] += xv.x * beff[c];
                        acc[c >> 1][j][2 * (c & 1) + 1] += xv.y * beff[c];
                    }
                }
            }
        }
    }
    cp_wait<0>();
    __syncthreads();

    // partial tile of this warp's K half: red[h][row][column]
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < MT8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int r = j * 8 + 2 * t + e;
            *reinterpret_cast<float4*>(red + (h * Gm::ROWS + r) * Gm::TN + cl) =
                make_float4(acc[0][j][e], acc[0][j][2 + e], acc[1][j][e], acc[1][j][2 + e]);
        }
    cluster.sync();

    // The cluster's blocks split the tile's float4s; each sums every block's
    // two halves in rank order.
    const int rank = static_cast<int>(cluster.block_rank());
    const int n4 = a.M * (Gm::TN / 4);
    for (int idx = rank * THREADS + threadIdx.x; idx < n4; idx += splits * THREADS) {
        const int r = idx / (Gm::TN / 4), c = (idx % (Gm::TN / 4)) * 4;
        const int n = n0 + c;
        if (n >= a.N) continue;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int src = 0; src < splits; ++src) {
            const float* peer = cluster.map_shared_rank(red, src);
#pragma unroll
            for (int hh = 0; hh < Gm::WK; ++hh) {
                const float4 v = *reinterpret_cast<const float4*>(peer + (hh * Gm::ROWS + r) * Gm::TN + c);
                sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
            }
        }
        if (a.bias) {
            const float4 bv = *reinterpret_cast<const float4*>(a.bias + n);
            sum.x += bv.x; sum.y += bv.y; sum.z += bv.z; sum.w += bv.w;
        }
        *reinterpret_cast<float4*>(a.y + static_cast<long>(r) * a.N + n) = sum;
    }
    cluster.sync();              // keep this block's partials alive until every peer has read them
}

template <int MT8, int G, bool PACKED, bool XBF16, int TN>
int launch(const Args& a, int n_splits, cudaStream_t st) {
    using Gm = Geom<MT8, G, PACKED, XBF16, TN>;
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(qmm_kernel<MT8, G, PACKED, XBF16, TN>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
        if (e != cudaSuccess) return static_cast<int>(e);
        smem_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((a.N + TN - 1) / TN, n_splits, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = Gm::SMEM;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = n_splits;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, qmm_kernel<MT8, G, PACKED, XBF16, TN>, a);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// 128 columns per block up to 16 rows; above, 256 where the caller asks for
// them (wide N: half the copies of x and of the scale rows per weight byte)
template <int G, bool PACKED, bool XBF16>
int launch_rows(const Args& a, int tile_n, int n_splits, cudaStream_t st) {
    if (a.M <= 8) return launch<1, G, PACKED, XBF16, 128>(a, n_splits, st);
    if (a.M <= 16) return launch<2, G, PACKED, XBF16, 128>(a, n_splits, st);
    if (a.M <= 32)
        return tile_n == 256 ? launch<4, G, PACKED, XBF16, 256>(a, n_splits, st)
                             : launch<4, G, PACKED, XBF16, 128>(a, n_splits, st);
    return tile_n == 256 ? launch<8, G, PACKED, XBF16, 256>(a, n_splits, st)
                         : launch<8, G, PACKED, XBF16, 128>(a, n_splits, st);
}

template <int G>
int launch_g(const Args& a, bool packed, bool xbf16, int tile_n, int n_splits, cudaStream_t st) {
    if (packed)
        return xbf16 ? launch_rows<G, true, true>(a, tile_n, n_splits, st)
                     : launch_rows<G, true, false>(a, tile_n, n_splits, st);
    return xbf16 ? launch_rows<G, false, true>(a, tile_n, n_splits, st)
                 : launch_rows<G, false, false>(a, tile_n, n_splits, st);
}

}  // namespace

// x: f32 or bf16 [M, K] (x_kind), 16-byte aligned; y: f32 [M, N].
// Requires 1 <= M <= 64, N % 16 == 0, K % G == 0, G in {16, 32}, tile_n in
// {128, 256} (256 is taken above 16 rows), 1 <= n_splits <= 8 K tiles,
// 16-byte aligned weight arrays (checked by the Python wrapper).  One
// launch: a grid of ceil(N / tile_n) x n_splits blocks in clusters of
// n_splits along K.
CL_EXPORT int qmm_launch(const void* x, int x_kind, const void* q, const void* s,
                         const void* b, const void* d, const void* dm, const void* bias,
                         void* y, int M, int K, int N, int G, int sb, int packed,
                         int zero_point, int s_kind, int tile_n, int n_splits, void* stream) {
    if (M < 1 || M > 64 || n_splits < 1 || n_splits > 8 || (G != 16 && G != 32)
        || (tile_n != 128 && tile_n != 256) || (x_kind != KIND_BF16 && x_kind != KIND_F32))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{x, static_cast<const uint8_t*>(q), s, b, static_cast<const __half*>(d),
                 static_cast<const __half*>(dm), static_cast<const float*>(bias),
                 static_cast<float*>(y), M, K, N, sb, zero_point, s_kind};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool xb = x_kind == KIND_BF16;
    return G == 16 ? launch_g<16>(a, packed, xb, tile_n, n_splits, st)
                   : launch_g<32>(a, packed, xb, tile_n, n_splits, st);
}
