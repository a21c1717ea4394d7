// K5: pipelined fused dequant x matmul for batched decode (1..64 rows).
//
//   y[M, N] = x[M, K] @ dequant(W) (+ bias),  bf16 weights and x, f32 accumulation
//
// Replaces chatllm_tpu/ops/pallas/qmm_decode.py::qmm_decode_pallas (body
// `_kernel`, dequantization `_dequant_halves`).  Its rounding, which sets it
// apart from K2 (csrc/qmm.cu), is kept exactly:
//
//   * superblock layouts: s = bf16(d*sc) and bb = bf16(-(dmin*m)); every
//     weight is formed in bf16 as bf16(bf16((q - zp)*s) + bb), where K2 adds
//     the min term in f32 from group sums of x;
//   * classic layouts: every weight is bf16((q - zp)*bf16(s)); their affine
//     term b is the wrapper's f32 product of the group sums of x with b, as
//     in the Pallas wrapper, and never reaches this kernel;
//   * x is rounded to bf16 and the products accumulate in f32.
//
// That is ops/cuda/qmm_decode.py::qmm_decode_plain; only the order of the
// f32 sums differs.  Each bf16 step is one correctly rounded instruction
// with an explicit .rn (mul.rn / add.rn .bf16x2), so the compiler cannot
// contract a multiply and an add into one rounding.
//
// Bound on the H100: at M <= 64 the work is 2*M*K*N flops against ~0.56
// byte per weight, at most ~230 flop/byte, below the ~295 flop/byte where
// the bf16 tensor cores overtake device memory: the bytes of the quantized
// weight bound it.
//
// Design (second version, for Hopper; each point answers a cause that held
// the first version back):
//  1. Operands (padded rows, a shared-memory round trip per tile).  The
//     dequantized weight is the mma A operand, built in registers from the
//     raw bytes (output columns are the 16-row dimension), and x^T is the
//     8-wide B operand, loaded by ldmatrix: an 8-row step is not padded to
//     16, and no dequantized tile is stored to shared memory and read back.
//     Nibbles become bf16 by OR-ing them into the mantissa of 128.0, then
//     one exact bf16 subtract of 128 + zero point.
//  2. x whole.  The kernel takes x [M, K] (bf16 or f32) as it is and
//     permutes the K order inside each 16-deep mma step so that a byte
//     row's low and high nibbles meet the same step: the low nibbles of
//     byte row j of group g are weight row G*g + j, the high ones
//     G*g + j + G/2, and the B fragment's two 8-deep halves are read from
//     those two runs of x.  Nothing splits x into x_lo / x_hi.
//  3. Load pipeline (small tiles, two slots).  A ring of 3-4 stages in
//     shared memory, each holding the raw weight bytes, the scale rows and
//     x of one 128-deep K tile, filled by cp.async (16-byte copies,
//     zero-filled past K and N) and tracked by commit groups; one barrier
//     per tile.  A block owns 128 columns (twice the first version's 64),
//     so x is read once per 128 columns.  Each thread works out its copies
//     once (`Copier`): a tile's copy is an add, a compare and a cp.async
//     per 16 bytes, with no divergent branch.  G, the packing, the type of
//     x and the row count (8/16/32/64) are template parameters: the tile
//     walk does no run-time division.
//  4. Split-K (two launches and a scratch buffer).  The blocks of a column
//     tile that share its K tiles are one thread-block cluster along K, of
//     up to 8 blocks (ops/cuda/qmm_decode.py::qmm_decode_splits).  Each
//     block leaves its partial tile in shared memory and the cluster sums
//     them through distributed shared memory in rank order: one launch per
//     call, no scratch in device memory, no second kernel, the same bits on
//     every launch.
// The unpack costs few instructions: the four lanes that share a column
// fold its scales once and pass them by shuffle, nibbles reach bf16 through
// one lop3 each, and with no zero point bf16(q * s) is one fma of 128 + q
// with s and -128 s (exact), rounded once.
// 8 warps, each owning 32 columns: two warps share a column range and take
// half of each tile's eight 16-deep steps each (summed in the epilogue).
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TK = 128;                   // K rows per pipeline stage
constexpr int THREADS = 256;
constexpr int TN = 128;                   // columns per block
constexpr int MAX_SPLITS = 8;             // blocks per cluster (the portable limit)
constexpr int SMEM_BUDGET = 110 * 1024;   // two blocks per SM where 4 stages fit
constexpr int SMEM_MAX = 227 * 1024;

struct Args {
    const void* x;
    const uint8_t* q;
    const void* s;      // classic f16/f32 scales; superblock int8 sc
    const int8_t* m;    // superblock int8 m, or null
    const __half* d;    // superblock f16 d
    const __half* dm;   // superblock f16 dmin (with m)
    const float* bias;
    float* y;
    int M, K, N, sb, zero_point, s_kind;
};

template <int MT8, int G, bool PACKED, bool XBF16>
struct Geom {
    static constexpr int WN = TN / 32;                   // warps along N (32 columns each)
    static constexpr int WK = 8 / WN;                    // warps along a tile's K steps
    static constexpr int QSTRIDE = TN + 16;              // bytes per byte row (bank-conflict pad)
    // per group: superblock sc i8 at 0, m i8 at TN, d f16 at 2TN, dmin f16
    // at 4TN; classic s (f16 or f32) at 0
    static constexpr int SCL_GROUP = 6 * TN;
    static constexpr int ROWS = MT8 * 8;                 // x rows held (zero past M)
    static constexpr int ESZ = XBF16 ? 2 : 4;
    static constexpr int XSTRIDE = TK * ESZ + 16;
    static constexpr int QROWS = PACKED ? TK / 2 : TK;
    static constexpr int QBYTES = QROWS * QSTRIDE;
    static constexpr int XBYTES = ROWS * XSTRIDE;
    static constexpr int NG = TK / G;                    // groups per tile
    static constexpr int STAGE = QBYTES + XBYTES + NG * SCL_GROUP;
    static constexpr int STAGES = SMEM_BUDGET / STAGE >= 4 ? 4 : 3;
    static constexpr int PIPE = STAGES * STAGE;
    static constexpr int RED = WK * ROWS * TN * 4;       // the K parts' [rows, TN] f32
    static constexpr int SMEM = PIPE > RED ? PIPE : RED;
    static constexpr int STEPS = TK / 16 / WK;           // 16-deep mma steps per warp per tile
    static_assert(SMEM <= SMEM_MAX, "shared memory");
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

// Correctly rounded bf16x2 steps (an explicit .rn: never contracted into an fma).
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}
// (a & b) | c in one instruction (b and c stay in registers)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t d;
    asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
}

// One thread's share of the copies of every K tile.  A thread's 16-byte
// chunks keep their columns from tile to tile, so everything but the tile's
// first row is worked out once: a copy is one 64-bit add, a compare and a
// cp.async.  The scale chunks are numbered array by array (a warp's 32
// chunks come from one array), so the choice of array does not diverge.
template <int MT8, int G, bool PACKED, bool XBF16>
struct Copier {
    using Gm = Geom<MT8, G, PACKED, XBF16>;
    static constexpr int QCPR = TN / 16;                         // chunks per byte row
    static constexpr int QPT = Gm::QROWS * QCPR / THREADS;       // per thread, exact
    static constexpr int QRSTEP = THREADS / QCPR;                // rows between them
    static constexpr int XCPR = TK * Gm::ESZ / 16;               // chunks per x row
    static constexpr int XCH = Gm::ROWS * XCPR;
    static constexpr int XPT = (XCH + THREADS - 1) / THREADS;
    static constexpr int XRSTEP = THREADS / XCPR;
    // superblock: sc, m (i8, TN/16 chunks a row), d, dmin (f16, TN/8); classic: s
    static constexpr int SCH_MAX = Gm::NG * 6 * TN / 16;
    static constexpr int SPT = (SCH_MAX + THREADS - 1) / THREADS;
    static_assert(Gm::QROWS * QCPR % THREADS == 0 && THREADS % XCPR == 0, "copy plan");

    const uint8_t* q;          // chunk 0 of this thread in tile 0
    long q_row_step, q_tile_step;
    int q_row, qrows, q_dst;
    bool q_ok;
    const char* x;             // chunk 0 of this thread at k = 0
    long x_row_step;
    int x_row, x_k, x_dst, M, K;
    const char* s_src[SPT];    // row 0 of the chunk's array, at its columns
    int s_dst[SPT], s_gl[SPT], s_esz[SPT], ng, sb, N;
    bool s_live[SPT], s_ok[SPT], s_sbrow[SPT];   // chunk exists; in bounds; row g / sb

    __device__ __forceinline__ Copier(const Args& a, int n0) {
        const int tid = threadIdx.x;
        const int qc = tid % QCPR;
        q_row = tid / QCPR;
        qrows = PACKED ? a.K / 2 : a.K;
        q_ok = n0 + qc * 16 < a.N;
        q = a.q + static_cast<long>(q_row) * a.N + n0 + qc * 16;
        q_row_step = static_cast<long>(QRSTEP) * a.N;
        q_tile_step = static_cast<long>(Gm::QROWS) * a.N;
        q_dst = q_row * Gm::QSTRIDE + qc * 16;

        const int xc = tid % XCPR;
        x_row = tid / XCPR;
        x_k = xc * (16 / Gm::ESZ);
        M = a.M;
        K = a.K;
        x = static_cast<const char*>(a.x) + (static_cast<long>(x_row) * a.K + x_k) * Gm::ESZ;
        x_row_step = static_cast<long>(XRSTEP) * a.K * Gm::ESZ;
        x_dst = Gm::QBYTES + x_row * Gm::XSTRIDE + xc * 16;

        ng = a.K / G;
        sb = a.sb > 0 ? a.sb : 1;
        N = a.N;
        constexpr int C1 = TN / 16, C2 = TN / 8, C4 = TN / 4;
        constexpr int R1 = Gm::NG * C1, R2 = Gm::NG * C2;
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
            int i = tid + j * THREADS;
            const void* arr = nullptr;
            int esz = 1, cpr = C1, off = 0;
            bool sbrow = false;
            if (a.sb) {
                if (i < R1) {
                    arr = a.s;
                } else if ((i -= R1) < R1) {
                    arr = a.m; off = TN;
                } else if ((i -= R1) < R2) {
                    arr = a.d; esz = 2; cpr = C2; off = 2 * TN; sbrow = true;
                } else if ((i -= R2) < R2) {
                    arr = a.m ? a.dm : nullptr; esz = 2; cpr = C2; off = 4 * TN; sbrow = true;
                }
            } else if (a.s_kind == KIND_F32) {
                if (i < Gm::NG * C4) { arr = a.s; esz = 4; cpr = C4; }
            } else if (i < R2) {
                arr = a.s; esz = 2; cpr = C2;
            }
            const int gl = i / cpr, c = i % cpr;
            const int n = n0 + c * (16 / esz);
            s_live[j] = arr != nullptr;
            s_ok[j] = s_live[j] && n < a.N;
            s_src[j] = s_ok[j] ? static_cast<const char*>(arr) + static_cast<long>(n) * esz
                               : static_cast<const char*>(a.s);
            s_dst[j] = Gm::QBYTES + Gm::XBYTES + gl * Gm::SCL_GROUP + off + c * 16;
            s_gl[j] = gl;
            s_esz[j] = esz;
            s_sbrow[j] = sbrow;
        }
    }

    // Issue the copies of K tile kt into stage `st`; rows past K and
    // columns past N are zero-filled.
    __device__ __forceinline__ void load(uint8_t* st, int kt) const {
        const uint8_t* qt = q + kt * q_tile_step;
        const int r0 = kt * Gm::QROWS + q_row;
#pragma unroll
        for (int j = 0; j < QPT; ++j)
            cp16(st + q_dst + j * QRSTEP * Gm::QSTRIDE, qt + j * q_row_step,
                 q_ok && r0 + j * QRSTEP < qrows);
        const int k = kt * TK + x_k;
#pragma unroll
        for (int j = 0; j < XPT; ++j)
            if (XCH % THREADS == 0 || threadIdx.x + j * THREADS < XCH)
                cp16(st + x_dst + j * XRSTEP * Gm::XSTRIDE, x + kt * TK * Gm::ESZ + j * x_row_step,
                     x_row + j * XRSTEP < M && k < K);
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
            if (!s_live[j]) continue;
            const int g = kt * Gm::NG + s_gl[j];
            const int row = s_sbrow[j] ? g / sb : g;
            cp16(st + s_dst[j], s_src[j] + static_cast<long>(row) * N * s_esz[j], s_ok[j] && g < ng);
        }
    }
};

template <int MT8, int G, bool PACKED, bool XBF16>
__global__ void __launch_bounds__(THREADS, 2) qmm_decode_kernel(const Args a) {
    using Gm = Geom<MT8, G, PACKED, XBF16>;
    extern __shared__ __align__(16) uint8_t smem[];
    cg::cluster_group cluster = cg::this_cluster();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gid = lane >> 2, t = lane & 3;
    const int wn = warp % Gm::WN, h = warp / Gm::WN;
    const int n0 = blockIdx.x * TN;
    const int cl = wn * 32 + gid * 4;              // this lane's 4 columns in the tile
    const int n_kt = (a.K + TK - 1) / TK;
    const int splits = gridDim.y;
    const int kt0 = static_cast<int>(static_cast<long>(blockIdx.y) * n_kt / splits);
    const int kt1 = static_cast<int>(static_cast<long>(blockIdx.y + 1) * n_kt / splits);
    const int nt = kt1 - kt0;
    const bool affine = a.sb && a.m != nullptr;     // the min term rounded into each weight
    const bool zp0 = a.zero_point == 0;
    const Copier<MT8, G, PACKED, XBF16> cp(a, n0);

    float acc[2][MT8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < MT8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const uint32_t z2 = bf2_bits(__float2bfloat162_rn(128.f + static_cast<float>(a.zero_point)));
    const uint32_t nib = 0x000F000Fu, magic = 0x43004300u, neg128 = 0xC300C300u;
    const float zp = static_cast<float>(a.zero_point);

#pragma unroll
    for (int s = 0; s < Gm::STAGES - 1; ++s) {
        if (s < nt) cp.load(smem + s * Gm::STAGE, kt0 + s);
        cp_commit();
    }

    // bf16(s), bf16(bb) and bf16(-128 s) of this lane's columns
    uint32_t s2[4], bb2[4], ns2[4];
    for (int it = 0; it < nt; ++it) {
        cp_wait<Gm::STAGES - 2>();
        __syncthreads();
        const int nx = it + Gm::STAGES - 1;
        if (nx < nt) cp.load(smem + (nx % Gm::STAGES) * Gm::STAGE, kt0 + nx);
        cp_commit();

        const uint8_t* qs = smem + (it % Gm::STAGES) * Gm::STAGE;
        const uint8_t* xs = qs + Gm::QBYTES;
        const uint8_t* ss = xs + Gm::XBYTES;
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
                // the four lanes of a gid share its four columns: lane t folds
                // column cl + t, and each takes the others' by shuffle
                const uint8_t* base = ss + gl * Gm::SCL_GROUP;
                const int col = cl + t;
                float se, be = 0.f;
                if (a.sb) {
                    se = static_cast<float>(reinterpret_cast<const int8_t*>(base)[col])
                         * __half2float(reinterpret_cast<const __half*>(base + 2 * TN)[col]);
                    if (affine)
                        be = -(static_cast<float>(reinterpret_cast<const int8_t*>(base + TN)[col])
                               * __half2float(reinterpret_cast<const __half*>(base + 4 * TN)[col]));
                } else if (a.s_kind == KIND_F32) {
                    se = reinterpret_cast<const float*>(base)[col];
                } else {
                    se = __half2float(reinterpret_cast<const __half*>(base)[col]);
                }
                const uint32_t so = bf2_bits(__float2bfloat162_rn(se));
                const uint32_t bo = bf2_bits(__float2bfloat162_rn(be));
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    s2[c] = __shfl_sync(FULL_MASK, so, (lane & ~3) | c);
                    bb2[c] = affine ? __shfl_sync(FULL_MASK, bo, (lane & ~3) | c) : 0u;
                    ns2[c] = bf2_mul(s2[c], neg128);   // exact
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
                    // the low / high nibbles of byte c of rows br, br + 1 as
                    // bf16 128 + q (exact), then (q - zp) * s rounded once:
                    // one fma with -128 s (exact) when zp is 0
                    const uint32_t sel = c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12);
                    const uint32_t p = __byte_perm(w0, w1, sel);
                    const uint32_t lo = and_or(p, nib, magic);
                    const uint32_t hi = and_or(p >> 4, nib, magic);
                    uint32_t wl, wh;
                    if (zp0) {
                        wl = bf2_fma(lo, s2[c], ns2[c]);
                        wh = bf2_fma(hi, s2[c], ns2[c]);
                    } else {
                        wl = bf2_mul(bf2_sub(lo, z2), s2[c]);
                        wh = bf2_mul(bf2_sub(hi, z2), s2[c]);
                    }
                    if (affine) {
                        wl = bf2_add(wl, bb2[c]);
                        wh = bf2_add(wh, bb2[c]);
                    }
                    af[c >> 1][c & 1] = wl;
                    af[c >> 1][2 + (c & 1)] = wh;
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
                    // (q - zp) * bf16(s) is exact in f32 and rounded once
                    const float sf = __low2float(*reinterpret_cast<const __nv_bfloat162*>(&s2[c]));
                    float v[4];
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        v[r] = (static_cast<float>(static_cast<int8_t>(w[r] >> (8 * c))) - zp) * sf;
                    uint32_t wl = bf2_bits(__floats2bfloat162_rn(v[0], v[1]));
                    uint32_t wh = bf2_bits(__floats2bfloat162_rn(v[2], v[3]));
                    if (affine) {
                        wl = bf2_add(wl, bb2[c]);
                        wh = bf2_add(wh, bb2[c]);
                    }
                    af[c >> 1][c & 1] = wl;
                    af[c >> 1][2 + (c & 1)] = wh;
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
        }
    }
    cp_wait<0>();
    __syncthreads();

    // partial tile of this warp's K part: red[h][row][column]
    float4* red = reinterpret_cast<float4*>(smem);
    constexpr int C4 = TN / 4;                     // float4s per row
#pragma unroll
    for (int j = 0; j < MT8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int r = j * 8 + 2 * t + e;
            red[(h * Gm::ROWS + r) * C4 + cl / 4] =
                make_float4(acc[0][j][e], acc[0][j][2 + e], acc[1][j][e], acc[1][j][2 + e]);
        }
    __syncthreads();
    // the block's K parts summed in order into part 0
    const int n4 = a.M * C4;
    for (int idx = threadIdx.x; idx < n4; idx += THREADS) {
        float4 sum = red[idx];
#pragma unroll
        for (int hh = 1; hh < Gm::WK; ++hh) {
            const float4 v = red[hh * Gm::ROWS * C4 + idx];
            sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
        }
        red[idx] = sum;
    }
    cluster.sync();

    // The cluster's blocks split the tile's float4s; each sums every block's
    // part in rank order, then adds the bias.  All the remote loads of an
    // output are issued before its first add.
    const int rank = static_cast<int>(cluster.block_rank());
    for (int idx = rank * THREADS + threadIdx.x; idx < n4; idx += splits * THREADS) {
        const int r = idx / C4, n = n0 + (idx % C4) * 4;
        if (n >= a.N) continue;
        float4 v[MAX_SPLITS];
#pragma unroll
        for (int src = 0; src < MAX_SPLITS; ++src)
            if (src < splits) v[src] = cluster.map_shared_rank(red, src)[idx];
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int src = 0; src < MAX_SPLITS; ++src) {
            if (src < splits) {
                sum.x += v[src].x; sum.y += v[src].y; sum.z += v[src].z; sum.w += v[src].w;
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

// One cluster launch of a grid of ceil(N / TN) x n_splits blocks.  The
// shared memory size is set at the first launch of each instantiation;
// later launches, and a CUDA-graph capture of them, make no call besides
// the launch.
template <int MT8, int G, bool PACKED, bool XBF16>
int launch(const Args& a, int n_splits, cudaStream_t st) {
    using Gm = Geom<MT8, G, PACKED, XBF16>;
    auto kernel = qmm_decode_kernel<MT8, G, PACKED, XBF16>;
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
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
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int G, bool PACKED, bool XBF16>
int launch_rows(const Args& a, int n_splits, cudaStream_t st) {
    if (a.M <= 8) return launch<1, G, PACKED, XBF16>(a, n_splits, st);
    if (a.M <= 16) return launch<2, G, PACKED, XBF16>(a, n_splits, st);
    if (a.M <= 32) return launch<4, G, PACKED, XBF16>(a, n_splits, st);
    return launch<8, G, PACKED, XBF16>(a, n_splits, st);
}

template <int G>
int launch_g(const Args& a, bool packed, bool xbf16, int n_splits, cudaStream_t st) {
    if (packed)
        return xbf16 ? launch_rows<G, true, true>(a, n_splits, st)
                     : launch_rows<G, true, false>(a, n_splits, st);
    return xbf16 ? launch_rows<G, false, true>(a, n_splits, st)
                 : launch_rows<G, false, false>(a, n_splits, st);
}

}  // namespace

// x: f32 or bf16 [M, K] (x_kind), 16-byte aligned; y: f32 [M, N].  m / dm:
// the superblock min term (null without it, and for classic layouts, whose
// affine b is the caller's separate product).  Requires 1 <= M <= 64,
// N % 16 == 0, K % G == 0, G in {16, 32}, 1 <= n_splits <= 8 and at most
// the number of 128-deep K tiles, 16-byte aligned weight arrays (checked by
// the Python wrapper).  One launch: a grid of ceil(N / 128) x n_splits
// blocks in clusters of n_splits along K.
CL_EXPORT int qmm_decode_launch(const void* x, int x_kind, const void* q, const void* s,
                                const void* m, const void* d, const void* dm, const void* bias,
                                void* y, int M, int K, int N, int G, int sb, int packed,
                                int zero_point, int s_kind, int n_splits, void* stream) {
    if (M < 1 || M > 64 || n_splits < 1 || n_splits > MAX_SPLITS
        || n_splits > (K + TK - 1) / TK || (G != 16 && G != 32)
        || (x_kind != KIND_BF16 && x_kind != KIND_F32))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{x, static_cast<const uint8_t*>(q), s, sb ? static_cast<const int8_t*>(m) : nullptr,
                 static_cast<const __half*>(d), static_cast<const __half*>(dm),
                 static_cast<const float*>(bias), static_cast<float*>(y),
                 M, K, N, sb, zero_point, s_kind};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool xb = x_kind == KIND_BF16;
    return G == 16 ? launch_g<16>(a, packed, xb, n_splits, st)
                   : launch_g<32>(a, packed, xb, n_splits, st);
}
