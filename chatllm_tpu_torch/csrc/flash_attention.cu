// K3: flash attention (online softmax) for prefill over the KV cache.
//
//   q [B, T, Hq, D], cache k/v [B, S, Hkv, D]  ->  o [B, T, Hq, D]
//   (all bf16; all f32 for an f32 cache; or f32 q and o over a bf16 cache)
//
// Replaces chatllm_tpu/ops/pallas/flash.py::flash_attention (body
// `_flash_kernel`), with the same mask contract: key position p is visible
// to query row t (position n_past + t) iff p < n_past + n_tokens, and, when
// causal, p <= n_past + t, and, with a sliding window W, p > n_past + t - W.
// Optional tanh logit softcap.  Masked scores are -1e30 (not -inf) and the
// final denominator is clamped at 1e-30, as in the Pallas kernel.  GQA maps
// query head h to kv head h / (Hq / Hkv).  q, k, v and o are read and
// written in their native [B, T|S, H, D] layouts through strides: no
// transposes (the Pallas wrapper's [B, H, S, D] transposes are not ported).
//
// Bound on the H100: for prefill chunks of >= 128 queries over a cache, the
// bf16 tensor-core work (4*D flops per visible query/key pair per head) is
// well above the bytes of q, k, v and o, so 989 TFLOP/s bounds it.
//
// bf16 design (`flash_wgmma_kernel`, Hopper warpgroup MMA over a TMA ring):
// one block per (head, batch row, 128-query tile): two consumer warpgroups
// of 64 query rows each and a producer warpgroup, one thread of which
// issues every load; `setmaxnreg` moves the producer's registers to the
// consumers (24 / 240 a thread), which hold the scores, the probabilities
// and the output accumulator at once.  What it does about the causes that
// held the earlier mma.sync kernel to 4% of the bound:
//  1. Nothing in flight during the math -> the producer keeps a ring of
//     STAGES K and V tiles of 128 keys in flight with TMA
//     (cp.async.bulk.tensor, completion on mbarriers); each consumer
//     warpgroup starts Q.K^T as soon as a K tile lands, and frees each
//     stage through an "empty" barrier that the producer waits on before
//     reloading it.  Q is loaded once, the same way.  Inside a warpgroup,
//     Q.K_i^T and P_{i-1}.V_{i-1} are issued together and the softmax of
//     tile i runs while P_{i-1}.V_{i-1} is still on the tensor cores.
//     TMA's out-of-bounds zero fill replaces the row guards: rows past T
//     or S read as zeros, and rows past T are never stored.
//  2. V transposed by scalar stores -> V stays in its row-major [keys, D]
//     layout as TMA writes it; P.V reads it through wgmma's transpose bit
//     (an MN-major B operand).
//  3. mma.sync with hand-gathered fragments -> wgmma: S = Q.K^T is
//     m64n128k16 with Q and K read from shared memory through 128-byte
//     swizzled descriptors (the swizzle TMA writes); the probabilities stay
//     in registers, rounded to bf16, as the A operand of m64n{D}k16 for P.V.
//  4. Small tiles, heaviest last -> 128 x 128 tiles, and the grid's slowest
//     dimension is a launch slot: slot r runs the query tile with the r-th
//     most key tiles (ties: the later tile first), computed on the card from
//     the same formulas as ops/cuda/flash.py::prefill_geometry.
//  5. expf and a separate scale -> the online softmax runs on the wgmma
//     accumulator fragments with scale * log2(e) folded into one FMA before
//     ex2; only tiles that cross the diagonal, the written end or the
//     window do mask arithmetic (per warpgroup, `tile_interior`).
// Scores, running max and denominator and the output accumulator are f32;
// each probability is rounded to bf16 for P.V while the denominator sums
// it unrounded (flash.py:75).  The tensor maps are encoded on the host per
// call (cuTensorMapEncodeTiled, fetched from the driver at run time, so the
// library needs no -lcuda) and passed as __grid_constant__ parameters.
//
// An f32 cache (--cache_dtype float32) takes `flash_f32_kernel`: the Pallas
// kernel runs its dots in the inputs' dtype, so there every product is an
// f32 FMA on the CUDA cores (67 TFLOP/s bounds it).  One block per
// (32-query tile, head, batch), 4 warps of 8 query rows, lane j scoring key
// j of each 32-key tile; tiles wholly above the causal diagonal, past the
// written keys or before the window are never visited, and tiles where
// every key is visible to every row skip the mask arithmetic.  An f32 query
// over a bf16 cache (--compute_dtype f32 --cache_dtype bf16) takes the same
// kernel with bf16 K/V loads: the Pallas kernel's mixed dot q.k runs in f32
// (bf16 keys are exact in f32), it rounds the probabilities to the cache's
// dtype before P.V (flash.py:75) and writes q's dtype, f32.
#include "common.cuh"

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low 16 bits)
    return *reinterpret_cast<uint32_t*>(&v);
}

struct Strides { long b, t, h; };

// ------------------------------------------------------------ bf16: wgmma
constexpr int HBQ = 128;                 // query rows per block
constexpr int WG_ROWS = 64;              // query rows per consumer warpgroup
constexpr int HBK = 128;                 // keys per K/V tile
constexpr int CONSUMER_WARPS = 8;        // two warpgroups
constexpr int HTHREADS = 32 * (CONSUMER_WARPS + 4);   // + the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, from a 1024-byte aligned base: Q as D/64
// column blocks of [HBQ rows x 128 bytes], then STAGES K tiles and STAGES V
// tiles, each D/64 column blocks of [HBK rows x 128 bytes] (the 128-byte
// swizzle TMA writes and the wgmma descriptors read), then the barriers
// (q_full, k_full[], v_full[], k_empty[], v_empty[]) and the tile index.
template <int D>
struct Geo {
    static constexpr int STAGES = D == 128 ? 2 : 4;
    static constexpr int CB = D / 64;
    static constexpr int Q_BYTES = HBQ * D * 2;
    static constexpr int KV_BYTES = HBK * D * 2;
    static constexpr int K_OFF = Q_BYTES;
    static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
    static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
    static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 4 * STAGES) + 8;
};

struct Problem {
    int T, S, Hq, Hkv, n_past, n_tokens, causal, window;
    float scale, softcap;
    long os_b, os_t, os_h;
};

// The key tiles [first, end) query tile qt visits (flash.py::tile_keys).
__device__ __forceinline__ void tile_keys(int qt, const Problem& p, int& first, int& end) {
    const int t0 = qt * HBQ;
    const int lo = p.window > 0 ? max(0, p.n_past + t0 - p.window + 1) : 0;
    int hi = min(p.n_past + p.n_tokens, p.S);
    if (p.causal) hi = min(hi, p.n_past + min(p.T, t0 + HBQ));
    if (hi <= lo) {
        first = end = 0;
        return;
    }
    first = lo / HBK;
    end = (hi + HBK - 1) / HBK;
}

// Every key of tile kt visible to every row of the warpgroup whose first row
// sits at position q_lo (flash.py::tile_interior).
__device__ __forceinline__ bool tile_interior(int kt, int q_lo, const Problem& p) {
    const int k0 = kt * HBK;
    bool ok = k0 + HBK <= p.n_past + p.n_tokens;
    if (p.causal) ok = ok && k0 + HBK - 1 <= q_lo;
    if (p.window > 0) ok = ok && k0 > q_lo + WG_ROWS - 1 - p.window;
    return ok;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// One TMA box of the [D, rows, heads, batch] tensor map into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
                    "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused, 16; MN-major: the distance between 64-wide
// column blocks), stride byte offset 1024 (between 8-row groups).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(1024 >> 4) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin register values at this point of the instruction stream, so the
// compiler moves no access to them across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// d[0:64] (+)= A[64 x 16] . B[128 x 16]^T, both in shared memory, K-major with
// the 128-byte swizzle; acc = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
}

// d[0:64] += A[64 x 16] (registers: bf16 pairs, the m16n8k16 A layout per warp)
//                 . B[16 x 128] (shared memory, MN-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0:32] += A[64 x 16] (registers: bf16 pairs, the m16n8k16 A layout per warp)
//                 . B[16 x 64] (shared memory, MN-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t b) {
    if constexpr (D == 128) wgmma_rs_n128(d, a, b);
    else wgmma_rs_n64(d, a, b);
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, const Problem p) {
    using G = Geo<D>;
    constexpr int ST = G::STAGES;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t sq = base, sk = base + G::K_OFF, sv = base + G::V_OFF;
    const uint32_t q_full = base + G::BAR_OFF;
    const auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
    const auto v_full = [&](int s) { return q_full + 8u * (1 + ST + s); };
    const auto k_empty = [&](int s) { return q_full + 8u * (1 + 2 * ST + s); };
    const auto v_empty = [&](int s) { return q_full + 8u * (1 + 3 * ST + s); };
    int* s_qt = reinterpret_cast<int*>(smem_raw + (base - raw) + G::BAR_OFF + 8 * (1 + 4 * ST));

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int h = blockIdx.x, b = blockIdx.y;
    const int hk = h / (p.Hq / p.Hkv);
    const int n_qt = (p.T + HBQ - 1) / HBQ;

    // launch slot blockIdx.z runs the query tile of that rank in the order
    // of flash.py::prefill_geometry: most key tiles first, then later tiles
    for (int i = tid; i < n_qt; i += HTHREADS) {
        int a, e;
        tile_keys(i, p, a, e);
        int rank = 0;
        for (int j = 0; j < n_qt; ++j) {
            int aj, ej;
            tile_keys(j, p, aj, ej);
            rank += (ej - aj > e - a) || (ej - aj == e - a && j > i);
        }
        if (rank == static_cast<int>(blockIdx.z)) *s_qt = i;
    }
    if (tid == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < ST; ++s) {
            mbar_init(k_full(s), 1);
            mbar_init(v_full(s), 1);
            mbar_init(k_empty(s), CONSUMER_WARPS);
            mbar_init(v_empty(s), CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    const int qt = *s_qt;
    const int t0 = qt * HBQ;
    int kt_first, kt_end;
    tile_keys(qt, p, kt_first, kt_end);
    const int n_tiles = kt_end - kt_first;

    if (warp >= CONSUMER_WARPS) {
        // producer: one thread loads Q once, then K and V tiles through the
        // ring; the warpgroup gives its registers to the consumers
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
        if (warp == CONSUMER_WARPS && lane == 0) {
            mbar_expect_tx(q_full, G::Q_BYTES);
#pragma unroll
            for (int c = 0; c < G::CB; ++c)
                tma_load(sq + c * HBQ * 128, &tm_q, q_full, c * 64, t0, h, b);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % ST;
                const uint32_t parity = ((i / ST) & 1) ^ 1;   // the previous round's release
                const int k0 = (kt_first + i) * HBK;
                if (i >= ST) mbar_wait(k_empty(s), parity);
                mbar_expect_tx(k_full(s), G::KV_BYTES);
#pragma unroll
                for (int c = 0; c < G::CB; ++c)
                    tma_load(sk + s * G::KV_BYTES + c * HBK * 128, &tm_k, k_full(s), c * 64, k0,
                             hk, b);
                if (i >= ST) mbar_wait(v_empty(s), parity);
                mbar_expect_tx(v_full(s), G::KV_BYTES);
#pragma unroll
                for (int c = 0; c < G::CB; ++c)
                    tma_load(sv + s * G::KV_BYTES + c * HBK * 128, &tm_v, v_full(s), c * 64, k0,
                             hk, b);
            }
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // consumers: warpgroup wg owns rows wg*64 .. of the tile; this thread
    // holds rows wr and wr + 8 of it (the wgmma accumulator layout: element
    // 4j + e is row wr + 8 (e >> 1), column 8j + 2 tig + (e & 1))
    const int wg = warp >> 2;
    const int wr = (warp & 3) * 16 + (lane >> 2);
    const int tig = lane & 3;
    const int q_lo = p.n_past + t0 + wg * WG_ROWS;
    const int qpos0 = q_lo + wr, qpos1 = qpos0 + 8;
    const int kv_len = p.n_past + p.n_tokens;
    // scores s enter exp2 as s * c: raw dots times scale * log2(e), or after
    // the softcap (already scaled) times log2(e)
    const float c = (p.softcap > 0.f ? 1.f : p.scale) * LOG2E;

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    float sacc[HBK / 2];
    uint32_t pf[HBK / 16][4];
    const uint32_t qa = sq + wg * (WG_ROWS * 128);
    const auto softmax = [&](int kt, float* corr) {
        const int k0 = kt * HBK;
        if (p.softcap > 0.f) {
#pragma unroll
            for (int j = 0; j < HBK / 2; ++j)
                sacc[j] = tanhf(sacc[j] * p.scale / p.softcap) * p.softcap;
        }
        if (!tile_interior(kt, q_lo, p)) {
#pragma unroll
            for (int j = 0; j < HBK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int kpos = k0 + 8 * j + 2 * tig + (e & 1);
                    const int qpos = e < 2 ? qpos0 : qpos1;
                    bool ok = kpos < kv_len;
                    if (p.causal) ok = ok && kpos <= qpos;
                    if (p.window > 0) ok = ok && kpos > qpos - p.window;
                    if (!ok) sacc[4 * j + e] = NEG_INF;
                }
        }
        // online softmax for rows wr (e = 0, 1) and wr + 8 (e = 2, 3)
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < HBK / 8; ++j) {
            mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
            mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
        }
        float mc[2], rsum[2] = {0.f, 0.f};
        bool none[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            corr[r] = fast_exp2((m_run[r] - m_new) * c);
            m_run[r] = m_new;
            mc[r] = m_new * c;
            // no visible key yet: every masked score equals the max, p = 1
            // (the -1e30 contract), which exp2 of s*c - m*c would not give
            // exactly at that magnitude
            none[r] = m_new == NEG_INF;
        }
#pragma unroll
        for (int j = 0; j < HBK / 2; ++j) {
            const int r = (j >> 1) & 1;
            float pv = fast_exp2(fmaf(sacc[j], c, -mc[r]));
            if (none[r]) pv = 1.f;
            sacc[j] = pv;
            rsum[r] += pv;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            rsum[r] += __shfl_xor_sync(FULL_MASK, rsum[r], 1);
            rsum[r] += __shfl_xor_sync(FULL_MASK, rsum[r], 2);
            l_run[r] = l_run[r] * corr[r] + rsum[r];
        }
    };
    // S = Q K^T of stage s: 64 rows x 128 keys, D/16 steps of 16 along D
    const auto issue_qk = [&](int s) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t a = qa + (kk >> 2) * (HBQ * 128) + (kk & 3) * 32;
            const uint32_t k = sk + s * G::KV_BYTES + (kk >> 2) * (HBK * 128) + (kk & 3) * 32;
            wgmma_ss_n128(sacc, sw128_desc(a, 16), sw128_desc(k, 16), kk > 0);
        }
        wgmma_commit();
    };
    // O += P V of stage s: V [128 keys x D] row-major, read MN-major
    // (transposed) by wgmma, 16 keys a step
    const auto issue_pv = [&](int s) {
#pragma unroll
        for (int kc = 0; kc < HBK / 16; ++kc)
            wgmma_pv<D>(oacc, pf[kc], sw128_desc(sv + s * G::KV_BYTES + kc * 2048, HBK * 128));
        wgmma_commit();
    };
    // P as bf16 A fragments (m16n8k16 layout per warp) straight from the
    // score accumulator: 16 keys = accumulator columns 8 (2 kc) .. + 15
    const auto pack_p = [&]() {
#pragma unroll
        for (int kc = 0; kc < HBK / 16; ++kc) {
            pf[kc][0] = pack_bf16(sacc[8 * kc + 0], sacc[8 * kc + 1]);
            pf[kc][1] = pack_bf16(sacc[8 * kc + 2], sacc[8 * kc + 3]);
            pf[kc][2] = pack_bf16(sacc[8 * kc + 4], sacc[8 * kc + 5]);
            pf[kc][3] = pack_bf16(sacc[8 * kc + 6], sacc[8 * kc + 7]);
        }
    };

    // tile 0: S, then its probabilities; O is still zero
    if (n_tiles > 0) {
        float corr[2];
        mbar_wait(k_full(0), 0);
        wgmma_fence();
        issue_qk(0);
        wgmma_wait<0>();
        reg_fence<HBK / 2>(sacc);
        if (lane == 0) mbar_arrive(k_empty(0));
        softmax(kt_first, corr);
        pack_p();
    }
    // tile i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} in flight together; the
    // softmax of S_i runs while P_{i-1} V_{i-1} is still on the tensor cores
    for (int i = 1; i < n_tiles; ++i) {
        const int s = i % ST, sp = (i - 1) % ST;
        float corr[2];
        mbar_wait(k_full(s), (i / ST) & 1);
        mbar_wait(v_full(sp), ((i - 1) / ST) & 1);
        reg_fence<D / 2>(oacc);
        reg_fence<HBK / 4>(&pf[0][0]);
        wgmma_fence();
        issue_qk(s);
        issue_pv(sp);
        wgmma_wait<1>();
        reg_fence<HBK / 2>(sacc);
        if (lane == 0) mbar_arrive(k_empty(s));
        softmax(kt_first + i, corr);
        wgmma_wait<0>();
        reg_fence<D / 2>(oacc);
        reg_fence<HBK / 4>(&pf[0][0]);
        if (lane == 0) mbar_arrive(v_empty(sp));
#pragma unroll
        for (int j = 0; j < D / 2; ++j) oacc[j] *= corr[(j >> 1) & 1];
        pack_p();
    }
    if (n_tiles > 0) {
        const int sp = (n_tiles - 1) % ST;
        mbar_wait(v_full(sp), ((n_tiles - 1) / ST) & 1);
        reg_fence<D / 2>(oacc);
        reg_fence<HBK / 4>(&pf[0][0]);
        wgmma_fence();
        issue_pv(sp);
        wgmma_wait<0>();
        reg_fence<D / 2>(oacc);
    }
    // finalize: o = acc / max(l, 1e-30); rows past T are never stored
    const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
    const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
    __nv_bfloat16* ob = o + b * p.os_b + h * p.os_h;
    const int ta = t0 + wg * WG_ROWS + wr, tb = ta + 8;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * tig;
        if (ta < p.T)
            *reinterpret_cast<__nv_bfloat162*>(ob + ta * p.os_t + col) =
                __floats2bfloat162_rn(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
        if (tb < p.T)
            *reinterpret_cast<__nv_bfloat162*>(ob + tb * p.os_t + col) =
                __floats2bfloat162_rn(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                  cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

// A bf16 [B, rows, H, D] tensor with element strides st = (b, t, h) as a
// tensor map of boxes [64 of D, box_rows rows, one head, one batch row],
// 128-byte swizzled, zero fill past the edges.  A dimension of extent 1 is
// only read at coordinate 0, so its stride is set to a legal one.
int encode_rows(CUtensorMap* map, const void* ptr, int D, int rows, int heads, int batch,
                const long* st, int box_rows) {
    const EncodeTiled encode = encoder();
    if (!encode) return static_cast<int>(cudaErrorNotSupported);
    cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                          static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
    cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 2, static_cast<cuuint64_t>(st[2]) * 2,
                             static_cast<cuuint64_t>(st[0]) * 2};
    for (int i = 0; i < 3; ++i)
        if (dims[i + 1] == 1) strides[i] = 16;
    cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
    cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, const long* st, int B,
                 int T, int S, int Hq, int Hkv, int n_past, int n_tokens, float scale,
                 int causal, int window, float softcap, cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    int err = encode_rows(&tq, q, D, T, Hq, B, st, HBQ);
    if (!err) err = encode_rows(&tk, k, D, S, Hkv, B, st + 3, HBK);
    if (!err) err = encode_rows(&tv, v, D, S, Hkv, B, st + 6, HBK);
    if (err) return err;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    const Problem p{T, S, Hq, Hkv, n_past, n_tokens, causal, window, scale, softcap,
                    st[9], st[10], st[11]};
    const dim3 grid(Hq, B, (T + HBQ - 1) / HBQ);
    flash_wgmma_kernel<D><<<grid, HTHREADS, Geo<D>::SMEM, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), p);
    return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ f32: CUDA cores
constexpr int FBQ = 32;           // f32 kernel: query rows per block
constexpr int FBK = 32;           // keys per tile, one per lane
constexpr int FROWS = FBQ / 4;    // query rows per warp

__device__ __forceinline__ void to_f32(const uint4& u, float* out, float) {
    const float* e = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = e[c];
}

__device__ __forceinline__ void to_f32(const uint4& u, float* out, __nv_bfloat16) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int c = 0; c < 8; ++c) out[c] = __bfloat162float(e[c]);
}

// f32 q and o; K/V of type KV (f32, or bf16 staged as f32).  Lane j scores
// key k0 + j against the warp's 8 rows (q read as broadcasts, K rows padded
// by 4 floats so the 16-byte reads of 8 consecutive lanes hit distinct
// banks), then owns output columns lane + 32i and gathers each key's
// probability with a shuffle.  Over a bf16 cache that probability is
// rounded to bf16 first; the denominator sums it unrounded.
template <int D, typename KV>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                 const KV* __restrict__ v, float* __restrict__ o,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 int T, int S, int Hq, int Hkv, int n_past, int n_tokens, float scale,
                 int causal, int window, float softcap) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float (*sq)[D] = reinterpret_cast<float (*)[D]>(smem_raw);
    float (*sk)[D + 4] = reinterpret_cast<float (*)[D + 4]>(sq + FBQ);
    float (*sv)[D] = reinterpret_cast<float (*)[D]>(sk + FBK);
    constexpr int NC = D / 32;     // output columns per lane

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (Hq / Hkv);
    const int t0 = qt * FBQ;
    const int row0 = warp * FROWS;

    const float* qb = q + b * qs.b + h * qs.h;
    const KV* kb = k + b * ks.b + hk * ks.h;
    const KV* vb = v + b * vs.b + hk * vs.h;
    constexpr int VEC = 16 / sizeof(KV);     // K/V elements per 16-byte load
    constexpr bool ROUND_P = sizeof(KV) == 2;

    for (int idx = tid; idx < FBQ * (D / 4); idx += THREADS) {
        const int r = idx / (D / 4), c4 = (idx % (D / 4)) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t0 + r < T) val = *reinterpret_cast<const float4*>(qb + (t0 + r) * qs.t + c4);
        *reinterpret_cast<float4*>(&sq[r][c4]) = val;
    }

    float oacc[FROWS][NC];
    float m_run[FROWS], l_run[FROWS];
#pragma unroll
    for (int r = 0; r < FROWS; ++r) {
        m_run[r] = NEG_INF;
        l_run[r] = 0.f;
#pragma unroll
        for (int i = 0; i < NC; ++i) oacc[r][i] = 0.f;
    }

    const int kv_len = n_past + n_tokens;
    const int q_lo = n_past + t0;
    const int q_hi = q_lo + FBQ - 1;
    int k_end = min(kv_len, S);
    if (causal) k_end = min(k_end, q_hi + 1);
    int kt_begin = 0;
    if (window > 0) kt_begin = max(0, q_lo - window + 1) / FBK;
    const int kt_end = (k_end + FBK - 1) / FBK;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * FBK;
        __syncthreads();   // q staged / previous tile's readers are done
        for (int idx = tid; idx < FBK * (D / VEC); idx += THREADS) {
            const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
            float kf[VEC], vf[VEC];
            if (k0 + r < S) {
                to_f32(*reinterpret_cast<const uint4*>(kb + (k0 + r) * ks.t + c), kf, KV{});
                to_f32(*reinterpret_cast<const uint4*>(vb + (k0 + r) * vs.t + c), vf, KV{});
            } else {
#pragma unroll
                for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
                *reinterpret_cast<float4*>(&sk[r][c + e]) =
                    make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
                *reinterpret_cast<float4*>(&sv[r][c + e]) =
                    make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
            }
        }
        __syncthreads();

        float s[FROWS];
#pragma unroll
        for (int r = 0; r < FROWS; ++r) s[r] = 0.f;
#pragma unroll 4
        for (int c = 0; c < D; c += 4) {
            const float4 kv = *reinterpret_cast<const float4*>(&sk[lane][c]);
#pragma unroll
            for (int r = 0; r < FROWS; ++r) {
                const float4 qv = *reinterpret_cast<const float4*>(&sq[row0 + r][c]);
                s[r] = fmaf(qv.x, kv.x, s[r]);
                s[r] = fmaf(qv.y, kv.y, s[r]);
                s[r] = fmaf(qv.z, kv.z, s[r]);
                s[r] = fmaf(qv.w, kv.w, s[r]);
            }
        }

        bool interior = k0 + FBK <= kv_len;
        if (causal) interior = interior && (k0 + FBK - 1 <= q_lo);
        if (window > 0) interior = interior && (k0 > q_hi - window);
        const int kpos = k0 + lane;
#pragma unroll
        for (int r = 0; r < FROWS; ++r) {
            float sv_ = s[r] * scale;
            if (softcap > 0.f) sv_ = tanhf(sv_ / softcap) * softcap;
            if (!interior) {
                const int qpos = q_lo + row0 + r;
                bool ok = kpos < kv_len;
                if (causal) ok = ok && kpos <= qpos;
                if (window > 0) ok = ok && kpos > qpos - window;
                if (!ok) sv_ = NEG_INF;
            }
            float mx = sv_;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
            const float m_new = fmaxf(m_run[r], mx);
            const float corr = expf(m_run[r] - m_new);
            m_run[r] = m_new;
            s[r] = expf(sv_ - m_new);
            l_run[r] = l_run[r] * corr + warp_sum(s[r]);
            if (ROUND_P) s[r] = __bfloat162float(__float2bfloat16_rn(s[r]));
#pragma unroll
            for (int i = 0; i < NC; ++i) oacc[r][i] *= corr;
        }

        // O += P V: key j's probability comes from lane j
#pragma unroll 4
        for (int j = 0; j < FBK; ++j) {
            float vj[NC];
#pragma unroll
            for (int i = 0; i < NC; ++i) vj[i] = sv[j][lane + 32 * i];
#pragma unroll
            for (int r = 0; r < FROWS; ++r) {
                const float p = __shfl_sync(FULL_MASK, s[r], j);
#pragma unroll
                for (int i = 0; i < NC; ++i) oacc[r][i] = fmaf(p, vj[i], oacc[r][i]);
            }
        }
    }

    float* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < FROWS; ++r) {
        const int t = t0 + row0 + r;
        if (t >= T) continue;
        const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
#pragma unroll
        for (int i = 0; i < NC; ++i) ob[t * os.t + lane + 32 * i] = oacc[r][i] * inv;
    }
}

template <typename QO, typename KV, typename KernelFn>
int launch_kernel(KernelFn kernel, size_t smem, int bq, const void* q, const void* k,
                  const void* v, void* o, const long* st, int B, int T, int S, int Hq,
                  int Hkv, int n_past, int n_tokens, float scale, int causal, int window,
                  float softcap, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((T + bq - 1) / bq, Hq, B);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const QO*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
        static_cast<QO*>(o), Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
        Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
        T, S, Hq, Hkv, n_past, n_tokens, scale, causal, window, softcap);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int mode, const void* q, const void* k, const void* v, void* o, const long* st,
           int B, int T, int S, int Hq, int Hkv, int n_past, int n_tokens, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
    const size_t f32_smem = sizeof(float) * (FBQ * D + FBK * (D + 4) + FBK * D);
    if (mode == 1)
        return launch_kernel<float, float>(
            flash_f32_kernel<D, float>, f32_smem, FBQ, q, k, v, o, st, B, T, S, Hq, Hkv,
            n_past, n_tokens, scale, causal, window, softcap, stream);
    if (mode == 2)
        return launch_kernel<float, __nv_bfloat16>(
            flash_f32_kernel<D, __nv_bfloat16>, f32_smem, FBQ, q, k, v, o, st, B, T, S,
            Hq, Hkv, n_past, n_tokens, scale, causal, window, softcap, stream);
    if (mode != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma<D>(q, k, v, o, st, B, T, S, Hq, Hkv, n_past, n_tokens, scale, causal,
                           window, softcap, stream);
}

}  // namespace

// mode 0: q/k/v/o all bf16; 1: all f32; 2: q/o f32 over bf16 k/v.  Unit
// stride along D;
// strides: 12 element strides (b, t, h) for q, k, v, o in that order, each
// a multiple of 16 bytes, and 16-byte aligned q, k, v (mode 0 reads them
// through TMA).  D must be 64 or 128; Hq % Hkv == 0; n_past + n_tokens <= S.
CL_EXPORT int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                     const long* strides, int B, int T, int S, int Hq,
                                     int Hkv, int D, int n_past, int n_tokens, float scale,
                                     int causal, int window, float softcap, int mode,
                                     void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D == 128)
        return launch<128>(mode, q, k, v, o, strides, B, T, S, Hq, Hkv, n_past, n_tokens,
                           scale, causal, window, softcap, st);
    if (D == 64)
        return launch<64>(mode, q, k, v, o, strides, B, T, S, Hq, Hkv, n_past, n_tokens,
                          scale, causal, window, softcap, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
