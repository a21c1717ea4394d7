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
//     STAGES K and V tiles of 128 keys (64 at D 256, `Geo`) in flight with TMA
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
// f32 modes (`flash_f32_kernel`): an f32 cache (--cache_dtype float32, mode
// 1), and an f32 query over a bf16 cache (mode 2): --compute_dtype f32, and
// also the chat path's prefill over a bf16 cache, whose projections return
// f32 as the JAX package's do (matmul's f32 result is not cast back).  The
// Pallas kernel runs its dots in the inputs' dtypes, so every product is an
// f32 product.  No Hopper tensor-core instruction multiplies f32 by f32 in
// one pass: TF32 keeps about three digits, and 3xTF32 changes the roundings
// and, at 495 / 3 TFLOP/s, gains little; so the CUDA cores' 67 TFLOP/s of
// f32 FMAs bound both modes.  In mode 2 the bf16 keys are exact in f32, each
// probability is rounded to bf16 before P.V while the denominator sums it
// unrounded (flash.py:75), and the output is q's dtype, f32.  What the
// design does about the causes that held the first f32 kernel (32 x 32
// tiles of 128 threads) to 21% of that bound:
//  1. Synchronous loads -> a ring of K and V tiles of 64 keys (2 stages at
//     D 128, 4 at D 64, 80 and 96; 2 stages of 32 keys at D 256) filled by
//     cp.async (16-byte copies, zero fill past S) as the cache's raw bytes:
//     the next tiles load while one is worked
//     on.  A bf16 tile is widened once into f32 tiles beside the ring, so
//     both modes' products read f32 (widening at every read was slower).
//  2. Q.K^T bound by shared-memory loads -> blocks of 256 threads own 128
//     query rows at D 128 (64 at D 64, or where 128-row tiles would leave
//     SMs idle: `f32_rows`); each thread holds an 8 x 4 (4 x 4) register
//     tile of S, rows ty + 16 r and keys tx + 16 j, read from padded rows of
//     Q and K: 10.7 FMAs per 16-byte shared read, 8 at 4 x 4 (was 3.6).
//     At D 64, 128-row blocks would hold the 1000-token Qwen2.5-0.5B chunk
//     to 112 blocks on 132 SMs with twice the longest walk.
//  3. P.V bound by shuffles -> P goes to shared memory key-major (into the
//     f32 K tile once Q.K^T is done), each thread's rows side by side, so
//     one 16-byte read gives a key's probabilities for four of them; a
//     thread owns its rows x D / 16 columns of O: no shuffles in P.V.  A
//     row's max takes 4 xor shuffles per tile (its scores lie across 16
//     lanes); its denominator is kept as per-thread shares summed once at
//     the end; exp2 with scale * log2(e) folded into one multiply.  The
//     scores are scaled before the mask, so a row whose visited keys are
//     all masked gets exp2(-1e30 - -1e30) = 1 for each, the -1e30 contract.
//     Only tiles that cross the diagonal, the written end or the window do
//     mask arithmetic.
//  4. Small tiles, lightest first -> the grid's slowest dimension is a
//     launch slot: slot r runs the query tile with the r-th most key tiles
//     (ties: the later tile first), as mode 0 does, from the formulas of
//     flash.py::prefill_geometry (mode 1 / 2).
//  5. Too few blocks on a long walk -> each query tile's key walk is split
//     over a cluster of C blocks, C the largest power of two <= 8 for which
//     the card holds all the grid's clusters at once
//     (cudaOccupancyMaxActiveClusters; flash.py::f32_splits): 1 for the
//     1000-token chunk, 2 for Llama-3-8B's 128-token chunk at n_past 8064
//     (64 clusters of 64-row blocks; 66 fit).  Each block walks a
//     contiguous share of the key tiles; the blocks merge (max,
//     denominator, accumulators) through distributed shared memory in rank
//     order, K4's pattern (csrc/flash_decode.cu): one launch, no scratch,
//     no atomics, the same bits on every launch.
// One block an SM (up to 254 registers a thread; 196 KB of shared memory at
// D 128); two blocks of the D 64 kernel on one SM ran slower than one.
#include "common.cuh"

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low 16 bits)
    return *reinterpret_cast<uint32_t*>(&v);
}

struct Strides { long b, t, h; };

// ------------------------------------------------------------ bf16: wgmma
constexpr int HBQ = 128;                 // query rows per block
constexpr int WG_ROWS = 64;              // query rows per consumer warpgroup
constexpr int CONSUMER_WARPS = 8;        // two warpgroups
constexpr int HTHREADS = 32 * (CONSUMER_WARPS + 4);   // + the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, from a 1024-byte aligned base: Q as D/64
// column blocks of [HBQ rows x 128 bytes], then STAGES K tiles and STAGES V
// tiles, each D/64 column blocks of [BK rows x 128 bytes] (the 128-byte
// swizzle TMA writes and the wgmma descriptors read), then the barriers
// (q_full, k_full[], v_full[], k_empty[], v_empty[]) and the tile index.
// Key tiles of 128 keys, 64 at D 256: there a consumer thread holds 128
// accumulators of O, which beside 128-key scores and their probabilities
// would pass setmaxnreg's 240 registers, and two stages of 128-key K and V
// tiles (256 KB) would pass the card's 227 KB of shared memory.  A head dim
// that is not a multiple of 64 (Phi's 80 and 96) runs on the tiles of the
// next one, DP = 128: the tensor maps' inner extent is the true D, so TMA
// zero-fills columns D .. DP - 1 of every Q, K and V tile and no read
// reaches the next head's row; Q.K^T takes only the D / 16 steps that hold
// data, P.V is m64n128 over the padded V (its columns past D are zeros), and
// only D columns of O are stored.
template <int D>
struct Geo {
    static constexpr int DP = D % 64 == 0 ? D : 128;       // the tiles' width
    static_assert(D % 16 == 0 && D <= DP, "D a multiple of 16, at most the tiles' width");
    static constexpr int BK = D == 256 ? 64 : 128;
    static constexpr int STAGES = D == 64 ? 4 : 2;
    static constexpr int CB = DP / 64;
    static constexpr int Q_BYTES = HBQ * DP * 2;
    static constexpr int KV_BYTES = BK * DP * 2;
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

// The key tiles [first, end) of BK keys query tile qt visits
// (flash.py::tile_keys).
template <int BK>
__device__ __forceinline__ void tile_keys(int qt, const Problem& p, int& first, int& end) {
    const int t0 = qt * HBQ;
    const int lo = p.window > 0 ? max(0, p.n_past + t0 - p.window + 1) : 0;
    int hi = min(p.n_past + p.n_tokens, p.S);
    if (p.causal) hi = min(hi, p.n_past + min(p.T, t0 + HBQ));
    if (hi <= lo) {
        first = end = 0;
        return;
    }
    first = lo / BK;
    end = (hi + BK - 1) / BK;
}

// Every key of tile kt (BK keys) visible to every row of the warpgroup whose
// first row sits at position q_lo (flash.py::tile_interior).
template <int BK>
__device__ __forceinline__ bool tile_interior(int kt, int q_lo, const Problem& p) {
    const int k0 = kt * BK;
    bool ok = k0 + BK <= p.n_past + p.n_tokens;
    if (p.causal) ok = ok && k0 + BK - 1 <= q_lo;
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

// d[0:32] (+)= A[64 x 16] . B[64 x 16]^T, as wgmma_ss_n128 over 64 keys
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
}

template <int BK>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t a, uint64_t b, int acc) {
    if constexpr (BK == 128) wgmma_ss_n128(d, a, b, acc);
    else wgmma_ss_n64(d, a, b, acc);
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

// O (D columns) += P . V of 16 keys; V's descriptor at address `addr`, its
// 64-wide column blocks `lbo` bytes apart.  At D 256 two m64n128k16: columns
// 128 .. 255 are accumulator elements 64 .. 127, the layout of one n256.
template <int D>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint32_t addr, uint32_t lbo) {
    if constexpr (D == 256) {
        wgmma_rs_n128(d, a, sw128_desc(addr, lbo));
        wgmma_rs_n128(d + 64, a, sw128_desc(addr + 2 * lbo, lbo));
    } else if constexpr (D == 128) {
        wgmma_rs_n128(d, a, sw128_desc(addr, lbo));
    } else {
        wgmma_rs_n64(d, a, sw128_desc(addr, lbo));
    }
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, const Problem p) {
    using G = Geo<D>;
    constexpr int ST = G::STAGES, BK = G::BK, DP = G::DP;
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
        tile_keys<BK>(i, p, a, e);
        int rank = 0;
        for (int j = 0; j < n_qt; ++j) {
            int aj, ej;
            tile_keys<BK>(j, p, aj, ej);
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
    tile_keys<BK>(qt, p, kt_first, kt_end);
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
                const int k0 = (kt_first + i) * BK;
                if (i >= ST) mbar_wait(k_empty(s), parity);
                mbar_expect_tx(k_full(s), G::KV_BYTES);
#pragma unroll
                for (int c = 0; c < G::CB; ++c)
                    tma_load(sk + s * G::KV_BYTES + c * BK * 128, &tm_k, k_full(s), c * 64, k0,
                             hk, b);
                if (i >= ST) mbar_wait(v_empty(s), parity);
                mbar_expect_tx(v_full(s), G::KV_BYTES);
#pragma unroll
                for (int c = 0; c < G::CB; ++c)
                    tma_load(sv + s * G::KV_BYTES + c * BK * 128, &tm_v, v_full(s), c * 64, k0,
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

    float oacc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    float sacc[BK / 2];
    uint32_t pf[BK / 16][4];
    const uint32_t qa = sq + wg * (WG_ROWS * 128);
    const auto softmax = [&](int kt, float* corr) {
        const int k0 = kt * BK;
        if (p.softcap > 0.f) {
#pragma unroll
            for (int j = 0; j < BK / 2; ++j)
                sacc[j] = tanhf(sacc[j] * p.scale / p.softcap) * p.softcap;
        }
        if (!tile_interior<BK>(kt, q_lo, p)) {
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
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
        for (int j = 0; j < BK / 8; ++j) {
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
        for (int j = 0; j < BK / 2; ++j) {
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
    // S = Q K^T of stage s: 64 rows x BK keys, D/16 steps of 16 along D (the
    // padded columns past D are zeros in both)
    const auto issue_qk = [&](int s) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t a = qa + (kk >> 2) * (HBQ * 128) + (kk & 3) * 32;
            const uint32_t k = sk + s * G::KV_BYTES + (kk >> 2) * (BK * 128) + (kk & 3) * 32;
            wgmma_qk<BK>(sacc, sw128_desc(a, 16), sw128_desc(k, 16), kk > 0);
        }
        wgmma_commit();
    };
    // O += P V of stage s: V [BK keys x D] row-major, read MN-major
    // (transposed) by wgmma, 16 keys a step
    const auto issue_pv = [&](int s) {
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc)
            wgmma_pv<DP>(oacc, pf[kc], sv + s * G::KV_BYTES + kc * 2048, BK * 128);
        wgmma_commit();
    };
    // P as bf16 A fragments (m16n8k16 layout per warp) straight from the
    // score accumulator: 16 keys = accumulator columns 8 (2 kc) .. + 15
    const auto pack_p = [&]() {
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) {
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
        reg_fence<BK / 2>(sacc);
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
        reg_fence<DP / 2>(oacc);
        reg_fence<BK / 4>(&pf[0][0]);
        wgmma_fence();
        issue_qk(s);
        issue_pv(sp);
        wgmma_wait<1>();
        reg_fence<BK / 2>(sacc);
        if (lane == 0) mbar_arrive(k_empty(s));
        softmax(kt_first + i, corr);
        wgmma_wait<0>();
        reg_fence<DP / 2>(oacc);
        reg_fence<BK / 4>(&pf[0][0]);
        if (lane == 0) mbar_arrive(v_empty(sp));
#pragma unroll
        for (int j = 0; j < DP / 2; ++j) oacc[j] *= corr[(j >> 1) & 1];
        pack_p();
    }
    if (n_tiles > 0) {
        const int sp = (n_tiles - 1) % ST;
        mbar_wait(v_full(sp), ((n_tiles - 1) / ST) & 1);
        reg_fence<DP / 2>(oacc);
        reg_fence<BK / 4>(&pf[0][0]);
        wgmma_fence();
        issue_pv(sp);
        wgmma_wait<0>();
        reg_fence<DP / 2>(oacc);
    }
    // finalize: o = acc / max(l, 1e-30) over the D real columns; rows past T
    // are never stored
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
// 128-byte swizzled, zero fill past the edges (columns D .. 127 of a box
// at D 80 or 96 among them).  A dimension of extent 1 is only read at
// coordinate 0, so its stride is set to a legal one.
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
    if (!err) err = encode_rows(&tk, k, D, S, Hkv, B, st + 3, Geo<D>::BK);
    if (!err) err = encode_rows(&tv, v, D, S, Hkv, B, st + 6, Geo<D>::BK);
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
constexpr int FTHREADS = 256;      // 16 x 16 threads
constexpr int MAX_SPLIT = 8;       // blocks of a cluster (the portable limit)
constexpr int MIN_SHARE = 4;       // key tiles each block of a split walks at least
constexpr int QK_UNROLL = 8;       // Q.K^T steps unrolled (measured: 8 of 2-32)
constexpr int PV_UNROLL = 16;      // P.V keys unrolled (measured: 16 of 2-16)

__device__ __forceinline__ void cp16(void* smem, const void* gmem, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(smem)), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// The f32 kernel's geometry, KV the cache's dtype (f32, or bf16 in mode 2).
// A block of 256 threads owns BQ query rows (128, or 64: `f32_rows`) and
// walks BK-key tiles (64 keys, 32 at D 256, where two stages of 64-key f32
// tiles beside Q would pass the card's shared memory); thread (ty, tx) holds
// S for the RT = BQ / 16 rows ty + 16 r and the KJ = BK / 16 keys tx + 16 j,
// and O for the same rows and the columns c 64 + 4 tx + e below D, c < NV =
// D / 64 rounded up (at D 80 and 96 the last 64-column block is partial:
// its columns past D belong to no thread).  Shared
// memory: Q [BQ][D + 4] f32; a ring of STAGES stages of K and V tiles as the
// cache's raw bytes (f32: K [BK][D + 4], V [BK][D]; bf16: K and V [BK][D],
// widened once per tile into f32 tiles KF [BK][D + 4] and VF [BK][D] after
// the ring); the products read only f32 tiles.  P [BK][BQ + 4] f32,
// key-major, row ty + 16 r at column
// RT ty + r (so one 16-byte read gives four of a thread's rows), takes the
// f32 K tile's place once Q.K^T is done.  The pads put the 16-byte reads
// and writes of 8 consecutive threads on distinct banks.  After the walk
// the space from the ring on holds the cluster's merge: [C][BQ / C][D]
// accumulators and [C][BQ / C] (max, denominator).
template <int D, typename KV, int BQ>
struct FGeo {
    static constexpr bool WIDEN = sizeof(KV) == 2;                      // bf16 cache
    static constexpr int BK = D == 256 ? 32 : 64;                       // keys per tile
    static constexpr int KJ = BK / 16;                                  // keys a thread
    static constexpr int STAGES = D == 128 || D == 256 ? 2 : 4;         // tiles in the ring
    static constexpr int RT = BQ / 16;                                  // rows a thread
    static constexpr int QS = D + 4;                                    // floats per q row
    static constexpr int FKS = D + 4;                                   // floats per f32 K row
    static constexpr int PS = BQ + 4;                                   // floats per P row
    static constexpr int RAW = D * static_cast<int>(sizeof(KV));        // bytes of a cache row
    static constexpr int KROW = WIDEN ? RAW : FKS * 4;                  // bytes per ring K row
    static constexpr int K_OFF = BQ * QS * 4;
    static constexpr int STAGE = BK * (KROW + RAW);
    static constexpr int KF_OFF = K_OFF + STAGES * STAGE;               // bf16: the f32 tiles
    static constexpr int VF_OFF = KF_OFF + BK * FKS * 4;
    static constexpr int SMEM = WIDEN ? VF_OFF + BK * D * 4 : KF_OFF;
    static_assert(D >= BQ, "P fits the f32 K tile");
    static_assert(SMEM - K_OFF >= 4 * (BQ * D + 2 * BQ), "the merge fits after Q");
};

struct FProblem {
    const float* q;
    const void* k;
    const void* v;
    float* o;
    Strides qs, ks, vs, os;
    int T, S, Hq, Hkv, n_past, n_tokens, causal, window, splits;
    float scale, softcap;
};

// The key tiles [first, end) of bk keys that the f32 kernel's query tile qt
// of bq rows visits (flash.py::tile_keys).
__host__ __device__ inline void f32_tile_keys(int qt, int bq, int bk, int T, int S, int n_past,
                                              int n_tokens, int causal, int window,
                                              int& first, int& end) {
    const int t0 = qt * bq;
    const int w0 = n_past + t0 - window + 1;
    const int lo = window > 0 && w0 > 0 ? w0 : 0;
    int hi = n_past + n_tokens < S ? n_past + n_tokens : S;
    const int last = n_past + (T < t0 + bq ? T : t0 + bq);
    if (causal && last < hi) hi = last;
    if (hi <= lo) {
        first = end = 0;
        return;
    }
    first = lo / bk;
    end = (hi + bk - 1) / bk;
}

__device__ __forceinline__ float4 lds4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// f32 q and o over K/V of type KV (FGeo's layout).  Rank `rank` of a
// cluster of C walks its share of the query tile's key tiles; the ranks
// merge in rank order.  Over a bf16 cache each probability is rounded to
// bf16 for P V and the denominator sums it unrounded.
template <int D, typename KV, int BQ>
__global__ void __launch_bounds__(FTHREADS, 1)
flash_f32_kernel(const FProblem p) {
    using G = FGeo<D, KV, BQ>;
    constexpr int RT = G::RT, BK = G::BK, KJ = G::KJ;
    constexpr int NV = (D + 63) / 64;             // 16-byte reads of a V row per thread
    // column block c of this thread lies below D (always, at a multiple of 64)
    const auto col_ok = [](int c) {
        return D % 64 == 0 || c * 64 + static_cast<int>(threadIdx.x & 15) * 4 < D;
    };
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_qt;
    float* sq = reinterpret_cast<float*>(smem);

    const int tid = threadIdx.x, lane = tid & 31;
    const int tx = lane & 15, ty = 2 * (tid >> 5) + (lane >> 4);
    const int C = p.splits, rank = blockIdx.x % C, h = blockIdx.x / C, b = blockIdx.y;
    const int hk = h / (p.Hq / p.Hkv);
    const int n_qt = (p.T + BQ - 1) / BQ;

    // launch slot blockIdx.z runs the query tile of that rank in the order
    // of flash.py::prefill_geometry: most key tiles first, then later tiles
    for (int i = tid; i < n_qt; i += FTHREADS) {
        int a, e;
        f32_tile_keys(i, BQ, BK, p.T, p.S, p.n_past, p.n_tokens, p.causal, p.window, a, e);
        int r = 0;
        for (int j = 0; j < n_qt; ++j) {
            int aj, ej;
            f32_tile_keys(j, BQ, BK, p.T, p.S, p.n_past, p.n_tokens, p.causal, p.window, aj, ej);
            r += (ej - aj > e - a) || (ej - aj == e - a && j > i);
        }
        if (r == static_cast<int>(blockIdx.z)) s_qt = i;
    }
    __syncthreads();
    const int qt = s_qt, t0 = qt * BQ;
    int first, end;
    f32_tile_keys(qt, BQ, BK, p.T, p.S, p.n_past, p.n_tokens, p.causal, p.window, first, end);
    const int n_all = end - first;
    const int ka = first + static_cast<int>(static_cast<long>(rank) * n_all / C);
    const int n_tiles = first + static_cast<int>(static_cast<long>(rank + 1) * n_all / C) - ka;

    const float* qb = p.q + b * p.qs.b + h * p.qs.h;
    const KV* kb = static_cast<const KV*>(p.k) + b * p.ks.b + hk * p.ks.h;
    const KV* vb = static_cast<const KV*>(p.v) + b * p.vs.b + hk * p.vs.h;
    const auto load_tile = [&](int kt, int stage) {
        unsigned char* sk = smem + G::K_OFF + stage * G::STAGE;
        unsigned char* sv = sk + BK * G::KROW;
        constexpr int NCH = G::RAW / 16;            // 16-byte chunks of a row
#pragma unroll
        for (int it = 0; it < (BK * NCH + FTHREADS - 1) / FTHREADS; ++it) {
            const int idx = tid + it * FTHREADS, r = idx / NCH, c = idx % NCH;
            if (BK * NCH % FTHREADS && idx >= BK * NCH) break;
            const int key = kt * BK + r;
            const bool ok = key < p.S;              // keys past S read as zeros
            const long row = ok ? key : 0;
            cp16(sk + r * G::KROW + c * 16,
                 reinterpret_cast<const unsigned char*>(kb + row * p.ks.t) + c * 16, ok);
            cp16(sv + r * G::RAW + c * 16,
                 reinterpret_cast<const unsigned char*>(vb + row * p.vs.t) + c * 16, ok);
        }
    };
    if (n_tiles > 0) {
        // Q once, rows past T as zeros (never stored), with the first tile
#pragma unroll
        for (int it = 0; it < BQ * D / 4 / FTHREADS; ++it) {
            const int idx = tid + it * FTHREADS, r = idx / (D / 4), c = (idx % (D / 4)) * 4;
            const bool ok = t0 + r < p.T;
            cp16(sq + r * G::QS + c, qb + (ok ? t0 + r : 0) * p.qs.t + c, ok);
        }
        load_tile(ka, 0);
    }
    cp_commit();
#pragma unroll
    for (int s = 1; s < G::STAGES - 1; ++s) {
        if (s < n_tiles) load_tile(ka + s, s);
        cp_commit();
    }

    float acc[RT][NV * 4];
    float m_run[RT], l_run[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        m_run[r] = NEG_INF;
        l_run[r] = 0.f;
#pragma unroll
        for (int c = 0; c < NV * 4; ++c) acc[r][c] = 0.f;
    }
    const int q_lo = p.n_past + t0, kv_len = p.n_past + p.n_tokens;
    // scores enter exp2 as s * c2: raw dots times scale * log2(e), or after
    // the softcap (already scaled) times log2(e)
    const float c2 = (p.softcap > 0.f ? 1.f : p.scale) * LOG2E;
    const float cap_in = p.softcap > 0.f ? p.scale / p.softcap : 0.f;

    for (int i = 0; i < n_tiles; ++i) {
        cp_wait<G::STAGES - 2>();
        __syncthreads();      // tile i has landed; every thread is done with tile i - 1
        if (i + G::STAGES - 1 < n_tiles)
            load_tile(ka + i + G::STAGES - 1, (i + G::STAGES - 1) % G::STAGES);
        cp_commit();
        unsigned char* sk = smem + G::K_OFF + (i % G::STAGES) * G::STAGE;
        float* kf = reinterpret_cast<float*>(G::WIDEN ? smem + G::KF_OFF : sk);
        const float* vf = reinterpret_cast<const float*>(G::WIDEN ? smem + G::VF_OFF
                                                                  : sk + BK * G::KROW);
        if constexpr (G::WIDEN) {
            // the bf16 tile widened once into the f32 tiles (the f32 of a
            // bf16 value is its 16 bits in the upper half)
            const uint16_t* rk = reinterpret_cast<const uint16_t*>(sk);
            const uint16_t* rv = rk + BK * D;
#pragma unroll
            for (int it = 0; it < (BK * D / 8 + FTHREADS - 1) / FTHREADS; ++it) {
                const int idx = tid + it * FTHREADS, r = idx / (D / 8), c = (idx % (D / 8)) * 8;
                if (BK * D / 8 % FTHREADS && idx >= BK * D / 8) break;
                const uint4 uk = *reinterpret_cast<const uint4*>(rk + r * D + c);
                const uint4 uv = *reinterpret_cast<const uint4*>(rv + r * D + c);
                const uint32_t wk[4] = {uk.x, uk.y, uk.z, uk.w}, wv[4] = {uv.x, uv.y, uv.z, uv.w};
                float fk[8], fv[8];
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    fk[2 * w] = __uint_as_float(wk[w] << 16);
                    fk[2 * w + 1] = __uint_as_float(wk[w] & 0xffff0000u);
                    fv[2 * w] = __uint_as_float(wv[w] << 16);
                    fv[2 * w + 1] = __uint_as_float(wv[w] & 0xffff0000u);
                }
                float* dk = kf + r * G::FKS + c;
                float* dv = reinterpret_cast<float*>(smem + G::VF_OFF) + r * D + c;
                *reinterpret_cast<float4*>(dk) = make_float4(fk[0], fk[1], fk[2], fk[3]);
                *reinterpret_cast<float4*>(dk + 4) = make_float4(fk[4], fk[5], fk[6], fk[7]);
                *reinterpret_cast<float4*>(dv) = make_float4(fv[0], fv[1], fv[2], fv[3]);
                *reinterpret_cast<float4*>(dv + 4) = make_float4(fv[4], fv[5], fv[6], fv[7]);
            }
            __syncthreads();
        }

        // S = Q K^T, an RT x KJ tile per thread: RT + KJ reads of 16 bytes
        // per 4 RT KJ FMAs
        float s[RT][KJ];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int j = 0; j < KJ; ++j) s[r][j] = 0.f;
#pragma unroll QK_UNROLL
        for (int d = 0; d < D; d += 4) {
            float4 kv[KJ];
#pragma unroll
            for (int j = 0; j < KJ; ++j) kv[j] = lds4(kf + (tx + 16 * j) * G::FKS + d);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const float4 qv = lds4(sq + (ty + 16 * r) * G::QS + d);
#pragma unroll
                for (int j = 0; j < KJ; ++j) {
                    s[r][j] = fmaf(qv.x, kv[j].x, s[r][j]);
                    s[r][j] = fmaf(qv.y, kv[j].y, s[r][j]);
                    s[r][j] = fmaf(qv.z, kv[j].z, s[r][j]);
                    s[r][j] = fmaf(qv.w, kv[j].w, s[r][j]);
                }
            }
        }

        // online softmax: a row's BK scores lie across 16 lanes of a warp
        const int k0 = (ka + i) * BK;
        bool interior = k0 + BK <= kv_len;
        if (p.causal) interior = interior && k0 + BK - 1 <= q_lo;
        if (p.window > 0) interior = interior && k0 > q_lo + BQ - 1 - p.window;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
                float x = s[r][j];
                if (p.softcap > 0.f) x = tanhf(x * cap_in) * p.softcap;
                x *= c2;
                if (!interior) {
                    const int kpos = k0 + tx + 16 * j, qpos = q_lo + ty + 16 * r;
                    bool ok = kpos < kv_len;
                    if (p.causal) ok = ok && kpos <= qpos;
                    if (p.window > 0) ok = ok && kpos > qpos - p.window;
                    if (!ok) x = NEG_INF;
                }
                s[r][j] = x;
            }
            float mx = s[r][0];
#pragma unroll
            for (int j = 1; j < KJ; ++j) mx = fmaxf(mx, s[r][j]);
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
            const float m_new = fmaxf(m_run[r], mx);
            // the scores are already scaled, so a masked score equal to the
            // max gives exp2(0) = 1: a row that sees none of the visited keys
            // takes p = 1 for each, the Pallas kernel's -1e30 contract
            const float corr = fast_exp2(m_run[r] - m_new);
            m_run[r] = m_new;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
                s[r][j] = fast_exp2(s[r][j] - m_new);
                sum += s[r][j];
            }
            l_run[r] = fmaf(l_run[r], corr, sum);       // this thread's share of the row
#pragma unroll
            for (int c = 0; c < NV * 4; ++c) acc[r][c] *= corr;
        }
        __syncthreads();      // every thread is done with the f32 K tile: P takes its place
        float* sp = kf;
        // P key-major: one 16-byte read gives a key's probabilities of 4 rows
#pragma unroll
        for (int j = 0; j < KJ; ++j)
#pragma unroll
            for (int h4 = 0; h4 < RT / 4; ++h4) {
                float4 pv = make_float4(s[4 * h4][j], s[4 * h4 + 1][j], s[4 * h4 + 2][j],
                                        s[4 * h4 + 3][j]);
                if (G::WIDEN) {
                    pv.x = __bfloat162float(__float2bfloat16_rn(pv.x));
                    pv.y = __bfloat162float(__float2bfloat16_rn(pv.y));
                    pv.z = __bfloat162float(__float2bfloat16_rn(pv.z));
                    pv.w = __bfloat162float(__float2bfloat16_rn(pv.w));
                }
                *reinterpret_cast<float4*>(sp + (tx + 16 * j) * G::PS + RT * ty + 4 * h4) = pv;
            }
        __syncthreads();

        // O += P V: per key RT / 4 reads of P and D / 64 of V for RT x D / 16
        // FMAs
#pragma unroll PV_UNROLL
        for (int k = 0; k < BK; ++k) {
            float4 pr[RT / 4];
#pragma unroll
            for (int h4 = 0; h4 < RT / 4; ++h4) pr[h4] = lds4(sp + k * G::PS + RT * ty + 4 * h4);
#pragma unroll
            for (int c = 0; c < NV; ++c) {
                if (!col_ok(c)) continue;
                const float4 v4 = lds4(vf + k * D + c * 64 + tx * 4);
                const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
                for (int h4 = 0; h4 < RT / 4; ++h4)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        acc[4 * h4][c * 4 + e] = fmaf(pr[h4].x, vv[e], acc[4 * h4][c * 4 + e]);
                        acc[4 * h4 + 1][c * 4 + e] =
                            fmaf(pr[h4].y, vv[e], acc[4 * h4 + 1][c * 4 + e]);
                        acc[4 * h4 + 2][c * 4 + e] =
                            fmaf(pr[h4].z, vv[e], acc[4 * h4 + 2][c * 4 + e]);
                        acc[4 * h4 + 3][c * 4 + e] =
                            fmaf(pr[h4].w, vv[e], acc[4 * h4 + 3][c * 4 + e]);
                    }
            }
        }
    }
    cp_wait<0>();
    // a row's denominator: the 16 shares summed in a fixed order
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
            l_run[r] += __shfl_xor_sync(FULL_MASK, l_run[r], off);

    float* ob = p.o + b * p.os.b + h * p.os.h;
    if (C == 1) {
        // o = acc / max(l, 1e-30); rows past T are never stored
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            const int t = t0 + ty + 16 * r;
            if (t >= p.T) continue;
            const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
#pragma unroll
            for (int c = 0; c < NV; ++c)
                if (col_ok(c))
                    *reinterpret_cast<float4*>(ob + t * p.os.t + c * 64 + tx * 4) =
                        make_float4(acc[r][c * 4] * inv, acc[r][c * 4 + 1] * inv,
                                    acc[r][c * 4 + 2] * inv, acc[r][c * 4 + 3] * inv);
        }
        return;
    }

    // The cluster's merge: rank o owns rows [o RO, (o + 1) RO) of the tile.
    // Every rank stores its (max, denominator) and accumulators of those
    // rows into the owner's shared memory through distributed shared
    // memory; after one cluster barrier each owner merges them in rank order.
    cg::cluster_group cluster = cg::this_cluster();
    __syncthreads();
    cluster.sync();           // every rank is done with its tiles: they may be written
    const int RO = BQ / C;
    float* racc = reinterpret_cast<float*>(smem + G::K_OFF);     // [C][RO][D]
    float* rml = racc + BQ * D;                                   // [C][RO][2]
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        const int row = ty + 16 * r, own = row / RO, rl = row - own * RO;
        float* dst = cluster.map_shared_rank(racc, own) + (rank * RO + rl) * D;
#pragma unroll
        for (int c = 0; c < NV; ++c)
            if (col_ok(c))
                *reinterpret_cast<float4*>(dst + c * 64 + tx * 4) =
                    make_float4(acc[r][c * 4], acc[r][c * 4 + 1], acc[r][c * 4 + 2],
                                acc[r][c * 4 + 3]);
        if (tx == 0)
            *reinterpret_cast<float2*>(cluster.map_shared_rank(rml, own) +
                                       (rank * RO + rl) * 2) = make_float2(m_run[r], l_run[r]);
    }
    cluster.sync();           // every partial has landed
    for (int idx = tid; idx < RO * D / 4; idx += FTHREADS) {
        const int rl = idx / (D / 4), c4 = (idx % (D / 4)) * 4;
        const int t = t0 + rank * RO + rl;
        if (t >= p.T) continue;
        float m = NEG_INF;
        for (int s = 0; s < C; ++s) m = fmaxf(m, rml[(s * RO + rl) * 2]);
        float l = 0.f;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < C; ++s) {
            // a rank that saw no visible key (max -1e30) weighs 0 beside one
            // that did, and 1 when no rank did (the -1e30 contract)
            const float w = fast_exp2(rml[(s * RO + rl) * 2] - m);
            l = fmaf(rml[(s * RO + rl) * 2 + 1], w, l);
            const float4 x = lds4(racc + (s * RO + rl) * D + c4);
            a.x = fmaf(x.x, w, a.x);
            a.y = fmaf(x.y, w, a.y);
            a.z = fmaf(x.z, w, a.z);
            a.w = fmaf(x.w, w, a.w);
        }
        const float inv = 1.f / fmaxf(l, 1e-30f);
        *reinterpret_cast<float4*>(ob + t * p.os.t + c4) =
            make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    }
}

// The query rows of an f32 block (flash.py::f32_rows): 128 at D 128 where
// the grid of 128-row tiles fills the SMs (128 rows cut the shared-memory
// reads per FMA by a quarter in Q.K^T and a third in P.V), else 64, so that
// a short chunk has twice the blocks.
__host__ inline int f32_rows(int D, int T, int Hq, int B, int sms) {
    return D == 128 && (T + 127) / 128 * Hq * B >= sms ? 128 : 64;
}

// How many clusters of C blocks of this kernel the card holds at once
// (cudaOccupancyMaxActiveClusters, asked once per C), or a CUDA error < 0.
template <int D, typename KV, int BQ>
int cluster_slots(int C) {
    static bool attr_set = false;
    static int slots[4] = {0, 0, 0, 0};
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel<D, KV, BQ>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   FGeo<D, KV, BQ>::SMEM);
        if (e != cudaSuccess) return -static_cast<int>(e);
        attr_set = true;
    }
    const int i = C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2 : 3;
    if (!slots[i]) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(C, 1, 1);
        cfg.blockDim = dim3(FTHREADS, 1, 1);
        cfg.dynamicSmemBytes = FGeo<D, KV, BQ>::SMEM;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = C;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int n = 0;
        const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, flash_f32_kernel<D, KV, BQ>, &cfg);
        if (e != cudaSuccess) return -static_cast<int>(e);
        slots[i] = n;
    }
    return slots[i];
}

int last_splits = 0;      // the split of the last f32 launch

// One f32 launch of BQ-row blocks.  The split of each query tile's key walk
// over a cluster (flash.py::f32_splits): the largest power of two C <=
// MAX_SPLIT such that the card holds all the grid's clusters of C at once
// and the longest walk gives each block at least MIN_SHARE tiles.
template <int D, typename KV, int BQ>
int launch_f32(const void* q, const void* k, const void* v, void* o, const long* st, int B,
               int T, int S, int Hq, int Hkv, int n_past, int n_tokens, float scale, int causal,
               int window, float softcap, cudaStream_t stream) {
    using G = FGeo<D, KV, BQ>;
    const int n_qt = (T + BQ - 1) / BQ;
    int longest = 0;
    for (int qt = 0; qt < n_qt; ++qt) {
        int a, b;
        f32_tile_keys(qt, BQ, G::BK, T, S, n_past, n_tokens, causal, window, a, b);
        longest = b - a > longest ? b - a : longest;
    }
    const int blocks = n_qt * Hq * B;
    int C = 1;
    while (2 * C <= MAX_SPLIT && longest >= 2 * C * MIN_SHARE) {
        const int n = cluster_slots<D, KV, BQ>(2 * C);
        if (n < 0) return -n;
        if (blocks > n) break;
        C *= 2;
    }
    const int err = cluster_slots<D, KV, BQ>(1);     // sets the shared-memory attribute
    if (err < 0) return -err;
    const FProblem p{static_cast<const float*>(q), k, v, static_cast<float*>(o),
                     Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
                     Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
                     T, S, Hq, Hkv, n_past, n_tokens, causal, window, C, scale, softcap};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C * Hq, B, n_qt);
    cfg.blockDim = dim3(FTHREADS, 1, 1);
    cfg.dynamicSmemBytes = G::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, flash_f32_kernel<D, KV, BQ>, p);
    last_splits = C;
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

int sm_count(int& sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return static_cast<int>(e);
}

template <int D, typename KV>
int launch_f32_rows(const void* q, const void* k, const void* v, void* o, const long* st, int B,
                    int T, int S, int Hq, int Hkv, int n_past, int n_tokens, float scale,
                    int causal, int window, float softcap, cudaStream_t stream) {
    int sms = 0;
    const int e = sm_count(sms);
    if (e) return e;
    if constexpr (D == 128) {
        if (f32_rows(D, T, Hq, B, sms) == 128)
            return launch_f32<D, KV, 128>(q, k, v, o, st, B, T, S, Hq, Hkv, n_past, n_tokens,
                                          scale, causal, window, softcap, stream);
    }
    return launch_f32<D, KV, 64>(q, k, v, o, st, B, T, S, Hq, Hkv, n_past, n_tokens, scale,
                                 causal, window, softcap, stream);
}

template <int D>
int launch(int mode, const void* q, const void* k, const void* v, void* o, const long* st,
           int B, int T, int S, int Hq, int Hkv, int n_past, int n_tokens, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
    if (mode == 1)
        return launch_f32_rows<D, float>(q, k, v, o, st, B, T, S, Hq, Hkv, n_past, n_tokens,
                                         scale, causal, window, softcap, stream);
    if (mode == 2)
        return launch_f32_rows<D, __nv_bfloat16>(q, k, v, o, st, B, T, S, Hq, Hkv, n_past,
                                                 n_tokens, scale, causal, window, softcap,
                                                 stream);
    if (mode != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma<D>(q, k, v, o, st, B, T, S, Hq, Hkv, n_past, n_tokens, scale, causal,
                           window, softcap, stream);
}

}  // namespace

// mode 0: q/k/v/o all bf16; 1: all f32; 2: q/o f32 over bf16 k/v.  Unit
// stride along D;
// strides: 12 element strides (b, t, h) for q, k, v, o in that order, each
// a multiple of 16 bytes, and 16-byte aligned q, k, v (mode 0 reads them
// through TMA).  D must be 64, 80, 96, 128 or 256; Hq % Hkv == 0; n_past +
// n_tokens <= S.
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
    if (D == 256)
        return launch<256>(mode, q, k, v, o, strides, B, T, S, Hq, Hkv, n_past, n_tokens,
                           scale, causal, window, softcap, st);
    if (D == 96)
        return launch<96>(mode, q, k, v, o, strides, B, T, S, Hq, Hkv, n_past, n_tokens,
                          scale, causal, window, softcap, st);
    if (D == 80)
        return launch<80>(mode, q, k, v, o, strides, B, T, S, Hq, Hkv, n_past, n_tokens,
                          scale, causal, window, softcap, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The split C (blocks per cluster) of the last mode 1 or 2 launch.
CL_EXPORT int flash_attention_last_splits() { return last_splits; }

// How many clusters of C blocks (1, 2, 4 or 8) of the f32 kernel of mode 1
// or 2 with bq-row blocks the card holds at once (-1: no such kernel; below:
// a CUDA error, negated).
CL_EXPORT int flash_attention_cluster_slots(int D, int mode, int bq, int C) {
    if (C != 1 && C != 2 && C != 4 && C != 8) return -1;
    if (mode == 1 && D == 128 && bq == 128) return cluster_slots<128, float, 128>(C);
    if (mode == 1 && D == 128 && bq == 64) return cluster_slots<128, float, 64>(C);
    if (mode == 1 && D == 64 && bq == 64) return cluster_slots<64, float, 64>(C);
    if (mode == 2 && D == 128 && bq == 128) return cluster_slots<128, __nv_bfloat16, 128>(C);
    if (mode == 2 && D == 128 && bq == 64) return cluster_slots<128, __nv_bfloat16, 64>(C);
    if (mode == 2 && D == 64 && bq == 64) return cluster_slots<64, __nv_bfloat16, 64>(C);
    if (mode == 1 && D == 256 && bq == 64) return cluster_slots<256, float, 64>(C);
    if (mode == 2 && D == 256 && bq == 64) return cluster_slots<256, __nv_bfloat16, 64>(C);
    if (mode == 1 && D == 96 && bq == 64) return cluster_slots<96, float, 64>(C);
    if (mode == 2 && D == 96 && bq == 64) return cluster_slots<96, __nv_bfloat16, 64>(C);
    if (mode == 1 && D == 80 && bq == 64) return cluster_slots<80, float, 64>(C);
    if (mode == 2 && D == 80 && bq == 64) return cluster_slots<80, __nv_bfloat16, 64>(C);
    return -1;
}
