// K4: flash decode, the attention of a few new tokens over the whole cache.
//
//   q [B, T, Hq, D] (bf16 or f32); cache k [B, S, Hkv, D] and v [B, S, Hkv,
//   Dv], int8 with f32 scales [B, S, Hkv] (the q8 cache) or bf16 / f32  ->
//   o [B, T, Hq, Dv] in q's dtype.  D = Dv = 64, 80, 96, 128 or 256, or (float dots only)
//   multi-head latent attention's expanded cache, D 192 (128 nope + 64 rope
//   dims) and Dv 128, with one query head per kv head
//
// Replaces chatllm_tpu/ops/pallas/flash_decode.py::flash_decode: with bf16
// or f32 dots its batched kernel `_batched_kernel` and its per-head kernel
// `_decode_kernel` (flash_decode_launch, `decode_kernel` below), with int8
// dots `_batched_kernel` (flash_decode_int8_launch), with the Pallas
// kernels' numerics.  The G*T query rows of kv head h are folded together:
// row r = g*T + t is query head h*G + g at position n_past[b] + t.  A key at
// position p is valid iff p < n_past[b] + n_tokens, p <= q_pos and, with a
// window W, p > q_pos - W; masked scores are -1e30.  The k scale multiplies
// the score after q.k (times the attention scale), the v scale multiplies
// the probability after the row sum has taken it, so the denominator sums
// the unscaled p.  Sinks join the denominator at the end and emit no value;
// the denominator is clamped at 1e-30.  With bf16 dots (the route's
// default) q and p * v_scale are rounded to bf16, as are the K/V of an f32
// cache; int8 and bf16 cache values are exact.  A bf16 x bf16 product is
// exact in f32, so the CUDA-core FMAs below match the tensor-core dots up
// to summation order.  f32 dots round nothing.
//
// Int8 dots (`_batched_kernel` with dot_dtype=int8, q8 cache only): each
// query row is quantized, qrow = max|q| / 127 (1 where 0), q8 =
// rint(q / qrow) clipped to +-127, and s = f32(q8 . k8) * (qrow * scale) *
// k_scale.  Per block of block_k keys (aligned at multiples of block_k from
// key 0) p = exp(s - m_block), l sums the unscaled p, then p * v_scale is
// quantized per row, psc = max p / 127 (1 where 0), pq = rint(p / psc), and
// the block adds f32(pq . v8) * psc.  The dots are dp4a's: integer sums of
// at most 512 products of magnitude <= 127^2, exact in int32 as in the s8
// MXU dots.  m_block is the block's own max over its live keys (the Pallas
// kernel's running max differs from it by a factor exp(-m) that cancels
// between p and psc up to float rounding); the blocks are weighed by their
// maxima in the cluster's merge as the Pallas kernel's running rescale
// weighs them.
//
// Up to 64 query rows G*T per kv head (Qwen2.5-0.5B's 7 heads per kv head
// at T = 8 are 56), 32 at D 256 (Gemma-3-1B's 4 at T = 8).  D 80 and 96
// (Phi-2's and Phi-3's heads) take the same designs: a row's 16-byte chunks
// (5 or 6 of int8, 10 or 12 of bf16) are split over the warps that share a
// key as evenly as they go, and P.V, whose DV / 4 = 20 or 24 threads across
// a row fill no power of two of the block, runs on the largest power of two
// of such groups that the block holds (8: 160 or 192 of its 256 threads).  D 256 (the Gemma
// family's heads) takes the same designs: its float-dot stages are 34 KB
// (int8), 66 KB (bf16) and 130 KB (f32: one stage, loads not overlapped),
// its int8-dot slots 18 KB.  The cache is read through element strides, the scales
// through their own (b, s, h) strides, so a [B, Hkv, S, D] cache and
// [B, Hkv, S] scales pass as permuted views.
//
// Bound on the H100: bytes.  A decode step reads every live key's K and V
// once per kv head (2 * D bytes for int8, plus 8 bytes of scales) and does
// 4 * D flops per (query row, key): at G*T = 4 rows (Llama-3, one token)
// that is 7.8 flops per byte.  At n_past 1000 a Llama-3-8B call reads ~2 MB,
// 0.64 us at 3.35 TB/s, below the card's per-launch floor: what a call
// costs is its chain of dependent latencies, not its bytes.
//
// Float dots (`decode_kernel`), the Hopper design.  The first design (one
// block of 128 threads per 256-key split, a grid sized by S; 32-key tiles
// loaded, widened to f32 in shared memory and consumed by the same threads;
// a second kernel merging the splits through f32 scratch) took ~53 us per
// Llama-3-8B call at n_past 1000.  Each part below answers one of its
// causes:
//  1. The work is sized by the live keys, on the device: one thread-block
//     cluster of C blocks of 256 threads per (batch row, kv head), C chosen
//     by the wrapper from the SM count and B * Hkv (ops/cuda/
//     flash_decode.py::decode_geometry; up to 16, above 8 with the
//     non-portable cluster attribute).  Each block reads its row's n_past,
//     takes the live keys [lo, hi) as 64-key tiles aligned at multiples of
//     64 (32-key tiles over an f32 cache at D 256: FGeom::TK), and its
//     share of them (`block_share`): a function of n_past and C
//     only, so a per-row n_past needs no read-back (the launch is
//     capturable in a CUDA graph) and results repeat bit for bit.
//  2. A ring of raw K/V tiles in shared memory in the cache's own dtype (an
//     int8 tile is 16 KB at D 128), filled by cp.async, up to 4 stages: the
//     next tiles' loads are in flight while a tile is worked on.
//  3. Each tile's k and v scales ride in its stage (4-byte cp.async), off
//     the score loop's dependent path.
//  4. K and V are widened to f32 in registers at use, each value once per
//     block where the rows are few.  Up to 8 rows (the main path's 4 and 7):
//     warp w dots quarter w % 4 of key half w / 4 (lane j: key 32 (w / 4) +
//     j, 16 bytes at a time; rows padded by 16 bytes, so the lanes' reads
//     fall on distinct banks; eighths of one 32-key tile over an f32 cache
//     at D 256) against every row, and the parts are summed
//     in shared memory; in P V thread i takes 4 columns of every row over
//     one of 256 / (D/4) slices of the tile's keys, the slices summed in
//     order at the end.  More rows: warp w takes rows w, w+8, ... over whole
//     key rows, thread i 4 columns of rows i / (D/4), + 256 / (D/4), ...
//     int8 values are widened by a byte permute and one subtract, not by the
//     quarter-rate integer conversion.  Warp w keeps the softmax state of
//     rows w, w+8, ...: the running max in every lane, the denominator as
//     per-lane shares summed once at the end.
//  5. The blocks of a cluster combine in the kernel: each stores its rows'
//     (max, denominator) and its accumulators into the shared memory of the
//     blocks that own those outputs, through distributed shared memory
//     (`Recv`, `send_acc`); after one cluster barrier the owners merge them
//     in rank order (`owner_merge`) and apply the sinks, the 1e-30 clamp and
//     the cast: one launch per call, no scratch in device memory, no
//     atomics.
//  6. The dots stay on the CUDA cores' FMAs.
//  7. K and V rows may differ in width (DK, DV): the ring's K tiles are DK
//     wide, its V tiles, the P V columns and the merged outputs DV wide.
//     MLA's (192, 128) is instantiated for up to 8 rows (G = 1, T <= 8), the
//     rows the JAX package's per-head kernel takes there with f32 dots; its
//     stages at 64 keys are 22 KB (int8), 42 KB (bf16) or 83 KB (f32), so 4,
//     2 and 2 stages fit the ring's 96 KB target.
//
// Int8 dots (`decode_int8_kernel`), the Hopper design.  The first design
// (one block of 128 threads per block_k-key quantization block, a grid
// sized by S; three serial passes staging K and V twice as f32 tiles;
// integer dots as f32 FMAs; scales read per key from device memory; a
// second kernel merging f32 scratch) took ~84 us per Llama-3-8B call at
// n_past 1000.  The same cluster, ring and merge as the float dots, and:
//  1. Shares count whole quantization blocks and tiles (`int8_share`,
//     ops/cuda/flash_decode.py::int8_share): with at least C live blocks
//     each rank takes a contiguous run of whole blocks; with fewer, live
//     block j goes to the contiguous ranks [j C / nb, (j + 1) C / nb), which
//     split its live 64-key tiles (aligned at the block's start) in rank
//     order.  The mode is the same in every rank of a cluster.
//  2. Ranks that share a block agree on its m and psc bit for bit: each
//     stores its rows' max of s, one cluster barrier, each takes the max
//     over its group through distributed shared memory; then the same for
//     the max of p * v_scale.  Every rank arrives at both barriers, with or
//     without keys.  fmaxf is exact, so the order of the group is moot.
//  3. The ring carries raw int8 K and V tiles (rows padded by 16 bytes),
//     per block its K tiles then its V tiles, each K tile with its k and v
//     scales; nothing is widened in shared memory.  Scores go to shared
//     memory ([R][<= 512] f32, one row per warp in the softmax), p * v_scale
//     in place, then pq as int8 over the first quarter of its own row.
//  4. q . k: thread (key j, row group) reads key row j 16 bytes at a time
//     and takes __dp4a against the packed q8 rows.  pq . v8: four keys of four
//     columns transposed by eight __byte_perm into four words of one column
//     each, __dp4a against the pq word of each row, int32 sums per block,
//     scaled by psc (times the rank's rescale) once per block.
//  5. One launch: the partials (m, l, acc) go to their owners through
//     distributed shared memory and merge in rank order (`owner_merge`),
//     which is key order; no scratch, no atomics, the same bits each launch.
//  6. Up to 8 rows, two blocks per SM (__launch_bounds__, 128 registers a
//     thread, no spills): unbounded, the kernel took 214 registers, one
//     block per SM, and a 16-block cluster then needs 16 free SMs of one
//     GPC, so some of a call's clusters waited for a second round.
#include <math_constants.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FTHREADS = 256;     // threads per block (both kernels)
constexpr int FWARPS = FTHREADS / 32;
constexpr int FTK = 64;           // keys per tile
constexpr int MAX_ROWS = 64;      // query rows G*T per kv head (flash_decode.py MAX_ROWS)
constexpr int MAX_BLOCK_K = 512;  // keys per quantization block of the int8 dots at most
constexpr int MAX_CLUSTER = 16;   // blocks per (batch row, kv head) (flash_decode.py MAX_CLUSTER)
constexpr float NEG_INF = -1e30f;

struct Strides { long b, t, h; };

// The largest power of two <= n: the groups of CW threads that share P V's
// keys or rows (a D 80 or 96 row's 20 or 24 threads leave the rest idle).
__host__ __device__ constexpr int pow2_floor(int n) { return n < 2 ? 1 : 2 * pow2_floor(n / 2); }

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const float* ks;            // [B, S, Hkv] through kss, or null for a float cache
    const float* vs;            //   through vss
    const float* sinks;         // [Hq] or null
    const long long* np_vec;    // [B] per-row n_past, or null: np_scalar
    long long np_scalar;
    void* o;
    Strides qs, kst, vst, os;   // element strides of q, k, v, o
    Strides kss, vss;           // element strides (b, s, h) of ks, vs
    // split: keys per quantization block (int8 dots) or per tile (FTK);
    // n_splits: blocks per cluster
    int T, S, Hq, Hkv, n_tokens, window, q_kind, bf16_dots, split, n_splits;
    float scale, softcap;
};

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// Four int8 values of a 32-bit word as f32, exactly, without the
// quarter-rate integer conversion: each byte, biased by 128, becomes the
// low mantissa byte of 2^23 (byte_perm), and one subtract of 2^23 + 128
// leaves the value.
__device__ __forceinline__ void i8x4_f32(uint32_t w, float* out) {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int c = 0; c < 4; ++c)
        out[c] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + c)) - 8388736.f;
}

__device__ __forceinline__ void cvt(const uint4& u, float* out, int8_t) {
    i8x4_f32(u.x, out);
    i8x4_f32(u.y, out + 4);
    i8x4_f32(u.z, out + 8);
    i8x4_f32(u.w, out + 12);
}

__device__ __forceinline__ void cvt(const uint4& u, float* out, __nv_bfloat16) {
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int c = 0; c < 8; ++c) out[c] = __bfloat162float(e[c]);
}

__device__ __forceinline__ void cvt(const uint4& u, float* out, float) {
    const float* e = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = e[c];
}

// Four consecutive cache values in shared memory as f32.
__device__ __forceinline__ float4 load4(const int8_t* p) {
    float f[4];
    i8x4_f32(*reinterpret_cast<const uint32_t*>(p), f);
    return make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

// N values at stride `st`, summed as a pairwise tree
template <int N>
__device__ __forceinline__ float tree_sum(const float* x, int st) {
    if constexpr (N == 1) return x[0];
    else return tree_sum<N / 2>(x, st) + tree_sum<N / 2>(x + N / 2 * st, st);
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp4(void* smem, const void* gmem, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(s), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Row b's n_past and the keys [lo, hi) some of its query rows may see:
// below the newest written key and, with a window, inside the oldest row's.
__device__ __forceinline__ void live_keys(const Params& p, int b, long long& np, int& lo,
                                          int& hi) {
    np = p.np_vec ? p.np_vec[b] : p.np_scalar;
    const long long h = np + p.n_tokens;
    const long long l = p.window > 0 ? np - p.window + 1 : 0;
    hi = static_cast<int>(min(max(h, 0LL), static_cast<long long>(p.S)));
    lo = static_cast<int>(min(max(l, 0LL), static_cast<long long>(p.S)));
}

__device__ __forceinline__ float load_q(const Params& p, long off) {
    return p.q_kind == KIND_F32 ? static_cast<const float*>(p.q)[off]
                                : __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[off]);
}

// The masked (softcapped) score of row r at key kp, from its raw dot.
__device__ __forceinline__ float finish_score(const Params& p, float s, long long np, int r,
                                              int kp, bool in_tile) {
    if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
    const long long qpos = np + r % p.T;
    bool ok = in_tile && kp < np + p.n_tokens && kp <= qpos;
    if (p.window > 0) ok = ok && kp > qpos - p.window;
    return ok ? s : NEG_INF;
}

// sinks, the 1e-30 clamp and the cast: o[b, t, h*G + g, c] from a row's
// merged max m, denominator l and accumulator a (m = -inf: no live key)
__device__ __forceinline__ void write_out(const Params& p, int b, int h, int r, int c, float m,
                                          float l, float a) {
    const int G = p.Hq / p.Hkv, g = r / p.T, t = r - g * p.T;
    float sc;
    if (p.sinks) {
        const float sink = p.sinks[h * G + g];
        const float m_f = fmaxf(m, sink);
        l = l * expf(m - m_f) + expf(sink - m_f);
        sc = expf(m - m_f) / fmaxf(l, 1e-30f);
    } else {
        sc = 1.f / fmaxf(l, 1e-30f);
    }
    const long off = b * p.os.b + t * p.os.t + static_cast<long>(h * G + g) * p.os.h + c;
    if (p.q_kind == KIND_F32)
        static_cast<float*>(p.o)[off] = a * sc;
    else
        static_cast<__nv_bfloat16*>(p.o)[off] = __float2bfloat16_rn(a * sc);
}

// Block `rank` of C takes the live tiles [ta, tb) of TK keys: the tiles
// aligned at multiples of TK that meet [lo, hi), in C contiguous runs in
// rank order (ops/cuda/flash_decode.py::decode_share).
template <int TK>
__device__ __forceinline__ void block_share(int lo, int hi, int rank, int C, int& ta, int& tb) {
    const int t0 = lo / TK, nt = hi > lo ? (hi + TK - 1) / TK - t0 : 0;
    ta = t0 + static_cast<int>(static_cast<long>(rank) * nt / C);
    tb = t0 + static_cast<int>(static_cast<long>(rank + 1) * nt / C);
}

// The cluster's merge.  Block o of the cluster owns the outputs [o SP,
// (o + 1) SP) of the flattened [R, D] output (SP, the span: R D / C rounded
// up to 4).  Every block stores its partial accumulators of them, under its
// own rank, and its rows' (max, denominator) into the owner's receive buffer
// through distributed shared memory.  After one cluster barrier each owner
// merges what it received in rank order.
struct Recv {
    __host__ __device__ static int span(int R, int D, int C) {
        return ((R * D + C - 1) / C + 3) / 4 * 4;
    }
    // racc [C][SP], rml [C][R][2], then the merge's weights [R][C] and maxima [R]
    __host__ __device__ static int bytes(int R, int D, int C) {
        return 4 * (C * (span(R, D, C) + 2 * R) + R * (C + 1));
    }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// N (1 or 4) partials of consecutive outputs idx .. idx + N - 1 (one owner)
template <int N>
__device__ __forceinline__ void send_acc(cg::cluster_group& cluster, float* racc, int idx,
                                         int span, const float* a) {
    float* dst = cluster.map_shared_rank(racc, idx / span) + blockIdx.x * span + idx % span;
    if constexpr (N == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
    else
        *dst = a[0];
}

// row r's (max (-inf: no live key in this block's share), denominator) to
// the owners of its outputs
__device__ __forceinline__ void send_ml(cg::cluster_group& cluster, float* rml, int R, int D,
                                        int span, int r, float m, float l) {
    for (int o = r * D / span; o <= ((r + 1) * D - 1) / span; ++o)
        *reinterpret_cast<float2*>(cluster.map_shared_rank(rml, o) + (blockIdx.x * R + r) * 2) =
            make_float2(m, l);
}

// The owner's merge of its outputs, in rank order, and their output.  The
// weights exp(m_s - m) of the rows it touches are taken once, into ws; a
// block with no live key (max -inf) weighs 0, and its partials are 0.
__device__ __forceinline__ void owner_merge(const Params& p, const float* racc, const float* rml,
                                            float* ws, int R, int D, int span, int b, int h) {
    const int C = gridDim.x, base = blockIdx.x * span;
    const int r0 = base / D, nr = base < R * D ? min(R, (base + span - 1) / D + 1) - r0 : 0;
    for (int t = threadIdx.x; t < nr * C; t += FTHREADS) {
        const int r = r0 + t / C, s = t - (t / C) * C;
        float m = -CUDART_INF_F;
#pragma unroll
        for (int s2 = 0; s2 < MAX_CLUSTER; ++s2)
            if (s2 < C) m = fmaxf(m, rml[(s2 * R + r) * 2]);
        const float ms = rml[(s * R + r) * 2];
        ws[t] = ms == -CUDART_INF_F ? 0.f : expf(ms - m);
        if (s == 0) ws[nr * C + t / C] = m;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < span && base + j < R * D; j += FTHREADS) {
        const int idx = base + j, r = idx / D;
        const float* w = ws + (r - r0) * C;
        float l = 0.f, a = 0.f;
#pragma unroll
        for (int s = 0; s < MAX_CLUSTER; ++s) {
            if (s >= C) break;
            l = fmaf(rml[(s * R + r) * 2 + 1], w[s], l);
            a = fmaf(racc[s * span + j], w[s], a);
        }
        write_out(p, b, h, r, idx - r * D, ws[nr * C + r - r0], l, a);
    }
}

// The float-dot kernel's shared memory: a ring of STAGES stages, each a
// TK-key K tile (DK wide, rows padded by 16 bytes), a V tile (DV wide) and
// the tile's k and v scales, all in the cache's dtype; after the last tile
// the ring's space takes, with few rows, the key slices' partials [ZS, R,
// DV].  Then, in f32: q [R, DK], with few rows the warps' partial dots
// [FWARPS, R, 32], p * v_scale [R, TK], the tile's rescale factors [R], and
// the receive buffer of the cluster's merge (Recv, over the [R, DV] output).
template <int DK, int DV, typename KV, int MAXR>
struct FGeom {
    static constexpr bool FEW = MAXR <= 8;
    static constexpr int KROWB = DK * static_cast<int>(sizeof(KV));  // bytes of a K row
    static constexpr int VROWB = DV * static_cast<int>(sizeof(KV));  // bytes of a V row
    static constexpr int KROW = KROWB + 16;
    static constexpr int KNCH = KROWB / 16;                          // 16-byte chunks per K row
    static constexpr int VNCH = VROWB / 16;                          // ... per V row
    static constexpr int VEC = 16 / static_cast<int>(sizeof(KV));    // values per chunk
    // keys per tile: FTK, or half that over an f32 cache at D 256, whose
    // 64-key stage (130 KB) leaves no room for a second
    static constexpr int TK = sizeof(KV) == 4 && DK == 256 ? FTK / 2 : FTK;
    static constexpr int KPL = TK / 32;            // keys per lane in the softmax
    static constexpr int DQ = FWARPS / KPL;        // FEW: warps sharing a key's dots
    static constexpr int VOFF = TK * KROW;
    static constexpr int SOFF = VOFF + TK * VROWB;
    static constexpr int STAGE = SOFF + 2 * TK * 4;
    static constexpr int FIT = 96 * 1024 / STAGE;
    static constexpr int STAGES = FIT > 4 ? 4 : FIT >= 2 ? FIT : 2;   // near the 96 KB target
    static_assert(STAGES * STAGE <= 200 * 1024, "two stages beside q and the merge buffers");
    static constexpr int CW = DV / 4;              // threads across a row in P V, 4 columns each
    static constexpr int ZS = pow2_floor(FTHREADS / CW);   // key slices (FEW) or rows in P V

    __host__ __device__ static int ring_bytes(int R) {
        const int part = FEW ? ZS * R * DV * 4 : 0;
        const int ring = STAGES * STAGE > part ? STAGES * STAGE : part;
        return (ring + 15) / 16 * 16;
    }
    __host__ __device__ static int recv_offset(int R) {
        return (ring_bytes(R) + 4 * (R * DK + (FEW ? FWARPS * R * 32 : 0) + R * TK + R) + 15) /
               16 * 16;
    }
    __host__ __device__ static int smem_bytes(int R, int C) {
        return recv_offset(R) + Recv::bytes(R, DV, C);
    }
};

template <int DK, int DV, typename KV, int MAXR>
__global__ void __launch_bounds__(FTHREADS)
decode_kernel(Params p) {
    using Gm = FGeom<DK, DV, KV, MAXR>;
    constexpr bool FEW = Gm::FEW;
    constexpr int NOWN = (MAXR + FWARPS - 1) / FWARPS;   // rows whose softmax a warp keeps
    constexpr int CW = Gm::CW, ZS = Gm::ZS, TK = Gm::TK, KPL = Gm::KPL, DQ = Gm::DQ;
    constexpr int NACC = FEW ? MAXR : MAXR / ZS;
    static_assert(Gm::KNCH >= Gm::VNCH, "the tile copy takes V no wider than K");
    // FEW: chunks of a warp's part of a key row; the last parts may be short
    // (D 80 and 96: 5 or 6 int8 chunks, 10 or 12 bf16 ones over 4 parts)
    constexpr int QCH = (Gm::KNCH + DQ - 1) / DQ;
    constexpr int KZ = TK / ZS;                  // FEW: keys per slice in P V
    extern __shared__ __align__(16) uint8_t smem[];
    cg::cluster_group cluster = cg::this_cluster();

    cluster_arrive_relaxed();                        // this block has started
    const int G = p.Hq / p.Hkv, R = G * p.T;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int h = blockIdx.y, b = blockIdx.z;
    const KV* kb = static_cast<const KV*>(p.k) + b * p.kst.b + h * p.kst.h;
    const KV* vb = static_cast<const KV*>(p.v) + b * p.vst.b + h * p.vst.h;
    const float* ksb = p.ks ? p.ks + b * p.kss.b + h * p.kss.h : nullptr;
    const float* vsb = p.ks ? p.vs + b * p.vss.b + h * p.vss.h : nullptr;
    long long np;
    int lo, hi, ta, tb;
    live_keys(p, b, np, lo, hi);
    block_share<TK>(lo, hi, blockIdx.x, gridDim.x, ta, tb);

    // tile t into its stage; keys outside [lo, hi) are zero-filled
    auto issue = [&](int t) {
        uint8_t* st = smem + ((t - ta) % Gm::STAGES) * Gm::STAGE;
        // one pass over a key's chunks copies its K and V chunks together
        // (for K wider than V, the last KNCH - VNCH chunks are K's alone)
        for (int idx = tid; idx < TK * Gm::KNCH; idx += FTHREADS) {
            const int j = idx / Gm::KNCH, c = idx - j * Gm::KNCH, kp = t * TK + j;
            const bool ok = kp >= lo && kp < hi;
            cp16(st + j * Gm::KROW + c * 16, ok ? kb + kp * p.kst.t + c * Gm::VEC : kb, ok);
            if (c < Gm::VNCH)
                cp16(st + Gm::VOFF + j * Gm::VROWB + c * 16,
                     ok ? vb + kp * p.vst.t + c * Gm::VEC : vb, ok);
        }
        if (ksb && tid < 2 * TK) {
            const int kp = t * TK + (tid & (TK - 1));
            const bool ok = kp >= lo && kp < hi;
            const float* src = tid < TK ? (ok ? ksb + kp * p.kss.t : ksb)
                                        : (ok ? vsb + kp * p.vss.t : vsb);
            cp4(st + Gm::SOFF + tid * 4, src, ok);
        }
    };
#pragma unroll
    for (int s = 0; s < Gm::STAGES - 1; ++s) {
        if (ta + s < tb) issue(ta + s);
        cp_commit();
    }
    float* sq = reinterpret_cast<float*>(smem + Gm::ring_bytes(R));
    float* spart = sq + R * DK;              // FEW: [FWARPS][R][32] partial dots
    float* sp = spart + (FEW ? FWARPS * R * 32 : 0);   // [R][TK]: p * v_scale of the tile
    float* scorr = sp + R * TK;              // [R]: the tile's rescale factor
    for (int idx = tid; idx < R * DK; idx += FTHREADS) {   // in flight beside the tiles' loads
        const int r = idx / DK, c = idx - r * DK, g = r / p.T, t = r - g * p.T;
        const float x = load_q(p, b * p.qs.b + t * p.qs.t + static_cast<long>(h * G + g) * p.qs.h + c);
        sq[idx] = p.bf16_dots ? round_bf16(x) : x;
    }

    // the keys [rlo, rhi) that row w + FWARPS i may see (the mask of
    // finish_score, for keys in [lo, hi))
    int rlo[NOWN], rhi[NOWN];
#pragma unroll
    for (int i = 0; i < NOWN; ++i) {
        const long long qpos = np + (warp + FWARPS * i) % p.T;
        rhi[i] = static_cast<int>(min(qpos + 1, static_cast<long long>(p.S)));
        rlo[i] = p.window > 0 ? static_cast<int>(max(qpos - p.window + 1, 0LL)) : 0;
    }
    const bool round_kv = p.bf16_dots && sizeof(KV) == 4;
    // m_run: the row's running max in every lane; l_run: the lane's share of
    // its denominator (summed over the warp at the end)
    float m_run[NOWN], l_run[NOWN], acc[NACC][4];
#pragma unroll
    for (int i = 0; i < NOWN; ++i) {
        m_run[i] = NEG_INF;
        l_run[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    const int c4 = (tid % CW) * 4, z = tid / CW;
    const bool in_pv = z < ZS;               // this thread takes part in P V

    for (int t = ta; t < tb; ++t) {
        cp_wait<Gm::STAGES - 2>();
        __syncthreads();   // tile t has landed; every thread is done with tile t - 1
        if (t + Gm::STAGES - 1 < tb) issue(t + Gm::STAGES - 1);
        cp_commit();
        const uint8_t* st = smem + ((t - ta) % Gm::STAGES) * Gm::STAGE;
        const KV* sv = reinterpret_cast<const KV*>(st + Gm::VOFF);
        const float* ssc = reinterpret_cast<const float*>(st + Gm::SOFF);
        // lane j holds keys t * TK + k * 32 + j, k < KPL
        int kp[KPL];
        bool in[KPL];
#pragma unroll
        for (int k = 0; k < KPL; ++k) {
            kp[k] = t * TK + k * 32 + lane;
            in[k] = kp[k] >= lo && kp[k] < hi;
        }

        // Raw dots s[i][k] of row w + FWARPS i with key k * 32 + lane.  Few
        // rows: warp w dots part w % DQ (of DQ) of key half w / DQ against
        // every row and leaves it in spart; many rows: whole key rows.
        float s[NOWN][KPL];
        if constexpr (FEW) {
            const int kh = warp / DQ, qd = warp % DQ;
            float sw[MAXR];
#pragma unroll
            for (int r = 0; r < MAXR; ++r) sw[r] = 0.f;
            const uint8_t* kr = st + (kh * 32 + lane) * Gm::KROW + qd * QCH * 16;
#pragma unroll
            for (int c = 0; c < QCH; ++c) {
                if (Gm::KNCH % DQ && qd * QCH + c >= Gm::KNCH) break;
                float kf[Gm::VEC];
                cvt(*reinterpret_cast<const uint4*>(kr + c * 16), kf, KV{});
                if (round_kv) {
#pragma unroll
                    for (int e = 0; e < Gm::VEC; ++e) kf[e] = round_bf16(kf[e]);
                }
#pragma unroll
                for (int r = 0; r < MAXR; ++r) {
                    if (r >= R) break;
                    const float* qr = sq + r * DK + (qd * QCH + c) * Gm::VEC;
#pragma unroll
                    for (int e = 0; e < Gm::VEC; e += 4) {
                        const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
                        sw[r] = fmaf(q4.x, kf[e], sw[r]);
                        sw[r] = fmaf(q4.y, kf[e + 1], sw[r]);
                        sw[r] = fmaf(q4.z, kf[e + 2], sw[r]);
                        sw[r] = fmaf(q4.w, kf[e + 3], sw[r]);
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < MAXR; ++r) {
                if (r >= R) break;
                spart[(warp * R + r) * 32 + lane] = sw[r];
            }
            __syncthreads();
            if (warp < R) {
#pragma unroll
                for (int k = 0; k < KPL; ++k)
                    s[0][k] = tree_sum<DQ>(spart + (DQ * k * R + warp) * 32 + lane, R * 32);
            }
        } else {
#pragma unroll
            for (int i = 0; i < NOWN; ++i) {
#pragma unroll
                for (int k = 0; k < KPL; ++k) s[i][k] = 0.f;
            }
#pragma unroll
            for (int k = 0; k < KPL; ++k) {
                const uint8_t* kr = st + (k * 32 + lane) * Gm::KROW;
#pragma unroll
                for (int c = 0; c < Gm::KNCH; ++c) {
                    float kf[Gm::VEC];
                    cvt(*reinterpret_cast<const uint4*>(kr + c * 16), kf, KV{});
                    if (round_kv) {
#pragma unroll
                        for (int e = 0; e < Gm::VEC; ++e) kf[e] = round_bf16(kf[e]);
                    }
#pragma unroll
                    for (int i = 0; i < NOWN; ++i) {
                        const int r = warp + FWARPS * i;
                        if (r >= R) break;
                        const float* qr = sq + r * DK + c * Gm::VEC;
#pragma unroll
                        for (int e = 0; e < Gm::VEC; e += 4) {
                            const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
                            s[i][k] = fmaf(q4.x, kf[e], s[i][k]);
                            s[i][k] = fmaf(q4.y, kf[e + 1], s[i][k]);
                            s[i][k] = fmaf(q4.z, kf[e + 2], s[i][k]);
                            s[i][k] = fmaf(q4.w, kf[e + 3], s[i][k]);
                        }
                    }
                }
            }
        }

        // the online softmax of rows w, w+8, ... over the tile's TK keys
        float ksc[KPL], vsc[KPL];
#pragma unroll
        for (int k = 0; k < KPL; ++k) {
            ksc[k] = ksb ? ssc[k * 32 + lane] : 1.f;
            vsc[k] = ksb ? ssc[TK + k * 32 + lane] : 1.f;
        }
#pragma unroll
        for (int i = 0; i < NOWN; ++i) {
            const int r = warp + FWARPS * i;
            if (r >= R) break;
            float x[KPL], mx = -CUDART_INF_F;
#pragma unroll
            for (int k = 0; k < KPL; ++k) {
                x[k] = s[i][k] * p.scale;
                if (ksb) x[k] *= ksc[k];
                if (p.softcap > 0.f) x[k] = tanhf(x[k] / p.softcap) * p.softcap;
                // keys outside [lo, hi) take no part; masked ones do, with
                // -1e30, as in the Pallas kernel (weight 0 once a valid key
                // sets the max)
                x[k] = kp[k] >= rlo[i] && kp[k] < rhi[i] ? x[k] : NEG_INF;
                mx = fmaxf(mx, in[k] ? x[k] : -CUDART_INF_F);
            }
            const float m_new = fmaxf(m_run[i], warp_max(mx));
            const float corr = expf(m_run[i] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int k = 0; k < KPL; ++k) {
                const float pk = in[k] ? expf(x[k] - m_new) : 0.f, pv = pk * vsc[k];
                psum += pk;
                sp[r * TK + k * 32 + lane] = p.bf16_dots ? round_bf16(pv) : pv;
            }
            l_run[i] = l_run[i] * corr + psum;
            m_run[i] = m_new;
            if (lane == 0) scorr[r] = corr;
        }
        __syncthreads();

        // O += P V over columns c4 .. c4 + 3: few rows, every row over the
        // keys of slice z; many rows, rows z, z + ZS, ... over every key.
        // (p and the zero-filled V rows of keys outside [lo, hi) are 0.)
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
            const int r = FEW ? i : z + ZS * i;
            if (!in_pv || r >= R) break;
            const float corr = scorr[r];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] *= corr;
        }
#pragma unroll 2
        for (int jb = 0; jb < (in_pv ? (FEW ? KZ : TK) : 0); jb += 4) {
            const int j = FEW ? z * KZ + jb : jb;
            float4 v[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                v[jj] = load4(sv + (j + jj) * DV + c4);
                if (round_kv)
                    v[jj] = make_float4(round_bf16(v[jj].x), round_bf16(v[jj].y),
                                        round_bf16(v[jj].z), round_bf16(v[jj].w));
            }
#pragma unroll
            for (int i = 0; i < NACC; ++i) {
                const int r = FEW ? i : z + ZS * i;
                if (r >= R) break;
                const float4 p4 = *reinterpret_cast<const float4*>(sp + r * TK + j);
                const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    acc[i][0] = fmaf(pj[jj], v[jj].x, acc[i][0]);
                    acc[i][1] = fmaf(pj[jj], v[jj].y, acc[i][1]);
                    acc[i][2] = fmaf(pj[jj], v[jj].z, acc[i][2]);
                    acc[i][3] = fmaf(pj[jj], v[jj].w, acc[i][3]);
                }
            }
        }
    }

    // The block's partials go to their owners (few rows: the key slices,
    // left where the ring was, summed in slice order first).
    cp_wait<0>();
    __syncthreads();
    const int span = Recv::span(R, DV, gridDim.x);
    float* racc = reinterpret_cast<float*>(smem + Gm::recv_offset(R));
    float* rml = racc + gridDim.x * span;
    if constexpr (FEW) {
        float* pz = reinterpret_cast<float*>(smem);    // [ZS][R][DV]
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
            if (!in_pv || r >= R) break;
            float* dst = pz + (z * R + r) * DV + c4;
            dst[0] = acc[r][0];
            dst[1] = acc[r][1];
            dst[2] = acc[r][2];
            dst[3] = acc[r][3];
        }
        __syncthreads();
        cluster_wait();    // every block of the cluster has started: owners may be written
        for (int idx = tid; idx < R * DV; idx += FTHREADS) {
            float a = pz[idx];
#pragma unroll
            for (int zz = 1; zz < ZS; ++zz) a += pz[zz * R * DV + idx];
            send_acc<1>(cluster, racc, idx, span, &a);
        }
    } else {
        cluster_wait();
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
            const int r = z + ZS * i;
            if (!in_pv || r >= R) break;
            send_acc<4>(cluster, racc, r * DV + c4, span, acc[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < NOWN; ++i) {
        const int r = warp + FWARPS * i;
        if (r >= R) break;
        const float l = warp_sum(l_run[i]);
        if (lane == 0)
            send_ml(cluster, rml, R, DV, span, r, ta < tb ? m_run[i] : -CUDART_INF_F, l);
    }
    cluster.sync();        // every partial has landed
    owner_merge(p, racc, rml, rml + gridDim.x * R * 2, R, DV, span, b, h);
}

// The live tiles [u0, u1) of quantization block j (keys [j bk, (j + 1) bk)):
// its FTK-key tiles, aligned at the block's first key, that meet [lo, hi).
__device__ __forceinline__ void block_tiles(int j, int lo, int hi, int bk, int& u0, int& u1) {
    const int base = j * bk, a = max(base, lo), e = min(base + bk, hi);
    u0 = (a - base) / FTK;
    u1 = e > a ? (e - base + FTK - 1) / FTK : u0;
}

// What rank `rank` of C takes of the live keys [lo, hi) in quantization
// blocks of bk keys (ops/cuda/flash_decode.py::int8_share): with nb >= C
// live blocks the whole blocks [j0, j1) (each its live tiles); with 0 < nb
// < C live block j = ((rank + 1) nb - 1) / C, shared by the ranks [g0, g0 +
// gn) = [j C / nb, (j + 1) C / nb), the i-th of which takes the tiles
// [u0 + i n / gn, u0 + (i + 1) n / gn) of its n live tiles [u0, u1).
struct I8Share {
    int j0, j1;      // quantization blocks
    int u0, u1;      // shared: this rank's tiles of block j0
    int g0, gn;      // shared: the ranks that take block j0
    bool shared;     // 0 < nb < C: the same in every rank of the cluster
};

__device__ __forceinline__ I8Share int8_share(int lo, int hi, int bk, int rank, int C) {
    I8Share s{0, 0, 0, 0, rank, 1, false};
    if (hi <= lo) return s;
    const int q0 = lo / bk, nb = (hi + bk - 1) / bk - q0;
    if (nb >= C) {
        s.j0 = q0 + static_cast<int>(static_cast<long>(rank) * nb / C);
        s.j1 = q0 + static_cast<int>(static_cast<long>(rank + 1) * nb / C);
        return s;
    }
    const int j = ((rank + 1) * nb - 1) / C;
    s.shared = true;
    s.j0 = q0 + j;
    s.j1 = s.j0 + 1;
    s.g0 = j * C / nb;
    s.gn = (j + 1) * C / nb - s.g0;
    int u0, u1;
    block_tiles(s.j0, lo, hi, bk, u0, u1);
    const int i = rank - s.g0, n = u1 - u0;
    s.u0 = u0 + i * n / s.gn;
    s.u1 = u0 + (i + 1) * n / s.gn;
    return s;
}

// The int8 kernel's shared memory: a ring of STAGES slots, each one 64-key
// K or V tile of raw int8 rows padded by 16 bytes, a K tile's slot also its
// k and v scales (with few rows the ring's space takes the key slices'
// partials [ZS, R, D] at the end); then the block's scores [R][SSK] f32
// (p * v_scale in place, then pq as int8 over each row's first SSK bytes),
// its v scales [SSK], q8 [R][D], and per row in f32 qrow * scale, the two
// exchanged maxima (s; p * v_scale), the block's max and denominator, the
// rank's rescale factors (old accumulators; new ones, times psc), the
// rank's running max and denominator; then the merge's receive buffer.
template <int D, int MAXR>
struct IGeom {
    static constexpr bool FEW = MAXR <= 8;
    static constexpr int KROW = D + 16;
    static constexpr int NCH = D / 16;             // 16-byte chunks per row
    static constexpr int SOFF = FTK * KROW;
    static constexpr int SLOT = SOFF + 2 * FTK * 4;
    static constexpr int STAGES = 4;
    static constexpr int CW = D / 4;               // threads across a row in P V, 4 columns each
    static constexpr int ZS = pow2_floor(FTHREADS / CW);   // key slices (FEW) or rows in P V
    static constexpr int NSTAT = 9;                // the per-row f32 arrays

    // score columns per row: a block's tiles, rounded up to 128 (whole
    // 32-lane x 4-key chunks when pq is written over the row)
    __host__ __device__ static int ssk(int bk) {
        return ((bk + FTK - 1) / FTK * FTK + 127) / 128 * 128;
    }
    __host__ __device__ static int ring_bytes(int R) {
        const int part = FEW ? ZS * R * D * 4 : 0;
        return STAGES * SLOT > part ? STAGES * SLOT : part;
    }
    __host__ __device__ static int recv_offset(int R, int bk) {
        return (ring_bytes(R) + 4 * (R * ssk(bk) + ssk(bk)) + R * D + 4 * NSTAT * R + 15) / 16 * 16;
    }
    __host__ __device__ static int smem_bytes(int R, int bk, int C) {
        return recv_offset(R, bk) + Recv::bytes(R, D, C);
    }
};

// Four int8 keys of four columns (word i: key i, columns 0-3) as four words
// of one column each (word c: column c, keys 0-3).
__device__ __forceinline__ void transpose4x4(const uint32_t* w, int* col) {
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
    col[0] = static_cast<int>(__byte_perm(t0, t2, 0x5410));
    col[1] = static_cast<int>(__byte_perm(t0, t2, 0x7632));
    col[2] = static_cast<int>(__byte_perm(t1, t3, 0x5410));
    col[3] = static_cast<int>(__byte_perm(t1, t3, 0x7632));
}

// The max over the group's ranks of their rows' value x[r] (the group may
// be this rank alone).
__device__ __forceinline__ float group_max(cg::cluster_group& cluster, float* x, int r,
                                           const I8Share& sh) {
    if (sh.gn == 1) return x[r];
    float m = -CUDART_INF_F;
    for (int g = sh.g0; g < sh.g0 + sh.gn; ++g) m = fmaxf(m, cluster.map_shared_rank(x, g)[r]);
    return m;
}

// Few rows: two blocks per SM (at most 128 registers a thread), so that
// the 16-block clusters of a call do not wait for whole free GPCs.
template <int D, int MAXR>
__global__ void __launch_bounds__(FTHREADS, MAXR <= 8 ? 2 : 1)
decode_int8_kernel(Params p) {
    using Gm = IGeom<D, MAXR>;
    constexpr bool FEW = Gm::FEW;
    constexpr int CW = Gm::CW, ZS = Gm::ZS, STAGES = Gm::STAGES;
    constexpr int NACC = FEW ? MAXR : MAXR / ZS;
    constexpr int KZ = FTK / ZS;                 // FEW: keys per slice in P V
    constexpr int RG = FTHREADS / FTK;           // row groups in q . k
    constexpr int NRA = (MAXR + RG - 1) / RG;    // rows per thread in q . k
    extern __shared__ __align__(16) uint8_t smem[];
    cg::cluster_group cluster = cg::this_cluster();

    const int G = p.Hq / p.Hkv, R = G * p.T, bk = p.split;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int h = blockIdx.y, b = blockIdx.z;
    long long np;
    int lo, hi;
    live_keys(p, b, np, lo, hi);
    const I8Share sh = int8_share(lo, hi, bk, blockIdx.x, gridDim.x);
    // this block has started (shared blocks: the first exchange says so)
    if (!sh.shared) cluster_arrive_relaxed();

    const int SSK = Gm::ssk(bk);
    float* ss = reinterpret_cast<float*>(smem + Gm::ring_bytes(R));   // [R][SSK]
    float* svs = ss + R * SSK;                                        // [SSK]
    int8_t* sq8 = reinterpret_cast<int8_t*>(svs + SSK);                // [R][D]
    float* sqsc = reinterpret_cast<float*>(sq8 + R * D);
    float* smax = sqsc + R;      // exchanged: the rank's max of s over the block
    float* spmax = smax + R;     // exchanged: its max of p * v_scale
    float* sm = spmax + R;       // the block's max
    float* sl = sm + R;          // the rank's denominator over the block
    float* sfo = sl + R;         // the rank's rescale of its older blocks
    float* sfn = sfo + R;        //   and of this block's sums (times psc)
    float* sM = sfn + R;         // the rank's running max (-inf: no key yet)
    float* sL = sM + R;          //   and denominator

    const int8_t* kb = static_cast<const int8_t*>(p.k) + b * p.kst.b + h * p.kst.h;
    const int8_t* vb = static_cast<const int8_t*>(p.v) + b * p.vst.b + h * p.vst.h;
    const float* ksb = p.ks + b * p.kss.b + h * p.kss.h;
    const float* vsb = p.vs + b * p.vss.b + h * p.vss.h;
    auto tiles = [&](int j, int& u0, int& u1) {
        if (sh.shared) {
            u0 = sh.u0;
            u1 = sh.u1;
        } else {
            block_tiles(j, lo, hi, bk, u0, u1);
        }
    };

    // The copy ring's producer walks, per block, its K tiles then its V
    // tiles; keys outside the block's live keys are zero-filled.
    int pj = sh.j0, pv = 0, pt = 0, pu1 = 0;
    if (pj < sh.j1) tiles(pj, pt, pu1);
    bool pmore = pj < sh.j1 && pt < pu1;
    auto issue = [&](int slot) {
        uint8_t* st = smem + slot * Gm::SLOT;
        const int base = pj * bk + pt * FTK;
        const int ka = max(lo, pj * bk), kz = min(hi, pj * bk + bk);
        const int8_t* src = pv ? vb : kb;
        const long rs = pv ? p.vst.t : p.kst.t;
        for (int idx = tid; idx < FTK * Gm::NCH; idx += FTHREADS) {
            const int j = idx / Gm::NCH, c = idx - j * Gm::NCH, kp = base + j;
            const bool ok = kp >= ka && kp < kz;
            cp16(st + j * Gm::KROW + c * 16, ok ? src + kp * rs + c * 16 : src, ok);
        }
        if (!pv && tid < 2 * FTK) {
            const int kp = base + (tid & (FTK - 1));
            const bool ok = kp >= ka && kp < kz;
            const float* s = tid < FTK ? (ok ? ksb + kp * p.kss.t : ksb)
                                       : (ok ? vsb + kp * p.vss.t : vsb);
            cp4(st + Gm::SOFF + tid * 4, s, ok);
        }
        if (++pt < pu1) return;
        if (pv == 0) {
            pv = 1;
            tiles(pj, pt, pu1);
        } else {
            pv = 0;
            if (++pj < sh.j1) tiles(pj, pt, pu1);
        }
        pmore = pj < sh.j1;
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (pmore) issue(s);
        cp_commit();
    }
    int n_used = 0;              // ring items taken
    auto next_tile = [&]() -> const uint8_t* {
        cp_wait<STAGES - 2>();
        __syncthreads();         // the item has landed; every thread is done with the last
        if (pmore) issue((n_used + STAGES - 1) % STAGES);
        cp_commit();
        return smem + (n_used++ % STAGES) * Gm::SLOT;
    };

    // per-row symmetric quantization of q (the Pallas wrapper's, :438-444),
    // packed four values to a word, lane j taking words j, j + 32, ...; in
    // flight beside the first tiles' loads
    constexpr int QW = (D / 4 + 31) / 32;        // words of a q8 row per lane
    for (int r = warp; r < R; r += FWARPS) {
        const int g = r / p.T, t = r - g * p.T;
        const long base = b * p.qs.b + t * p.qs.t + static_cast<long>(h * G + g) * p.qs.h;
        float x[QW][4];
        float ax = 0.f;
#pragma unroll
        for (int u = 0; u < QW; ++u) {
            const int wi = lane + 32 * u;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                x[u][e] = wi * 4 < D ? load_q(p, base + wi * 4 + e) : 0.f;
                ax = fmaxf(ax, fabsf(x[u][e]));
            }
        }
        const float amax = warp_max(ax);
        const float qrow = amax > 0.f ? amax / 127.f : 1.f;
#pragma unroll
        for (int u = 0; u < QW; ++u) {
            const int wi = lane + 32 * u;
            if (wi * 4 >= D) continue;
            uint32_t w = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int v = static_cast<int>(fminf(fmaxf(rintf(x[u][e] / qrow), -127.f), 127.f));
                w |= (static_cast<uint32_t>(v) & 0xffu) << (8 * e);
            }
            reinterpret_cast<uint32_t*>(sq8 + r * D)[wi] = w;
        }
        if (lane == 0) {
            sqsc[r] = qrow * p.scale;
            sM[r] = -CUDART_INF_F;
            sL[r] = 0.f;
        }
    }

    int iacc[NACC][4];
    float acc[NACC][4];
#pragma unroll
    for (int i = 0; i < NACC; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            iacc[i][e] = 0;
            acc[i][e] = 0.f;
        }
    const int c4 = (tid % CW) * 4, z = tid / CW;
    const bool in_pv = z < ZS;               // this thread takes part in P V
    const uint8_t* spq = reinterpret_cast<const uint8_t*>(ss);   // pq of row r: spq + 4 r SSK

    for (int j = sh.j0; j < sh.j1; ++j) {
        int u0, u1;
        tiles(j, u0, u1);
        const int ka = max(lo, j * bk), kz = min(hi, j * bk + bk);
        const int kbase = j * bk + u0 * FTK;                 // the key of score column 0
        const int ncol = (u1 - u0) * FTK;
        const int va = max(ka - kbase, 0), vz = min(kz - kbase, ncol);   // live columns

        // (A) s = f32(q8 . k8) * (qrow * scale) * k_scale, softcapped and
        // masked: thread (key jj, row group rg) over rows rg, rg + RG, ...,
        // 16 bytes of its key row at a time
        for (int u = u0; u < u1; ++u) {
            const uint8_t* st = next_tile();
            const int jj = tid & (FTK - 1), rg = tid / FTK;
            const int col = (u - u0) * FTK + jj, kp = kbase + col;
            const bool in = kp >= ka && kp < kz;
            int d[NRA][2];
#pragma unroll
            for (int i = 0; i < NRA; ++i) d[i][0] = d[i][1] = 0;
#pragma unroll
            for (int c = 0; c < Gm::NCH; ++c) {
                const uint4 kw = *reinterpret_cast<const uint4*>(st + jj * Gm::KROW + c * 16);
#pragma unroll
                for (int i = 0; i < NRA; ++i) {
                    const int r = rg + RG * i;
                    if (r >= R) break;
                    const uint4 q4 = reinterpret_cast<const uint4*>(sq8 + r * D)[c];
                    d[i][0] = __dp4a(static_cast<int>(kw.x), static_cast<int>(q4.x), d[i][0]);
                    d[i][1] = __dp4a(static_cast<int>(kw.y), static_cast<int>(q4.y), d[i][1]);
                    d[i][0] = __dp4a(static_cast<int>(kw.z), static_cast<int>(q4.z), d[i][0]);
                    d[i][1] = __dp4a(static_cast<int>(kw.w), static_cast<int>(q4.w), d[i][1]);
                }
            }
            const float* ssc = reinterpret_cast<const float*>(st + Gm::SOFF);
            const float ksc = ssc[jj];
            if (rg == 0) svs[col] = ssc[FTK + jj];
#pragma unroll
            for (int i = 0; i < NRA; ++i) {
                const int r = rg + RG * i;
                if (r >= R) break;
                const float x = static_cast<float>(d[i][0] + d[i][1]) * sqsc[r];
                ss[r * SSK + col] = finish_score(p, x * ksc, np, r, kp, in);
            }
        }
        __syncthreads();         // the block's scores are in

        // (B) per row (warp w: rows w, w + 8, ...): the block's max m over
        // its group, p = exp(s - m), the rank's l, p * v_scale, psc over
        // the group, pq
        for (int r = warp; r < R; r += FWARPS) {
            float mx = -CUDART_INF_F;
            for (int c = va + lane; c < vz; c += 32) mx = fmaxf(mx, ss[r * SSK + c]);
            mx = warp_max(mx);
            if (lane == 0) smax[r] = mx;
        }
        if (sh.shared)
            cluster.sync();      // every rank of the group has its max
        else
            __syncwarp();
        for (int r = warp; r < R; r += FWARPS) {
            const float m = group_max(cluster, smax, r, sh);
            float l = 0.f, pmax = 0.f;
            for (int c = va + lane; c < vz; c += 32) {
                const float pk = expf(ss[r * SSK + c] - m);
                l += pk;
                const float pvj = pk * svs[c];
                ss[r * SSK + c] = pvj;
                pmax = fmaxf(pmax, pvj);
            }
            l = warp_sum(l);
            pmax = warp_max(pmax);
            if (lane == 0) {
                sm[r] = m;
                sl[r] = l;
                spmax[r] = pmax;
            }
        }
        if (sh.shared)
            cluster.sync();      // every rank of the group has its max of p * v_scale
        else
            __syncwarp();
        for (int r = warp; r < R; r += FWARPS) {
            const float pmax = group_max(cluster, spmax, r, sh);
            const float psc = pmax > 0.f ? pmax / 127.f : 1.f;
            // pq over the row's first SSK bytes: chunk k of 128 columns
            // writes words [32 k, 32 k + 32) of the row, read before
            float* row = ss + r * SSK;
            for (int k = 0; k * 128 < ncol; ++k) {
                const int c = k * 128 + lane * 4;
                const float4 v4 = *reinterpret_cast<const float4*>(row + c);
                const float pv4[4] = {v4.x, v4.y, v4.z, v4.w};
                uint32_t w = 0;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool ok = c + e >= va && c + e < vz;
                    const uint32_t q = ok ? static_cast<uint32_t>(rintf(pv4[e] / psc)) : 0u;
                    w |= q << (8 * e);
                }
                __syncwarp();
                reinterpret_cast<uint32_t*>(row)[k * 32 + lane] = w;
            }
            if (lane == 0 && u1 > u0) {
                const float mo = sM[r], mn = fmaxf(mo, sm[r]);
                const float fo = expf(mo - mn), fw = expf(sm[r] - mn);
                sfo[r] = fo;
                sfn[r] = fw * psc;
                sL[r] = sL[r] * fo + sl[r] * fw;
                sM[r] = mn;
            }
        }
        __syncthreads();         // pq and the rescale factors are in

        // (C) the block's int32 sums pq . v8 over columns c4 .. c4 + 3: few
        // rows, every row over the keys of slice z; many rows, rows z, z +
        // ZS, ... over every key.  (pq of dead keys is 0, their V rows 0.)
        for (int u = u0; u < u1; ++u) {
            const uint8_t* st = next_tile();
            const int cb = (u - u0) * FTK;
#pragma unroll 2
            for (int jb = 0; jb < (in_pv ? (FEW ? KZ : FTK) : 0); jb += 4) {
                const int jk = FEW ? z * KZ + jb : jb;
                uint32_t w[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    w[e] = *reinterpret_cast<const uint32_t*>(st + (jk + e) * Gm::KROW + c4);
                int col[4];
                transpose4x4(w, col);
#pragma unroll
                for (int i = 0; i < NACC; ++i) {
                    const int r = FEW ? i : z + ZS * i;
                    if (r >= R) break;
                    const int pw = *reinterpret_cast<const int*>(spq + 4 * r * SSK + cb + jk);
#pragma unroll
                    for (int e = 0; e < 4; ++e) iacc[i][e] = __dp4a(pw, col[e], iacc[i][e]);
                }
            }
        }
        if (u1 > u0) {
#pragma unroll
            for (int i = 0; i < NACC; ++i) {
                const int r = FEW ? i : z + ZS * i;
                if (!in_pv || r >= R) break;
                const float fo = sfo[r], fn = sfn[r];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    acc[i][e] = acc[i][e] * fo + static_cast<float>(iacc[i][e]) * fn;
                    iacc[i][e] = 0;
                }
            }
        }
    }

    // The rank's partials go to their owners (few rows: the key slices,
    // left where the ring was, summed in slice order first).
    cp_wait<0>();
    __syncthreads();
    const int C = gridDim.x, span = Recv::span(R, D, C);
    float* racc = reinterpret_cast<float*>(smem + Gm::recv_offset(R, bk));
    float* rml = racc + C * span;
    if constexpr (FEW) {
        float* pz = reinterpret_cast<float*>(smem);    // [ZS][R][D]
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
            if (!in_pv || r >= R) break;
            float* dst = pz + (z * R + r) * D + c4;
            dst[0] = acc[r][0];
            dst[1] = acc[r][1];
            dst[2] = acc[r][2];
            dst[3] = acc[r][3];
        }
        __syncthreads();
        if (!sh.shared) cluster_wait();   // every block has started: owners may be written
        for (int idx = tid; idx < R * D; idx += FTHREADS) {
            float a = pz[idx];
#pragma unroll
            for (int zz = 1; zz < ZS; ++zz) a += pz[zz * R * D + idx];
            send_acc<1>(cluster, racc, idx, span, &a);
        }
    } else {
        if (!sh.shared) cluster_wait();
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
            const int r = z + ZS * i;
            if (!in_pv || r >= R) break;
            send_acc<4>(cluster, racc, r * D + c4, span, acc[i]);
        }
    }
    for (int r = tid; r < R; r += FTHREADS) send_ml(cluster, rml, R, D, span, r, sM[r], sL[r]);
    cluster.sync();        // every partial has landed
    owner_merge(p, racc, rml, rml + C * R * 2, R, D, span, b, h);
}

// A kernel (either dots) as one cluster launch of gridDim (C, Hkv, B).  Its
// attributes (the shared memory of its most rows, clusters above 8) are
// set at its first launch; later launches, and a CUDA-graph capture of
// them, make no call besides the launch.
template <typename K>
int launch_cluster(K kernel, bool& attrs_set, int smem_max, int smem, const Params& p, int B,
                   cudaStream_t stream) {
    if (!attrs_set) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             smem_max);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return static_cast<int>(e);
        attrs_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.n_splits, p.Hkv, B);
    cfg.blockDim = dim3(FTHREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.n_splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int DK, int DV, typename KV, int MAXR>
int launch_rows(const Params& p, int R, int B, cudaStream_t stream) {
    static bool set = false;
    int most = 0;
    for (int c = 1; c <= MAX_CLUSTER; ++c) {
        const int bytes = FGeom<DK, DV, KV, MAXR>::smem_bytes(MAXR, c);
        most = bytes > most ? bytes : most;
    }
    return launch_cluster(decode_kernel<DK, DV, KV, MAXR>, set, most,
                          FGeom<DK, DV, KV, MAXR>::smem_bytes(R, p.n_splits), p, B, stream);
}

// K and V of one width: up to 64 rows, 32 at D 256 (`max_rows`).  MLA's K
// 192 / V 128 (one query head per kv head, T <= 8): up to 8 rows.
template <int DK, int DV, typename KV>
int launch_float_rows(const Params& p, int B, cudaStream_t stream) {
    const int R = (p.Hq / p.Hkv) * p.T;
    if (R <= 8) return launch_rows<DK, DV, KV, 8>(p, R, B, stream);
    if constexpr (DK == DV) {
        if (R <= 32) return launch_rows<DK, DV, KV, 32>(p, R, B, stream);
        if constexpr (DK == 256) return static_cast<int>(cudaErrorInvalidValue);
        else return launch_rows<DK, DV, KV, 64>(p, R, B, stream);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <int DK, int DV>
int launch_float_kv(int kv_kind, const Params& p, int B, cudaStream_t stream) {
    switch (kv_kind) {
        case KIND_I8: return launch_float_rows<DK, DV, int8_t>(p, B, stream);
        case KIND_BF16: return launch_float_rows<DK, DV, __nv_bfloat16>(p, B, stream);
        case KIND_F32: return launch_float_rows<DK, DV, float>(p, B, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The int8 dots as one cluster launch of gridDim (C, Hkv, B), block_k
// (p.split) keys per quantization block.
template <int D, int MAXR>
int launch_int8_rows(const Params& p, int R, int B, cudaStream_t stream) {
    using Gm = IGeom<D, MAXR>;
    static bool set = false;
    int most = 0;
    for (int c = 1; c <= MAX_CLUSTER; ++c) {
        const int bytes = Gm::smem_bytes(MAXR, MAX_BLOCK_K, c);
        most = bytes > most ? bytes : most;
    }
    return launch_cluster(decode_int8_kernel<D, MAXR>, set, most,
                          Gm::smem_bytes(R, p.split, p.n_splits), p, B, stream);
}

template <int D>
int launch_int8(const Params& p, int B, cudaStream_t stream) {
    const int R = (p.Hq / p.Hkv) * p.T;
    if (R <= 8) return launch_int8_rows<D, 8>(p, R, B, stream);
    if (R <= 32) return launch_int8_rows<D, 32>(p, R, B, stream);
    if constexpr (D == 256) return static_cast<int>(cudaErrorInvalidValue);
    else return launch_int8_rows<D, 64>(p, R, B, stream);
}

Params make_params(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const float* sinks, const long long* np_vec, int np_scalar,
                   void* o, const long* st, int T, int S, int Hq, int Hkv, int n_tokens,
                   float scale, int window, float softcap, int q_kind, int bf16_dots, int split,
                   int n_splits) {
    return Params{q, k, v, ks, vs, sinks, np_vec, np_scalar, o,
                  Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
                  Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
                  Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]},
                  T, S, Hq, Hkv, n_tokens, window, q_kind, bf16_dots, split, n_splits,
                  scale, softcap};
}

// Query rows G*T per kv head at head dim D: MAX_ROWS, 32 at D 256, where
// 64 rows' q, partials and merge buffers beside the tiles pass the card's
// shared memory (flash_decode.py D256_MAX_ROWS).
constexpr int max_rows(int D) { return D == 256 ? 32 : MAX_ROWS; }

bool bad_shape(int Hq, int Hkv, int T, int D, int q_kind) {
    return Hkv <= 0 || Hq % Hkv || T <= 0 ||
           (D != 64 && D != 80 && D != 96 && D != 128 && D != 256) ||
           (Hq / Hkv) * T > max_rows(D) || (q_kind != KIND_F32 && q_kind != KIND_BF16);
}

}  // namespace

// FD_PART selects what a build exports: 1 the float dots at D 64, 128 and
// MLA's (192, 128), 3 the float dots at D 80, 96 and 256, 2 the int8 dots;
// unset, all of them.  Each part instantiates only its own kernels, so the
// three libraries build side by side (ops/cuda/build.py).
#if !defined(FD_PART)
#define FD_NARROW 1
#define FD_WIDE 1
#else
#define FD_NARROW (FD_PART == 1)
#define FD_WIDE (FD_PART == 3)
#endif
#if FD_NARROW || FD_WIDE
// q: bf16 (q_kind KIND_BF16) or f32 (KIND_F32); k/v: int8 with ks/vs
// (kv_kind KIND_I8) or bf16 / f32 without; unit stride along the head dim
// and 16-byte aligned rows; strides: 18 element strides (b, t|s, h) of q,
// k, v, o, ks, vs.  np_vec: int64 [B] per-row n_past, or null to use
// np_scalar.  (D, Dv), the widths of q and K and of V and o: (64, 64), (80,
// 80), (96, 96) or (128, 128) with G*T at most 64, (256, 256) with G*T at
// most 32, or MLA's (192, 128) with G*T at most 8.
// bf16 or f32 dots; `ctas` (1..16) blocks per (batch row, kv head), one
// cluster (flash_decode.py decode_geometry).
CL_EXPORT int flash_decode_launch(const void* q, const void* k, const void* v,
                                  const float* ks, const float* vs, const float* sinks,
                                  const long long* np_vec, int np_scalar, void* o,
                                  const long* strides, int B, int T, int S, int Hq, int Hkv,
                                  int D, int Dv, int n_tokens, float scale, int window,
                                  float softcap, int q_kind, int kv_kind, int bf16_dots,
                                  int ctas, void* stream) {
    const bool mla = D == 192 && Dv == 128;
    if ((mla ? bad_shape(Hq, Hkv, T, 128, q_kind) : bad_shape(Hq, Hkv, T, D, q_kind) || Dv != D) ||
        (kv_kind == KIND_I8) != (ks != nullptr) || (ks != nullptr) != (vs != nullptr) ||
        ctas <= 0 || ctas > MAX_CLUSTER)
        return static_cast<int>(cudaErrorInvalidValue);
    const Params p = make_params(q, k, v, ks, vs, sinks, np_vec, np_scalar, o, strides, T, S, Hq,
                                 Hkv, n_tokens, scale, window, softcap, q_kind, bf16_dots, FTK,
                                 ctas);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (mla ? 192 : D) {
#if FD_NARROW
        case 192: return launch_float_kv<192, 128>(kv_kind, p, B, st);
        case 128: return launch_float_kv<128, 128>(kv_kind, p, B, st);
        case 64: return launch_float_kv<64, 64>(kv_kind, p, B, st);
#endif
#if FD_WIDE
        case 256: return launch_float_kv<256, 256>(kv_kind, p, B, st);
        case 96: return launch_float_kv<96, 96>(kv_kind, p, B, st);
        case 80: return launch_float_kv<80, 80>(kv_kind, p, B, st);
#endif
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

#endif

#if !defined(FD_PART) || FD_PART == 2
// The int8-dot mode over an int8 cache with its scales: q to sinks, np_vec,
// np_scalar, o and strides as flash_decode_launch; `block_k` (1..512) keys
// per quantization block, the Pallas kernel's; `ctas` (1..16) blocks per
// (batch row, kv head), one cluster (flash_decode.py decode_geometry).
CL_EXPORT int flash_decode_int8_launch(const void* q, const void* k, const void* v,
                                       const float* ks, const float* vs, const float* sinks,
                                       const long long* np_vec, int np_scalar, void* o,
                                       const long* strides, int B, int T, int S, int Hq, int Hkv,
                                       int D, int n_tokens, float scale, int window,
                                       float softcap, int q_kind, int block_k, int ctas,
                                       void* stream) {
    if (bad_shape(Hq, Hkv, T, D, q_kind) || !ks || !vs || block_k <= 0 ||
        block_k > MAX_BLOCK_K || ctas <= 0 || ctas > MAX_CLUSTER)
        return static_cast<int>(cudaErrorInvalidValue);
    const Params p = make_params(q, k, v, ks, vs, sinks, np_vec, np_scalar, o, strides, T, S, Hq,
                                 Hkv, n_tokens, scale, window, softcap, q_kind, 0, block_k, ctas);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 256: return launch_int8<256>(p, B, st);
        case 128: return launch_int8<128>(p, B, st);
        case 96: return launch_int8<96>(p, B, st);
        case 80: return launch_int8<80>(p, B, st);
        default: return launch_int8<64>(p, B, st);
    }
}
#endif
