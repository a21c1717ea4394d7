// K4: flash decode, the attention of a few new tokens over the whole cache.
//
//   q [B, T, Hq, D] (bf16 or f32); cache k/v [B, S, Hkv, D], int8 with f32
//   scales [B, S, Hkv] (the q8 cache) or bf16 / f32  ->  o [B, T, Hq, D]
//   in q's dtype
//
// Replaces chatllm_tpu/ops/pallas/flash_decode.py::flash_decode (bodies
// `_batched_kernel` and `_decode_kernel`) with the Pallas kernels'
// numerics.  The G*T query rows of kv head h are folded together: row
// r = g*T + t is query head h*G + g at position n_past[b] + t.  A key at
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
// the block adds f32(pq . v8) * psc.  Integer products of magnitude <= 127^2
// summed over <= 512 terms stay below 2^24, so f32 FMAs on the integer
// values give the s8 dots' int32 sums exactly.  A split of the int8 kernel
// is exactly one such block: the quantization of p depends only on the
// block's own keys (exp(-m) cancels between p and psc), and the fixed-order
// combine weighs the blocks as the Pallas kernel's running rescale does.
//
// Up to 64 query rows G*T per kv head (MAXR 32 or 64 by instantiation:
// Qwen2.5-0.5B's 7 heads per kv head at T = 8 are 56).  The cache is read
// through element strides, the scales through their own (b, s, h) strides,
// so a [B, Hkv, S, D] cache and [B, Hkv, S] scales pass as permuted views.
//
// Bound on the H100: bytes.  A decode step reads every live key's K and V
// once per kv head (2 * D bytes for int8, plus 8 bytes of scales) and does
// 4 * D flops per (query row, key): at G*T = 4 rows (Llama-3, one token)
// that is 7.8 flops per byte, where the tensor cores could do ~295.  This
// first kernel runs the dots as f32 FMAs on the CUDA cores, which sustain
// ~20 flops per byte of HBM (67 TFLOP/s over 3.35 TB/s): enough at 4 rows,
// not at 16.  The cache is read in its native [B, S, Hkv, D] layout through
// strides, with no transposed copy.
//
// Design (flash-decoding, split-K): the first kernel runs one block of 128
// threads per (256-key split (block_k keys with int8 dots), kv head, batch
// row); splits outside the
// row's live keys return at once.  A block stages 32-key K/V tiles with
// 16-byte loads and converts them to f32 in shared memory; warp w keeps
// the running max and denominator of rows w, w+4, ... with lane j scoring
// key j; thread c accumulates output column c of its rows.  Its (max,
// denominator, accumulator) partials go to scratch, and the second kernel
// merges a row's live splits in split order, with no atomics, so greedy
// decoding repeats bit for bit.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int TK = 32;            // keys per tile, one per lane
constexpr int MAX_ROWS = 64;      // query rows G*T per kv head (flash_decode.py MAX_ROWS)
constexpr int MAX_SPLIT = 512;    // keys per split of the int8 kernel at most
constexpr float NEG_INF = -1e30f;

struct Strides { long b, t, h; };

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
    float* part_ml;             // [B, Hkv, n_splits, R, 2]: running max, denominator
    float* part_acc;            // [B, Hkv, n_splits, R, D]
    Strides qs, kst, vst, os;   // element strides of q, k, v, o
    Strides kss, vss;           // element strides (b, s, h) of ks, vs
    int T, S, Hq, Hkv, n_tokens, window, q_kind, bf16_dots, split, n_splits;
    float scale, softcap;
};

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cvt(const uint4& u, float* out, int8_t) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int c = 0; c < 16; ++c) out[c] = static_cast<float>(e[c]);
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
    return v;
}

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

__device__ __forceinline__ float scale_at(const float* sc, const Strides& st, int b, long kp,
                                          int h) {
    return sc[b * st.b + kp * st.t + h * st.h];
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

template <int D, typename KV, int MAXR>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(Params p) {
    constexpr int VEC = 16 / sizeof(KV);     // cache elements per 16-byte load
    constexpr int NV = D / VEC;              // loads per key row
    constexpr int RSTEP = THREADS / D;       // rows between a thread's accumulators
    constexpr int NACC = MAXR / RSTEP;
    constexpr int NOWN = MAXR / NWARPS;      // rows whose softmax state a warp keeps
    extern __shared__ __align__(16) float smem[];

    const int G = p.Hq / p.Hkv, R = G * p.T;
    float* sk = smem;                        // [TK][D + 4]: +4 keeps 16-byte rows
    float* sv = sk + TK * (D + 4);           //   of 8 lanes on distinct banks
    float* sq = sv + TK * D;                 // [R][D]
    float* sp = sq + R * D;                  // [R][TK]: p * v_scale of the tile
    float* scorr = sp + R * TK;              // [R]: the tile's rescale factor

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    long long np;
    int lo, hi;
    live_keys(p, b, np, lo, hi);
    const int k_begin = max(split * p.split, lo), k_end = min(split * p.split + p.split, hi);
    if (k_begin >= k_end) return;            // the combine kernel skips this split

    for (int idx = tid; idx < R * D; idx += THREADS) {
        const int r = idx / D, c = idx - r * D, g = r / p.T, t = r - g * p.T;
        const float x = load_q(p, b * p.qs.b + t * p.qs.t + static_cast<long>(h * G + g) * p.qs.h + c);
        sq[idx] = p.bf16_dots ? round_bf16(x) : x;
    }

    const KV* kb = static_cast<const KV*>(p.k) + b * p.kst.b + h * p.kst.h;
    const KV* vb = static_cast<const KV*>(p.v) + b * p.vst.b + h * p.vst.h;
    const bool round_kv = p.bf16_dots && sizeof(KV) == 4;

    float m_run[NOWN], l_run[NOWN], acc[NACC];
#pragma unroll
    for (int i = 0; i < NOWN; ++i) {
        m_run[i] = NEG_INF;
        l_run[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    const int c_own = tid % D, r_own = tid / D;

    for (int k0 = k_begin; k0 < k_end; k0 += TK) {
        const int nk = min(TK, k_end - k0);
        __syncthreads();   // q staged / the previous tile's readers are done
        for (int idx = tid; idx < TK * NV; idx += THREADS) {
            const int j = idx / NV, c = (idx - j * NV) * VEC;
            float kf[VEC], vf[VEC];
            if (j < nk) {
                const long kp = k0 + j;
                cvt(*reinterpret_cast<const uint4*>(kb + kp * p.kst.t + c), kf, KV{});
                cvt(*reinterpret_cast<const uint4*>(vb + kp * p.vst.t + c), vf, KV{});
                if (round_kv) {
#pragma unroll
                    for (int e = 0; e < VEC; ++e) {
                        kf[e] = round_bf16(kf[e]);
                        vf[e] = round_bf16(vf[e]);
                    }
                }
            } else {
#pragma unroll
                for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
                *reinterpret_cast<float4*>(sk + j * (D + 4) + c + e) =
                    make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
                *reinterpret_cast<float4*>(sv + j * D + c + e) =
                    make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
            }
        }
        __syncthreads();

        // scores and the online softmax: lane j holds key k0 + j
        const int kp = k0 + lane;
        const bool in_tile = lane < nk;
        float ksc = 1.f, vsc = 1.f;
        if (in_tile && p.ks) {
            ksc = scale_at(p.ks, p.kss, b, kp, h);
            vsc = scale_at(p.vs, p.vss, b, kp, h);
        }
        const float* kr = sk + lane * (D + 4);
#pragma unroll
        for (int i = 0; i < NOWN; ++i) {
            const int r = warp + NWARPS * i;
            if (r >= R) break;
            const float* qr = sq + r * D;
            float s = 0.f;
#pragma unroll 8
            for (int c = 0; c < D; c += 4) {
                const float4 k4 = *reinterpret_cast<const float4*>(kr + c);
                const float4 q4 = *reinterpret_cast<const float4*>(qr + c);
                s = fmaf(q4.x, k4.x, s);
                s = fmaf(q4.y, k4.y, s);
                s = fmaf(q4.z, k4.z, s);
                s = fmaf(q4.w, k4.w, s);
            }
            s *= p.scale;
            if (p.ks) s *= ksc;
            s = finish_score(p, s, np, r, kp, in_tile);
            // keys past the tile's end take no part; masked ones do, as in
            // the Pallas kernel (weight 0 once a valid key sets the max)
            const float m_new = fmaxf(m_run[i], warp_max(in_tile ? s : -CUDART_INF_F));
            const float corr = expf(m_run[i] - m_new);
            const float pj = in_tile ? expf(s - m_new) : 0.f;
            l_run[i] = l_run[i] * corr + warp_sum(pj);
            m_run[i] = m_new;
            const float pv = pj * vsc;
            sp[r * TK + lane] = p.bf16_dots ? round_bf16(pv) : pv;
            if (lane == 0) scorr[r] = corr;
        }
        __syncthreads();

        // O += P V: column c_own of rows r_own, r_own + RSTEP, ...
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
            const int r = r_own + RSTEP * i;
            if (r >= R) break;
            const float* pr = sp + r * TK;
            float a = acc[i] * scorr[r];
            for (int j = 0; j < nk; ++j) a = fmaf(pr[j], sv[j * D + c_own], a);
            acc[i] = a;
        }
    }

    const long part = (static_cast<long>(b * p.Hkv + h) * p.n_splits + split) * R;
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < NOWN; ++i) {
            const int r = warp + NWARPS * i;
            if (r >= R) break;
            p.part_ml[(part + r) * 2] = m_run[i];
            p.part_ml[(part + r) * 2 + 1] = l_run[i];
        }
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
        const int r = r_own + RSTEP * i;
        if (r >= R) break;
        p.part_acc[(part + r) * D + c_own] = acc[i];
    }
}

// Int8 dots: one block per (block_k-key block, kv head, batch row).  Three
// passes over the block's live keys: (A) scores of the quantized q rows
// against the int8 keys into shared memory, with each row's max; (B) per
// row p, l, p * v_scale and its quantization, in place; (C) pq . v8.
template <int D, int MAXR>
__global__ void __launch_bounds__(THREADS)
decode_split_int8_kernel(Params p) {
    constexpr int NV = D / 16;               // 16-byte loads per int8 key row
    constexpr int RSTEP = THREADS / D;
    constexpr int NACC = MAXR / RSTEP;
    constexpr int NOWN = MAXR / NWARPS;
    extern __shared__ __align__(16) float smem[];

    const int G = p.Hq / p.Hkv, R = G * p.T;
    float* skv = smem;                       // [TK][D + 4]: the K tile, then the V tile
    float* sq = skv + TK * (D + 4);          // [R][D]: q8 values
    float* sqsc = sq + R * D;                // [R]: qrow * scale
    float* spsc = sqsc + R;                  // [R]: psc
    float* ss = spsc + R;                    // [R][split]: scores, then pq

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    long long np;
    int lo, hi;
    live_keys(p, b, np, lo, hi);
    const int k_begin = max(split * p.split, lo), k_end = min(split * p.split + p.split, hi);
    if (k_begin >= k_end) return;
    const int n_keys = k_end - k_begin;

    // per-row symmetric quantization of q (the Pallas wrapper's, :438-444)
    for (int r = warp; r < R; r += NWARPS) {
        const int g = r / p.T, t = r - g * p.T;
        const long base = b * p.qs.b + t * p.qs.t + static_cast<long>(h * G + g) * p.qs.h;
        float amax = 0.f;
        for (int c = lane; c < D; c += 32) {
            const float x = load_q(p, base + c);
            sq[r * D + c] = x;
            amax = fmaxf(amax, fabsf(x));
        }
        amax = warp_max(amax);
        const float qrow = amax > 0.f ? amax / 127.f : 1.f;
        for (int c = lane; c < D; c += 32)
            sq[r * D + c] = fminf(fmaxf(rintf(sq[r * D + c] / qrow), -127.f), 127.f);
        if (lane == 0) sqsc[r] = qrow * p.scale;
    }

    const int8_t* kb = static_cast<const int8_t*>(p.k) + b * p.kst.b + h * p.kst.h;
    const int8_t* vb = static_cast<const int8_t*>(p.v) + b * p.vst.b + h * p.vst.h;
    auto stage = [&](const int8_t* base, long row_stride, int k0, int nk) {
        for (int idx = tid; idx < TK * NV; idx += THREADS) {
            const int j = idx / NV, c = (idx - j * NV) * 16;
            float f[16];
            if (j < nk) {
                cvt(*reinterpret_cast<const uint4*>(base + (k0 + j) * row_stride + c), f, int8_t{});
            } else {
#pragma unroll
                for (int e = 0; e < 16; ++e) f[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < 16; e += 4)
                *reinterpret_cast<float4*>(skv + j * (D + 4) + c + e) =
                    make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
        }
    };

    // (A) s = f32(q8 . k8) * qsc * k_scale, softcapped and masked
    float m_run[NOWN];
#pragma unroll
    for (int i = 0; i < NOWN; ++i) m_run[i] = NEG_INF;
    for (int k0 = k_begin; k0 < k_end; k0 += TK) {
        const int nk = min(TK, k_end - k0);
        __syncthreads();   // q staged / the previous tile's readers are done
        stage(kb, p.kst.t, k0, nk);
        __syncthreads();
        const int kp = k0 + lane;
        const bool in_tile = lane < nk;
        const float ksc = in_tile ? scale_at(p.ks, p.kss, b, kp, h) : 1.f;
        const float* kr = skv + lane * (D + 4);
#pragma unroll
        for (int i = 0; i < NOWN; ++i) {
            const int r = warp + NWARPS * i;
            if (r >= R) break;
            const float* qr = sq + r * D;
            float s = 0.f;                   // exact: an integer below 2^24
#pragma unroll 8
            for (int c = 0; c < D; c += 4) {
                const float4 k4 = *reinterpret_cast<const float4*>(kr + c);
                const float4 q4 = *reinterpret_cast<const float4*>(qr + c);
                s = fmaf(q4.x, k4.x, s);
                s = fmaf(q4.y, k4.y, s);
                s = fmaf(q4.z, k4.z, s);
                s = fmaf(q4.w, k4.w, s);
            }
            s = finish_score(p, s * sqsc[r] * ksc, np, r, kp, in_tile);
            if (in_tile) ss[r * p.split + (kp - k_begin)] = s;
            m_run[i] = fmaxf(m_run[i], warp_max(in_tile ? s : -CUDART_INF_F));
        }
    }
    __syncwarp();

    // (B) per row: p = exp(s - m), l = sum p, p * v_scale quantized per row
    const long part = (static_cast<long>(b * p.Hkv + h) * p.n_splits + split) * R;
#pragma unroll
    for (int i = 0; i < NOWN; ++i) {
        const int r = warp + NWARPS * i;
        if (r >= R) break;
        float* sr = ss + r * p.split;
        float lsum = 0.f, pmax = 0.f;
        for (int j = lane; j < n_keys; j += 32) {
            const float pj = expf(sr[j] - m_run[i]);
            lsum += pj;
            const float pv = pj * scale_at(p.vs, p.vss, b, k_begin + j, h);
            sr[j] = pv;
            pmax = fmaxf(pmax, pv);
        }
        const float l = warp_sum(lsum);
        pmax = warp_max(pmax);
        const float psc = pmax > 0.f ? pmax / 127.f : 1.f;
        for (int j = lane; j < n_keys; j += 32) sr[j] = rintf(sr[j] / psc);
        if (lane == 0) {
            spsc[r] = psc;
            p.part_ml[(part + r) * 2] = m_run[i];
            p.part_ml[(part + r) * 2 + 1] = l;
        }
    }

    // (C) acc = f32(pq . v8) * psc: column c_own of rows r_own, r_own + RSTEP, ...
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    const int c_own = tid % D, r_own = tid / D;
    for (int k0 = k_begin; k0 < k_end; k0 += TK) {
        const int nk = min(TK, k_end - k0);
        __syncthreads();   // pq and psc written / the previous tile's readers are done
        stage(vb, p.vst.t, k0, nk);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
            const int r = r_own + RSTEP * i;
            if (r >= R) break;
            const float* pr = ss + r * p.split + (k0 - k_begin);
            float a = acc[i];                // exact: an integer below 2^24
            for (int j = 0; j < nk; ++j) a = fmaf(pr[j], skv[j * (D + 4) + c_own], a);
            acc[i] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
        const int r = r_own + RSTEP * i;
        if (r >= R) break;
        p.part_acc[(part + r) * D + c_own] = acc[i] * spsc[r];
    }
}

// One block per (kv head, batch row): merges the live splits of each row
// in split order, applies the sinks and writes o in q's dtype.
template <int D>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(Params p) {
    constexpr int RSTEP = THREADS / D;
    const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
    const int G = p.Hq / p.Hkv, R = G * p.T;
    long long np;
    int lo, hi;
    live_keys(p, b, np, lo, hi);
    const int s_begin = lo / p.split;
    const int s_end = hi > lo ? (hi + p.split - 1) / p.split : s_begin;
    const long base = static_cast<long>(b * p.Hkv + h) * p.n_splits;
    const int c = tid % D;
    for (int r = tid / D; r < R; r += RSTEP) {
        float m = -CUDART_INF_F;
        for (int s = s_begin; s < s_end; ++s) m = fmaxf(m, p.part_ml[((base + s) * R + r) * 2]);
        float l = 0.f, a = 0.f;
        for (int s = s_begin; s < s_end; ++s) {
            const long i = (base + s) * R + r;
            const float w = expf(p.part_ml[i * 2] - m);
            l = fmaf(p.part_ml[i * 2 + 1], w, l);
            a = fmaf(p.part_acc[i * D + c], w, a);
        }
        const int g = r / p.T, t = r - g * p.T;
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
}

// Above 48 KB of dynamic shared memory a kernel needs the attribute set
// first; smaller launches (E7's) make no call besides the launch, so that a
// CUDA-graph capture records them as they are.
template <typename K>
int run_split(K kernel, size_t smem, const Params& p, int B, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(p.n_splits, p.Hkv, B), THREADS, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int D, typename KV, int MAXR>
int launch(const Params& p, int B, bool int8_dots, cudaStream_t stream) {
    const int R = (p.Hq / p.Hkv) * p.T;
    int rc;
    if constexpr (sizeof(KV) == 1) {
        if (int8_dots) {
            const size_t smem = sizeof(float) * (TK * (D + 4) + R * D + 2 * R + R * p.split);
            rc = run_split(decode_split_int8_kernel<D, MAXR>, smem, p, B, stream);
        } else {
            const size_t smem = sizeof(float) * (TK * (D + 4) + TK * D + R * D + R * TK + R);
            rc = run_split(decode_split_kernel<D, KV, MAXR>, smem, p, B, stream);
        }
    } else {
        if (int8_dots) return static_cast<int>(cudaErrorInvalidValue);
        const size_t smem = sizeof(float) * (TK * (D + 4) + TK * D + R * D + R * TK + R);
        rc = run_split(decode_split_kernel<D, KV, MAXR>, smem, p, B, stream);
    }
    if (rc != 0) return rc;
    decode_combine_kernel<D><<<dim3(p.Hkv, B), THREADS, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int D, int MAXR>
int launch_kv(int kv_kind, const Params& p, int B, bool int8_dots, cudaStream_t stream) {
    switch (kv_kind) {
        case KIND_I8: return launch<D, int8_t, MAXR>(p, B, int8_dots, stream);
        case KIND_BF16: return launch<D, __nv_bfloat16, MAXR>(p, B, int8_dots, stream);
        case KIND_F32: return launch<D, float, MAXR>(p, B, int8_dots, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

int dispatch(const Params& p, int B, int D, int kv_kind, bool int8_dots, cudaStream_t st) {
    const bool wide = (p.Hq / p.Hkv) * p.T > 32;
    if (D == 128) return wide ? launch_kv<128, 64>(kv_kind, p, B, int8_dots, st)
                              : launch_kv<128, 32>(kv_kind, p, B, int8_dots, st);
    if (D == 64) return wide ? launch_kv<64, 64>(kv_kind, p, B, int8_dots, st)
                             : launch_kv<64, 32>(kv_kind, p, B, int8_dots, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

Params make_params(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const float* sinks, const long long* np_vec, int np_scalar,
                   void* o, float* part_ml, float* part_acc, const long* st, int T, int S,
                   int Hq, int Hkv, int n_tokens, float scale, int window, float softcap,
                   int q_kind, int bf16_dots, int split) {
    return Params{q, k, v, ks, vs, sinks, np_vec, np_scalar, o, part_ml, part_acc,
                  Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
                  Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
                  Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]},
                  T, S, Hq, Hkv, n_tokens, window, q_kind, bf16_dots, split,
                  (S + split - 1) / split, scale, softcap};
}

bool bad_shape(int Hq, int Hkv, int T, int q_kind) {
    return Hkv <= 0 || Hq % Hkv || T <= 0 || (Hq / Hkv) * T > MAX_ROWS ||
           (q_kind != KIND_F32 && q_kind != KIND_BF16);
}

}  // namespace

// q: bf16 (q_kind KIND_BF16) or f32 (KIND_F32); k/v: int8 with ks/vs
// (kv_kind KIND_I8) or bf16 / f32 without; unit stride along D and 16-byte
// aligned rows; strides: 18 element strides (b, t|s, h) of q, k, v, o, ks,
// vs.  np_vec: int64 [B] per-row n_past, or null to use np_scalar.
// part_ml and part_acc: f32 scratch of [B, Hkv, ceil(S / split), G*T] x 2
// and x D.  D must be 64 or 128 and G*T at most 64.  bf16 or f32 dots, in
// splits of `split` keys (flash_decode.py SPLIT_K).
CL_EXPORT int flash_decode_launch(const void* q, const void* k, const void* v,
                                  const float* ks, const float* vs, const float* sinks,
                                  const long long* np_vec, int np_scalar, void* o,
                                  float* part_ml, float* part_acc, const long* strides,
                                  int B, int T, int S, int Hq, int Hkv, int D, int n_tokens,
                                  float scale, int window, float softcap, int q_kind,
                                  int kv_kind, int bf16_dots, int split, void* stream) {
    if (bad_shape(Hq, Hkv, T, q_kind) || (kv_kind == KIND_I8) != (ks != nullptr) || split <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const Params p = make_params(q, k, v, ks, vs, sinks, np_vec, np_scalar, o, part_ml, part_acc,
                                 strides, T, S, Hq, Hkv, n_tokens, scale, window, softcap,
                                 q_kind, bf16_dots, split);
    return dispatch(p, B, D, kv_kind, false, static_cast<cudaStream_t>(stream));
}

// The int8-dot mode over an int8 cache with its scales: the arguments of
// flash_decode_launch less kv_kind and bf16_dots; `block_k` (1..512) keys
// per split, the Pallas kernel's quantization block.
CL_EXPORT int flash_decode_int8_launch(const void* q, const void* k, const void* v,
                                       const float* ks, const float* vs, const float* sinks,
                                       const long long* np_vec, int np_scalar, void* o,
                                       float* part_ml, float* part_acc, const long* strides,
                                       int B, int T, int S, int Hq, int Hkv, int D,
                                       int n_tokens, float scale, int window, float softcap,
                                       int q_kind, int block_k, void* stream) {
    if (bad_shape(Hq, Hkv, T, q_kind) || !ks || !vs || block_k <= 0 || block_k > MAX_SPLIT)
        return static_cast<int>(cudaErrorInvalidValue);
    const Params p = make_params(q, k, v, ks, vs, sinks, np_vec, np_scalar, o, part_ml, part_acc,
                                 strides, T, S, Hq, Hkv, n_tokens, scale, window, softcap,
                                 q_kind, 0, block_k);
    return dispatch(p, B, D, KIND_I8, true, static_cast<cudaStream_t>(stream));
}
