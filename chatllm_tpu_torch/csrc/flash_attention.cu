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
// Design (FlashAttention-2 on mma.sync): one block per (64-query tile, head,
// batch), 4 warps of 16 query rows each.  The block walks 64-key tiles from
// the first live one to the last: tiles wholly above the causal diagonal,
// past the written keys or before the window are never visited, and tiles
// where every key is visible to every row skip the mask arithmetic.  Q lives
// in registers as mma A fragments; each K tile is staged row-major and each
// V tile transposed in shared memory so every B fragment is one 32-bit
// load.  Scores, the running max/denominator and the output accumulator are
// f32; probabilities enter the P.V product as bf16.
//
// An f32 cache (--cache_dtype float32) takes `flash_f32_kernel`: the Pallas
// kernel runs its dots in the inputs' dtype, so there every product is an
// f32 FMA on the CUDA cores (67 TFLOP/s bounds it).  Same tiling of the
// mask; one block per (32-query tile, head, batch), 4 warps of 8 query rows,
// lane j scoring key j of each 32-key tile.  An f32 query over a bf16 cache
// (--compute_dtype f32 --cache_dtype bf16) takes the same kernel with bf16
// K/V loads: the Pallas kernel's mixed dot q.k runs in f32 (bf16 keys are
// exact in f32), it rounds the probabilities to the cache's dtype before
// P.V (flash.py:75) and writes q's dtype, f32.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int PAD = 8;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low 16 bits)
    return *reinterpret_cast<uint32_t*>(&v);
}

struct Strides { long b, t, h; };

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             Strides qs, Strides ks, Strides vs, Strides os,
             int T, int S, int Hq, int Hkv, int n_past, int n_tokens, float scale,
             int causal, int window, float softcap) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16 (*sq)[D + PAD] = reinterpret_cast<__nv_bfloat16 (*)[D + PAD]>(smem_raw);
    __nv_bfloat16 (*sk)[D + PAD] = sq + BQ;
    __nv_bfloat16 (*svt)[BK + PAD] = reinterpret_cast<__nv_bfloat16 (*)[BK + PAD]>(sk + BK);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (Hq / Hkv);
    const int t0 = qt * BQ;

    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
    const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

    // Q tile -> shared -> A fragments (rows past T are zero and never stored)
    for (int idx = tid; idx < BQ * (D / 8); idx += THREADS) {
        const int r = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (t0 + r < T) val = *reinterpret_cast<const uint4*>(qb + (t0 + r) * qs.t + c8);
        *reinterpret_cast<uint4*>(&sq[r][c8]) = val;
    }
    __syncthreads();
    uint32_t qf[D / 16][4];
    const int r0 = warp * 16 + gid;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
        const int c = kc * 16 + tig * 2;
        qf[kc][0] = *reinterpret_cast<const uint32_t*>(&sq[r0][c]);
        qf[kc][1] = *reinterpret_cast<const uint32_t*>(&sq[r0 + 8][c]);
        qf[kc][2] = *reinterpret_cast<const uint32_t*>(&sq[r0][c + 8]);
        qf[kc][3] = *reinterpret_cast<const uint32_t*>(&sq[r0 + 8][c + 8]);
    }

    float oacc[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};

    const int kv_len = n_past + n_tokens;
    const int q_lo = n_past + t0;
    const int q_hi = q_lo + BQ - 1;
    int k_end = min(kv_len, S);
    if (causal) k_end = min(k_end, q_hi + 1);
    int kt_begin = 0;
    if (window > 0) kt_begin = max(0, q_lo - window + 1) / BK;
    const int kt_end = (k_end + BK - 1) / BK;
    const int qpos0 = q_lo + r0, qpos1 = qpos0 + 8;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();   // previous tile's readers are done
        for (int idx = tid; idx < BK * (D / 8); idx += THREADS) {
            const int r = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
            uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
            if (k0 + r < S) {
                kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * ks.t + c8);
                vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * vs.t + c8);
            }
            *reinterpret_cast<uint4*>(&sk[r][c8]) = kv;
            const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
            for (int e = 0; e < 8; ++e) svt[c8 + e][r] = ve[e];
        }
        __syncthreads();

        // S = Q K^T for this warp's 16 rows x 64 keys
        float sacc[BK / 8][4];
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
            const int c = kc * 16 + tig * 2;
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
                uint32_t bf[2];
                bf[0] = *reinterpret_cast<const uint32_t*>(&sk[nt * 8 + gid][c]);
                bf[1] = *reinterpret_cast<const uint32_t*>(&sk[nt * 8 + gid][c + 8]);
                mma_bf16_16816(sacc[nt], qf[kc], bf);
            }
        }

        bool interior = k0 + BK <= kv_len;
        if (causal) interior = interior && (k0 + BK - 1 <= q_lo);
        if (window > 0) interior = interior && (k0 > q_hi - window);
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float sv = sacc[nt][e] * scale;
                if (softcap > 0.f) sv = tanhf(sv / softcap) * softcap;
                if (!interior) {
                    const int kpos = k0 + nt * 8 + tig * 2 + (e & 1);
                    const int qpos = e < 2 ? qpos0 : qpos1;
                    bool ok = kpos < kv_len;
                    if (causal) ok = ok && kpos <= qpos;
                    if (window > 0) ok = ok && kpos > qpos - window;
                    if (!ok) sv = NEG_INF;
                }
                sacc[nt][e] = sv;
            }

        // online softmax for rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3)
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
            mx[0] = fmaxf(mx[0], fmaxf(sacc[nt][0], sacc[nt][1]));
            mx[1] = fmaxf(mx[1], fmaxf(sacc[nt][2], sacc[nt][3]));
        }
        float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 2));
            const float m_new = fmaxf(m_run[i], mx[i]);
            corr[i] = expf(m_run[i] - m_new);
            m_run[i] = m_new;
        }
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = expf(sacc[nt][e] - m_run[e >> 1]);
                sacc[nt][e] = p;
                rsum[e >> 1] += p;
            }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            rsum[i] += __shfl_xor_sync(FULL_MASK, rsum[i], 1);
            rsum[i] += __shfl_xor_sync(FULL_MASK, rsum[i], 2);
            l_run[i] = l_run[i] * corr[i] + rsum[i];
        }
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
            oacc[dt][0] *= corr[0];
            oacc[dt][1] *= corr[0];
            oacc[dt][2] *= corr[1];
            oacc[dt][3] *= corr[1];
        }

        // O += P V, P as bf16 A fragments taken straight from the score tiles
#pragma unroll
        for (int kc = 0; kc < BK / 16; ++kc) {
            uint32_t pf[4];
            pf[0] = pack_bf16(sacc[2 * kc][0], sacc[2 * kc][1]);
            pf[1] = pack_bf16(sacc[2 * kc][2], sacc[2 * kc][3]);
            pf[2] = pack_bf16(sacc[2 * kc + 1][0], sacc[2 * kc + 1][1]);
            pf[3] = pack_bf16(sacc[2 * kc + 1][2], sacc[2 * kc + 1][3]);
            const int c = kc * 16 + tig * 2;
#pragma unroll
            for (int dt = 0; dt < D / 8; ++dt) {
                uint32_t bf[2];
                bf[0] = *reinterpret_cast<const uint32_t*>(&svt[dt * 8 + gid][c]);
                bf[1] = *reinterpret_cast<const uint32_t*>(&svt[dt * 8 + gid][c + 8]);
                mma_bf16_16816(oacc[dt], pf, bf);
            }
        }
    }

    // finalize: o = acc / max(l, 1e-30)
    const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
    const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
    const int ta = t0 + r0, tb = ta + 8;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
        const int c = dt * 8 + tig * 2;
        if (ta < T)
            *reinterpret_cast<__nv_bfloat162*>(ob + ta * os.t + c) =
                __floats2bfloat162_rn(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
        if (tb < T)
            *reinterpret_cast<__nv_bfloat162*>(ob + tb * os.t + c) =
                __floats2bfloat162_rn(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
    }
}

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
    return launch_kernel<__nv_bfloat16, __nv_bfloat16>(
        flash_kernel<D>,
        sizeof(__nv_bfloat16) * ((BQ + BK) * (D + PAD) + D * (BK + PAD)), BQ,
        q, k, v, o, st, B, T, S, Hq, Hkv, n_past, n_tokens, scale, causal, window,
        softcap, stream);
}

}  // namespace

// mode 0: q/k/v/o all bf16; 1: all f32; 2: q/o f32 over bf16 k/v.  Unit
// stride along D;
// strides: 12 element strides (b, t, h) for q, k, v, o in that order, each
// a multiple of 16 bytes.  D must be 64 or 128; Hq % Hkv == 0;
// n_past + n_tokens <= S.
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
