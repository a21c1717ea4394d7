"""Synthetic (random or constant weight) models of real architectures
(counterpart of the JAX package's `models/synthetic.py`, main-path subset).

Used where no checkpoint file exists: the device layouts are identical to
the loader's output, so the kernels measured are the production kernels.
Random weights are drawn on the target device from a seeded
`torch.Generator`; they do not reproduce the JAX package's numpy draws.
"""
from __future__ import annotations

import torch

from ..nn.transformer import TransformerConfig
from ..ops.qtensor import DenseLinear, QuantLinear
from ..ops.rope import ROPE_NEOX, ROPE_NORMAL, RopeConfig


def _randint(gen, lo, hi, shape, dtype, device):
    return torch.randint(lo, hi, shape, generator=gen, device=device,
                         dtype=torch.int32).to(dtype)


def _rand(gen, shape, scale, dtype, device):
    return (torch.rand(shape, generator=gen, device=device) * scale).to(dtype)


def synth_linear(n_in: int, n_out: int, fmt: str, *, bias: bool = False,
                 gen: torch.Generator | None = None, zeros: bool = True,
                 device="cpu", centered: bool = False, k_fallback: str = "q4",
                 centered_q8: bool = False):
    """A linear layer in the given device format: 'q4k' = superblock
    QuantLinear (int8 sc/m + f16 d/dmin, the q4_k loader layout), 'q4'/'q8'
    = grouped-affine QuantLinear, 'bf16'/'f32' = dense.  Random q4k / q4
    weights are positive-biased (d sc q - dm m, s q); `centered` draws them
    around zero instead, about n_in^-0.5 in spread (m = sc and dm = 7.5 d,
    b = -7.5 s: w = d sc (q - 7.5), s (q - 7.5)), so that a stack of them
    keeps its activations' scale and its routing varied.  A 'q4k' weight
    whose n_in is not a multiple of 256 takes `k_fallback` instead: 'q8' is
    what the converter writes (q4_k -> q8_0, chatllm.cpp convert.py
    tensor_type_fallback).  No converted file holds the default 'q4' there;
    it is kept only so that the parameters built before 'q8' was offered
    (DeepSeek-V2-Lite's layer-0 down, K 10944) stay as they were.  Random
    'q8' weights are symmetric with scales up to 0.01 (about 0.42 in
    spread, whatever n_in); `centered_q8` draws their scales so that the
    spread is n_in^-0.5, as a centred q4k weight's."""
    G = 32
    b_t = None
    if bias and zeros:
        b_t = torch.zeros(n_out, dtype=torch.float32, device=device)
    elif bias:
        b_t = torch.randn(n_out, generator=gen, device=device) * 0.1
    if fmt == "q4k" and n_in % 256 != 0:
        fmt = k_fallback          # same gate as the q4_k loader (in % QK_K)
    if fmt == "q4k":
        SB = 8
        if zeros:
            q = torch.zeros(n_in // 2, n_out, dtype=torch.uint8, device=device)
            sc = torch.full((n_in // G, n_out), 20, dtype=torch.int8, device=device)
            m = torch.full((n_in // G, n_out), 10, dtype=torch.int8, device=device)
            d = torch.full((n_in // (G * SB), n_out), 0.001, dtype=torch.float16, device=device)
            dm = torch.full((n_in // (G * SB), n_out), 0.0005, dtype=torch.float16, device=device)
        elif centered:
            q = _randint(gen, 0, 255, (n_in // 2, n_out), torch.uint8, device)
            sc = _randint(gen, 0, 64, (n_in // G, n_out), torch.int8, device)
            m = sc.clone()
            d = _rand(gen, (n_in // (G * SB), n_out), 2 * n_in ** -0.5 / 193.6,
                      torch.float32, device)
            d, dm = d.to(torch.float16), (d * 7.5).to(torch.float16)
        else:
            q = _randint(gen, 0, 255, (n_in // 2, n_out), torch.uint8, device)
            sc = _randint(gen, 0, 64, (n_in // G, n_out), torch.int8, device)
            m = _randint(gen, 0, 64, (n_in // G, n_out), torch.int8, device)
            d = _rand(gen, (n_in // (G * SB), n_out), 0.002, torch.float16, device)
            dm = _rand(gen, (n_in // (G * SB), n_out), 0.001, torch.float16, device)
        return QuantLinear(q=q, s=sc, b=m, packed=True, d=d, dm=dm, sb=SB, bias=b_t)
    if fmt in ("q4", "q8"):
        packed = fmt == "q4"
        rows = n_in // 2 if packed else n_in
        if zeros:
            q = torch.zeros(rows, n_out, dtype=torch.uint8 if packed else torch.int8,
                            device=device)
            s = torch.full((n_in // G, n_out), 0.01, dtype=torch.float16, device=device)
        elif packed:
            q = _randint(gen, 0, 255, (rows, n_out), torch.uint8, device)
            s = _rand(gen, (n_in // G, n_out), 2 * n_in ** -0.5 / 5.32 if centered else 0.01,
                      torch.float16, device)
        else:
            # E[q^2] = 127^2 / 3 and E[s^2] = smax^2 / 3: smax = 3 / (127 n_in^0.5)
            # gives weights of spread n_in^-0.5
            q = _randint(gen, -127, 127, (rows, n_out), torch.int8, device)
            smax = 3.0 / 127.0 * n_in ** -0.5 if centered and centered_q8 else 0.01
            s = _rand(gen, (n_in // G, n_out), smax, torch.float16, device)
        b = None
        if packed:
            b = ((s.float() * -7.5).to(torch.float16) if centered and not zeros else
                 torch.zeros(n_in // G, n_out, dtype=torch.float16, device=device))
        return QuantLinear(q=q, s=s, b=b, packed=packed, bias=b_t)
    dt = torch.bfloat16 if fmt == "bf16" else torch.float32
    if zeros:
        w = torch.zeros(n_in, n_out, dtype=dt, device=device)
    else:
        w = (torch.randn(n_in, n_out, generator=gen, device=device) * 0.02).to(dt)
    return DenseLinear(w=w, bias=b_t)


def build_synthetic_params(cfg: TransformerConfig, fmt: str = "q4", *,
                           zeros: bool = True, compute_dtype=torch.bfloat16,
                           seed: int = 0, device="cpu", centered: bool = False,
                           fused: bool = False, k_fallback: str = "q4", mlp: str = "gated",
                           centered_q8: bool = False):
    """The parameter dict of `cfg` in format `fmt` (see synth_linear), zero
    or seeded random.  MLA layers (cfg.mla) get the converter's split kv
    projections, and in latent mode the absorbed wk_abs / wv_abs; MoE layers
    a router, `cfg.moe_num_experts` experts of width
    `cfg.moe_intermediate_size`, stacked
    dense in the compute dtype as the loader stacks them (random: N(0,
    1 / fan-in), drawn on the device), and a shared expert of width
    cfg.moe_shared_intermediate when it is not 0.  `centered`: see
    synth_linear.  Post-norms under cfg.post_norms (Gemma-2/3's sandwich).
    `fused`: the GLM2 architecture's consolidated q|k|v ("qkv") and gate|up
    ("gate_up") projections in place of the separate ones.  `k_fallback`:
    see synth_linear.  `mlp="plain"`: the dense FFN is up / down (Phi-2's
    fc1 / fc2).  Under cfg.o_bias (Phi-2's layout) the o projection, the
    dense FFN's linears and the head carry biases (q/k/v follow
    cfg.qkv_bias).  A LayerNorm config
    (cfg.norm_type) gets every norm's bias, zero beside its unit weight; a
    parallel-residual one no ffn_norm.  GPT-OSS's layout follows from its
    config: the softmax-top-k router (cfg.moe_score_func "softmax_topk")
    gets its bias ("gate_linear_bias", f32), `swiglu_oai` experts
    (cfg.moe_act) their gate_b / up_b [E, F] and down_b [E, H] in the
    compute dtype (random: N(0, 0.1^2)); with either, every layer gets one
    f32 sink logit a query head (N(0, 1) when random) and the head no bias
    under cfg.o_bias.  `centered_q8`: see synth_linear.  The defaults build
    what they built before these options existed, draw for draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    H = cfg.hidden_size
    d = cfg.resolved_head_dim()
    qo = cfg.num_attention_heads * d
    kvo = cfg.num_key_value_heads * d
    F = cfg.intermediate_size
    plain = mlp == "plain"
    biases = cfg.o_bias
    router_bias = cfg.moe_score_func == "softmax_topk"
    expert_biases = cfg.moe_act == "swiglu_oai"
    sinks = router_bias or expert_biases

    def lin(i, o, bias=False):
        return synth_linear(i, o, fmt, bias=bias, gen=gen, zeros=zeros, device=device,
                            centered=centered, k_fallback=k_fallback, centered_q8=centered_q8)

    def vec(*shape, scale=0.1, dtype=torch.float32):
        if zeros:
            return torch.zeros(shape, dtype=dtype, device=device)
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def ones(n=H):
        p = {"w": torch.ones(n, dtype=torch.float32, device=device)}
        if cfg.norm_type == "layernorm":
            p["b"] = torch.zeros(n, dtype=torch.float32, device=device)
        return p

    def stack(*shape):
        if zeros:
            return torch.zeros(shape, dtype=compute_dtype, device=device)
        return torch.randn(shape, generator=gen, device=device,
                           dtype=compute_dtype).mul_(shape[1] ** -0.5)

    def attention():
        if cfg.mla is None and fused:
            return {"qkv": lin(H, qo + 2 * kvo, cfg.qkv_bias), "o": lin(qo, H)}
        if cfg.mla is None:
            attn = {"q": lin(H, qo, cfg.qkv_bias), "k": lin(H, kvo, cfg.qkv_bias),
                    "v": lin(H, kvo, cfg.qkv_bias), "o": lin(qo, H, biases)}
            if cfg.qk_norm == "rmsnorm":          # Qwen3's per-head q/k norms
                attn.update(q_norm=ones(d), k_norm=ones(d))
            if sinks:
                attn["sinks"] = vec(cfg.num_attention_heads, scale=1.0)
            return attn
        m, h = cfg.mla, cfg.num_attention_heads
        attn = {"q": lin(H, h * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                "d_kv": lin(H, m.kv_lora_rank), "k_pe": lin(H, m.qk_rope_head_dim),
                "kv_norm": ones(m.kv_lora_rank),
                "u_k_nope": lin(m.kv_lora_rank, h * m.qk_nope_head_dim),
                "u_v": lin(m.kv_lora_rank, h * m.v_head_dim), "o": lin(h * m.v_head_dim, H)}
        if cfg.mla_compressed:
            from .deepseek import absorb_mla

            attn.update(absorb_mla(attn, cfg, compute_dtype))
        return attn

    def ffn(spec):
        if not spec.is_moe and fused:
            return {"gate_up": lin(H, 2 * F), "down": lin(F, H)}
        if not spec.is_moe and plain:
            return {"up": lin(H, F, biases), "down": lin(F, H, biases)}
        if not spec.is_moe:
            return {"gate": lin(H, F), "up": lin(H, F), "down": lin(F, H)}
        E, Fe, Fs = cfg.moe_num_experts, cfg.moe_intermediate_size, cfg.moe_shared_intermediate
        mlp = {"gate": lin(H, E),
               "experts": {"gate": stack(E, H, Fe), "up": stack(E, H, Fe),
                           "down": stack(E, Fe, H)}}
        if router_bias:
            mlp["gate_linear_bias"] = vec(E)
        if expert_biases:
            mlp["experts"].update(gate_b=vec(E, Fe, dtype=compute_dtype),
                                  up_b=vec(E, Fe, dtype=compute_dtype),
                                  down_b=vec(E, H, dtype=compute_dtype))
        if Fs:
            mlp["shared"] = {"gate": lin(H, Fs), "up": lin(H, Fs), "down": lin(Fs, H)}
        return mlp

    if zeros:
        embed = torch.zeros(cfg.vocab_size, H, dtype=compute_dtype, device=device)
    else:
        embed = (torch.randn(cfg.vocab_size, H, generator=gen, device=device)
                 * 0.02).to(compute_dtype)
    layers = []
    for i in range(cfg.num_hidden_layers):
        layer = {"attn_norm": ones(), "attn": attention()}
        if not cfg.parallel_residual:
            layer["ffn_norm"] = ones()
        layer["mlp"] = ffn(cfg.layer_spec(i))
        if cfg.post_norms:
            layer.update(post_attn_norm=ones(), post_ffn_norm=ones())
        layers.append(layer)
    params = {"embed": embed, "final_norm": ones(), "layers": tuple(layers)}
    if not cfg.tie_lm_head:
        params["lm_head"] = lin(H, cfg.vocab_size, biases and not sinks)
    return params


def llama3_8b_config(max_length: int = 8192) -> TransformerConfig:
    """Llama-3-8B shape (BASELINE.json config #2)."""
    return TransformerConfig(
        vocab_size=128256, hidden_size=4096, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8,
        intermediate_size=14336, max_length=max_length,
        rope=RopeConfig(head_dim=128, freq_base=500000.0, layout=ROPE_NEOX),
        norm_eps=1e-5,
    )


def mistral_7b_config(max_length: int = 8192) -> TransformerConfig:
    """Mistral-7B as published (Hugging Face `mistralai/Mistral-7B-v0.1`,
    config.json): vocab_size 32000, hidden_size 4096, num_hidden_layers 32,
    num_attention_heads 32, num_key_value_heads 8 (head_dim 128),
    intermediate_size 14336, sliding_window 4096 on every layer, rope_theta
    10000, max_position_embeddings 32768, tie_word_embeddings false; RMS eps
    1e-6 and the interleaved rope layout, as the MISTRAL loader builds them
    (models/mistral.py).  Only max_length is cut: at 8192 every layer's
    cache is a ring of 4096 + SWA_EXTRA = 4608 slots; at 4608 or less the
    same model takes the dense windowed route."""
    from ..nn.transformer import LayerSpec

    return TransformerConfig(
        vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8,
        intermediate_size=14336, max_length=max_length,
        rope=RopeConfig(head_dim=128, freq_base=10000.0, layout=ROPE_NORMAL),
        norm_eps=1e-6, layer_specs=tuple(LayerSpec(sliding_window=4096) for _ in range(32)),
    )


def glm4_9b_config(max_length: int = 8192) -> TransformerConfig:
    """GLM-4-9B as published (Hugging Face `THUDM/glm-4-9b-chat`,
    config.json): padded_vocab_size 151552, hidden_size 4096, num_layers 40,
    num_attention_heads 32, multi_query_group_num 2, kv_channels 128,
    ffn_hidden_size 13696, add_qkv_bias, untied output_layer, rope_ratio 500
    (rope base 10000 x 500); as the GLM4 loader builds it (models/glm.py:
    the interleaved rope on half of each head, RMS eps 1e-5, which is what
    `load_model` keeps: it overrides eps only from `rms_norm_eps`, and GLM's
    config.json says `layernorm_epsilon`).  Only max_length is cut.  The
    FFN is not a multiple of 256, so a q4_k file stores `dense_4h_to_h` as
    q8_0 (build_synthetic_params(..., k_fallback="q8"))."""
    return TransformerConfig(
        vocab_size=151552, hidden_size=4096, num_hidden_layers=40,
        num_attention_heads=32, num_key_value_heads=2,
        intermediate_size=13696, max_length=max_length,
        rope=RopeConfig(head_dim=128, rot_dim=64, freq_base=10000.0 * 500,
                        layout=ROPE_NORMAL),
        norm_eps=1e-5, qkv_bias=True)


# Phi-3.5-mini-instruct's LongRoPE long_factor (config.json rope_scaling), one
# per pair of a head's 96 dims, as f32 values: what the PHI3_SU2 loader reads
# from a converted file (the first rot / 2 of the 128 stored).
PHI3_5_MINI_LONG_FACTOR = (
    1.0800000429153442, 1.1100000143051147, 1.1399999856948853, 1.340000033378601,
    1.5899999141693115, 1.600000023841858, 1.6200000047683716, 2.620000123977661,
    3.2300000190734863, 3.2300000190734863, 4.789999961853027, 7.400000095367432,
    7.700000286102295, 9.09000015258789, 12.199999809265137, 17.670000076293945,
    24.46000099182129, 28.57000160217041, 30.420001983642578, 30.840002059936523,
    32.590003967285156, 32.93000411987305, 42.320003509521484, 44.96000289916992,
    50.340003967285156, 50.45000457763672, 57.55000305175781, 57.93000411987305,
    58.21000289916992, 60.1400032043457, 62.61000442504883, 62.62000274658203,
    62.71000289916992, 63.1400032043457, 63.1400032043457, 63.77000427246094,
    63.93000411987305, 63.96000289916992, 63.970001220703125, 64.02999877929688,
    64.06999969482422, 64.08000183105469, 64.12000274658203, 64.41000366210938,
    64.4800033569336, 64.51000213623047, 64.52999877929688, 64.83999633789062)


def phi3_5_mini_config(max_length: int = 8192) -> TransformerConfig:
    """Phi-3.5-mini-instruct as published (Hugging Face
    `microsoft/Phi-3.5-mini-instruct`, config.json): vocab_size 32064,
    hidden_size 3072, num_hidden_layers 32, num_attention_heads 32,
    num_key_value_heads 32 (head dim 96), intermediate_size 8192,
    rope_theta 10000, rope_scaling longrope over
    original_max_position_embeddings 4096 of max_position_embeddings 131072,
    sliding_window 262144, rms_norm_eps 1e-5, untied head; as the PHI3_SU2
    loader builds it (models/phi.py: the interleaved rope the converter
    permutes q/k into, the long factors, mscale sqrt(1 + ln 32 / ln 4096),
    every layer windowed over 262145 keys, which no cache of max_length
    slots reaches: the dense windowed route, no ring).  Only max_length is
    cut."""
    import math

    from ..nn.transformer import LayerSpec

    mscale = math.sqrt(1.0 + math.log(131072 / 4096) / math.log(4096))
    return TransformerConfig(
        vocab_size=32064, hidden_size=3072, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32,
        intermediate_size=8192, max_length=max_length,
        rope=RopeConfig(head_dim=96, freq_base=10000.0, layout=ROPE_NORMAL,
                        freq_factors=PHI3_5_MINI_LONG_FACTOR, mscale_all=mscale),
        norm_eps=1e-5, layer_specs=tuple(LayerSpec(sliding_window=262145) for _ in range(32)))


def phi2_config(max_length: int = 4096) -> TransformerConfig:
    """Phi-2 as published (Hugging Face `microsoft/phi-2`, config.json):
    vocab_size 51200, hidden_size 2560, num_hidden_layers 32,
    num_attention_heads 32 (MHA, head dim 80), intermediate_size 10240,
    partial_rotary_factor 0.4 (NeoX rope on 32 of 80 dims), rope_theta
    10000, layer_norm_eps 1e-5, gelu_new (tanh GELU), biases on every
    projection and on the untied head, a parallel residual; as the PHI2_V2
    loader builds it (models/phi.py).  max_length 4096 is above the trained
    2048, so that a q8 cache takes K4 (attention.py's 4096-slot threshold);
    rope past the trained positions means nothing on random weights."""
    return TransformerConfig(
        vocab_size=51200, hidden_size=2560, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32,
        intermediate_size=10240, max_length=max_length, act="gelu_tanh",
        norm_type="layernorm", norm_eps=1e-5,
        rope=RopeConfig(head_dim=80, rot_dim=32, freq_base=10000.0, layout=ROPE_NEOX),
        qkv_bias=True, o_bias=True, parallel_residual=True)


def gemma3_12b_config(max_length: int = 8192) -> TransformerConfig:
    """Gemma-3-12B's text model as published (Hugging Face
    `google/gemma-3-12b-it`, config.json `text_config`): vocab_size 262208,
    hidden_size 3840, num_hidden_layers 48, intermediate_size 15360,
    num_attention_heads 16, num_key_value_heads 8, head_dim 256,
    query_pre_attn_scalar 256, sliding_window 1024 with
    sliding_window_pattern 6 (layer i global iff (i + 1) % 6 == 0),
    rope_theta 1e6 with linear rope_scaling factor 8, rope_local_base_freq
    1e4, rms_norm_eps 1e-6, gelu_pytorch_tanh, tied embeddings; as the
    GEMMA3 loader builds it (models/gemma.py: NeoX rope, q/k norms, sandwich
    norms, the head scaled by 1/sqrt(hidden)).  Only max_length is cut: at
    8192 the 40 sliding layers keep rings of 1024 + SWA_EXTRA = 1536 slots
    beside 8 full layers of 8192; at 1536 or less no layer is a ring (the
    dense windowed route)."""
    from ..nn.transformer import LayerSpec

    return TransformerConfig(
        vocab_size=262208, hidden_size=3840, num_hidden_layers=48,
        num_attention_heads=16, num_key_value_heads=8, head_dim=256,
        intermediate_size=15360, max_length=max_length, act="gelu_tanh", norm_eps=1e-6,
        rope=RopeConfig(head_dim=256, freq_base=1e6, freq_scale=1.0 / 8, layout=ROPE_NEOX),
        rope_local=RopeConfig(head_dim=256, freq_base=1e4, layout=ROPE_NEOX),
        attention_scale=256 ** -0.5, qk_norm="rmsnorm", post_norms=True,
        layer_specs=tuple(LayerSpec() if (i + 1) % 6 == 0
                          else LayerSpec(sliding_window=1024, local_rope=True)
                          for i in range(48)),
        tie_lm_head=True, logit_scale=3840 ** -0.5)


def gemma2_9b_config(max_length: int = 8192) -> TransformerConfig:
    """Gemma-2-9B as published (Hugging Face `google/gemma-2-9b-it`,
    config.json): vocab_size 256000, hidden_size 3584, num_hidden_layers 42,
    intermediate_size 14336, num_attention_heads 16, num_key_value_heads 8,
    head_dim 256, query_pre_attn_scalar 256, sliding_window 4096 on the even
    layers, attn_logit_softcapping 50, final_logit_softcapping 30,
    rope_theta 1e4, rms_norm_eps 1e-6, gelu_pytorch_tanh, tied embeddings;
    as the GEMMA2 loader builds it (models/gemma.py: interleaved rope,
    sandwich norms, the head scaled by 1/sqrt(hidden)).  Only max_length is
    cut: at 8192 the even layers keep rings of 4096 + SWA_EXTRA = 4608
    slots."""
    from ..nn.transformer import LayerSpec

    return TransformerConfig(
        vocab_size=256000, hidden_size=3584, num_hidden_layers=42,
        num_attention_heads=16, num_key_value_heads=8, head_dim=256,
        intermediate_size=14336, max_length=max_length, act="gelu_tanh", norm_eps=1e-6,
        rope=RopeConfig(head_dim=256, freq_base=1e4, layout=ROPE_NORMAL),
        attention_scale=256 ** -0.5, logit_softcap=50.0, final_logit_softcap=30.0,
        post_norms=True,
        layer_specs=tuple(LayerSpec(sliding_window=4096 if i % 2 == 0 else 0)
                          for i in range(42)),
        tie_lm_head=True, logit_scale=3584 ** -0.5)


# build_synthetic_params' options for GPT-OSS (its layout follows from the
# config): q/k/v, the router and the head (K 2880, not a multiple of 256) in
# q8_0, as the converter writes them, drawn at n_in^-0.5 with the rest of a
# centred model
GPT_OSS_OPTS = dict(k_fallback="q8", centered_q8=True)


def gpt_oss_20b_config(max_length: int = 8192) -> TransformerConfig:
    """GPT-OSS-20B as published (Hugging Face `openai/gpt-oss-20b`,
    config.json): vocab_size 201088, hidden_size 2880, num_hidden_layers
    24, num_attention_heads 64, num_key_value_heads 8, head_dim 64,
    num_local_experts 32 of intermediate_size 2880, num_experts_per_tok 4,
    sliding_window 128 on the layers `layer_types` marks
    sliding_attention (the even ones, layer 0 first), rope_theta 150000
    with YaRN (factor 32 over original_max_position_embeddings 4096,
    beta_fast 32, beta_slow 1), swiglu_limit 7.0, rms_norm_eps 1e-5,
    attention biases, untied head; as the GPT_OSS loader builds it
    (models/gpt_oss.py: NeoX rope, the softmax over the top 4 of the
    biased router logits, `swiglu_oai`; every FFN a MoE; build_synthetic_params
    gives it the sinks and the biases).  Only
    max_length is cut: at 8192 the sliding layers keep rings of 128 +
    SWA_EXTRA = 640 slots beside 12 full layers of 8192."""
    from ..nn.transformer import LayerSpec

    return TransformerConfig(
        vocab_size=201088, hidden_size=2880, num_hidden_layers=24,
        num_attention_heads=64, num_key_value_heads=8, head_dim=64,
        intermediate_size=2880, max_length=max_length, norm_eps=1e-5,
        rope=RopeConfig(head_dim=64, freq_base=150000.0, layout=ROPE_NEOX,
                        freq_scale=1.0 / 32, ext_factor=1.0, beta_fast=32.0, beta_slow=1.0,
                        orig_ctx=4096),
        layer_specs=tuple(LayerSpec(sliding_window=128 if i % 2 == 0 else 0, is_moe=True)
                          for i in range(24)),
        qkv_bias=True, o_bias=True, moe_num_experts=32, moe_top_k=4,
        moe_intermediate_size=2880, moe_score_func="softmax_topk", moe_act="swiglu_oai",
        moe_swiglu_limit=7.0)


def qwen2_5_0_5b_config(max_length: int = 32768) -> TransformerConfig:
    """Qwen2.5-0.5B-Instruct as published (Hugging Face
    `Qwen/Qwen2.5-0.5B-Instruct`, config.json; BASELINE.json config #1):
    biased q/k/v, 14 query heads over 2 kv heads, tied lm_head."""
    return TransformerConfig(
        vocab_size=151936, hidden_size=896, num_hidden_layers=24,
        num_attention_heads=14, num_key_value_heads=2,
        intermediate_size=4864, max_length=max_length,
        rope=RopeConfig(head_dim=64, freq_base=1000000.0, layout=ROPE_NEOX),
        norm_eps=1e-6, qkv_bias=True, tie_lm_head=True,
    )


def deepseek_v2_lite_config(max_length: int = 8192, *,
                            mla_cache: str = "speed") -> TransformerConfig:
    """DeepSeek-V2-Lite as published (Hugging Face `deepseek-ai/DeepSeek-V2-Lite`,
    config.json; BASELINE.json config #3), only max_length cut:
    num_hidden_layers 27, hidden_size 2048, num_attention_heads 16,
    vocab_size 102400, intermediate_size 10944 (the dense layer 0:
    first_k_dense_replace 1, moe_layer_freq 1); n_routed_experts 64,
    moe_intermediate_size 1408, n_shared_experts 2 (shared width 2 x 1408
    = 2816), num_experts_per_tok 6, norm_topk_prob false,
    routed_scaling_factor 1.0, n_group 1, topk_group 1, scoring_func softmax; kv_lora_rank 512, q_lora_rank null,
    qk_nope_head_dim 128, qk_rope_head_dim 64, v_head_dim 128; rope_theta
    10000, rope_scaling yarn with factor 40,
    original_max_position_embeddings 4096, beta_fast 32, beta_slow 1,
    mscale 0.707, mscale_all_dim 0.707; rms_norm_eps 1e-6.  The rope table
    and attention scale are the loader's (models/deepseek.py::yarn_rope)."""
    from ..nn.transformer import LayerSpec, MLAConfig
    from .deepseek import yarn_rope

    rope, attn_scale = yarn_rope(128, 64, 10000.0, 40.0, 0.707, 0.707, 32.0, 1.0, 4096)
    return TransformerConfig(
        vocab_size=102400, hidden_size=2048, num_hidden_layers=27,
        num_attention_heads=16, num_key_value_heads=16, intermediate_size=10944,
        max_length=max_length, norm_eps=1e-6, rope=rope, attention_scale=attn_scale,
        layer_specs=tuple(LayerSpec(is_moe=i >= 1) for i in range(27)),
        moe_num_experts=64, moe_top_k=6, moe_norm_topk_prob=False, moe_intermediate_size=1408,
        moe_shared_intermediate=2 * 1408, moe_n_group=1,
        moe_topk_group=1, moe_routed_scale=1.0, moe_score_func="softmax",
        mla=MLAConfig(q_lora_rank=0, kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        mla_compressed=mla_cache == "memory")


def internvl3_5_8b_config(max_length: int = 8192) -> TransformerConfig:
    """InternVL3.5-8B's LLM, Qwen3-8B as published (Hugging Face
    `OpenGVLab/InternVL3_5-8B`, config.json `llm_config`): vocab_size 151936,
    hidden_size 4096, num_hidden_layers 36, num_attention_heads 32,
    num_key_value_heads 8, head_dim 128, intermediate_size 12288, rope_theta
    1e6, rms_norm_eps 1e-6, tie_word_embeddings false; per-head RMS q/k
    norms.  Only max_length is cut."""
    return TransformerConfig(
        vocab_size=151936, hidden_size=4096, num_hidden_layers=36,
        num_attention_heads=32, num_key_value_heads=8, head_dim=128,
        intermediate_size=12288, max_length=max_length,
        rope=RopeConfig(head_dim=128, freq_base=1000000.0, layout=ROPE_NEOX),
        norm_eps=1e-6, qk_norm="rmsnorm")


def qwen3_30b_a3b_config(max_length: int = 8192) -> TransformerConfig:
    """Qwen3-30B-A3B as published (Hugging Face `Qwen/Qwen3-30B-A3B`,
    config.json): vocab_size 151936, hidden_size 2048, num_hidden_layers 48,
    every layer sparse (decoder_sparse_step 1, no mlp_only_layers),
    num_attention_heads 32, num_key_value_heads 4, head_dim 128, num_experts
    128, num_experts_per_tok 8, moe_intermediate_size 768, norm_topk_prob
    true, no shared expert, rope_theta 1e6, rms_norm_eps 1e-6,
    tie_word_embeddings false; per-head RMS q/k norms.  Only max_length is
    cut.  (intermediate_size 6144 is the dense FFN's, which no layer has.)"""
    from ..nn.transformer import LayerSpec

    return TransformerConfig(
        vocab_size=151936, hidden_size=2048, num_hidden_layers=48,
        num_attention_heads=32, num_key_value_heads=4, head_dim=128,
        intermediate_size=6144, max_length=max_length,
        rope=RopeConfig(head_dim=128, freq_base=1000000.0, layout=ROPE_NEOX),
        norm_eps=1e-6, qk_norm="rmsnorm",
        layer_specs=tuple(LayerSpec(is_moe=True) for _ in range(48)),
        moe_num_experts=128, moe_top_k=8, moe_norm_topk_prob=True,
        moe_intermediate_size=768, moe_score_func="softmax")


def internvit_300m_config():
    """InternVL3.5-8B's tower, InternViT-300M-448px-V2_5 (the same config.json,
    `vision_config`): hidden_size 1024, num_hidden_layers 24,
    num_attention_heads 16, intermediate_size 4096, patch_size 14,
    image_size 448, layer_norm_eps 1e-6, qkv_bias true, exact GELU, a class
    token and layer scales."""
    from .internvl import internvit_config

    return internvit_config(hidden=1024, layers=24, heads=16, inter=4096, patch=14,
                            image_size=448, eps=1e-6)


def build_synthetic_vision(vcfg, lm_hidden: int, *, downsample_ratio: float = 0.5,
                           dtype=torch.bfloat16, ls_scale: float = 0.1, seed: int = 0,
                           device="cpu") -> dict:
    """A seeded InternViT tower and projector in the loader's layout: the
    patch weight [p, p, 3, hidden], class token, position table, norms,
    biases and layer scales in f32; the linears dense in `dtype` with f32
    biases.  Weights are N(0, 1 / fan-in), biases and embeddings N(0,
    0.02²), LayerNorm weights 1 and biases 0, every layer scale `ls_scale`,
    so that the residual stream stays O(1) over the tower's depth."""
    gen = torch.Generator(device=device).manual_seed(seed)
    Hv, F = vcfg.hidden_size, vcfg.intermediate_size
    fac = int(round(1 / downsample_ratio))
    Hp = Hv * fac * fac

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    def lin(i, o):
        return DenseLinear(w=randn(i, o, scale=i ** -0.5).to(dtype), bias=randn(o, scale=0.02))

    def ln(n):
        return {"w": torch.ones(n, device=device), "b": torch.zeros(n, device=device)}

    p, n_pos = vcfg.patch_size, vcfg.grid ** 2 + 1
    layers = tuple({"norm1": ln(Hv), "attn": {k: lin(Hv, Hv) for k in ("q", "k", "v", "o")},
                    "norm2": ln(Hv), "mlp": {"fc0": lin(Hv, F), "fc1": lin(F, Hv)},
                    "ls1": torch.full((Hv,), ls_scale, device=device),
                    "ls2": torch.full((Hv,), ls_scale, device=device)}
                   for _ in range(vcfg.num_hidden_layers))
    return {"embed": {"proj_w": randn(p, p, 3, Hv, scale=(p * p * 3) ** -0.5),
                      "proj_b": randn(Hv, scale=0.02), "cls": randn(1, Hv, scale=0.02),
                      "pos": randn(n_pos, Hv, scale=0.02)},
            "projector": {"ln": ln(Hp), "fc0": lin(Hp, lm_hidden), "fc1": lin(lm_hidden, lm_hidden)},
            "layers": layers}


def tiny_config(*, vocab=512, hidden=128, layers=2, heads=4, kv_heads=2,
                inter=256, max_length=256) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=vocab, hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, num_key_value_heads=kv_heads,
        intermediate_size=inter, max_length=max_length,
        rope=RopeConfig(head_dim=hidden // heads, layout=ROPE_NEOX))


def param_bytes(params) -> int:
    """Bytes of every tensor in a parameter tree (dicts, tuples and the
    DenseLinear / QuantLinear fields)."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(param_bytes(v) for v in params)
    if isinstance(params, (DenseLinear, QuantLinear)):
        return sum(param_bytes(v) for v in vars(params).values())
    return 0
