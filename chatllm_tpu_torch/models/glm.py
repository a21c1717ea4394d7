"""GLM family (counterpart of the JAX package's `models/glm.py`: CHATGLM2,
CODEGEEX2, CHATGLM3, GLM4, CODEGEEX4, GLM4_0414 and CHARACTERGLM).

The GLM2-architecture generations (ChatGLM2/3, GLM-4, CodeGeeX) carry one
consolidated q|k|v projection with a bias (`query_key_value`) and a fused
gate|up SwiGLU projection (`dense_h_to_4h`), rotate half of each head with
interleaved rope, and have an untied head.  GLM-4-0414 has separate q/k/v,
the sandwich norms and a rope width and base of its own.  ChatGLM-6B (v1)
is not ported: its 2-D rope and GLM residual come with the residual
variants (ROADMAP.md section 1), and loading it fails naming its type.
"""
from __future__ import annotations

from ..nn.transformer import TransformerConfig
from ..ops.rope import ROPE_NORMAL, RopeConfig
from ..runtime.chat import ChatTokenizer, HistoryEncoder
from ..tokenizer.processor import BPEProcessor1, BPEProcessor2
from .base import BaseConfig, BaseLLM, ParamBuilder, RuntimeConfig, register_model
from .model_types import ModelType

# chatllm.cpp models/chatglm.cpp v4 Tokenizer regex
GLM4_REGEX = [
    r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
]


class GLM4Encoder(HistoryEncoder):
    """[gMASK]<sop><|role|>\\n content template (chatllm.cpp models/chatglm.cpp v4)."""

    add_nl_token = True

    def _role(self, ids, role_tok):
        ids.append(role_tok)
        if self.add_nl_token:
            ids.append(self.tokenizer.nl_token_id)

    def append_sys_prompt(self, ids):
        tok = self.tokenizer
        ids.extend([tok.gmask_token_id, tok.sop_token_id])
        if tok.sys_prompt:
            self._role(ids, tok.system_token_id)
            ids.extend(tok.encode(tok.sys_prompt))

    def append_user(self, round_idx, user, ids):
        self._role(ids, self.tokenizer.user_token_id)
        ids.extend(self.tokenizer.encode(user))

    def append_ai(self, round_idx, ai, ids):
        self.append_ai_opening(round_idx, ids)
        ids.extend(self.tokenizer.encode(ai))

    def append_ai_opening(self, round_idx, ids):
        self._role(ids, self.tokenizer.assistant_token_id)


GLM4_SPECIALS = ("mask", "gmask", "smask", "sop", "eop", "system", "user", "assistant",
                 "observation")


def make_glm4_tokenizer(gf, base: BaseConfig) -> ChatTokenizer:
    """chatllm.cpp models/chatglm.cpp v4 Tokenizer::do_load: the special ids
    follow <|endoftext|> one after another."""
    tp = BPEProcessor2(GLM4_REGEX)
    tp.load(gf.tokenizer_reader(), base.vocab_size)
    tp.enable_return_special_token(True)
    tok = ChatTokenizer(tp, GLM4Encoder(), sys_prompt="")
    eos = base.eos_token_id
    if eos < 0:
        eos = tp.piece_to_id("<|endoftext|>")
    tok.eos_token_id = eos
    tok.bos_token_id = base.bos_token_id
    for j, name in enumerate(GLM4_SPECIALS):
        setattr(tok, f"{name}_token_id", eos + 1 + j)
    tok.nl_token_id = tp.encode("\n")[0]
    tok.terminate_ids |= {eos, tok.user_token_id, tok.observation_token_id}
    specials = {eos} | {getattr(tok, f"{name}_token_id") for name in GLM4_SPECIALS}
    tok.is_special_id = lambda i: i in specials
    return tok


def load_glm2_params(pb: ParamBuilder, n_layers: int) -> dict:
    """The GLM2 architecture's weights (chatllm.cpp convert.py
    ChatGLM2Converter names): fused `qkv` and `gate_up`."""
    params = {
        "embed": pb.embedding("transformer.embedding.word_embeddings.weight"),
        "final_norm": pb.norm("transformer.encoder.final_layernorm"),
        "lm_head": pb.linear("transformer.output_layer"),
        "layers": [],
    }
    for i in range(n_layers):
        pfx = f"transformer.encoder.layers.{i}"
        params["layers"].append({
            "attn_norm": pb.norm(f"{pfx}.input_layernorm"),
            "attn": {
                "qkv": pb.linear(f"{pfx}.self_attention.query_key_value"),
                "o": pb.linear(f"{pfx}.self_attention.dense"),
            },
            "ffn_norm": pb.norm(f"{pfx}.post_attention_layernorm"),
            "mlp": {
                "gate_up": pb.linear(f"{pfx}.mlp.dense_h_to_4h"),
                "down": pb.linear(f"{pfx}.mlp.dense_4h_to_h"),
            },
        })
    params["layers"] = tuple(params["layers"])
    return params


def _glm_config(base: BaseConfig, rt: RuntimeConfig, n_kv: int, rope: RopeConfig,
                **kw) -> TransformerConfig:
    """What the GLM loaders share: RMS eps 1e-5 (load_model overrides it
    only from a file's `rms_norm_eps`), the file's context unless the
    runtime cuts it."""
    return TransformerConfig(
        vocab_size=base.vocab_size, hidden_size=base.hidden_size,
        num_hidden_layers=base.num_hidden_layers,
        num_attention_heads=base.num_attention_heads, num_key_value_heads=n_kv,
        intermediate_size=base.intermediate_size,
        max_length=rt.max_length if rt.max_length > 0 else base.max_length,
        norm_eps=1e-5, rope=rope, cache_dtype=rt.cache_dtype, **kw)


class GLM2Encoder(HistoryEncoder):
    """ChatGLM2's template: every piece is prefixed [gMASK] sop; rounds read
    "[Round N]\\n\\n问：...\\n\\n答：..." (chatllm.cpp models/chatglm.cpp v2)."""

    def _enc(self, text, ids):
        tok = self.tokenizer
        ids.extend([tok.gmask_token_id, tok.sop_token_id])
        ids.extend(tok.encode(text))

    def append_user(self, round_idx, user, ids):
        self._enc(f"[Round {round_idx + 1}]\n\n问：{user}\n\n", ids)

    def append_ai(self, round_idx, ai, ids):
        self._enc(f"答：{ai}\n\n", ids)

    def append_ai_opening(self, round_idx, ids):
        self._enc("答：", ids)


@register_model(ModelType.CHATGLM2, ModelType.CODEGEEX2, ModelType.CHATGLM3)
class ChatGLM2(BaseLLM):
    """ChatGLM2/3 and CodeGeeX2: BaseConfig + num_kv_heads (chatllm.cpp
    models/chatglm.h:46-49); SentencePiece-score vocab whose special ids
    start at its piece count."""
    EXTRA_FMT = "i"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv,) = BaseConfig.parse(gf, cls.EXTRA_FMT)
        d = base.hidden_size // base.num_attention_heads
        cfg = _glm_config(base, rt, n_kv, RopeConfig(head_dim=d, rot_dim=d // 2,
                                                     freq_base=10000.0, layout=ROPE_NORMAL))
        tp = BPEProcessor1()
        tp.load(gf.tokenizer_reader(), base.vocab_size)
        tok = ChatTokenizer(tp, GLM2Encoder(), sys_prompt="")
        tok.bos_token_id = base.bos_token_id
        tok.eos_token_id = base.eos_token_id
        sid = tp.get_piece_size()
        for j, name in enumerate(("mask", "gmask", "smask", "sop", "eop")):
            setattr(tok, f"{name}_token_id", sid + j)
        tok.is_special_id = lambda i: i >= sid
        params = load_glm2_params(ParamBuilder(gf, rt, device), base.num_hidden_layers)
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.GLM4_0414)
class GLM40414(BaseLLM):
    """GLM-4-0414 (HF Glm4ForCausalLM; chatllm.cpp models/chatglm.h
    glm4_0414): separate q/k/v, partial interleaved rope of the file's width
    and base, sandwich norms."""
    # BaseConfig + {n_kv, use_attention_bias, rope_dim} + rope_theta
    EXTRA_FMT = "3if"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv, attn_bias, rope_dim, rope_theta) = BaseConfig.parse(gf, cls.EXTRA_FMT)
        d = base.hidden_size // base.num_attention_heads
        cfg = _glm_config(base, rt, n_kv, RopeConfig(head_dim=d, rot_dim=rope_dim,
                                                     freq_base=rope_theta, layout=ROPE_NORMAL),
                          post_norms=True, qkv_bias=bool(attn_bias))
        tok = make_glm4_tokenizer(gf, base)
        pb = ParamBuilder(gf, rt, device)
        params = {
            "embed": pb.embedding("model.embed_tokens.weight"),
            "final_norm": pb.norm("model.norm"),
            "lm_head": pb.linear("lm_head"),
            "layers": [],
        }
        for i in range(base.num_hidden_layers):
            pfx = f"model.layers.{i}"
            params["layers"].append({
                "attn_norm": pb.norm(f"{pfx}.input_layernorm"),
                "attn": {n: pb.linear(f"{pfx}.self_attn.{n}_proj") for n in "qkvo"},
                "post_attn_norm": pb.norm(f"{pfx}.post_self_attn_layernorm"),
                "ffn_norm": pb.norm(f"{pfx}.post_attention_layernorm"),
                "post_ffn_norm": pb.norm(f"{pfx}.post_mlp_layernorm"),
                "mlp": {n: pb.linear(f"{pfx}.mlp.{n}_proj") for n in ("gate", "up", "down")},
            })
        params["layers"] = tuple(params["layers"])
        return cls(gf.model_type, cfg, params, tok, device)


@register_model(ModelType.GLM4, ModelType.CODEGEEX4)
class GLM4(BaseLLM):
    """GLM-4 and CodeGeeX4: BaseConfig + num_kv_heads + rope_ratio
    (chatllm.cpp models/chatglm.h:46-49, 123-126); rope on half of each
    head, its base 10000 times rope_ratio."""
    EXTRA_FMT = "if"

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        base, (n_kv, rope_ratio) = BaseConfig.parse(gf, cls.EXTRA_FMT)
        d = base.hidden_size // base.num_attention_heads
        cfg = _glm_config(base, rt, n_kv, RopeConfig(head_dim=d, rot_dim=d // 2,
                                                     freq_base=10000.0 * rope_ratio,
                                                     layout=ROPE_NORMAL))
        tok = make_glm4_tokenizer(gf, base)
        params = load_glm2_params(ParamBuilder(gf, rt, device), base.num_hidden_layers)
        return cls(gf.model_type, cfg, params, tok, device)


class CharacterGLMEncoder(HistoryEncoder):
    """Persona dialogue framing (chatllm.cpp models/characterglm.cpp:44-110)."""

    def __init__(self):
        super().__init__()
        self.user_name, self.bot_name = "Human", "CharacterGLM"
        self.user_info, self.bot_info = "", ""

    def append_sys_prompt(self, ids):
        oss = f"以下是一段{self.user_name}和{self.bot_name}之间的对话。\n"
        if self.bot_info:
            oss += f"关于{self.bot_name}的信息：{self.bot_info}\n"
        if self.user_info:
            oss += f"关于{self.user_name}的信息：{self.user_info}\n"
        ids.extend(self.tokenizer.encode(oss))

    def append_user(self, round_idx, user, ids):
        ids.extend(self.tokenizer.encode(f"[{self.user_name}]{user}\n"))

    def append_ai(self, round_idx, ai, ids):
        self.append_ai_opening(round_idx, ids)
        ids.extend(self.tokenizer.encode(ai + "\n"))

    def append_ai_opening(self, round_idx, ids):
        ids.extend(self.tokenizer.encode(f"[{self.bot_name}]"))


@register_model(ModelType.CHARACTERGLM)
class CharacterGLM(BaseLLM):
    """ChatGLM2's architecture with a persona template; `--set user_name /
    bot_name / user_info / bot_info` reach its encoder (chatllm.cpp
    characterglm.cpp set_additional_args)."""

    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        lm = ChatGLM2.load(gf, rt, device)
        model = cls(gf.model_type, lm.cfg, lm.params, lm.tokenizer, device)
        enc = CharacterGLMEncoder()
        enc.tokenizer = model.tokenizer
        model.tokenizer.chat_encoder = enc
        return model

    def set_additional_args(self, args: dict):
        enc = self.tokenizer.chat_encoder
        for k in ("user_name", "bot_name", "user_info", "bot_info"):
            if k in args:
                setattr(enc, k, args[k])
