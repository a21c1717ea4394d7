"""Model framework: registry, config parsing, weight loading (counterpart of
the JAX package's `models/base.py`).

Per-arch modules register a loader keyed by the on-disk ModelType id; the
loader parses the binary Config struct, builds the tokenizer from the file's
vocab span, and maps GGMM tensor names into the parameter dict, placing
every tensor on the model's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..ggmm.quants import GGMLType, dequantize, quantize
from ..ggmm.reader import GGMMFile
from ..nn.transformer import TransformerConfig
from ..ops.qtensor import linear_from_ggml
from ..runtime.chat import ChatTokenizer
from ..runtime.generate import InferenceEngine, PerfInfo

_REGISTRY: dict[int, type] = {}


def register_model(*types):
    def deco(cls):
        for t in types:
            _REGISTRY[int(t)] = cls
        return cls
    return deco


def lookup_model(model_type: int):
    return _REGISTRY.get(int(model_type))


@dataclass
class RuntimeConfig:
    """Runtime options (reference RuntimeConfig + Args subset)."""
    weight_dtype: str = "auto"      # auto = keep quantized | bfloat16 | float32
    compute_dtype: str = "bfloat16" # activation dtype
    cache_dtype: str = "bfloat16"   # KV cache dtype
    max_length: int = -1            # context override (-1 = model default)
    re_quantize: str = ""           # on-the-fly requantization target of the
                                    # 2-D weights, e.g. "q4_0"/"q4_k"/"q8_0"
    mla_cache: str = "speed"        # MLA cache mode: "speed" (expanded per-head
                                    # K/V) | "memory" (latent cache)
    additional: dict = field(default_factory=dict)  # --set k v
    layer_spec: str = ""            # --layer_spec "0:3,1:4": rebuild the stack
                                    # from half-open source-layer ranges
                                    # (duplicates share weights)


@dataclass
class BaseConfig:
    """The common binary config header every arch embeds
    (chatllm.cpp src/chat.h:243-263): 11 little-endian i32."""
    dtype: int
    vocab_size: int
    hidden_size: int
    num_attention_heads: int
    num_hidden_layers: int
    intermediate_size: int
    max_length: int
    bos_token_id: int
    eos_token_id: int
    pad_token_id: int
    sep_token_id: int

    STRUCT_FMT = "11i"

    @classmethod
    def parse(cls, gf: GGMMFile, extra_fmt: str = ""):
        """Parse BaseConfig (+ trailing per-arch fields given by extra_fmt).
        Returns (BaseConfig, tuple)."""
        vals = gf.read_config(cls.STRUCT_FMT + extra_fmt)
        return cls(*vals[:11]), vals[11:]


class ParamBuilder:
    """Reads named tensors from a GGMMFile onto the device, applying the
    runtime dtype policy (keep-quantized vs dequantize-at-load)."""

    def __init__(self, gf: GGMMFile, rt: RuntimeConfig, device: torch.device):
        self.gf = gf
        self.rt = rt
        self.device = device
        self.compute_dtype = torch_dtype(rt.compute_dtype)

    def raw_f32(self, name: str) -> np.ndarray:
        return self.gf.tensor_f32(name)

    def array(self, name: str, dtype=torch.float32) -> torch.Tensor:
        """Full-precision small tensor (norm weights, biases)."""
        # copy: an f32 tensor's data is a read-only view into the mmap
        return torch.from_numpy(np.array(self.raw_f32(name), dtype=np.float32)).to(
            device=self.device, dtype=dtype)

    def embedding(self, name: str) -> torch.Tensor:
        """Token embedding table [V, H] in the compute dtype."""
        return self.array(name, self.compute_dtype)

    def linear(self, prefix: str, *, bias: bool = True):
        """`{prefix}.weight` (+ `.bias` when the file has it and `bias`) as a
        DenseLinear/QuantLinear."""
        wname = prefix + ".weight"
        e = self.gf.tensors[wname]
        bname = prefix + ".bias"
        b = self.raw_f32(bname) if bias and self.gf.has_tensor(bname) else None
        raw, dtype = self.gf.raw_tensor(wname), e.dtype
        if self.rt.re_quantize and len(e.shape) == 2:
            target = GGMLType[self.rt.re_quantize.upper()]
            if target != dtype:
                # chatllm.cpp read_tensor_data with a target type (src/chat.h:710)
                w = dequantize(raw, dtype, e.shape)
                raw, dtype = np.frombuffer(quantize(w, target), np.uint8), target
        dq = None if self.rt.weight_dtype == "auto" else torch_dtype(self.rt.weight_dtype)
        if dq is None and dtype in (GGMLType.F16, GGMLType.F32, GGMLType.BF16):
            dq = self.compute_dtype
        return linear_from_ggml(raw, dtype, e.shape, bias=b, dequant_to=dq,
                                device=self.device)

    def norm(self, prefix: str) -> dict:
        """`{prefix}.weight` (+ `.bias`, LayerNorm's) in f32."""
        p = {"w": self.array(prefix + ".weight")}
        if self.gf.has_tensor(prefix + ".bias"):
            p["b"] = self.array(prefix + ".bias")
        return p


def load_llama_family_params(pb: ParamBuilder, n_layers: int, *,
                             tie_lm_head: bool = False, sparse=(), n_experts: int = 0,
                             shared: str = "") -> dict:
    """Weight map shared by the llama-like families (converter weight names:
    chatllm.cpp convert.py LlamaConverter:1604).  Layers marked in `sparse`
    take the MoE FFN of `load_moe_mlp` instead of the dense one."""
    params = {
        "embed": pb.embedding("model.embed_tokens.weight"),
        "final_norm": pb.norm("model.norm"),
        "layers": [],
    }
    for i in range(n_layers):
        pfx = f"model.layers.{i}"
        if i < len(sparse) and sparse[i]:
            mlp = load_moe_mlp(pb, f"{pfx}.mlp", n_experts, shared)
        else:
            mlp = {"gate": pb.linear(f"{pfx}.mlp.gate_proj"),
                   "up": pb.linear(f"{pfx}.mlp.up_proj"),
                   "down": pb.linear(f"{pfx}.mlp.down_proj")}
        params["layers"].append({
            "attn_norm": pb.norm(f"{pfx}.input_layernorm"),
            "attn": {
                "q": pb.linear(f"{pfx}.self_attn.q_proj"),
                "k": pb.linear(f"{pfx}.self_attn.k_proj"),
                "v": pb.linear(f"{pfx}.self_attn.v_proj"),
                "o": pb.linear(f"{pfx}.self_attn.o_proj"),
            },
            "ffn_norm": pb.norm(f"{pfx}.post_attention_layernorm"),
            "mlp": mlp,
        })
    params["layers"] = tuple(params["layers"])
    if not tie_lm_head:
        params["lm_head"] = pb.linear("lm_head")
    return params


def load_moe_mlp(pb: ParamBuilder, pfx: str, n_experts: int, shared: str = "") -> dict:
    """A sparse FFN `{pfx}`: the router `gate`, the stacked experts and, when
    `shared` names its container (`shared_experts`, `shared_expert`), the
    shared expert."""
    mlp = {"gate": pb.linear(f"{pfx}.gate"),
           "experts": load_moe_experts(pb, pfx, n_experts)}
    if shared:
        mlp["shared"] = {k: pb.linear(f"{pfx}.{shared}.{k}_proj") for k in ("gate", "up", "down")}
    return mlp


def load_moe_experts(pb: ParamBuilder, pfx: str, n_experts: int,
                     names=("gate_proj", "up_proj", "down_proj"),
                     container: str = "experts") -> dict:
    """Per-expert FFN weights `{pfx}.{container}.{j}.<name>.weight` stacked
    into gate/up [E, H, F] and down [E, F, H] tensors in the compute dtype,
    with the JAX package's roundings (the file's values as f32, then the
    compute dtype).  Each stack is allocated once on the device and filled
    one expert at a time, so the host never holds more than one expert's
    f32 copy."""
    out = {}
    for key, name in zip(("gate", "up", "down"), names):
        stack = None
        for j in range(n_experts):
            w = torch.from_numpy(np.array(pb.raw_f32(f"{pfx}.{container}.{j}.{name}.weight").T,
                                          dtype=np.float32))
            if stack is None:
                stack = torch.empty((n_experts, *w.shape), dtype=pb.compute_dtype,
                                    device=pb.device)
            stack[j].copy_(w)
        out[key] = stack
    return out


class BaseLLM:
    """A loaded model: static config + parameters + tokenizer + engine."""

    def __init__(self, model_type: int, cfg: TransformerConfig, params,
                 tokenizer: ChatTokenizer, device: torch.device):
        self.model_type = model_type
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = device
        self.perf = PerfInfo()
        self._engine: Optional[InferenceEngine] = None

    @property
    def engine(self) -> InferenceEngine:
        if self._engine is None:
            self._engine = InferenceEngine(self.cfg, self.params, device=self.device)
        return self._engine

    def forward_logits(self, input_ids, n_past: int = 0, cache=None):
        """Full-sequence logits (testing)."""
        from ..nn.transformer import transformer_forward

        ids = torch.as_tensor(np.atleast_2d(np.asarray(input_ids, np.int64)),
                              device=self.device)
        if cache is None:
            cache = self.engine.new_cache(ids.shape[0], max(ids.shape[1], 1))
        return transformer_forward(self.cfg, self.params, ids, cache, n_past)


def load_model(path: str, rt: RuntimeConfig | None = None, device=None) -> BaseLLM:
    """ModelFactory::load analog: open the file, dispatch on model_type.
    The model lives on the card unless `device="cpu"` is asked for."""
    dev = resolve_device(device)
    rt = rt or RuntimeConfig()
    gf = GGMMFile.open(path)
    cls = lookup_model(gf.model_type)
    if cls is None:
        from .model_types import ModelType

        name = next((t.name for t in ModelType if int(t) == gf.model_type), "unknown")
        raise ValueError(f"unsupported model_type 0x{gf.model_type:x} ({name}) in {path}")
    model = cls.load(gf, rt, dev)
    if rt.layer_spec:
        model = _apply_layer_spec(model, rt.layer_spec)
    # Norm eps is the one field the binary config structs don't carry; the
    # GGMM JSON meta holds the original HF config.json (`rms_norm_eps`, or
    # `layer_norm_eps` for a LayerNorm decoder).
    hf_cfg = (gf.meta or {}).get("config.json") or {}
    key = "layer_norm_eps" if model.cfg.norm_type == "layernorm" else "rms_norm_eps"
    eps = hf_cfg.get(key)
    if eps is not None and float(eps) != model.cfg.norm_eps:
        model.cfg = replace(model.cfg, norm_eps=float(eps))
    return model


def parse_layer_spec(spec: str, n_layers: int) -> list[int]:
    """'0:3,1:4' -> [0, 1, 2, 1, 2, 3]; 'all' -> identity; bare ints allowed
    (chatllm.cpp --layer_spec, src/main.cpp:169-176)."""
    if spec in ("", "all"):
        return list(range(n_layers))
    ids: list[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            a, b = part.split(":")
            ids.extend(range(int(a), int(b)))
        else:
            ids.append(int(part))
    for i in ids:
        if not (0 <= i < n_layers):
            raise ValueError(f"layer_spec index {i} out of range 0..{n_layers - 1}")
    return ids


def _apply_layer_spec(model: BaseLLM, spec: str) -> BaseLLM:
    """Rebuild the layer stack from source-layer indices.  Duplicated layers
    alias the same weight tensors (no copies); each stack position still
    gets its own KV cache slot."""
    cfg = model.cfg
    ids = parse_layer_spec(spec, cfg.num_hidden_layers)
    model.params = dict(model.params, layers=tuple(model.params["layers"][j] for j in ids))
    specs = tuple(cfg.layer_spec(j) for j in ids) if cfg.layer_specs else ()
    model.cfg = replace(cfg, num_hidden_layers=len(ids), layer_specs=specs)
    return model
