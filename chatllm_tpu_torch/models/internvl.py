"""InternVL 3.x (counterpart of the JAX package's `models/internvl.py`).

InternViT tower (cls token + layer-scale pre-LN ViT) -> pixel-shuffle
downsample -> LN + MLP projector (`vision_projector`) -> Qwen3 LLM.  The
image's embeddings are spliced between the prompt's text embeddings and
prefilled with `InferenceEngine.prefill_embeds`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.vit import ViTConfig, pixel_shuffle, vit_forward
from ..ops.norm import layer_norm
from ..ops.qmm import matmul
from .base import BaseLLM, ParamBuilder, RuntimeConfig, register_model
from .model_types import ModelType
from .qwen import Qwen3

PROJECTOR_LN_EPS = 1e-5            # the projector's LayerNorm (the tower's is 1e-6)


@register_model(ModelType.INTERN_VL)
class InternVL(BaseLLM):
    @classmethod
    def load(cls, gf, rt: RuntimeConfig, device):
        lm = Qwen3.load.__func__(Qwen3, gf, rt, device)
        cfg_json = (gf.meta or {}).get("config.json", {})
        pp = (gf.meta or {}).get("preprocessor_config.json", {})
        vis = cfg_json.get("vision_config", {})
        vis_cfg = vis_params = None
        if vis and gf.has_tensor("visual.embeddings.class_embedding"):
            def _dim(v):
                # HF-native InternVL stores image_size/patch_size as [h, w]
                return int(v[0] if isinstance(v, (list, tuple)) else v)

            vis_cfg = internvit_config(
                hidden=int(vis["hidden_size"]), layers=int(vis["num_hidden_layers"]),
                heads=int(vis["num_attention_heads"]), inter=int(vis["intermediate_size"]),
                patch=_dim(vis["patch_size"]), image_size=_dim(vis["image_size"]),
                eps=float(vis.get("layer_norm_eps", 1e-6)))
            vis_params = load_internvit_params(ParamBuilder(gf, rt, device), vis_cfg)
        return cls.from_parts(
            lm.cfg, lm.params, lm.tokenizer, vis_cfg, vis_params, device,
            model_type=gf.model_type,
            downsample_ratio=float(cfg_json.get("downsample_ratio", 0.5)),
            use_thumbnail=bool(cfg_json.get("use_thumbnail", True)),
            image_mean=pp.get("image_mean", [0.485, 0.456, 0.406]),
            image_std=pp.get("image_std", [0.229, 0.224, 0.225]))

    @classmethod
    def from_parts(cls, cfg, params, tokenizer, vis_cfg: ViTConfig | None, vis_params, device,
                   *, model_type: int = int(ModelType.INTERN_VL), downsample_ratio: float = 0.5,
                   use_thumbnail: bool = True, image_mean=(0.485, 0.456, 0.406),
                   image_std=(0.229, 0.224, 0.225)) -> "InternVL":
        """The model over given LLM and tower parameters (a loaded file's, or
        synthetic ones); the tokenizer gains the `<img>` / `</img>` ids."""
        self = cls(model_type, cfg, params, tokenizer, device)
        tokenizer.img_start_token_id = tokenizer.tp.piece_to_id("<img>")
        tokenizer.img_end_token_id = tokenizer.tp.piece_to_id("</img>")
        self.vis_cfg, self.vis_params = vis_cfg, vis_params
        self.downsample_ratio = downsample_ratio
        self.use_thumbnail = use_thumbnail
        self.image_mean, self.image_std = list(image_mean), list(image_std)
        self._image_cache = None
        return self

    @torch.inference_mode()
    def encode_images(self, tiles) -> torch.Tensor:
        """tiles [N, S, S, 3] f32 -> projected embeddings [N * tokens,
        lm_hidden] (chatllm.cpp internvl MultiModalProjector::forward: drop
        cls, pixel shuffle, LN -> fc -> exact GELU -> fc)."""
        self._need_tower()
        return encode_images(self.vis_cfg, self.vis_params, tiles, self.downsample_ratio,
                             self.params["embed"].dtype, self.device)

    def _need_tower(self):
        if self.vis_cfg is None:
            raise ValueError("InternVL: the file holds no vision tower")

    def image_token_count(self) -> int:
        g = self.vis_cfg.grid
        fac = int(round(1 / self.downsample_ratio))
        return (g // fac) * (g // fac)

    def image_prompt(self, question: str) -> tuple[list, list]:
        """The ids before and after the image's embeddings: the system prompt,
        `<|im_start|>user\\n<img>`, then `</img>\\n{question}<|im_end|>\\n
        <|im_start|>assistant\\n`."""
        tok = self.tokenizer
        pre: list[int] = []
        tok.chat_encoder.append_sys_prompt(pre)
        pre.append(tok.im_start_token_id)
        pre.extend(tok.encode("user\n"))
        pre.append(tok.img_start_token_id)
        mid: list[int] = [tok.img_end_token_id]
        mid.extend(tok.encode("\n" + question))
        mid.append(tok.im_end_token_id)
        mid.extend(tok.encode("\n"))
        mid.append(tok.im_start_token_id)
        mid.extend(tok.encode("assistant\n"))
        return pre, mid

    @torch.inference_mode()
    def chat_image(self, image, question: str, gen_config=None, streamer=None,
                   max_tiles: int = 12) -> str:
        """One-shot VQA: preprocess -> encode the tiles -> splice their
        embeddings into the prompt -> prefill them from position 0 -> decode."""
        from ..runtime.generate import GenerationConfig
        from ..runtime.vision import internvl_tiles, load_image

        self._need_tower()
        gen_config = gen_config or GenerationConfig(do_sample=False, max_new_tokens=256)
        tiles, _ = internvl_tiles(load_image(image), image_size=self.vis_cfg.image_size,
                                  max_num=max_tiles, use_thumbnail=self.use_thumbnail,
                                  mean=self.image_mean, std=self.image_std)
        media = self.encode_images(tiles)
        embeds = self.splice(media, *self.image_prompt(question))
        eng, tok = self.engine, self.tokenizer
        logits, cache, n_past = eng.prefill_embeds(embeds, self.image_cache(), 0)
        out, _, _ = eng.generate_from_logits(
            logits, cache, n_past, gen_config, is_terminator=tok.is_terminate_token,
            on_token=(lambda t: streamer.put([t])) if streamer else None)
        if streamer:
            streamer.end()
        return tok.decode(out)

    def image_cache(self):
        """The cache chat_image prefills into: one per engine, kept between
        images, so that the decode graphs captured over it (keyed by its
        storage) replay for the next image."""
        eng = self.engine
        if self._image_cache is None or self._image_cache[0] is not eng:
            self._image_cache = None                  # free the old engine's first
            self._image_cache = (eng, eng.new_cache(1, eng.max_length))
        return self._image_cache[1]

    def splice(self, media: torch.Tensor, pre: list, mid: list) -> torch.Tensor:
        """[1, len(pre) + tokens + len(mid), H]: the ids' embeddings around
        the media's, in the embedding's dtype."""
        emb = self.params["embed"]
        ids = torch.as_tensor(np.asarray(pre + mid, np.int64), device=emb.device)
        text = emb[ids]
        return torch.cat([text[:len(pre)], media.to(emb.dtype), text[len(pre):]])[None]


def internvit_config(*, hidden: int, layers: int, heads: int, inter: int, patch: int,
                     image_size: int, eps: float = 1e-6) -> ViTConfig:
    """InternViT: exact GELU, a class token and layer scales."""
    return ViTConfig(hidden_size=hidden, num_hidden_layers=layers, num_attention_heads=heads,
                     intermediate_size=inter, patch_size=patch, image_size=image_size,
                     act="gelu", cls_token=True, layer_scale=True, norm_eps=eps)


def encode_images(cfg: ViTConfig, vp: dict, tiles, downsample_ratio: float, embed_dtype,
                  device) -> torch.Tensor:
    """The tower, then the projector, over tiles [N, S, S, 3] -> [N * tokens,
    lm_hidden] f32."""
    x = vit_forward(cfg, vp, torch.as_tensor(np.asarray(tiles, np.float32), device=device))
    return project(cfg, vp, x, downsample_ratio, embed_dtype)


def project(cfg: ViTConfig, vp: dict, x: torch.Tensor, downsample_ratio: float,
            embed_dtype) -> torch.Tensor:
    """The tower's output [N, 1 + g², hidden] -> [N * tokens, lm_hidden] f32:
    drop the cls token, pixel shuffle, LN (eps 1e-5) -> fc -> exact GELU in
    f32 -> fc, which takes bf16 input when the LLM's embedding is bf16, as in
    the JAX package."""
    x = pixel_shuffle(x[:, 1:, :], cfg.grid, cfg.grid, downsample_ratio)
    p = vp["projector"]
    x = layer_norm(x, p["ln"]["w"], p["ln"]["b"], eps=PROJECTOR_LN_EPS)
    x = F.gelu(matmul(x, p["fc0"]).float(), approximate="none")
    x = matmul(x.to(torch.bfloat16) if embed_dtype == torch.bfloat16 else x, p["fc1"])
    N, T, H = x.shape
    return x.reshape(N * T, H)


def load_internvit_params(pb: ParamBuilder, cfg: ViTConfig) -> dict:
    """Weight names per the converter's InternVLConverter; the patch weight
    [hidden, 3, p, p] is stored as the convolution's [p, p, 3, hidden]."""
    proj_w = np.transpose(pb.raw_f32("visual.embeddings.patch_embedding.weight"), (2, 3, 1, 0))
    params = {
        "embed": {
            "proj_w": torch.from_numpy(np.ascontiguousarray(proj_w, np.float32)).to(pb.device),
            "proj_b": pb.array("visual.embeddings.patch_embedding.bias"),
            "cls": pb.array("visual.embeddings.class_embedding").reshape(1, -1),
            "pos": pb.array("visual.embeddings.position_embedding").reshape(
                -1, cfg.hidden_size),
        },
        "projector": {
            "ln": pb.norm("vision_projector.0"),
            "fc0": pb.linear("vision_projector.1"),
            "fc1": pb.linear("vision_projector.3"),
        },
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        pfx = f"visual.layers.{i}"
        params["layers"].append({
            "norm1": pb.norm(f"{pfx}.norm1"),
            "attn": {name: pb.linear(f"{pfx}.self_attn.{name}_proj")
                     for name in ("q", "k", "v", "o")},
            "norm2": pb.norm(f"{pfx}.norm2"),
            "mlp": {"fc0": pb.linear(f"{pfx}.mlp.fc1"), "fc1": pb.linear(f"{pfx}.mlp.fc2")},
            "ls1": pb.array(f"{pfx}.ls1"),
            "ls2": pb.array(f"{pfx}.ls2"),
        })
    return params
