"""HF goldens of the main path's families in the port, on the CPU: a tiny
Llama-3, Qwen2 and Qwen3 built from `transformers` configs (random weights
from a seed, nothing downloaded), converted by the JAX package's converter
to f32 GGMMs and loaded in the port, whose logits stay within
atol = rtol = 2e-3 of the `transformers` model's (the bound of the JAX
package's tests/test_model_golden.py).  The Llama-3 is
tests/test_model_golden.py's `make_tiny_llama3` config (converted here, so
the converter's q/k permutation to the interleaved rope layout is on the
path), the Qwen2 and Qwen3 the converter tests' with q/k/v biases and
per-head q/k norms."""
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import torch_one_thread  # noqa: F401  (one intra-op thread: see its docstring)

import chatllm_tpu_torch.models as tm

transformers = pytest.importorskip("transformers")

IDS = np.array([[5, 77, 101, 32, 9, 200, 3, 4, 150, 7]], dtype=np.int64)
CHATML = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
LLAMA3 = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>", "<|end_header_id|>",
          "<|eot_id|>"]


def _hf(name):
    """(HF model, its config, architecture name, special pieces)."""
    common = dict(vocab_size=260, hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=2, num_hidden_layers=2, intermediate_size=96,
                  max_position_embeddings=128, tie_word_embeddings=False)
    if name == "llama3":
        torch.manual_seed(1)
        cfg = transformers.LlamaConfig(rope_theta=50000.0, rms_norm_eps=1e-5,
                                       attention_bias=False, **common)
        return transformers.LlamaForCausalLM(cfg).eval(), cfg, "LlamaForCausalLM", LLAMA3
    if name == "qwen2":
        torch.manual_seed(3)
        cfg = transformers.Qwen2Config(rope_theta=10000.0, rms_norm_eps=1e-6,
                                       sliding_window=None, **common)
        return transformers.Qwen2ForCausalLM(cfg).eval(), cfg, "Qwen2ForCausalLM", CHATML
    torch.manual_seed(2)
    cfg = transformers.Qwen3Config(head_dim=32, rope_theta=10000.0, rms_norm_eps=1e-6,
                                   attention_bias=False, **common)
    return transformers.Qwen3ForCausalLM(cfg).eval(), cfg, "Qwen3ForCausalLM", CHATML


# name -> (the port's loader, what the model shows of its family)
CASES = {"llama3": ("Llama3", lambda c: c.rope.layout == "normal"),
         "qwen2": ("Qwen2", lambda c: c.qkv_bias and c.rope.layout == "neox"),
         "qwen3": ("Qwen3", lambda c: c.qk_norm == "rmsnorm" and c.resolved_head_dim() == 32)}


@pytest.mark.parametrize("name", list(CASES))
def test_main_path_family_matches_hf(tmp_path, name):
    from chatllm_tpu.tools.convert import convert
    from test_convert_wave2 import _save_dir

    hf, cfg, arch, specials = _hf(name)
    path = str(tmp_path / f"{name}.bin")
    convert(_save_dir(tmp_path, hf, cfg, arch, specials), path, "f32")
    model = tm.load_model(path, tm.RuntimeConfig(weight_dtype="float32",
                                                 compute_dtype="float32",
                                                 cache_dtype="float32"), device="cpu")
    loader, shows = CASES[name]
    assert type(model).__name__ == loader and shows(model.cfg)
    with torch.no_grad():
        ref = hf(torch.from_numpy(IDS)).logits[0].numpy()
        got = model.forward_logits(IDS[0].tolist())[0][0].numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=2e-3)
