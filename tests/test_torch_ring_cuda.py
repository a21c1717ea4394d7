"""The sliding-window ring cache on the card, against the CPU, at a narrow
width (a Mistral GGMM of window 8 and SWA_EXTRA 16: rings of 24 slots).
Marked `cuda`: they skip where no GPU is present.  This file imports no JAX
(the GPU machine has none).  On a GPU machine:

    python -m pytest -q --noconftest -m cuda tests/test_torch_ring_cuda.py

  - `attention_block` over a ring on the card (its projections through K1
    and K2) against the CPU's, with an int, a 0-d device and per-slot [B]
    offsets past the wrap, over f32, bf16 and q8 rings;
  - CUDA-graph decode across the wrap: the replayed tokens equal the
    uncaptured loop's on the card, from one graph (a ring has no KV bucket),
    and over an f32 ring the CPU's."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

CACHES = ("float32", "bfloat16", "int8")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def models(dev, tmp_path, monkeypatch):
    """The narrow Mistral on the card and on the CPU, per cache dtype, with
    rings of 24 slots."""
    import chip_smoke
    import chatllm_tpu_torch.nn.transformer as T
    from chatllm_tpu_torch.models import RuntimeConfig, load_model

    monkeypatch.setattr(T, "SWA_EXTRA", 16)
    path = str(chip_smoke.write_family_ggmm(tmp_path / "w8.bin", "mistral", dtype=0, seed=5,
                                            window=8))

    def load(cache, device):
        return load_model(path, RuntimeConfig(compute_dtype="float32", cache_dtype=cache),
                          device=device)
    return load


@pytest.mark.parametrize("form", ["int", "0d", "per_slot"])
@pytest.mark.parametrize("cache", CACHES)
def test_ring_attention_block_card_matches_cpu(dev, models, cache, form):
    import chatllm_tpu_torch.nn.transformer as T
    from chatllm_tpu_torch.ops.rope import precompute_rope_cache

    card, cpu = models(cache, dev), models(cache, "cpu")
    B, Tn, off = {"int": (1, 5, 46), "0d": (1, 1, 61), "per_slot": (2, 1, [27, 50])}[form]
    rng = np.random.default_rng(len(cache) + len(form))
    x = torch.from_numpy(rng.standard_normal((B, Tn, cpu.cfg.hidden_size)).astype(np.float32))
    pos = torch.from_numpy(np.broadcast_to(np.asarray(off), (B,))[:, None]
                           + np.arange(Tn)[None, :])
    outs, rings = [], []
    for m, d in ((card, dev), (cpu, "cpu")):
        kv = m.engine.new_cache(B)
        assert kv.k[0].shape[1] == 24
        gen = torch.Generator().manual_seed(1)         # the same old contents on both
        for t in kv.k[:1] + kv.v[:1]:
            t.copy_(torch.randn(t.shape, generator=gen).mul(20).to(t.dtype))
        for t in (kv.k_scale or [])[:1] + (kv.v_scale or [])[:1]:
            t.copy_(torch.rand(t.shape, generator=gen) * 0.02 + 1e-3)
        n = off if form == "int" else torch.tensor(off, device=d)
        cos, sin = precompute_rope_cache(pos.to(d), m.cfg.rope)
        with torch.inference_mode():
            out = T.attention_block(m.cfg, m.cfg.layer_spec(0), m.params["layers"][0]["attn"],
                                    x.to(d), cos, sin, kv.k[0], kv.v[0], n,
                                    kv.k_scale[0] if kv.k_scale else None,
                                    kv.v_scale[0] if kv.v_scale else None)
        outs.append(out.float().cpu())
        rings.append(kv.k[0].float().cpu())
    g, c = outs
    assert torch.isfinite(g).all()
    assert (g - c).abs().max().item() <= 1e-3 * c.abs().max().item()
    # the slots written: the positions modulo the ring (q8: one int8 step)
    written = torch.zeros(B, 24, dtype=torch.bool)
    written[torch.arange(B)[:, None], pos % 24] = True
    assert torch.equal(rings[0][~written], rings[1][~written])
    tol = 1.0 if cache == "int8" else 1e-3 * rings[1].abs().max().item()
    assert (rings[0][written] - rings[1][written]).abs().max().item() <= tol


@pytest.mark.parametrize("cache", CACHES)
def test_ring_decode_replay_crosses_the_wrap(dev, models, cache):
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine

    card, cpu = models(cache, dev), models(cache, "cpu")
    ids = np.random.default_rng(2).integers(3, 380, 30).tolist()
    g = GenerationConfig(do_sample=False, max_new_tokens=40)
    eager = InferenceEngine(card.cfg, card.params, device=dev, cuda_graphs=False)
    want = eager.generate(ids, g)[0]
    eng = card.engine
    kv = eng.new_cache(1)
    got = eng.generate(ids, g, cache=kv)[0]
    again = eng.generate(ids, g, cache=kv)[0]        # replays only
    assert got == again == want
    assert eng.decoder.num_graphs() == 1 and eng.decoder.replayed_steps >= 2 * 39
    if cache == "float32":              # the other caches round keys the CPU may round apart
        with torch.inference_mode():
            assert cpu.engine.generate(ids, g)[0] == want
