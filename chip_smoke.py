"""Chip smoke test of the PyTorch/CUDA port (chatllm_tpu_torch) on one GPU.

    python3 chip_smoke.py                      # every phase but fused_decode
    python3 chip_smoke.py --phases glm4_9b,cli  # build, kernels and the named ones

Phases (any failure raises and exits non-zero; nothing is caught; with
--phases, build and kernels run and then the named phases in this order, the
Llama-3-8B params built when one of phases 3-7 and pipeline is named;
`PHASES` lists the names).  The last line is `{"ok": true, "device": ...}`
only when every phase of the run without arguments ran; a --phases run that
leaves one out ends with `{"phases_passed": [...], "device": ...}` instead:
  1. build   nvcc-build every kernel library from csrc/, print the card.
  2. kernels hold K1 qgemv, K2 qmm, K3 flash_attention, K4 flash_decode
             (also its int8 dots, its 64-row shapes, E7's head-major cache
             at B 32, and the edges of its tiles and blocks' shares, every
             case launched twice and bit-identical), K5 qmm_decode (timed at 8
             and 64 rows beside K2 and the library), K6 the
             read probe, E2's stream_once / vpu_once (also at E1's 4096 x
             14336), E3's stream_read / qgemv_bf16, E4's unpack_gemv (modes
             v0-v3), E5's
             qmm_dma and E6's qmm_unpack (three variants) and
             qmm_unpack_diag (five modes)
             against their plain PyTorch versions at the Llama-3-8B shapes,
             and K1-K5 at the Qwen2.5-0.5B shapes too (q8_0 with a bias, head
             dim 64, 14 query heads over 2 kv heads), K4 at DeepSeek-V2-Lite's
             expanded MLA cache (K 192, V 128, f32 dots), K1, K3 (mode 2) and
             K4 at InternVL3.5-8B's Qwen3-8B shapes (FFN 12288, lm_head N
             151936, the 3424-token image prefill, a q8 decode step at n_past
             3440), K1 (timed) and K2 at Mistral-7B's 32000-column lm_head,
             K3 (mode 2 timed) at its dense windowed route's prefill chunks
             and K4 at its q8 decode step (window 4096 in a 4608-slot cache),
             K1 and K2 at Qwen3-30B-A3B's projections (K 2048, its
             128-column router, lm_head N 151936; K2 at the server's 2
             rows), K3 (mode 2 timed) at its 512- and 2048-token chunks and
             K4 over a q8 cache at its GQA group of 8 (32 query heads over
             4 kv heads: 8 and 16 rows per kv head, B 1 and 2), K1 (timed)
             and K2 at Gemma-3-12B's projections (K 3840 and 15360), K3 in its
             three modes and K4 (float and int8 dots) at head_dim 256
             (Gemma-3-12B's prefill chunk over 8192 slots, its dense windowed
             route's chunk with window 1024 across the 64-key tiles, a chunk
             deep in the cache, Gemma-2-9B's softcap 50, its q8 decode past
             4096, a per-row step at B 2, 32 rows per kv head), K1 (timed)
             and K2 at GLM-4-9B's projections (fused qkv N 4608 and gate_up
             N 27392, the q8_0 down at K 13696, the head N 151552; K2 timed
             at the server's 2 rows), K3 (mode 2 timed) and K4 at its 32
             query heads over 2 kv heads, K3 in its three modes and K4 (f32
             and int8 dots) at head dims 96 and 80 (Phi-3.5-mini's and
             Phi-2's 1000-token chunk over 8192 / 4096 slots and their q8
             decode after it, timed; the 2-slot step, a chunk ending at the
             cache's last slot, a window with the softcap, 64 rows a kv
             head), K1 (timed) and K2 at GPT-OSS-20B's q8_0 projections (K
             2880: q N 4096, k / v N 512, the head N 201088; K2 timed at the
             server's 2 rows) and K4 with sinks at its 64 query heads over 8
             kv heads of 64 (f32 dots, timed at n_past 1064 and 8000 and the
             2-slot step; the library time SDPA with the sink as one zero
             key), and K1, K2
             and K5 also on
             every layout they take (q4_k, q5_k, q6_k, q2_k, q8_0, q4_0, q4_1,
             f32 scales with b, q8_0 with a bias), bf16 and f32 x, 1-64 rows
             on both sides of every tile edge, N that are not multiples of
             the 128- or 256-column tiles and a K that ends a tile part way,
             each launch twice and bit-identical, and K2 and K5 bit-equal to
             their plain versions on one-hot rows (COVER_*, ONE_HOT_ROWS);
             `quantize_kv` on the card
             bit-equal to the CPU; K3 in its three modes (bf16; f32 cache;
             f32 query over a bf16 cache) also at the edges of the bf16
             kernel's 128 x 128 tiles (n_past off the tile grid, the cache's
             last tile, a window crossing key tiles, softcap with a window, T
             off the grid) and of the f32 kernel's 128- or 64-row tiles and
             split walks (a window crossing a split boundary, padded rows,
             softcap and a one-tile query over splits of 2-8), every case launched
             twice and bit-identical, each f32-mode split as its schedule
             says, and each mode timed beside two library calls (SDPA with a
             mask over the whole cache, and SDPA over the live keys with
             is_causal; mode 2's over the cache cast to f32), mode 2 also
             against the bound of its exact tensor-core route
             (K1: rel 1e-4 of the output scale; K2, K5: 2e-2 of it; K6 and
             stream_once: exact; vpu_once: 1e-5 of the output scale; K3: atol
             2e-2, and per element 2^-7 (bf16 cache, or an f32 query over
             one) or 1e-4 (f32 cache) of |o| + 4 sqrt(sum_j p_j^2 v_j^2),
             see FLASH_SCALED_TOL; K4: the same measure, 2^-7 with bf16
             dots and 1e-4 with f32 ones, see DECODE_SCALED_TOL; its int8
             dots: two quantization steps, see DECODE_INT8_STEPS;
             stream_read, qgemv_bf16 and qmm_dma: exact; unpack_gemv: 1e-5
             of the output scale, and 1e-4 against K1; qmm_unpack and
             qmm_unpack_diag: 1e-5 of the output scale), and time
             the kernel, the plain version and one library call (a
             yardstick the port never calls).
  3. llama3_8b  full-width Llama-3-8B (32 layers, vocab 128256, random q4_k
             weights from a seed, max_length 8192) through InferenceEngine: a
             40-token and a 1000-token prompt, 64 greedy tokens each, over a
             bf16 cache (K1, K2 and K3's mode 2 must launch: the projections
             return f32, so K3 takes an f32 query and no path of the engine
             launches its bf16 kernel), then the 1000-token prompt over a q8
             cache (K4 launches 32 times per decode step).  Decode runs in
             blocks of 16 steps replayed from CUDA graphs: each engine runs
             its prompts once (capturing) and is counted on the second run,
             in which every block replays (63 decode steps: 4 blocks, 64
             steps launched, K4 32 x 64).
     graph_decode  the same model and the 1000-token prompt, 64 greedy
             tokens, over a bf16 and a q8 cache, with the decode blocks
             uncaptured (the reference) and replayed from graphs in the same
             call: identical tokens, exact launches per replayed step (K1 225,
             K4 32 over the q8 cache), both decode rates, the graphs and
             their capture ms, peak memory, one replayed block timed and
             profiled (busy share, top kernels) and K1's and K4's shares of
             a replayed step from the kernel table.
     fused_decode  (only when named: `--phases fused_decode`; it brings
             graph_decode, whose tokens it is held against, and K1's cases at
             the fused shapes in the kernels phase) the same model through
             `runtime/fuse.py::fuse_decode_streams` (q|k|v and gate|up fused:
             K1 4 x 32 + 1 a step instead of 7 x 32 + 1) over bf16: its
             replayed rate and exact launches, and both parameter sets
             teacher-forced on the unfused run's 64 tokens, the fused logits
             within 1e-3 of the logit scale at every step, the same argmax
             where the top two are 2e-3 of it apart.
  4. bench   `chatllm_tpu_torch.bench.run_bench` on BENCH_DEPTH = 8 of the
             same full-width params' layers (TTFT at 512 and 2048 tokens, single-stream and batched
             decode replayed from CUDA graphs, the K6 read-bandwidth probe),
             its JSON line printed, launches exact per section (its warm-up
             blocks and two runs of replays); then
             the B=8 batched decode once more with CHATLLM_TPU_QMM_V2=1 (K5
             launches 7 a layer + 1 per step, K2 not at all) and K5's tokens and
             last-step logits held against K2's on the same token history
             (0.9 of the tokens equal, logits within 5e-3 of their scale);
             then `python -m chatllm_tpu_torch.bench` as a user runs it, with
             a short BENCH_STEPS, over the bf16 and the q8 cache.
  5. serve   the same model with a q8 cache behind the HTTP server with 4
             slots: 8 chat requests of ~30 to ~1000 tokens, 32 greedy tokens
             each, sent one at a time and then all at once; the replies must
             be identical, and K2 and K4 must launch (BatchedEngine's decode
             blocks replay CUDA graphs captured over the shared cache).
  6. two_layer  2-layer cuts at full width against a CPU run of the same
             weights (1e-3 of the logit scale, same argmax): a 40-token
             prefill, and one batched decode step of 4 slots at per-row
             n_past over a q8 cache.
     int8_engine  the same model over a q8 cache under
             CHATLLM_TPU_FLASH_QK=int8: the first decode step after the
             1000-token prompt against the bf16-dot run (INT8_LOGIT_TOL, same
             argmax), then 16 greedy tokens, K4's int8 dots launched 32
             times per decode step (their decode rate recorded).
     f32_engine  the same model through InferenceEngine with K3's f32 modes:
             the 1000-token prompt over an f32 cache (mode 1) and with f32
             activations over a bf16 cache (mode 2), 16 greedy tokens each, K3
             launched exactly 32 times in the run's mode; then a 2-layer cut
             over an f32 cache, a 256-token prompt into 1024 slots, against
             the CPU (1e-3 of the logit scale, same argmax).  (The bf16-cache
             chat path of phase 3 also takes mode 2: its projections return
             f32; the launches by mode are recorded.)
     switches  CHATLLM_TPU_FLASH_DECODE=1 (forced) and =0 on a bf16 cache at
             B = 8 through BatchedEngine (K4 32 times per batched step, warm-up
             and replayed, or never), CHATLLM_TPU_FLASH=0 on the 1000-token
             prefill (no K3).
     pipeline  the chat Pipeline on PIPE_DEPTH = 8 of the same weights' 32
             layers (Llama-3's NORMAL rope, a
             byte-level Llama-3 chat tokenizer of the model's vocab, 4096
             slots; `pipeline_phase`): a ~200-token system prompt
             pre-evaluated, six ~1000-token turns of 64 greedy tokens over a
             q8 cache with Shift extending (two Shifts, each in place and held
             against the port's shift on the CPU over a copy of the cache: V,
             its scales and the kept rows bit-equal, int8 keys at most one
             step apart in at most 1e-5 of the entries, k scales within 1e-6
             relative; no turn
             captures a graph for a bucket captured before; K1 7 a layer + 1
             and K4 one a layer per decode step; the system prompt's rows
             bit-equal
             after every turn), a session saved after turn 2 and loaded into
             a fresh Pipeline whose turn 3 has the same greedy ids; four turns
             over a bf16 cache with Restart (K3 mode 2 in every prefill, the
             prefill after the overflow starting at the system prompt's end)
             and its session; a 2-layer cut of the Shift chat against the CPU
             at each Shift (the next turn's prefill and first decode step over
             the shifted cache within 1e-3 of the logit scale, same argmax),
             run first, its CPU side in a worker thread during the rest.
  7. qwen2   full-width Qwen2.5-0.5B cut to QWEN_DEPTH = 6 of its 24 layers
             (vocab 151936, random q8_0 weights with non-zero q/k/v biases,
             tied lm_head, max_length 8192) through InferenceEngine over bf16
             and q8 caches with exact launch counts (7 quantized projections a
             layer per token), its 2-layer
             cuts against the CPU (1e-2 of the logit scale, same argmax), and
             graph_decode at its width.
     deepseek_v2_lite  full-width DeepSeek-V2-Lite cut to DSV2_DEPTH = 3 of
             its 27 layers (MLA, 64
             routed experts + 2 shared, top-6; random zero-centred q4_k
             projections and bf16 expert stacks from a seed,
             max_length 8192; `deepseek_phase`): the 1000-token prompt and 64
             greedy tokens over a bf16 cache, uncaptured and replayed (tokens
             identical, K1 8 L - 1 launches per replayed step), over a q8 cache
             (K4 at (192, 128) once per layer and step, one block profiled) and
             with K4 off; the latent MLA cache (256 tokens, 16 new); 2-layer
             cuts against the CPU (router scores within 1e-2, at least 0.9
             of the tokens with the same expert picks and the others on
             near-ties, then logits within 2e-2 of the logit scale where the
             picks agree, DSV2_CUT_TOL); a 4-slot q8 server (4 chat
             requests, 16 tokens each).
     internvl  full-width InternVL3.5-8B (`internvl_phase`: a Qwen3-8B LLM cut
             to IVL_DEPTH = 12 of its 36 layers, per-head q/k norms, random
             q4_k projections, and
             the 24-layer InternViT-300M tower and projector in bf16, from
             seeds, max_length 8192) through `InternVL.chat_image` on seeded
             2000 x 1500 PNGs (12 tiles + a thumbnail, 3328 image tokens):
             preprocessing, tower, projector and spliced prefill timed; a
             second image on the same engine over a bf16 cache and over a q8
             one captures nothing, K3 one launch a layer in mode 2 per image
             prefill, K4 one a layer per q8 decode step, K1 7 a layer + 1 per
             step; an OpenAI
             image_url request with a data URI answers as chat_image does;
             2-layer cuts of the tower and of the LLM over the spliced
             embeddings against the CPU.
     qwen3_30b_a3b  full-width Qwen3-30B-A3B cut to A3B_DEPTH = 8 of its 48
             MoE layers (`qwen3_a3b_phase`:
             128 experts, top-8, no shared expert, 32 query
             heads over 4 kv heads, random zero-centred q4_k projections and
             bf16 expert stacks from a seed, max_length 8192;
             every earlier phase's model freed first): prefill of 512 and
             2048 tokens (K3 mode 2, one launch a layer and chunk), the 1000-token
             prompt and 64 greedy tokens over bf16 and q8 caches, eager and
             replayed (tokens identical; K1 5 L + 1 and, over q8, K4 L launches
             per step), peak memory, one q8 block profiled, one MoE layer's
             expert products timed; 2-layer cuts against the CPU (router
             scores, picks and logits with DeepSeek-V2-Lite's bounds); a
             2-slot q8 server (two requests, concurrent replies equal to
             sequential ones; K2 and K4 launched).
     mistral_7b  full-width Mistral-7B cut to MISTRAL_DEPTH = 4 of its 32
             layers (`mistral_phase`: sliding window 4096, vocab 32000,
             random q4_k weights from seed 0).  The ring route (max_length
             8192: rings of 4096 + SWA_EXTRA = 4608 slots) over bf16 and q8
             caches: a
             4480-token prompt in chunks of 512 and 512 greedy tokens, so
             decode crosses the wrap, replayed from one CUDA graph (K1 7 a
             layer + 1 per launched step and one per prefill chunk, no K3,
             no K4), one block past the wrap profiled, the uncaptured loop's
             first 192 tokens equal to the replayed ones.  The dense windowed
             route (max_length 4608, no ring): the prompt's bf16 prefill (K3
             mode 2 with window 4096, 2 a layer; its last logits within 2e-2
             of the ring route's), a q8 decode from n_past 4480 (K4 with
             window 4096 on every layer of every launched step).  The
             server's BatchedEngine, 2 slots over q8 rings: two staggered
             requests of 4560 and 4590 tokens, 64 greedy tokens each, wrapping
             at different ring phases, each equal to the single-stream
             engine's tokens (K2 7 a layer + 1 per batched step).  A 2-layer
             cut against the CPU over 4720 positions and 2 decode steps
             across the wrap, bf16 (1e-3 of the logit scale) and q8 rings
             (4e-3; layer 0's int8 entries at most one step from the CPU's).
             Params and peak device memory printed.
     gemma3_12b  full-width, full-depth Gemma-3-12B (`gemma3_phase`: 48
             layers of head_dim 256, 40 local over windows of 1024 on the local
             rope table and 8 global, sandwich norms, the tied bf16 head of
             262208 rows, random zero-centred q4_k weights from seed 0).  The
             ring route (max_length 8192: rings of 1536 slots beside 8 global
             layers) over bf16 and q8: a 2048-token prompt in chunks of 512
             (K3 mode 2 on the global layers) and 256 greedy tokens,
             replayed (K1 336 per launched step, K4 8 per q8 step), one
             block profiled.  The uncaptured reference at a depth cut of 12
             layers (ten local, two global) in a child process
             (`gemma3_uncaptured_main`) that runs beside the next phases:
             256 tokens uncaptured and replayed over both rings, equal,
             checked after the cli phase.  At f32 activations:
             the dense windowed route (max_length 1536): 1500 tokens, K3 on
             all 48 layers (96 launches), its last logits within 2e-2 of
             the ring route's, the same argmax; a 2-slot q8 server (2150
             and 2170 tokens x 64): staggered replies bit-equal to
             one-at-a-time ones, each token the single-stream engine's
             greedy choice teacher-forced, up to 8e-3 of the logit scale
             (K2 336, K4 8 per batched step).  A 2-layer cut (layers 4 and
             5: local, global) over 1602 positions against the CPU, within
             2e-2 of the logit scale over bf16 and q8, which its witness (the
             card with its attention scale one f32 step up) passes and its control
             (the local layer on the global rope table) fails.  Peak memory.
     glm4_9b  full-width, full-depth GLM-4-9B (`glm4_phase`: 40 layers, 32
             query heads over 2 kv heads of 128 (G 16), the fused biased qkv
             and gate_up, rope on half of each head at base 5e6, random q4_k
             weights from seed 0 with the 13696-wide down projection q8_0,
             the untied 151552-row head, max_length 8192).  The 1000-token
             prompt and 64 greedy tokens over bf16 and q8 caches replayed
             from graphs: K1 161 per step (+ the prefill's head), K3 mode 2
             on all 40 layers over bf16, K4 40 a q8 step (16 rows a kv
             head), one block profiled; on zero-centred weights (whose
             tokens vary) a 2-slot q8 server (1000 and 1100 tokens x 64, f32
             activations): staggered replies bit-equal to one-at-a-time
             ones, K2 161 a batched step, each token's gap below the
             single-stream engine's greedy choice, teacher-forced,
             recorded; the same server at a 4-layer cut with each token that
             cut's greedy choice, teacher-forced, up to 8e-3 of the logit
             scale, beside a witness (attention scale one f32 step up) that
             must pass it and a control (n_past one ahead) that must fail
             it; and uncaptured tokens equal to replayed ones at a
             4-layer cut over both caches; a 2-layer cut over 642
             positions against the CPU within 1e-3 (bf16) and 4e-3 (q8) of
             the logit scale, a miss reported beside its witness (the card's
             cut with its attention scale one f32 step up) and failed beyond
             twice it, its control (rope over whole heads) outside the
             bound.  Peak memory.
     phi3_5_mini  full-width, full-depth Phi-3.5-mini (`phi_phase`: 32
             layers, 32 heads of 96 over 32 kv heads, LongRoPE's long factors
             and mscale, a window of 262145 beyond every cache (the dense
             windowed route), the untied 32064-row head on the
             dequantize-then-matmul route, random q4_k weights from seed 0,
             max_length 8192): the 1000-token prompt and 64 greedy tokens
             over bf16 and q8 caches replayed from graphs, K1 224 a step, K3
             mode 2 at D 96 on all 32 layers over bf16, K4 (one row a kv
             head, f32 dots) 32 a q8 step, one block profiled; a 2-layer cut
             over 642 positions against the CPU within 1e-3 / 4e-3, the
             argmax equal where clear (recorded beside two witnesses: the
             attention scale one f32 step up, and the card at f32
             activations; control: the long factors dropped); on
             zero-centred weights uncaptured tokens equal to
             replayed ones at a 4-layer cut, and a 2-slot q8 server (1000 and
             1100 tokens x 32, f32 activations, K4 with per-row n_past at B.G
             2) whose replies equal one-at-a-time ones, its tie to the single
             stream held at a 4-layer cut as GLM-4-9B's.  Peak memory.
     phi2    full-width, full-depth Phi-2 (`phi_phase`: 32 heads of 80,
             LayerNorm with biases, the parallel residual, the biased GELU
             MLP and head, NeoX rope on 32 of 80 dims, zero-centred q4_k
             weights from seed 0; max_length 4096, above
             its trained 2048, so that a q8 cache takes K4): the same chat
             runs (K1 193 a step: q, k, v, dense, fc1, fc2 a layer and the
             head; K3 mode 2 and K4 at D 80), the 2-layer cut (a miss of 1e-3
             / 4e-3 fails on a clear argmax or beyond twice the larger of its
             two witnesses; control: rope over whole heads; the same cut on
             positive-biased weights recorded beside its witnesses) and the
             uncaptured check; no server.
     gpt_oss_20b  full-width, full-depth GPT-OSS-20B (`gpt_oss_phase`: 24
             layers, 64 query heads over 8 kv heads of 64, window 128 on the
             even layers in rings of 640 slots, 12 full layers, sinks on
             every layer, YaRN, 32 experts of 2880 top-4 with the biased
             router and biased swiglu_oai experts, 38.2 GB of bf16 stacks,
             q/k/v, the router and the 201088-row head in q8_0, max_length
             8192): the 1000-token prompt (two chunks of 512, which wrap the
             rings) and 64 greedy tokens over bf16 and q8 caches replayed from
             graphs, K1 73 a step (+ each chunk's head), K4 with sinks 12 a
             q8 step, K3 never; one block profiled, one layer's expert
             products timed; uncaptured tokens equal to replayed ones at a
             4-layer cut; a 2-layer cut (a ring and a full layer) over 706
             positions (the ring wraps) against the CPU on the CPU's expert
             picks (`pick_tape`), the picks by the MoE rules, the logits
             within 1e-3 / 4e-3 where they agree or within twice the larger
             of two witnesses (attention scale one f32 step up; the card at
             f32 activations), its control (swiglu_oai replaced by SiLU) and
             the cut without its sinks beyond; a 2-slot q8 server (1000 and 1100
             tokens x 32) whose replies equal one-at-a-time ones, K2 73 and
             K4 12 a batched step.  Peak memory.
     gemma2_9b  a full-width 2-layer cut of Gemma-2-9B (`gemma2_phase`: a
             ring layer and a global one, attention softcap 50, final softcap
             30) over 642 positions against the CPU, as gemma3's cut (its
             control: no sandwich norms): K3 mode 2 and the ring's einsum
             with softcap 50 over bf16, K4 with softcap 50 over q8.
     families  a narrow GGMM of every model type that runs on blocks
             already on the card (FAMILIES: LLAMA3_2, the DeepSeek-R1
             distills over Llama, Qwen2 and Qwen3, Qwen3-MoE, Qwen2-MoE,
             DeepSeek V1 and V1-MoE, DeepSeek-V3, Moonlight, V3-Light,
             Llama-2, CodeLlama, Mistral and Mixtral over rings of 576 slots
             that their 640-token prompt wraps, Mistral2 with 128-wide heads,
             Gemma, Gemma-2, Gemma-3 and RNJ-1 with heads of 256, the last
             three over such rings, ChatGLM2 / 3, CodeGeeX2 / 4, CharacterGLM,
             GLM-4 and GLM-4-0414, the ten Phi types: Phi-2 and
             Dolphin-Phi-2 in both layouts, Phi-3 over a ring of 2560
             slots, Phi-3-SU / SU2 / SU3, Phi-4-mini and Phi-4, GPT-OSS with
             sinks over a 576-slot ring and a full layer) in f32 and
             q4_k, loaded on the card and
             the CPU (`families_phase`): config and weights bit-equal, logits
             within 1e-4 (f32) or 2e-2 (q4_k) of the CPU's; the narrow
             Qwen3-MoE and each of FAMILY_CHATS chat through `main.py --test` on
             the card and the CPU with equal transcripts (the ring families'
             turns wrap their rings).
  8. cli     write narrow LLAMA3, Qwen2 and DEEPSEEK_V2_LIGHT GGMMs with the
             port's writer and chat through `python -m chatllm_tpu_torch.main`
             twice each (bf16 cache; --cache_dtype q8_0; Qwen2 with ChatML
             and a tied head; DeepSeek-V2 (q4_k, MoE, MLA at 192 / 128) with
             --mla_cache speed over a q8 cache of 4096 slots (K4 at (192,
             128)) and --mla_cache memory), greedy: each pair's transcripts
             are byte-identical.  Then the chat pipeline's flags on the
             narrow Llama-3 (`cli_pipeline_jobs`): --test of seven turns with
             --extending shift -l 256 -s --cache_dtype q8_0 --re_quantize q8_0
             --layer_spec 0:2,1:2; the same with -i over the first six turns
             on stdin and --save_session (replies equal to --test's); twice
             --load_session with the seventh turn (byte-identical, the reply
             equal to --test's seventh); a sampled chat (-t 0.8 -k 40 -q 0.9
             --seed 7 --repeat_penalty 1.1 --penalty_window 64 --format
             completion) and one with --sampling tfs --tfs_z 0.9, each twice
             and byte-identical; --tokenize against the tokenizer in process.
             A narrow INTERN_VL GGMM (q4_k Qwen3 behind a 2-layer InternViT)
             asked about a 120 x 90 PNG through --multimedia_file_tags on the
             card and with --device cpu: byte-identical transcripts.
             The 21 calls run eight processes at a time, each on one intra-op
             thread (`_run_cli`; the two
             --load_session calls after the rest).
  9. e2      `chatllm_tpu_torch.experiments.gemv_probe2.main`, all six
             variants.
 10. e1      `chatllm_tpu_torch.experiments.gemv_probe.main`, all seven
             variants (16 layers of 4096 x 14336 x 8 steps; E2's kernels),
             each timed eagerly and by a CUDA-graph replay.
 11. e3      `chatllm_tpu_torch.experiments.gemv_model_bench.main`, the
             sweep of vpu (K1), stream (stream_read), vpu_bf16 (qgemv_bf16)
             and mxu (K2) over 3.93 GB of Llama-3-8B-shaped q4 weights, each
             timed eagerly and by a CUDA-graph replay (ms/token of both).
 12. e4      `chatllm_tpu_torch.experiments.gemv_unpack.main`: each unpack
             mode checked against K1, then timed over 2048 chained calls.
 13. e5      `chatllm_tpu_torch.experiments.qmm_m32.main`: the copy-only
             pass and K2 at M = 32 (q4k, q8, q4), 2048 chained calls each.
 14. e6      `chatllm_tpu_torch.experiments.qmm_unpack_variants.main`: the
             five diagnostic bodies and the three variants at M 32, K 4096,
             N 14336, each checked against K2, 2048 chained calls each.
 15. e7      `chatllm_tpu_torch.experiments.bhsd_decode.main`: the 8
             variant/cache combinations of a Llama-3-8B decode step at B 32
             over 1024 slots, 4 steps (the original's 48 cut to a twelfth)
             eagerly and as a CUDA-graph replay.
             Phases 9-15 count every kernel's launches exactly.
Then it prints the kernels line, the card line and, last, the result line.
Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import gc
import json
import os
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
BF16_TC_FLOPS = 989e12             # dense bf16 tensor cores
F32_FLOPS = 67e12                  # f32 outside the tensor cores

# Llama-3-8B projections (K, N) and their count per decode token / layer
SHAPES_8B = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
             "down": (14336, 4096), "lm_head": (4096, 128256)}
PER_LAYER = {"q_o": 2, "k_v": 2, "gate_up": 2, "down": 1}
# the fused projections of Llama-3-8B under fuse_decode_streams (one of each a layer)
SHAPES_8B_FUSED = {"qkv": (4096, 6144), "gate_up": (4096, 28672)}
N_LAYERS = 32
DSV2_LAYERS = 27                   # DeepSeek-V2-Lite
# The depth the DeepSeek-V2-Lite and Qwen3-30B-A3B phases run at, cut from 27
# and 48 so that the whole script stays inside its time with the mistral_7b
# phase (PERF.md section 4); widths stay as published
# Depth cuts of phases whose kernels and paths other phases cover at full
# depth, sized to the time the Phi phases added, after a whole-script run with
# them passed 1200 s (1292.3 s on a host that built in 127.9 s; PERF.md
# section 4)
DSV2_DEPTH = 3                     # the dense layer 0 and 2 MoE layers
A3B_DEPTH = 8
MISTRAL_DEPTH = 4                  # Mistral-7B's 32 layers cut to 4 (since the Gemma phases)
IVL_DEPTH = 12                     # InternVL3.5-8B's 36 LLM layers cut to 12 (likewise)
QWEN_DEPTH = 6                     # Qwen2.5-0.5B's 24 layers cut to 6
# Depth cuts sized to the time the gpt_oss_20b phase added, after a
# whole-script run with it took 1265 s on an H100 host that built in 87.3 s
# (PERF.md section 4): the chat Pipeline and the in-process bench on 8 of
# Llama-3-8B's 32 layers (the llama3_8b, graph_decode and serve phases and
# the bench's entry point run them at 32)
PIPE_DEPTH = 8
BENCH_DEPTH = 8
DECODE_BLOCK = 16                  # InferenceEngine's default decode_block


PHASE_STARTS: list = []           # (phase, time) at each "== phase" line
CHILDREN: list = []               # processes started beside the phases, stopped on exit
HOST_THREADS = torch.get_num_threads()
CUT_WORKER = ThreadPoolExecutor(1)  # the cuts' CPU sides, one at a time
CUT_JOBS: dict = {}               # each CPU side's queued, started and ended times


def log(msg: str):
    if msg.startswith("== "):
        now = time.perf_counter()
        if PHASE_STARTS:
            msg += f"  (at {now - PHASE_STARTS[0][1]:.1f} s)"
        PHASE_STARTS.append((msg[3:].split()[0], now))
    print(msg, flush=True)


def write_llama3_ggmm(path, *, vocab_pad: int = 384, hidden: int = 256, heads: int = 4,
                      kv_heads: int = 2, layers: int = 2, inter: int = 512,
                      max_len: int = 512, dtype=None, seed: int = 0, writer_cls=None,
                      rope_theta: float = 500000.0, rope_scaling=None,
                      visible_reserved: bool = False):
    """A narrow random-weight LLAMA3 GGMM: byte-level vocab (every byte a
    token, no merges) plus the Llama-3 chat control tokens, padded to
    `vocab_pad` entries with reserved tokens.  `rope_scaling` = (orig_ctx,
    factor, low_freq, high_freq) writes a LLAMA3_1 file instead.
    `writer_cls` defaults to the port's GGMMWriter (the tests pass the JAX
    package's).  The reserved tokens are control tokens, which decode to
    nothing; `visible_reserved` writes them as normal pieces that decode to
    their names (no merge ever forms them, so encoding is unchanged)."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.ggmm.writer import GGMMWriter
    from chatllm_tpu_torch.models.model_types import ModelType
    from chatllm_tpu_torch.tokenizer.processor import TokenType

    writer_cls = writer_cls or GGMMWriter
    dtype = GGMLType.Q4_K if dtype is None else GGMLType(int(dtype))
    pieces = _byte_pieces(LLAMA3_SPECIALS, vocab_pad,
                          pad_type=TokenType.NORMAL if visible_reserved else None)
    bos, eos = 256, 257
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = shape[-1] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    with open(path, "wb") as f:
        mtype = ModelType.LLAMA3 if rope_scaling is None else ModelType.LLAMA3_1
        wr = writer_cls(f, int(mtype), 1, meta={"model_name": "tiny-llama3"})
        wr.write_config([int(dtype), vocab_pad, hidden, heads, layers, inter, max_len,
                         bos, eos, -1, -1, kv_heads], fmt="12i")
        f.write(struct.pack("<f", rope_theta))
        if rope_scaling is not None:
            orig_ctx, factor, low_f, high_f = rope_scaling
            f.write(struct.pack("<ifff", orig_ctx, factor, low_f, high_f))
        wr._patch_offset(12)
        wr.write_vocab_bpe(pieces, [])
        _write_dense_tensors(wr, w, dtype, vocab_pad, hidden, heads, kv_heads, layers, inter)
    return path


def _write_dense_tensors(wr, w, dtype, vocab: int, hidden: int, heads: int, kv_heads: int,
                         layers: int, inter: int, *, qkv_bias: bool = False,
                         tie: bool = False, sparse=(), head_dim: int = 0, moe_pfx: str = "mlp",
                         sandwich: bool = False, qk_norm: bool = False,
                         embed_scale: float = 1.0, **moe):
    """The llama-family tensors of a narrow model, drawn from `w`; norm
    weights, biases and the embedding stay f32, as the converter leaves them.
    Layers marked in `sparse` take `_write_moe_ffn(**moe)` for their FFN,
    under `{layer}.{moe_pfx}`.  `head_dim` defaults to hidden / heads.
    `sandwich` writes Gemma-2/3's four norms a layer (post_attention_layernorm
    after attention, pre_ / post_feedforward_layernorm around the FFN),
    `qk_norm` Gemma-3's per-head q / k norms.  The embedding's entries are
    N(0, embed_scale^2)."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType

    d = head_dim or hidden // heads
    wr.write_tensor("model.embed_tokens.weight", w(vocab, hidden, scale=embed_scale),
                    GGMLType.F32)
    for i in range(layers):
        p = f"model.layers.{i}"
        wr.write_tensor(f"{p}.input_layernorm.weight",
                        1.0 + 0.1 * w(hidden, scale=1.0), GGMLType.F32)
        for name, n_out in (("q", heads * d), ("k", kv_heads * d), ("v", kv_heads * d)):
            wr.write_tensor(f"{p}.self_attn.{name}_proj.weight", w(n_out, hidden), dtype)
            if qkv_bias:
                wr.write_tensor(f"{p}.self_attn.{name}_proj.bias", w(n_out, scale=0.5),
                                GGMLType.F32)
        wr.write_tensor(f"{p}.self_attn.o_proj.weight", w(hidden, heads * d), dtype)
        if qk_norm:
            for name in ("q_norm", "k_norm"):
                wr.write_tensor(f"{p}.self_attn.{name}.weight", 1.0 + 0.1 * w(d, scale=1.0),
                                GGMLType.F32)
        norms = (("post_attention", "pre_feedforward", "post_feedforward") if sandwich
                 else ("post_attention",))
        for name in norms:
            wr.write_tensor(f"{p}.{name}_layernorm.weight", 1.0 + 0.1 * w(hidden, scale=1.0),
                            GGMLType.F32)
        if i < len(sparse) and sparse[i]:
            _write_moe_ffn(wr, w, dtype, f"{p}.{moe_pfx}", hidden, **moe)
        else:
            _write_ffn(wr, w, dtype, f"{p}.mlp", hidden, inter)
    wr.write_tensor("model.norm.weight", 1.0 + 0.1 * w(hidden, scale=1.0), GGMLType.F32)
    if not tie:
        wr.write_tensor("lm_head.weight", w(vocab, hidden), dtype)


FFN_NAMES = ("gate_proj", "up_proj", "down_proj")
MIXTRAL_FFN_NAMES = ("w1", "w3", "w2")     # Mixtral's experts: gate, up, down


def _write_ffn(wr, w, dtype, pfx: str, hidden: int, inter: int, names=FFN_NAMES):
    gate, up, down = names
    wr.write_tensor(f"{pfx}.{gate}.weight", w(inter, hidden), dtype)
    wr.write_tensor(f"{pfx}.{up}.weight", w(inter, hidden), dtype)
    wr.write_tensor(f"{pfx}.{down}.weight", w(hidden, inter), dtype)


def _write_moe_ffn(wr, w, dtype, pfx: str, hidden: int, *, experts: int, moe_inter: int,
                   shared: str = "", shared_inter: int = 0, shared_gate: bool = False,
                   gate_bias: bool = False, names=FFN_NAMES):
    """A sparse FFN under the converter's names: the router `{pfx}.gate`
    [experts, hidden], `experts` routed experts of width `moe_inter` (their
    gate / up / down matrices named by `names`), and, when `shared` names its
    container, a shared expert of width `shared_inter` (`shared_gate`:
    Qwen2-MoE's [1, hidden] sigmoid gate of it); `gate_bias` writes V3's f32
    e_score_correction_bias."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType

    wr.write_tensor(f"{pfx}.gate.weight", w(experts, hidden), dtype)
    if gate_bias:
        wr.write_tensor(f"{pfx}.gate.e_score_correction_bias", w(experts, scale=0.05),
                        GGMLType.F32)
    for j in range(experts):
        _write_ffn(wr, w, dtype, f"{pfx}.experts.{j}", hidden, moe_inter, names)
    if shared:
        _write_ffn(wr, w, dtype, f"{pfx}.{shared}", hidden, shared_inter)
    if shared_gate:
        wr.write_tensor(f"{pfx}.shared_expert_gate.weight", w(1, hidden), dtype)


def _byte_pieces(specials, vocab_pad: int, pad: str = "<|reserved_{}|>", pad_type=None):
    """Byte-level vocab (every byte a token, no merges), `specials` as control
    tokens, padded to `vocab_pad` entries."""
    from chatllm_tpu_torch.tokenizer.processor import TokenType, byte_level_encode

    pieces = [(byte_level_encode(bytes([b])), TokenType.NORMAL) for b in range(256)]
    pieces += [(t.encode(), TokenType.CONTROL) for t in specials]
    pad_type = TokenType.CONTROL if pad_type is None else pad_type
    pieces += [(pad.format(i).encode(), pad_type) for i in range(vocab_pad - len(pieces))]
    return [(p, int(t)) for p, t in pieces]


# SentencePiece-score pieces of the narrow Llama-2 / Mistral vocabs (after the
# converter's layout: <unk>, <s>, </s>, the 256 byte pieces as raw bytes at
# ids 3-258, then these pieces, scored in this order), chosen so that English
# text merges into multi-byte pieces and CJK text meets both in-vocab pieces
# and byte fallback
SP_PIECES = (" t", "he", " the", "in", " a", "er", "on", " s", "re", "at", "en", "is", " o",
             "it", "an", "or", "es", " w", "ed", " c", "ing", " b", " f", "ou", " m", " p",
             "ar", " d", "al", "le", " h", " in", " to", " of", " and", "ll", "as", "ic",
             " is", "om", " th", "lo", "llo", " he", " hello", "wor", "ld", " world", "[I", "NS",
             "IN", "ST", "INST", "[INST]", " [/", "INST]", "ch", "ly", " be", " H", "!\n",
             "中", "文", "中文", " 中", "µ", "ö", "20", "24", "2024", "  ", "   ", "\n\n")


def _sp_pieces(vocab_pad: int) -> list:
    """(piece bytes, score) of a narrow SentencePiece-score vocab of
    `vocab_pad` entries: <unk> as the converter writes it, empty <s> and </s>
    (control pieces), the byte pieces, SP_PIECES at falling scores, then
    unreachable <extra_i> pieces."""
    pieces = [(" ⁇ ".encode(), 0.0), (b"", 0.0), (b"", 0.0)]
    pieces += [(bytes([b]), 0.0) for b in range(256)]
    pieces += [(t.encode(), -float(i)) for i, t in enumerate(SP_PIECES)]
    pieces += [(f"<extra_{i}>".encode(), -1e4) for i in range(vocab_pad - len(pieces))]
    return pieces


# The DeepSeek-R1 distills' special pieces (full-width bars, U+2581 for spaces)
R1_SPECIALS = ("<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>", "<｜User｜>", "<｜Assistant｜>")
CHATML_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
LLAMA3_SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                   "<|end_header_id|>", "<|eot_id|>")


def write_qwen2_ggmm(path, *, vocab_pad: int = 384, hidden: int = 256, heads: int = 4,
                     kv_heads: int = 2, layers: int = 2, inter: int = 512,
                     max_len: int = 512, dtype=None, seed: int = 0, writer_cls=None,
                     rope_theta: float = 1000000.0, tie: bool = True):
    """A narrow random-weight Qwen2 GGMM: byte-level vocab plus the ChatML
    control tokens, biased q/k/v, and no `lm_head.weight` when `tie` (the
    loader then ties the head to the embedding; the file says QWEN2TIE).
    `dtype` defaults to q8_0."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.ggmm.writer import GGMMWriter
    from chatllm_tpu_torch.models.model_types import ModelType
    from chatllm_tpu_torch.tokenizer.processor import TokenType

    writer_cls = writer_cls or GGMMWriter
    dtype = GGMLType.Q8_0 if dtype is None else GGMLType(int(dtype))
    pieces = _byte_pieces(CHATML_SPECIALS, vocab_pad, "<|extra_{}|>", TokenType.NORMAL)
    eot = 256
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = shape[-1] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    with open(path, "wb") as f:
        mtype = ModelType.QWEN2TIE if tie else ModelType.QWEN2
        wr = writer_cls(f, int(mtype), 1, meta={"model_name": "tiny-qwen2"})
        # BaseConfig + {num_key_value_heads, sliding_window} + rope_theta
        wr.write_config([int(dtype), vocab_pad, hidden, heads, layers, inter, max_len,
                         eot, eot, eot, -1, kv_heads, max_len], fmt="13i")
        f.write(struct.pack("<f", rope_theta))
        wr._patch_offset(12)
        wr.write_vocab_bpe(pieces, [])
        _write_dense_tensors(wr, w, dtype, vocab_pad, hidden, heads, kv_heads, layers, inter,
                             qkv_bias=True, tie=tie)
    return path


def write_internvl_ggmm(path, *, vocab_pad: int = 384, hidden: int = 256, heads: int = 4,
                        kv_heads: int = 2, head_dim: int = 64, layers: int = 2,
                        inter: int = 512, max_len: int = 4096, dtype=None, seed: int = 0,
                        writer_cls=None, rope_theta: float = 1000000.0, vis_hidden: int = 64,
                        vis_layers: int = 2, vis_heads: int = 2, vis_inter: int = 128,
                        patch: int = 14, image_size: int = 56, tower: bool = True,
                        yarn: tuple = (-1.0, -1), tie: bool = False, experts: int = -1,
                        sparse=None, model_type=None, r1_vocab: bool = False):
    """A narrow random-weight INTERN_VL GGMM: a Qwen3 LLM (chatllm.cpp
    models/qwen.h v3 Config: BaseConfig + n_kv, head_dim, rope_theta,
    yarn_factor, six ints, the tie flag and layer_is_sparse[128]; per-head
    q/k norms, an untied lm_head) behind an InternViT tower and projector
    under the converter's names (f16 linears, f32 norms, biases, layer
    scales and embeddings), with `config.json`'s vision_config and
    downsample_ratio in the meta.  Byte-level vocab plus ChatML's control
    tokens and `<img>` / `</img>`.  `dtype` (the LLM's linears) defaults to
    q4_k.  `tower=False` writes the Qwen3 LLM alone as a QWEN3 file (or as
    `model_type`); `yarn` is (yarn_factor, yarn_orig); `tie` sets the tie
    flag and writes no lm_head; `experts` > 0 writes a Qwen3-MoE LLM whose
    layers marked in `sparse` (every layer by default) route 2 of `experts`
    experts of width 128 (softmax, norm_topk_prob, no shared expert);
    `r1_vocab` swaps ChatML's tokens for the DeepSeek-R1 distills' pieces."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.ggmm.writer import GGMMWriter
    from chatllm_tpu_torch.models.model_types import ModelType
    from chatllm_tpu_torch.tokenizer.processor import TokenType

    writer_cls = writer_cls or GGMMWriter
    dtype = GGMLType.Q4_K if dtype is None else GGMLType(int(dtype))
    specials = R1_SPECIALS if r1_vocab else CHATML_SPECIALS + ("<img>", "</img>")
    pieces = _byte_pieces(specials, vocab_pad, "<|extra_{}|>", TokenType.NORMAL)
    eot = 256
    rng = np.random.default_rng(seed)
    sparse = [experts > 0 and (sparse is None or bool(sparse[i])) for i in range(layers)]

    def w(*shape, scale=None):
        scale = shape[-1] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    meta = {"model_name": "tiny-internvl",
            "config.json": {"vision_config": {
                "hidden_size": vis_hidden, "num_hidden_layers": vis_layers,
                "num_attention_heads": vis_heads, "intermediate_size": vis_inter,
                "patch_size": patch, "image_size": image_size, "layer_norm_eps": 1e-6},
                "downsample_ratio": 0.5, "use_thumbnail": True}}
    if not tower:
        meta = {"model_name": "tiny-qwen3"}
    with open(path, "wb") as f:
        mtype = model_type or (ModelType.INTERN_VL if tower else ModelType.QWEN3)
        wr = writer_cls(f, int(mtype), 1, meta=meta)
        wr.write_config([int(dtype), vocab_pad, hidden, heads, layers, inter, max_len,
                         eot, eot, eot, -1, kv_heads, head_dim], fmt="13i")
        f.write(struct.pack("<ff", rope_theta, yarn[0]))       # rope_theta, yarn_factor
        # yarn_orig, decoder_sparse_step, moe_intermediate_size,
        # num_experts_per_tok, num_experts, norm_topk_prob
        moe = experts > 0
        f.write(struct.pack("<6i", yarn[1], int(moe), 128 if moe else -1, 2 if moe else -1,
                            experts, int(moe)))
        f.write(struct.pack("<i", int(tie)))                   # tie_word_embeddings
        f.write(struct.pack("<128i", *(list(map(int, sparse)) + [0] * (128 - layers))))
        wr._patch_offset(12)
        wr.write_vocab_bpe(pieces, [])
        wr.write_tensor("model.embed_tokens.weight", w(vocab_pad, hidden, scale=1.0),
                        GGMLType.F32)
        for i in range(layers):
            p = f"model.layers.{i}"
            wr.write_tensor(f"{p}.input_layernorm.weight", 1.0 + 0.1 * w(hidden, scale=1.0),
                            GGMLType.F32)
            for name, n_out in (("q", heads * head_dim), ("k", kv_heads * head_dim),
                                ("v", kv_heads * head_dim)):
                wr.write_tensor(f"{p}.self_attn.{name}_proj.weight", w(n_out, hidden), dtype)
            wr.write_tensor(f"{p}.self_attn.o_proj.weight", w(hidden, heads * head_dim), dtype)
            for name in ("q_norm", "k_norm"):
                wr.write_tensor(f"{p}.self_attn.{name}.weight",
                                1.0 + 0.1 * w(head_dim, scale=1.0), GGMLType.F32)
            wr.write_tensor(f"{p}.post_attention_layernorm.weight",
                            1.0 + 0.1 * w(hidden, scale=1.0), GGMLType.F32)
            if sparse[i]:
                _write_moe_ffn(wr, w, dtype, f"{p}.mlp", hidden, experts=experts, moe_inter=128)
            else:
                _write_ffn(wr, w, dtype, f"{p}.mlp", hidden, inter)
        wr.write_tensor("model.norm.weight", 1.0 + 0.1 * w(hidden, scale=1.0), GGMLType.F32)
        if not tie:
            wr.write_tensor("lm_head.weight", w(vocab_pad, hidden), dtype)
        if not tower:
            return path

        def small(name, *shape, scale=0.02):
            wr.write_tensor(name, w(*shape, scale=scale), GGMLType.F32)

        small("visual.embeddings.class_embedding", vis_hidden)
        small("visual.embeddings.patch_embedding.weight", vis_hidden, 3, patch, patch,
              scale=(3 * patch * patch) ** -0.5)
        small("visual.embeddings.patch_embedding.bias", vis_hidden)
        small("visual.embeddings.position_embedding", 1, (image_size // patch) ** 2 + 1,
              vis_hidden)
        lins = [("self_attn.q_proj", vis_hidden, vis_hidden),
                ("self_attn.k_proj", vis_hidden, vis_hidden),
                ("self_attn.v_proj", vis_hidden, vis_hidden),
                ("self_attn.o_proj", vis_hidden, vis_hidden),
                ("mlp.fc1", vis_inter, vis_hidden), ("mlp.fc2", vis_hidden, vis_inter)]
        for i in range(vis_layers):
            p = f"visual.layers.{i}"
            for name, n_out, n_in in lins:
                wr.write_tensor(f"{p}.{name}.weight", w(n_out, n_in), GGMLType.F16)
                small(f"{p}.{name}.bias", n_out)
            for name in ("norm1", "norm2"):
                wr.write_tensor(f"{p}.{name}.weight", 1.0 + 0.1 * w(vis_hidden, scale=1.0),
                                GGMLType.F32)
                small(f"{p}.{name}.bias", vis_hidden)
            small(f"{p}.ls1", vis_hidden, scale=0.1)
            small(f"{p}.ls2", vis_hidden, scale=0.1)
        hp = vis_hidden * 4                                    # pixel shuffle at 0.5
        wr.write_tensor("vision_projector.0.weight", 1.0 + 0.1 * w(hp, scale=1.0),
                        GGMLType.F32)
        small("vision_projector.0.bias", hp)
        wr.write_tensor("vision_projector.1.weight", w(hidden, hp), GGMLType.F16)
        small("vision_projector.1.bias", hidden)
        wr.write_tensor("vision_projector.3.weight", w(hidden, hidden), GGMLType.F16)
        small("vision_projector.3.bias", hidden)
    return path


# write_deepseek_v2_ggmm's model loaded on the card against the CPU: (weight
# format, compute dtype, cache dtype, mla_cache, max_len, logits' tolerance
# relative to the logit scale).  An f32 cache holds to 1e-4; a q8 cache to
# 1e-2, since an f32-level difference flips int8 roundings of the cache
# (1.7e-3 on the CPU alone); q4_k weights with bf16 activations to 2e-2, as
# the other q4_k models (tests/test_torch_deepseek.py::
# test_tiny_fixture_moves_with_an_f32_level_perturbation).
DSV2_TINY_CASES = {
    "f32": ("f32", "float32", "float32", "speed", 512, 1e-4),
    "f32_q8": ("f32", "float32", "q8_0", "speed", 4096, 1e-2),
    "f32_latent": ("f32", "float32", "float32", "memory", 512, 1e-4),
    "q4k": ("q4_k", "bfloat16", "bfloat16", "speed", 512, 2e-2),
    "q4k_q8": ("q4_k", "bfloat16", "q8_0", "speed", 4096, 2e-2),
    "q4k_latent": ("q4_k", "bfloat16", "bfloat16", "memory", 512, 2e-2),
}


def write_deepseek_v2_ggmm(path, *, vocab_pad: int = 384, hidden: int = 256, heads: int = 4,
                           layers: int = 2, inter: int = 512, moe_inter: int = 256,
                           experts: int = 8, shared: int = 2, top_k: int = 2,
                           kv_rank: int = 256, max_len: int = 512, dtype=None, seed: int = 0,
                           writer_cls=None, model_type=None, q_lora_rank: int = 0,
                           n_group: int = 1, topk_group: int = 1, norm_topk: bool = False,
                           routed_scale: float = 1.0):
    """A narrow random-weight DEEPSEEK_V2_LIGHT GGMM in the converter's layout:
    byte-level vocab plus DeepSeek's begin/end-of-sentence control tokens,
    layer 0 dense and the rest MoE (`experts` routed, `top_k` a token, softmax
    scores, `shared` shared experts), MLA at DeepSeek-V2-Lite's head widths
    (nope 128, rope 64, v 128: a q8 cache of >= 4096 slots sends decode to K4
    at (192, 128)), and its YaRN rope (factor 40 over 4096, mscale 0.707).
    Every matrix takes `dtype` (q4_k by default; each width is a multiple of
    256); norms and the embedding stay f32.  `writer_cls` defaults to the
    port's GGMMWriter.  `model_type` writes another type of the layout:
    DEEPSEEK_V3, MOONLIGHT and DEEPSEEK_V3_LIGHT add each MoE layer's f32
    e_score_correction_bias; the non-light types (DEEPSEEK_V2, DEEPSEEK_V3)
    add q_lora_rank and topk_group to the header, and `q_lora_rank` > 0
    writes the low-rank q projections (d_q, q_norm, u_q) for q_proj."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.ggmm.writer import GGMMWriter
    from chatllm_tpu_torch.models.model_types import ModelType

    writer_cls = writer_cls or GGMMWriter
    dtype = GGMLType.Q4_K if dtype is None else GGMLType(int(dtype))
    mtype = ModelType(int(model_type or ModelType.DEEPSEEK_V2_LIGHT))
    light = mtype in (ModelType.DEEPSEEK_V2_LIGHT, ModelType.DEEPSEEK_V3_LIGHT,
                      ModelType.MOONLIGHT)
    gate_bias = mtype in (ModelType.DEEPSEEK_V3, ModelType.DEEPSEEK_V3_LIGHT,
                          ModelType.MOONLIGHT)
    nope, rope_d, v_dim = 128, 64, 128
    pieces = _byte_pieces(("<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>"), vocab_pad)
    bos, eos = 256, 257
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = shape[-1] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def norm(n):
        return 1.0 + 0.1 * w(n, scale=1.0)

    with open(path, "wb") as f:
        wr = writer_cls(f, int(mtype), 1, meta={"model_name": "tiny-dsv2"})
        # BaseConfig, then n_kv .. v_head_dim (14i) and beta_fast .. routed
        # scaling (7f), as tools/convert.py writes a V2-Lite file
        wr.write_config([int(dtype), vocab_pad, hidden, heads, layers, inter, max_len, bos, eos,
                         -1, -1, heads, 1, kv_rank, moe_inter, 1, n_group, experts, shared,
                         int(norm_topk), top_k, nope, rope_d, 4096, v_dim], fmt="25i")
        f.write(struct.pack("<7f", 32.0, 1.0, 40.0, 0.707, 0.707, 10000.0, routed_scale))
        if not light:
            f.write(struct.pack("<2i", q_lora_rank, topk_group))
        wr._patch_offset(12)
        wr.write_vocab_bpe(pieces, [])
        wr.write_tensor("model.embed_tokens.weight", w(vocab_pad, hidden, scale=1.0),
                        GGMLType.F32)
        for i in range(layers):
            p = f"model.layers.{i}"
            wr.write_tensor(f"{p}.input_layernorm.weight", norm(hidden), GGMLType.F32)
            q = ((("d_q_proj", (q_lora_rank, hidden)),
                  ("u_q_proj", (heads * (nope + rope_d), q_lora_rank))) if q_lora_rank > 0
                 else (("q_proj", (heads * (nope + rope_d), hidden)),))
            for name, shape in q + (("d_kv_proj", (kv_rank, hidden)),
                                    ("k_pe_proj", (rope_d, hidden)),
                                    ("u_k_nope_proj", (heads * nope, kv_rank)),
                                    ("u_v_proj", (heads * v_dim, kv_rank)),
                                    ("o_proj", (hidden, heads * v_dim))):
                wr.write_tensor(f"{p}.self_attn.{name}.weight", w(*shape), dtype)
            if q_lora_rank > 0:
                wr.write_tensor(f"{p}.self_attn.q_norm.weight", norm(q_lora_rank), GGMLType.F32)
            wr.write_tensor(f"{p}.self_attn.kv_norm.weight", norm(kv_rank), GGMLType.F32)
            wr.write_tensor(f"{p}.post_attention_layernorm.weight", norm(hidden), GGMLType.F32)
            if i > 0:
                _write_moe_ffn(wr, w, dtype, f"{p}.mlp", hidden, experts=experts,
                               moe_inter=moe_inter, shared="shared_experts",
                               shared_inter=shared * moe_inter, gate_bias=gate_bias)
            else:
                _write_ffn(wr, w, dtype, f"{p}.mlp", hidden, inter)
        wr.write_tensor("model.norm.weight", norm(hidden), GGMLType.F32)
        wr.write_tensor("lm_head.weight", w(vocab_pad, hidden), dtype)
    return path


GEMMA_FAMILIES = ("gemma", "gemma2", "gemma3", "rnj_1")
# BPEProcessor1 vocabs
SP_FAMILIES = ("llama2", "codellama", "mistral", "mixtral") + GEMMA_FAMILIES
RING_FAMILIES = ("mistral", "mixtral", "gemma2", "gemma3", "rnj_1")
FAMILY_WINDOW = 64
FAMILY_RING_CTX = 1024
FAMILY_RING_PROMPT = 640           # wraps a ring of 64 + SWA_EXTRA = 576 slots
MISTRAL2_HEAD_DIM = 128
MISTRAL2_SPECIALS = ("<unk>", "<s>", "</s>", "[INST]", "[/INST]")
GEMMA_HEAD_DIM = 256               # the narrow Gemmas' heads: most Gemma models' width
GEMMA_SPECIALS = ("<pad>", "<start_of_turn>", "<end_of_turn>")
# The narrow Gemmas' embedding entries: the tied head reads the embedding,
# so at N(0, 1) a token's own row outweighs every other logit and greedy
# decoding repeats the last token; at 0.1 the tokens vary
GEMMA_EMBED_SCALE = 0.1


def write_family_ggmm(path, family: str, *, dtype=None, seed: int = 0, writer_cls=None,
                      tie: bool = False, window: int = FAMILY_WINDOW):
    """A narrow random-weight GGMM of one of FAMILIES' model types, in the
    converter's layout: byte-level vocab of 384 plus the family's control
    tokens (Llama-2, CodeLlama, Mistral and Mixtral: the SentencePiece-score
    vocab of `_sp_pieces`), hidden 256, 4 heads of 64 (over 2 kv heads but
    for DeepSeek v1, Llama-2 and CodeLlama; Mistral2: heads of 128, wider
    than hidden / heads), 2 layers, FFN 512, 8 experts of 256 with top-2
    (Qwen3-MoE's: the writer's), every matrix in `dtype` (q4_k by default),
    norms, biases and the embedding f32.  `tie` sets LLAMA3_2's and the R1
    distills' tie flag and writes no lm_head.  Mistral and Mixtral attend
    over a `window` of 64 in a context of 1024: rings of 64 + SWA_EXTRA =
    576 slots that a prompt of FAMILY_RING_PROMPT tokens wraps.  The Gemmas
    (GEMMA_FAMILIES) carry GEMMA_SPECIALS in their SentencePiece-score vocab
    and heads of GEMMA_HEAD_DIM, 4 over 2 kv heads (Gemma-3: over 1, 4 query
    heads a kv head, Gemma-3-1B's), always tied; Gemma-2's even layers and
    Gemma-3's and RNJ-1's layer 0 (local, on the local rope table; layer 1
    global) attend over the same window in rings of 576 slots.  Gemma-2 and
    RNJ-1 softcap the scores at 50 and the logits at 30; Gemma-2 scales the
    queries by query_pre_attn_scalar 144, not 256; RNJ-1 takes YaRN with
    factor 4 over an original context of 256."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.ggmm.writer import GGMMWriter
    from chatllm_tpu_torch.models.model_types import ModelType

    mtype = ModelType[FAMILIES[family][0]]
    kw = dict(dtype=dtype, seed=seed, writer_cls=writer_cls, **FAMILIES[family][1])
    if family in ("qwen3_moe", "ds_r1_qwen3"):
        return write_internvl_ggmm(path, tower=False, model_type=mtype, tie=tie, max_len=512,
                                   **kw)
    if family in ("deepseek_v3", "moonlight", "deepseek_v3_light"):
        return write_deepseek_v2_ggmm(path, model_type=mtype, **kw)
    if family in GLM_FAMILIES:
        return write_glm_ggmm(path, family, **kw)
    if family in PHI_FAMILIES:
        return write_phi_ggmm(path, family, **kw)
    if family == "gpt_oss":
        return write_gpt_oss_ggmm(path, window=window, **kw)
    writer_cls = writer_cls or GGMMWriter
    dtype = GGMLType.Q4_K if dtype is None else GGMLType(int(dtype))
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = shape[-1] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    vocab, hidden, heads, layers, inter, max_len = 384, 256, 4, 2, 512, 512
    experts, top_k, moe_inter = 8, 2, 256
    sp = family in SP_FAMILIES
    if family in RING_FAMILIES:
        max_len = FAMILY_RING_CTX
    gemma = family in GEMMA_FAMILIES
    specials = (R1_SPECIALS if family.startswith("ds_r1") else
                CHATML_SPECIALS if family.startswith("qwen") else
                R1_SPECIALS[:2] if family.startswith("deepseek") else
                MISTRAL2_SPECIALS if family == "mistral2" else LLAMA3_SPECIALS)
    n_kv = heads if family in ("deepseek", "llama2", "codellama") else 2
    if family == "gemma3":
        n_kv = 1
    bos, eos = (1, 2) if sp else (256, 257)
    base = [int(dtype), vocab, hidden, heads, layers, inter, max_len, bos, eos, -1, -1]
    tensors = dict(qkv_bias=family in ("ds_r1_qwen", "qwen2_moe"), tie=tie or gemma)
    if gemma:
        tensors.update(head_dim=GEMMA_HEAD_DIM, sandwich=family != "gemma",
                       qk_norm=family in ("gemma3", "rnj_1"), embed_scale=GEMMA_EMBED_SCALE)
    with open(path, "wb") as f:
        wr = writer_cls(f, int(mtype), 1, meta={"model_name": f"tiny-{family}"})
        if family in ("llama2", "codellama"):
            wr.write_config(base, fmt="11i")
            if family == "codellama":
                f.write(struct.pack("<f", 1000000.0))          # rope_theta
        elif family in ("mistral", "mixtral"):
            # n_kv, sliding_window, rope_theta (+ Mixtral's n_active, n_experts)
            wr.write_config(base + [n_kv, window], fmt="13i")
            if family == "mistral":
                f.write(struct.pack("<f", 10000.0))
            else:
                f.write(struct.pack("<f2i", 1000000.0, top_k, experts))
                tensors.update(sparse=[True] * layers, experts=experts, moe_inter=moe_inter,
                               moe_pfx="block_sparse_moe", names=MIXTRAL_FFN_NAMES)
        elif family == "mistral2":
            # n_kv, head_dim, sliding_window (none: Mistral-Nemo's), rope_theta
            wr.write_config(base + [n_kv, MISTRAL2_HEAD_DIM, -1], fmt="14i")
            f.write(struct.pack("<f", 1000000.0))
            tensors.update(head_dim=MISTRAL2_HEAD_DIM)
        elif family in ("llama3_2", "ds_r1_llama"):
            # v3_1 (n_kv, rope_theta, rope scaling) + tie_word_embeddings
            wr.write_config(base + [n_kv], fmt="12i")
            f.write(struct.pack("<fifffi", 500000.0, 8192, 32.0, 1.0, 4.0, int(tie)))
        elif family == "ds_r1_qwen":
            # Qwen2's (n_kv, sliding_window, rope_theta) + the tie flag
            wr.write_config(base + [n_kv, max_len], fmt="13i")
            f.write(struct.pack("<fi", 1000000.0, int(tie)))
        elif family == "qwen2_moe":
            # n_kv, moe_inter, shared_inter, sliding_window, n_active,
            # n_experts, norm_topk, rope_theta
            wr.write_config(base + [n_kv, moe_inter, 2 * moe_inter, max_len, top_k, experts, 0],
                            fmt="18i")
            f.write(struct.pack("<f", 1000000.0))
            tensors.update(sparse=[True] * layers, experts=experts, moe_inter=moe_inter,
                           shared="shared_expert", shared_inter=2 * moe_inter, shared_gate=True)
        elif family == "gemma":
            # n_kv, head_dim, rope_theta
            wr.write_config(base + [n_kv, GEMMA_HEAD_DIM], fmt="13i")
            f.write(struct.pack("<f", 10000.0))
        elif family == "gemma2":
            # n_kv, head_dim, query_pre_attn_scalar, sliding_window; rope_theta,
            # final and attention softcaps
            wr.write_config(base + [n_kv, GEMMA_HEAD_DIM, 144, window], fmt="15i")
            f.write(struct.pack("<3f", 10000.0, 30.0, 50.0))
        elif family in ("gemma3", "rnj_1"):
            # n_kv, head_dim, query_pre_attn_scalar, sliding_window, pattern;
            # rope_local_base, rope_theta, rope_factor (linear)
            wr.write_config(base + [n_kv, GEMMA_HEAD_DIM, GEMMA_HEAD_DIM, window, 2],
                            fmt="16i")
            f.write(struct.pack("<3f", 10000.0, 1000000.0, 8.0 if family == "gemma3" else 1.0))
            if family == "rnj_1":
                # YaRN: attn_factor, beta_fast, beta_slow, ext_factor, factor,
                # orig_max; final and attention softcaps
                f.write(struct.pack("<5fi2f", 1.0, 32.0, 1.0, 1.0, 4.0, 256, 30.0, 50.0))
        elif family == "deepseek":
            wr.write_config(base, fmt="11i")
        else:                                   # deepseek_v1_moe: layer 0 dense
            # n_kv, first_k_dense, moe_inter, moe_layer_freq, n_routed,
            # n_shared, norm_topk, n_active, rope_theta
            wr.write_config(base + [n_kv, 1, moe_inter, 1, experts, 2, 1, top_k], fmt="19i")
            f.write(struct.pack("<f", 10000.0))
            tensors.update(sparse=[i >= 1 for i in range(layers)], experts=experts,
                           moe_inter=moe_inter, shared="shared_experts",
                           shared_inter=2 * moe_inter)
        wr._patch_offset(12)
        if gemma:
            pieces = _sp_pieces(vocab - len(GEMMA_SPECIALS))
            wr.write_vocab_sp(pieces + [(t.encode(), -1e4) for t in GEMMA_SPECIALS])
        elif sp:
            wr.write_vocab_sp(_sp_pieces(vocab))
        else:
            wr.write_vocab_bpe(_byte_pieces(specials, vocab), [])
        _write_dense_tensors(wr, w, dtype, vocab, hidden, heads, n_kv, layers, inter, **tensors)
    return path


# The GLM families: the GLM2 architecture (fused qkv and gate_up) over
# ChatGLM2's SentencePiece-score vocab or GLM-4's byte-level one, and
# GLM-4-0414 (separate q/k/v, sandwich norms) over GLM-4's
GLM2_FAMILIES = ("chatglm2", "chatglm3", "codegeex2", "characterglm")
GLM4_FAMILIES = ("glm4", "codegeex4")
GLM_FAMILIES = GLM2_FAMILIES + GLM4_FAMILIES + ("glm4_0414",)
# GLM-4's <|endoftext|> and the nine special pieces its tokenizer counts up
# from it (chatllm.cpp models/chatglm.cpp v4)
GLM4_SPECIALS = ("<|endoftext|>", "[MASK]", "[gMASK]", "[sMASK]", "<sop>", "<eop>",
                 "<|system|>", "<|user|>", "<|assistant|>", "<|observation|>")
GLM2_SPECIAL_IDS = 5               # ChatGLM2's mask .. eop ids, at and above its piece count


def write_glm_ggmm(path, family: str, *, dtype=None, seed: int = 0, writer_cls=None,
                   vocab: int = 384, hidden: int = 256, heads: int = 4, kv_heads: int = 2,
                   layers: int = 2, inter: int = 512, max_len: int = 512):
    """A narrow random-weight GGMM of a GLM family (GLM_FAMILIES) in the
    converter's layout (chatllm.cpp convert.py ChatGLM2Converter /
    GLM4Converter names): hidden 256, 4 heads of 64 over 2 kv heads, 2
    layers, FFN 512, every matrix in `dtype` (q4_k by default), norms,
    biases and the embedding f32.  The GLM2 architecture writes the biased `query_key_value`
    [q | k | v] and `dense_h_to_4h` [gate | up]; ChatGLM2's vocab is
    SentencePiece-score with GLM2_SPECIAL_IDS ids past its pieces, GLM-4's
    byte-level with GLM4_SPECIALS.  GLM-4 writes rope_ratio 500, GLM-4-0414
    biased q/k/v, a rope of half the head and rope_theta 1e4."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.ggmm.writer import GGMMWriter
    from chatllm_tpu_torch.models.model_types import ModelType

    writer_cls = writer_cls or GGMMWriter
    dtype = GGMLType.Q4_K if dtype is None else GGMLType(int(dtype))
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = shape[-1] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def norm(name, n=hidden):
        wr.write_tensor(f"{name}.weight", 1.0 + 0.1 * w(n, scale=1.0), GGMLType.F32)

    d = hidden // heads
    glm2 = family in GLM2_FAMILIES
    bos, eos = (1, 2) if glm2 else (-1, 256)
    base = [int(dtype), vocab, hidden, heads, layers, inter, max_len, bos, eos, -1, -1]
    with open(path, "wb") as f:
        wr = writer_cls(f, int(ModelType[FAMILIES[family][0]]), 1,
                        meta={"model_name": f"tiny-{family}"})
        if family == "glm4_0414":
            # n_kv, use_attention_bias, rope_dim; rope_theta
            wr.write_config(base + [kv_heads, 1, d // 2], fmt="14i")
            f.write(struct.pack("<f", 10000.0))
        else:
            wr.write_config(base + [kv_heads], fmt="12i")
            if not glm2:
                f.write(struct.pack("<f", 500.0))                # rope_ratio
        wr._patch_offset(12)
        if glm2:
            wr.write_vocab_sp(_sp_pieces(vocab - GLM2_SPECIAL_IDS))
        else:
            wr.write_vocab_bpe(_byte_pieces(GLM4_SPECIALS, vocab), [])
        qkv = (heads + 2 * kv_heads) * d
        if family == "glm4_0414":
            wr.write_tensor("model.embed_tokens.weight", w(vocab, hidden, scale=1.0),
                            GGMLType.F32)
            for i in range(layers):
                p = f"model.layers.{i}"
                norm(f"{p}.input_layernorm")
                for name, n_out in (("q", heads * d), ("k", kv_heads * d), ("v", kv_heads * d)):
                    wr.write_tensor(f"{p}.self_attn.{name}_proj.weight", w(n_out, hidden), dtype)
                    wr.write_tensor(f"{p}.self_attn.{name}_proj.bias", w(n_out, scale=0.5),
                                    GGMLType.F32)
                wr.write_tensor(f"{p}.self_attn.o_proj.weight", w(hidden, heads * d), dtype)
                for name in ("post_self_attn", "post_attention", "post_mlp"):
                    norm(f"{p}.{name}_layernorm")
                wr.write_tensor(f"{p}.mlp.gate_proj.weight", w(inter, hidden), dtype)
                wr.write_tensor(f"{p}.mlp.up_proj.weight", w(inter, hidden), dtype)
                wr.write_tensor(f"{p}.mlp.down_proj.weight", w(hidden, inter), dtype)
            norm("model.norm")
            wr.write_tensor("lm_head.weight", w(vocab, hidden), dtype)
            return path
        wr.write_tensor("transformer.embedding.word_embeddings.weight",
                        w(vocab, hidden, scale=1.0), GGMLType.F32)
        for i in range(layers):
            p = f"transformer.encoder.layers.{i}"
            norm(f"{p}.input_layernorm")
            wr.write_tensor(f"{p}.self_attention.query_key_value.weight", w(qkv, hidden), dtype)
            wr.write_tensor(f"{p}.self_attention.query_key_value.bias", w(qkv, scale=0.5),
                            GGMLType.F32)
            wr.write_tensor(f"{p}.self_attention.dense.weight", w(hidden, heads * d), dtype)
            norm(f"{p}.post_attention_layernorm")
            wr.write_tensor(f"{p}.mlp.dense_h_to_4h.weight", w(2 * inter, hidden), dtype)
            wr.write_tensor(f"{p}.mlp.dense_4h_to_h.weight", w(hidden, inter), dtype)
        norm("transformer.encoder.final_layernorm")
        wr.write_tensor("transformer.output_layer.weight", w(vocab, hidden), dtype)
    return path


# The Phi families: Phi-2's LayerNorm decoder with a parallel residual and
# biases everywhere, in the v2 (HF) names or the v1 (GPT-style) ones; Phi-3's
# llama-like blocks over a SentencePiece-score vocab, plain, windowed over
# 2048 keys in a 4096 context (a ring of 2560 slots), or with LongRoPE's
# factors (SU / SU2 over a window wider than any cache; SU3 / PHI4_MINI with
# their stored mscales); Phi-4's over a byte-level vocab
PHI2_FAMILIES = ("phi2", "dolphinphi2_v2", "phi2_v1", "dolphinphi2")
PHI3_FAMILIES = ("phi3", "phi3_su", "phi3_su2", "phi3_su3", "phi4_mini")
PHI_FAMILIES = PHI2_FAMILIES + PHI3_FAMILIES + ("phi4",)
PHI3_SPECIALS = ("<|endoftext|>", "<|assistant|>", "<|system|>", "<|end|>", "<|user|>")
PHI4_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_sep|>", "<|im_end|>")
PHI3_WINDOW = 2047                 # Phi-3-mini-4k's sliding_window (the loader adds 1)
PHI3_CTX = 4096
PHI2_ROPE_DIM = 24                 # the v2 files' rope width (v1's is fixed at 32)
PHI_SU_CTX = (1024, 256)           # max_position_embeddings, original_max_position_embeddings
PHI_SU_WINDOW = 262144             # Phi-3.5-mini's: wider than any cache, no ring
PHI35_WINDOW = PHI_SU_WINDOW + 1   # the window its layers take (the loader adds 1)


def write_phi_ggmm(path, family: str, *, dtype=None, seed: int = 0, writer_cls=None,
                   vocab: int = 384, hidden: int = 256, heads: int = 4, kv_heads: int = 2,
                   layers: int = 2, inter: int = 512, phi3_fallback: bool = False):
    """A narrow random-weight GGMM of a Phi family (PHI_FAMILIES) in the
    converter's layout (chatllm.cpp convert.py Phi2Converter / Phi3Converter
    / Phi3SUConverter / Phi4Converter names): hidden 256, 4 heads of 64, 2
    layers, FFN 512, every matrix in `dtype` (q4_k by default), norms,
    biases and the embedding f32.  Phi-2 (MHA): LayerNorm weights and
    biases, biased q/k/v, dense, fc1, fc2 and head; its vocab byte-level
    with <|endoftext|> (Dolphin's: ChatML's specials).  Phi-3 (2 kv heads):
    the SentencePiece-score vocab of `_sp_pieces` with PHI3_SPECIALS past it
    (eos <|endoftext|>); `phi3_fallback` writes a PHI3 file whose 32000
    pieces hold no role piece under a config vocab of 32064, the layout in
    which the loader takes Phi-3's fixed role ids.  Phi-4: the Llama-3
    config over a byte-level vocab with PHI4_SPECIALS."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.ggmm.writer import GGMMWriter
    from chatllm_tpu_torch.models.model_types import ModelType

    writer_cls = writer_cls or GGMMWriter
    dtype = GGMLType.Q4_K if dtype is None else GGMLType(int(dtype))
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = shape[-1] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def tensor(name, *shape, scale=None):
        wr.write_tensor(name, w(*shape, scale=scale), dtype if len(shape) == 2 else GGMLType.F32)

    phi2 = family in PHI2_FAMILIES
    if phi3_fallback:
        vocab = 32064
    max_len = PHI3_CTX if family == "phi3" else PHI_SU_CTX[0] if family != "phi4" else 512
    if phi2:
        kv_heads, max_len = heads, 512
    specials = (CHATML_SPECIALS if family.startswith("dolphin") else PHI4_SPECIALS
                if family == "phi4" else CHATML_SPECIALS[:1] if phi2 else PHI3_SPECIALS)
    sp = family in PHI3_FAMILIES
    bos, eos = ((1, vocab - len(PHI3_SPECIALS)) if sp and not phi3_fallback else (1, 2) if sp
                else (256, 256) if phi2 else (256, 256 + len(PHI4_SPECIALS) - 1))
    base = [int(dtype), vocab, hidden, heads, layers, inter, max_len, bos, eos, -1, -1]
    d = hidden // heads
    with open(path, "wb") as f:
        wr = writer_cls(f, int(ModelType[FAMILIES[family][0]]), 1,
                        meta={"model_name": f"tiny-{family}"})
        if family in ("phi2", "dolphinphi2_v2"):
            wr.write_config(base, fmt="11i")
            f.write(struct.pack("<if", PHI2_ROPE_DIM, 10000.0))       # rope_dim, rope_theta
        elif phi2:
            wr.write_config(base, fmt="11i")
        elif family == "phi3":
            # n_kv, original_max_position_embeddings, sliding_window; rope_theta
            wr.write_config(base + [kv_heads, PHI3_CTX, PHI3_WINDOW], fmt="14i")
            f.write(struct.pack("<f", 10000.0))
        elif family == "phi4":
            wr.write_config(base + [kv_heads], fmt="12i")              # n_kv; rope_theta
            f.write(struct.pack("<f", 250000.0))
        else:
            # max_position_embeddings, n_kv, original_max, sliding_window,
            # rope_scaling; rope_theta, short and long factors (128 each,
            # the first d / 2 used), SU3 / PHI4_MINI: short and long mscale
            wr.write_config(base + [PHI_SU_CTX[0], kv_heads, PHI_SU_CTX[1], PHI_SU_WINDOW, 1],
                            fmt="16i")
            half = d // 2
            short = [1.0] * half + [0.0] * (128 - half)
            long = [1.0 + i / 4 for i in range(half)] + [0.0] * (128 - half)
            f.write(struct.pack("<f128f128f", 10000.0, *short, *long))
            if family in ("phi3_su3", "phi4_mini"):
                f.write(struct.pack("<2f", 1.0, 1.25))
        wr._patch_offset(12)
        if phi3_fallback:
            wr.write_vocab_sp(_sp_pieces(32000))
        elif sp:
            wr.write_vocab_sp(_sp_pieces(vocab - len(specials))
                              + [(t.encode(), -1e4) for t in specials])
        else:
            wr.write_vocab_bpe(_byte_pieces(specials, vocab), [])
        if not phi2:
            _write_dense_tensors(wr, w, dtype, vocab, hidden, heads, kv_heads, layers, inter)
            return path
        v1 = family in ("phi2_v1", "dolphinphi2")
        names = PHI2_V1_TENSORS if v1 else PHI2_V2_TENSORS
        wr.write_tensor(names["embed"], w(vocab, hidden, scale=1.0), GGMLType.F32)
        for i in range(layers):
            p = names["layer"].format(i=i)
            wr.write_tensor(f"{p}.{names['norm']}.weight", 1.0 + 0.1 * w(hidden, scale=1.0),
                            GGMLType.F32)
            tensor(f"{p}.{names['norm']}.bias", hidden, scale=0.1)
            for name in ("q_proj", "k_proj", "v_proj", names["o"]):
                tensor(f"{p}.{names['attn']}.{name}.weight", hidden, heads * d)
                tensor(f"{p}.{names['attn']}.{name}.bias", hidden, scale=0.5)
            tensor(f"{p}.mlp.fc1.weight", inter, hidden)
            tensor(f"{p}.mlp.fc1.bias", inter, scale=0.5)
            tensor(f"{p}.mlp.fc2.weight", hidden, inter)
            tensor(f"{p}.mlp.fc2.bias", hidden, scale=0.5)
        wr.write_tensor(f"{names['final_norm']}.weight", 1.0 + 0.1 * w(hidden, scale=1.0),
                        GGMLType.F32)
        tensor(f"{names['final_norm']}.bias", hidden, scale=0.1)
        tensor(f"{names['head']}.weight", vocab, hidden)
        tensor(f"{names['head']}.bias", vocab, scale=0.5)
    return path


PHI2_V2_TENSORS = {"embed": "model.embed_tokens.weight", "layer": "model.layers.{i}",
                   "norm": "input_layernorm", "attn": "self_attn", "o": "dense",
                   "final_norm": "model.final_layernorm", "head": "lm_head"}
PHI2_V1_TENSORS = {"embed": "transformer.embd.wte.weight", "layer": "transformer.h.{i}",
                   "norm": "ln", "attn": "mixer", "o": "out_proj", "final_norm": "lm_head.ln",
                   "head": "lm_head.linear"}


# GPT-OSS: the harmony special pieces, and merges of byte pairs (as raw
# bytes) that cross what the o200k pre-split keeps apart or together: a
# space and a word, digit runs, contractions, an accent's and a CJK
# character's UTF-8 bytes, a letter and a combining mark, \r\n, spaces
GPT_OSS_SPECIALS = ("<|startoftext|>", "<|endoftext|>", "<|start|>", "<|message|>", "<|end|>",
                    "<|channel|>", "<|return|>")
GPT_OSS_MERGES = ((b" ", b"t"), (b"h", b"e"), (b" t", b"he"), (b"1", b"2"), (b"12", b"3"),
                  (b"3", b"4"), (b"'", b"s"), (b"'", b"t"), (b"\xc3", b"\xa9"), (b"\xc3", b"\x89"),
                  (b"\xe4", b"\xb8"), (b"\xcc", b"\x81"), (b"e", b"\xcc\x81"), (b"\r", b"\n"),
                  (b" ", b" "), (b"  ", b" "), (b"a", b"b"), (b"A", b"B"), (b"B", b"c"),
                  (b".", b"\r"), (b"!", b"!"), (b" ", b"!"))


def write_gpt_oss_ggmm(path, *, dtype=None, seed: int = 0, writer_cls=None,
                       window: int = FAMILY_WINDOW):
    """A narrow random-weight GPT_OSS GGMM in the converter's layout (the JAX
    package's tools/convert.py::convert_gpt_oss names): hidden 256, 4 heads
    of 64 over 2 kv heads, 2 layers (layer 0 attends over a `window` of 64,
    in a ring of 64 + SWA_EXTRA = 576 slots within a context of 1024; layer
    1 over the whole context), sinks N(0, 1), biased q/k/v/o, a biased
    router over 4 experts of 256 (top 2), biased experts, YaRN with factor 4
    over an original context of 256, swiglu_limit 7; every matrix in `dtype`
    (q4_k by default), norms, biases, sinks and the embedding f32.  The
    vocab is byte-level with the merges of GPT_OSS_MERGES and the harmony
    specials (GPT_OSS_SPECIALS)."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.ggmm.writer import GGMMWriter
    from chatllm_tpu_torch.models.model_types import ModelType
    from chatllm_tpu_torch.tokenizer.processor import TokenType, byte_level_encode

    writer_cls = writer_cls or GGMMWriter
    dtype = GGMLType.Q4_K if dtype is None else GGMLType(int(dtype))
    rng = np.random.default_rng(seed)
    vocab, hidden, heads, kv_heads, layers, max_len = 384, 256, 4, 2, 2, FAMILY_RING_CTX
    experts, top_k, inter = 4, 2, 256

    def tensor(name, *shape, scale=None):
        scale = shape[-1] ** -0.5 if scale is None else scale
        arr = (rng.standard_normal(shape) * scale).astype(np.float32)
        wr.write_tensor(name, arr, dtype if len(shape) == 2 else GGMLType.F32)

    enc = [byte_level_encode(a) for a in (m for pair in GPT_OSS_MERGES for m in pair)]
    merges = [f"{a.decode()} {b.decode()}" for a, b in zip(enc[::2], enc[1::2])]
    pieces = [(byte_level_encode(bytes([b])), int(TokenType.NORMAL)) for b in range(256)]
    pieces += [(byte_level_encode(a + b), int(TokenType.NORMAL)) for a, b in GPT_OSS_MERGES]
    n_normal = len(pieces)
    pieces += [(t.encode(), int(TokenType.CONTROL)) for t in GPT_OSS_SPECIALS]
    pieces += [(f"<|reserved_{i}|>".encode(), int(TokenType.CONTROL))
               for i in range(vocab - len(pieces))]
    bos, eos = n_normal, n_normal + 1
    d = hidden // heads
    layer_type = [int(i % 2 == 0) for i in range(layers)] + [0] * (128 - layers)
    with open(path, "wb") as f:
        wr = writer_cls(f, int(ModelType.GPT_OSS), 1, meta={"model_name": "tiny-gpt-oss"})
        wr.write_config([int(dtype), vocab, hidden, heads, layers, inter, max_len, bos, eos, -1,
                         -1, kv_heads, d, top_k, top_k, experts, window] + layer_type,
                        fmt=f"{11 + 6 + 128}i")
        # router_aux_loss_coef, swiglu_limit, rope_theta, original_max_position_embeddings,
        # beta_fast, beta_slow, factor
        f.write(struct.pack("<7f", 0.9, 7.0, 150000.0, 256.0, 32.0, 1.0, 4.0))
        wr._patch_offset(12)
        wr.write_vocab_bpe(pieces, merges)
        tensor("model.embed_tokens.weight", vocab, hidden, scale=1.0)
        for i in range(layers):
            p = f"model.layers.{i}"
            wr.write_tensor(f"{p}.input_layernorm.weight",
                            (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32),
                            GGMLType.F32)
            for j in range(experts):
                e = f"{p}.mlp.experts.{j}"
                tensor(f"{e}.down_proj.weight", hidden, inter)
                tensor(f"{e}.down_proj.bias", hidden, scale=0.1)
                for name in ("gate_proj", "up_proj"):
                    tensor(f"{e}.{name}.weight", inter, hidden)
                    tensor(f"{e}.{name}.bias", inter, scale=0.1)
            tensor(f"{p}.mlp.router.weight", experts, hidden)
            tensor(f"{p}.mlp.router.bias", experts, scale=0.5)
            wr.write_tensor(f"{p}.post_attention_layernorm.weight",
                            (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32),
                            GGMLType.F32)
            for name, n_out in (("k", kv_heads * d), ("q", heads * d), ("v", kv_heads * d),
                                ("o", hidden)):
                tensor(f"{p}.self_attn.{name}_proj.weight", n_out,
                       heads * d if name == "o" else hidden)
                tensor(f"{p}.self_attn.{name}_proj.bias", n_out, scale=0.5)
            tensor(f"{p}.self_attn.sinks", heads, scale=1.0)
        wr.write_tensor("model.norm.weight",
                        (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32),
                        GGMLType.F32)
        tensor("lm_head.weight", vocab, hidden)
    return path


# The families of write_family_ggmm: name -> (model type, writer options)
FAMILIES = {
    "llama3_2": ("LLAMA3_2", {}),
    "ds_r1_llama": ("DEEPSEEK_R1_DISTILL_LLAMA", {}),
    "ds_r1_qwen": ("DEEPSEEK_R1_DISTILL_QWEN", {}),
    "ds_r1_qwen3": ("DEEPSEEK_R1_DISTILL_QWEN3", dict(r1_vocab=True, experts=-1)),
    "qwen3_moe": ("QWEN3", dict(experts=8, sparse=(True, False))),   # a sparse and a dense layer
    "qwen2_moe": ("QWEN2MoE", {}),
    "deepseek": ("DEEPSEEK", {}),
    "deepseek_v1_moe": ("DEEPSEEK_V1_MoE", {}),
    "deepseek_v3": ("DEEPSEEK_V3", dict(q_lora_rank=256, n_group=4, topk_group=2,
                                        norm_topk=True, routed_scale=2.5)),
    "moonlight": ("MOONLIGHT", dict(norm_topk=True)),
    "deepseek_v3_light": ("DEEPSEEK_V3_LIGHT", dict(norm_topk=True)),
    "llama2": ("LLAMA2", {}),
    "codellama": ("CODELLAMA", {}),
    "mistral": ("MISTRAL", {}),
    "mixtral": ("MIXTRAL", {}),
    "mistral2": ("MISTRAL2", {}),
    "gemma": ("GEMMA", {}),
    "gemma2": ("GEMMA2", {}),
    "gemma3": ("GEMMA3", {}),
    "rnj_1": ("RNJ_1", {}),
    "chatglm2": ("CHATGLM2", {}),
    "chatglm3": ("CHATGLM3", {}),
    "codegeex2": ("CODEGEEX2", {}),
    "characterglm": ("CHARACTERGLM", {}),
    "glm4": ("GLM4", {}),
    "codegeex4": ("CODEGEEX4", {}),
    "glm4_0414": ("GLM4_0414", {}),
    "phi2": ("PHI2_V2", {}),
    "dolphinphi2_v2": ("DOLPHINPHI2_V2", {}),
    "phi2_v1": ("PHI2", {}),
    "dolphinphi2": ("DOLPHINPHI2", {}),
    "phi3": ("PHI3", {}),
    "phi3_su": ("PHI3_SU", {}),
    "phi3_su2": ("PHI3_SU2", {}),
    "phi3_su3": ("PHI3_SU3", {}),
    "phi4_mini": ("PHI4_MINI", {}),
    "phi4": ("PHI4", {}),
    "gpt_oss": ("GPT_OSS", {}),
}


# ---------------------------------------------------------------- timing
class Timer:
    """Per-launch CUDA-event timing with the L2 flushed before every
    launch (decode and prefill find their weights cold); median in ms.  The
    flush writes 1 GiB, about 0.4 ms of work on the card, behind which the
    host issues the wrapper's launches: the events then bracket the kernels'
    time on the card and not the host's time in the wrapper."""

    def __init__(self, device):
        self.flush = torch.empty(2 ** 30, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(nb: int, flops: float, peak: float):
    t_b, t_f = nb / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ------------------------------------------------------------ kernels phase
def quant_weight(fmt: str, K: int, N: int, gen, dev):
    """A random quantized weight in one of the layouts K1 and K2 take:
    q4_k (superblock, packed, with m), q5_k (superblock, int8 0..31, with
    m), q6_k (superblock G 16, int8 -32..31, signed sc, no m), q2_k
    (superblock G 16, packed 0..3, with m), q8_0 (classic f16), q4_0
    (packed, zero point 8), q4_1 (packed, f16 b) and q8_f32b (classic f32
    scales with b)."""
    from chatllm_tpu_torch.models.synthetic import synth_linear
    from chatllm_tpu_torch.ops.qtensor import QuantLinear

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)

    def halfs(shape, scale):
        return (torch.rand(shape, generator=gen, device=dev) * scale + 1e-4).half()

    if fmt == "q4_k":
        return synth_linear(K, N, "q4k", gen=gen, zeros=False, device=dev)
    if fmt in ("q5_k", "q6_k", "q2_k"):
        G = 32 if fmt == "q5_k" else 16
        sb, ng = 256 // G, K // G
        d = halfs((ng // sb, N), 0.002)
        if fmt == "q5_k":
            return QuantLinear(q=ints(0, 32, (K, N), torch.int8), s=ints(0, 64, (ng, N), torch.int8),
                               b=ints(0, 64, (ng, N), torch.int8), group_size=G, d=d,
                               dm=halfs((ng // sb, N), 0.001), sb=sb)
        if fmt == "q6_k":
            return QuantLinear(q=ints(-32, 32, (K, N), torch.int8),
                               s=ints(-128, 128, (ng, N), torch.int8), group_size=G, d=d, sb=sb)
        q = ints(0, 4, (K // 2, N), torch.uint8) | (ints(0, 4, (K // 2, N), torch.uint8) << 4)
        return QuantLinear(q=q, s=ints(0, 16, (ng, N), torch.int8),
                           b=ints(0, 16, (ng, N), torch.int8), group_size=G, packed=True, d=d,
                           dm=halfs((ng // sb, N), 0.001), sb=sb)
    G = 32
    s = halfs((K // G, N), 0.01)
    if fmt == "q8_0":
        return QuantLinear(q=ints(-127, 128, (K, N), torch.int8), s=s)
    if fmt == "q8_f32b":
        b = -(torch.rand(K // G, N, generator=gen, device=dev) * 0.08)
        return QuantLinear(q=ints(-127, 128, (K, N), torch.int8), s=s.float(), b=b)
    q = ints(0, 256, (K // 2, N), torch.uint8)
    if fmt == "q4_0":
        return QuantLinear(q=q, s=s, packed=True, zero_point=8)
    b = -(torch.rand(K // G, N, generator=gen, device=dev) * 0.08).half()
    return QuantLinear(q=q, s=s, b=b, packed=True)            # q4_1


def lin_args(lin):
    return ((lin.q, lin.s, lin.b, lin.bias),
            dict(group=lin.group_size, packed=lin.packed, zero_point=lin.zero_point,
                 d=lin.d, dm=lin.dm, sb=lin.sb))


def rel_err(y, ref) -> tuple[float, float]:
    diff = (y.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def _check_matmul(res, name, kern, plain, x, lin, tol, tag, quiet=False) -> torch.Tensor:
    """Hold one quantized-matmul kernel against its plain version."""
    arrays, kw = lin_args(lin)
    y = kern(x, *arrays, **kw)
    ref = plain(x, *arrays, **kw)
    torch.cuda.synchronize()
    err, rel = rel_err(y, ref)
    K, N = lin.shape_in_out
    if not quiet:
        log(f"  {name:10s} {tag:5s} K={K:5d} N={N:6d} B={x.shape[0]:2d}  max_abs_err={err:.3e} "
            f"rel={rel:.2e}")
    if not (torch.isfinite(y).all() and rel <= tol):
        raise AssertionError(f"{name} {tag} {K}x{N} B={x.shape[0]}: rel err {rel} > {tol}")
    res[name]["cases"].append({"fmt": tag, "K": K, "N": N, "B": x.shape[0],
                               "max_abs_err": err, "rel": rel})
    return y


def _time_matmul(timer, kern, plain, x, lin, y, w_bf16, peak) -> dict:
    arrays, kw = lin_args(lin)
    K, N = lin.shape_in_out
    wbytes = nbytes(lin.q, lin.s, lin.b, lin.d, lin.dm, lin.bias)
    b_ms, b_by = bound(wbytes + nbytes(x, y), 2.0 * x.shape[0] * K * N, peak)
    r = {"K": K, "N": N, "B": x.shape[0],
         "ms": timer(lambda: kern(x, *arrays, **kw)),
         "plain_ms": timer(lambda: plain(x, *arrays, **kw), iters=5),
         "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
         "bound_ms": b_ms, "bound_by": b_by}
    log(f"    timing {r}")
    return r


# Everything K1, K2 and K5 take, at row counts either side of every tile
# edge of K2 and K5 (8-row mma tiles, instantiations for 8/16/32/64 rows)
# and at N that are not multiples of their column tiles (400: 128 columns;
# 4112: K2's 256 columns above 16 rows); K 544 ends their last 128-deep tile
# part way (classic layouts only: a superblock needs K % 256 == 0).
COVER_FMTS = ("q4_k", "q5_k", "q6_k", "q2_k", "q8_0", "q4_0", "q4_1", "q8_f32b", "q8+b")
COVER_ROWS = (1, 2, 7, 8, 9, 16, 17, 31, 32, 33, 37, 63, 64)
COVER_SHAPES = ((512, 400), (544, 128), (512, 4112))


def coverage_cases(dev, gen, res) -> int:
    """K1 (one row, 1e-4 of the output scale), K2 and K5 (every row count,
    2e-2) against their plain versions on every layout, bf16 and f32 x;
    each kernel launched twice on the same inputs must give the same bits,
    and K2 and K5 must equal their plain versions bit for bit on one-hot
    rows.  Returns the number of kernel calls checked."""
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv, qgemv_plain
    from chatllm_tpu_torch.ops.cuda.qmm_decode import qmm_decode, qmm_decode_plain
    from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm, qmm_plain

    matmuls = [("qmm", qmm, qmm_plain), ("qmm_decode", qmm_decode, qmm_decode_plain)]

    n = 0
    for fmt in COVER_FMTS:
        for K, N in COVER_SHAPES:
            if fmt in ("q4_k", "q5_k", "q6_k", "q2_k") and K % 256:
                continue
            lin = quant_weight("q8_0" if fmt == "q8+b" else fmt, K, N, gen, dev)
            if fmt == "q8+b":
                lin = replace(lin, bias=torch.randn(N, generator=gen, device=dev))
            for xdt in (torch.bfloat16, torch.float32):
                tag = f"{fmt}/{'bf16' if xdt == torch.bfloat16 else 'f32'}"
                for rows in COVER_ROWS:
                    x = torch.randn(rows, K, generator=gen, device=dev).to(xdt)
                    pairs = [(name, kern, plain, 2e-2) for name, kern, plain in matmuls]
                    if rows == 1:
                        pairs.append(("qgemv", qgemv, qgemv_plain, 1e-4))
                    for name, kern, plain, tol in pairs:
                        y = _check_matmul(res, name, kern, plain, x, lin, tol, tag, quiet=True)
                        arrays, kw = lin_args(lin)
                        again = kern(x, *arrays, **kw)
                        if not torch.equal(y, again):
                            raise AssertionError(f"{name} {tag} {K}x{N} B={rows}: two launches "
                                                 "differ")
                        n += 2
                # one-hot rows: each output is one dequantized weight plus its
                # affine term, so K2 and K5 must equal their plain versions bit
                # for bit (K2's bf16 unpack, subtract and multiply round
                # q * bf16(s_eff) once, as the Pallas kernel's f32 product
                # rounded to bf16; K5 rounds that, and then its sum with
                # bf16(bb), once each, as its Pallas kernel does in bf16)
                for rows in ONE_HOT_ROWS:
                    x = one_hot_rows(rows, K, dev).to(xdt)
                    arrays, kw = lin_args(lin)
                    for name, kern, plain in matmuls:
                        y, ref = kern(x, *arrays, **kw), plain(x, *arrays, **kw)
                        if not torch.equal(y, ref):
                            raise AssertionError(
                                f"{name} {tag} {K}x{N} one-hot B={rows}: the dequantized weights "
                                f"differ from the plain version's by {(y - ref).abs().max().item()}")
                        n += 1
    log(f"  coverage: {n} K1/K2/K5 launches on {len(COVER_FMTS)} layouts x bf16/f32 x rows "
        f"{COVER_ROWS} x (K, N) {COVER_SHAPES}: all within tolerance, every pair bit-identical, "
        f"K2 and K5 bit-equal to their plain versions on one-hot rows {ONE_HOT_ROWS}")
    return n


ONE_HOT_ROWS = (1, 8, 17, 64)


def one_hot_rows(rows: int, K: int, dev) -> torch.Tensor:
    """f32 [rows, K]: row r is 1 at column r * (K // rows) + r % 7, else 0,
    so each output is one weight (the columns meet different groups, and
    both nibbles of a byte row)."""
    x = torch.zeros(rows, K, device=dev)
    r = torch.arange(rows, device=dev)
    x[r, r * (K // rows) + r % 7] = 1.0
    return x


def quantize_kv_case(dev, gen) -> dict:
    """`ops/attention.py::quantize_kv` on the card against the CPU on the same
    K/V rows (one 1000-token prompt of Llama-3-8B's 8 kv heads, f32 and
    bf16): int8 values and f32 scales must be bit-equal.  Also counts the
    scales that a division by the Python scalar 127.0 (a multiplication by
    its reciprocal on the card) would have moved."""
    from chatllm_tpu_torch.ops.attention import quantize_kv

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn(1, 1000, 8, 128, generator=gen, device=dev) * 3).to(dt)
        q, sc = quantize_kv(x)
        qc, scc = quantize_kv(x.cpu())
        torch.cuda.synchronize()
        scalar = (x.float().abs().amax(dim=-1) / 127.0).cpu()
        moved = int((scalar != scc).sum())
        name = str(dt).split(".")[-1]
        log(f"  quantize_kv {name}: card == CPU values {torch.equal(q.cpu(), qc)}, scales "
            f"{torch.equal(sc.cpu(), scc)}; a division by the scalar 127.0 would move {moved} of "
            f"{scc.numel()} scales")
        if not (torch.equal(q.cpu(), qc) and torch.equal(sc.cpu(), scc)):
            raise AssertionError(f"quantize_kv {name}: the card differs from the CPU")
        out[name] = {"scales": scc.numel(), "moved_by_scalar_division": moved}
    return out


K5_ROWS = 8          # K5 is timed at the rows of the bench's batched section
SHAPES_QWEN = {"q_o": (896, 896), "k_v": (896, 128), "gate_up": (896, 4864),
               "down": (4864, 896)}
QWEN_LAYERS = 24
# InternVL3.5-8B's LLM (Qwen3-8B): FFN 12288, lm_head N 151936
SHAPES_IVL = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 12288),
              "down": (12288, 4096), "lm_head": (4096, 151936)}
# Qwen3-30B-A3B's quantized projections (K, N) per layer and decode token:
# q, k and v, o, the router (stored quantized), and the lm_head once
SHAPES_A3B = {"q": (2048, 4096), "k_v": (2048, 512), "o": (4096, 2048),
              "router": (2048, 128), "lm_head": (2048, 151936)}
PER_LAYER_A3B = {"q": 1, "k_v": 2, "o": 1, "router": 1}
A3B_LAYERS = 48
A3B_ROWS = 2                       # K2's rows in the A3B server's batched steps (2 slots)
MISTRAL_LM_HEAD = (4096, 32000)    # Mistral-7B's lm_head (K, N); its other projections are
#                                    Llama-3-8B's
# Gemma-3-12B's quantized projections (K, N); its head is the tied bf16
# embedding (dot_f32, not K1)
SHAPES_G3 = {"q": (3840, 4096), "k_v": (3840, 2048), "o": (4096, 3840),
             "gate_up": (3840, 15360), "down": (15360, 3840)}
PER_LAYER_G3 = {"q": 1, "k_v": 2, "o": 1, "gate_up": 2, "down": 1}
G3_LAYERS = 48
# GLM-4-9B's projections (K, N, format): the fused q|k|v (32 + 2 x 2 heads of
# 128) and gate|up, o, the down projection at K 13696 (not a multiple of 256:
# the converter stores it q8_0), the untied 151552-row head
SHAPES_GLM = {"qkv": (4096, 4608, "q4_k"), "o": (4096, 4096, "q4_k"),
              "gate_up": (4096, 27392, "q4_k"), "down": (13696, 4096, "q8_0"),
              "lm_head": (4096, 151552, "q4_k")}
PER_LAYER_GLM = {"qkv": 1, "o": 1, "gate_up": 1, "down": 1}
GLM_LAYERS = 40
GLM_ROWS = 2                       # K2's rows in the GLM-4-9B server's batched steps (2 slots)
# GPT-OSS-20B's projections on K1 / K2 (K, N, format): q (64 heads of 64), k and
# v (8 kv heads), the untied 201088-row head, all at K 2880 (not a multiple
# of 256: the converter stores them q8_0); o (N 2880) and the router (N 32)
# fail N % 128 and take the dequantize-then-matmul route, as in the JAX package
SHAPES_GO = {"q": (2880, 4096, "q8_0"), "k_v": (2880, 512, "q8_0"),
             "lm_head": (2880, 201088, "q8_0")}
PER_LAYER_GO = {"q": 1, "k_v": 2}
GO_LAYERS = 24
GO_FULL_LAYERS = 12                # the full-attention layers (the odd ones): K4's
GO_ROWS = 2                        # K2's rows in the GPT-OSS-20B server's batched steps


def kernels_phase(dev, timer, fused: bool = False) -> dict:
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv, qgemv_plain
    from chatllm_tpu_torch.ops.cuda.qmm_decode import qmm_decode, qmm_decode_plain
    from chatllm_tpu_torch.ops.cuda.qmm_kernel import qmm, qmm_plain
    from chatllm_tpu_torch.ops.qmm import dequant_weight

    gen = torch.Generator(device=dev).manual_seed(1)
    res = {k: {"cases": [], "shapes": {}, "qwen_shapes": {}}
           for k in ("qgemv", "qmm", "qmm_decode")}
    # K2 at 8 rows and K5 at 64 rows too, so that the two compare at both
    res["qmm"].update(shapes_b8={}, qwen_shapes_b8={})
    res["qmm_decode"].update(shapes_b64={}, qwen_shapes_b64={})

    def run(lin, fmt, sname, timed, shapes_key):
        K, N = lin.shape_in_out
        w_bf16 = dequant_weight(lin, torch.bfloat16) if timed else None
        x = torch.randn(1, K, generator=gen, device=dev).to(torch.bfloat16)
        y = _check_matmul(res, "qgemv", qgemv, qgemv_plain, x, lin, 1e-4, fmt)
        if timed:
            res["qgemv"][shapes_key][sname] = _time_matmul(
                timer, qgemv, qgemv_plain, x, lin, y, w_bf16, F32_FLOPS)
        for B in (2, 8, 32, 37, 64):
            xb = torch.randn(B, K, generator=gen, device=dev).to(torch.bfloat16)
            yb = _check_matmul(res, "qmm", qmm, qmm_plain, xb, lin, 2e-2, fmt)
            if timed and B == 64 and sname != "lm_head":
                res["qmm"][shapes_key][sname] = _time_matmul(
                    timer, qmm, qmm_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)
            if timed and B == K5_ROWS:
                res["qmm"][shapes_key + "_b8"][sname] = _time_matmul(
                    timer, qmm, qmm_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)
            yb = _check_matmul(res, "qmm_decode", qmm_decode, qmm_decode_plain, xb, lin,
                               2e-2, fmt)
            if timed and B == K5_ROWS:
                res["qmm_decode"][shapes_key][sname] = _time_matmul(
                    timer, qmm_decode, qmm_decode_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)
            if timed and B == 64 and sname != "lm_head":
                res["qmm_decode"][shapes_key + "_b64"][sname] = _time_matmul(
                    timer, qmm_decode, qmm_decode_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)

    for fmt in ("q4_k", "q8_0", "q4_0", "q4_1"):
        for sname, (K, N) in SHAPES_8B.items():
            run(quant_weight(fmt, K, N, gen, dev), fmt, sname, fmt == "q4_k", "shapes")
    # Llama-3-8B through fuse_decode_streams (with the fused_decode phase):
    # K1 timed at the fused q|k|v and gate|up (its o and down are the
    # unfused ones), on a generator of their own
    res["qgemv"]["fused_shapes"] = {}
    fgen = torch.Generator(device=dev).manual_seed(2)
    for sname, (K, N) in SHAPES_8B_FUSED.items() if fused else ():
        lin = quant_weight("q4_k", K, N, fgen, dev)
        x = torch.randn(1, K, generator=fgen, device=dev).to(torch.bfloat16)
        y = _check_matmul(res, "qgemv", qgemv, qgemv_plain, x, lin, 1e-4, "q4_k")
        res["qgemv"]["fused_shapes"][sname] = _time_matmul(
            timer, qgemv, qgemv_plain, x, lin, y, dequant_weight(lin, torch.bfloat16), F32_FLOPS)
        del lin
    # Qwen2.5-0.5B: q8_0 (unpacked int8) with a bias, K = 896 and 4864
    for sname, (K, N) in SHAPES_QWEN.items():
        lin = replace(quant_weight("q8_0", K, N, gen, dev),
                      bias=torch.randn(N, generator=gen, device=dev))
        run(lin, "q8+b", sname, True, "qwen_shapes")
    # InternVL3.5-8B's Qwen3-8B: K1 timed at its q4_k projections
    res["qgemv"]["ivl_shapes"] = {}
    for sname, (K, N) in SHAPES_IVL.items():
        lin = quant_weight("q4_k", K, N, gen, dev)
        x = torch.randn(1, K, generator=gen, device=dev).to(torch.bfloat16)
        y = _check_matmul(res, "qgemv", qgemv, qgemv_plain, x, lin, 1e-4, "q4_k")
        res["qgemv"]["ivl_shapes"][sname] = _time_matmul(
            timer, qgemv, qgemv_plain, x, lin, y, dequant_weight(lin, torch.bfloat16), F32_FLOPS)
        del lin
    # Qwen3-30B-A3B (K 2048, a 128-column router): K1 and K2 at 2 and 8 rows
    # checked, K1 and K2 at the server's 2 rows timed
    res["qgemv"]["a3b_shapes"], res["qmm"]["a3b_shapes"] = {}, {}
    for sname, (K, N) in SHAPES_A3B.items():
        lin = quant_weight("q4_k", K, N, gen, dev)
        w_bf16 = dequant_weight(lin, torch.bfloat16)
        x = torch.randn(1, K, generator=gen, device=dev).to(torch.bfloat16)
        y = _check_matmul(res, "qgemv", qgemv, qgemv_plain, x, lin, 1e-4, "q4_k")
        res["qgemv"]["a3b_shapes"][sname] = _time_matmul(
            timer, qgemv, qgemv_plain, x, lin, y, w_bf16, F32_FLOPS)
        for B in (A3B_ROWS, 8):
            xb = torch.randn(B, K, generator=gen, device=dev).to(torch.bfloat16)
            yb = _check_matmul(res, "qmm", qmm, qmm_plain, xb, lin, 2e-2, "q4_k")
            if B == A3B_ROWS:
                res["qmm"]["a3b_shapes"][sname] = _time_matmul(
                    timer, qmm, qmm_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)
        del lin, w_bf16
    # Mistral-7B: Llama-3-8B's projections but a 32000-column lm_head (a
    # multiple of 128, not of 256 or 512): K1 timed, K2 checked at 2-64 rows
    # and timed at the ring server's 2
    res["qgemv"]["mistral_shapes"], res["qmm"]["mistral_shapes"] = {}, {}
    lin = quant_weight("q4_k", *MISTRAL_LM_HEAD, gen, dev)
    w_bf16 = dequant_weight(lin, torch.bfloat16)
    x = torch.randn(1, MISTRAL_LM_HEAD[0], generator=gen, device=dev).to(torch.bfloat16)
    y = _check_matmul(res, "qgemv", qgemv, qgemv_plain, x, lin, 1e-4, "q4_k")
    res["qgemv"]["mistral_shapes"]["lm_head"] = _time_matmul(
        timer, qgemv, qgemv_plain, x, lin, y, w_bf16, F32_FLOPS)
    for B in (2, 8, 37, 64):
        xb = torch.randn(B, MISTRAL_LM_HEAD[0], generator=gen, device=dev).to(torch.bfloat16)
        yb = _check_matmul(res, "qmm", qmm, qmm_plain, xb, lin, 2e-2, "q4_k")
        if B == 2:
            res["qmm"]["mistral_shapes"]["lm_head"] = _time_matmul(
                timer, qmm, qmm_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)
    del lin, w_bf16
    # Gemma-3-12B (K 3840 and 15360): K1 timed at its q4_k projections, K2
    # checked at 2 and 64 rows and timed at the 2-slot server's 2
    res["qgemv"]["g3_shapes"], res["qmm"]["g3_shapes"] = {}, {}
    for sname, (K, N) in SHAPES_G3.items():
        lin = quant_weight("q4_k", K, N, gen, dev)
        w_bf16 = dequant_weight(lin, torch.bfloat16)
        x = torch.randn(1, K, generator=gen, device=dev).to(torch.bfloat16)
        y = _check_matmul(res, "qgemv", qgemv, qgemv_plain, x, lin, 1e-4, "q4_k")
        res["qgemv"]["g3_shapes"][sname] = _time_matmul(
            timer, qgemv, qgemv_plain, x, lin, y, w_bf16, F32_FLOPS)
        for B in (2, 64):
            xb = torch.randn(B, K, generator=gen, device=dev).to(torch.bfloat16)
            yb = _check_matmul(res, "qmm", qmm, qmm_plain, xb, lin, 2e-2, "q4_k")
            if B == 2:
                res["qmm"]["g3_shapes"][sname] = _time_matmul(
                    timer, qmm, qmm_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)
        del lin, w_bf16
    # GLM-4-9B: K1 timed at its fused q4_k projections, its q8_0 down (K
    # 13696: 428 groups) and its head; K2 checked at 2-64 rows and timed at
    # the 2-slot server's 2
    res["qgemv"]["glm_shapes"], res["qmm"]["glm_shapes"] = {}, {}
    for sname, (K, N, fmt) in SHAPES_GLM.items():
        lin = quant_weight(fmt, K, N, gen, dev)
        w_bf16 = dequant_weight(lin, torch.bfloat16)
        x = torch.randn(1, K, generator=gen, device=dev).to(torch.bfloat16)
        y = _check_matmul(res, "qgemv", qgemv, qgemv_plain, x, lin, 1e-4, fmt)
        res["qgemv"]["glm_shapes"][sname] = _time_matmul(
            timer, qgemv, qgemv_plain, x, lin, y, w_bf16, F32_FLOPS)
        for B in (GLM_ROWS, 8, 37, 64):
            xb = torch.randn(B, K, generator=gen, device=dev).to(torch.bfloat16)
            yb = _check_matmul(res, "qmm", qmm, qmm_plain, xb, lin, 2e-2, fmt)
            if B == GLM_ROWS:
                res["qmm"]["glm_shapes"][sname] = _time_matmul(
                    timer, qmm, qmm_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)
        del lin, w_bf16
    # GPT-OSS-20B: K1 timed at its q8_0 projections and head (K 2880: 90
    # groups), K2 checked at 2-64 rows and timed at the 2-slot server's 2
    res["qgemv"]["go_shapes"], res["qmm"]["go_shapes"] = {}, {}
    for sname, (K, N, fmt) in SHAPES_GO.items():
        lin = quant_weight(fmt, K, N, gen, dev)
        w_bf16 = dequant_weight(lin, torch.bfloat16)
        x = torch.randn(1, K, generator=gen, device=dev).to(torch.bfloat16)
        y = _check_matmul(res, "qgemv", qgemv, qgemv_plain, x, lin, 1e-4, fmt)
        res["qgemv"]["go_shapes"][sname] = _time_matmul(
            timer, qgemv, qgemv_plain, x, lin, y, w_bf16, F32_FLOPS)
        for B in (GO_ROWS, 8, 37, 64):
            xb = torch.randn(B, K, generator=gen, device=dev).to(torch.bfloat16)
            yb = _check_matmul(res, "qmm", qmm, qmm_plain, xb, lin, 2e-2, fmt)
            if B == GO_ROWS:
                res["qmm"]["go_shapes"][sname] = _time_matmul(
                    timer, qmm, qmm_plain, xb, lin, yb, w_bf16, BF16_TC_FLOPS)
        del lin, w_bf16
    coverage_cases(dev, gen, res)
    res["quantize_kv"] = quantize_kv_case(dev, gen)
    res["flash_attention"] = flash_cases(dev, timer, gen)
    res["flash_decode"] = decode_cases(dev, timer, gen)
    res["flash_decode_mla"] = mla_decode_cases(dev, timer, gen)
    res["bw_probe"] = probe_case(dev, timer, gen)
    res.update(gemv_probe_cases(dev, timer, gen))
    res.update(gemv_model_cases(dev, timer, gen))
    res["unpack_gemv"] = unpack_cases(dev, timer, gen)
    res["qmm_dma"] = dma_case(dev, timer, gen)
    res["flash_decode_int8"] = decode_int8_cases(dev, timer, gen)
    res["flash_decode_e7"] = e7_cases(dev, timer, gen)
    res.update(e6_cases(dev, timer, gen))
    return res


def probe_case(dev, timer, gen) -> dict:
    """K6's sum on a seeded random 256 MB buffer against its plain version
    (exact), and the time of one pass."""
    from chatllm_tpu_torch.ops.cuda.bw_probe import read_sum, read_sum_plain

    q = torch.randint(0, 256, (256 << 20,), generator=gen, device=dev, dtype=torch.uint8)
    c = torch.tensor([1.5], device=dev)
    got, want = read_sum(q, c), read_sum_plain(q, c)
    torch.cuda.synchronize()
    err = (got - want).abs().item()
    log(f"  bw_probe 256 MiB: sum {got.item():.9g}, plain {want.item():.9g}, "
        f"max_abs_err={err:.1e}")
    if not torch.equal(got, want):
        raise AssertionError(f"bw_probe: {got.item()} != {want.item()}")
    b_ms, b_by = bound(nbytes(q, c, got), float(q.numel()), F32_FLOPS)
    r = {"bytes": q.numel(),
         "ms": timer(lambda: read_sum(q, c)),
         "plain_ms": timer(lambda: read_sum_plain(q, c), iters=5),
         "library_ms": timer(lambda: torch.sum(q, dtype=torch.int64)),
         "bound_ms": b_ms, "bound_by": b_by}
    r["gb_s"] = q.numel() / r["ms"] / 1e6
    log(f"    timing {r}")
    return {"cases": [{"bytes": q.numel(), "max_abs_err": err}], "shapes": {"pass_256mb": r}}


def gemv_probe_cases(dev, timer, gen) -> dict:
    """E2's two kernels against their plain versions at E2's 4096 x 16384
    and at E1's 4096 x 14336 (E1's `stream_max` and `vpu_gemv` run on them):
    stream_once exact, vpu_once 1e-5 of the output scale (f32 sums in
    another order)."""
    from chatllm_tpu_torch.experiments import gemv_probe as e1
    from chatllm_tpu_torch.experiments import gemv_probe2 as e2

    out = {name: {"cases": [], "shapes": {}} for name in ("gemv_stream", "gemv_vpu")}
    for K, N in ((e2.K, e2.N), (e1.K, e1.N)):
        key = f"{K}x{N}"
        wq, ws = e2.weights(K, N, dev)
        x = torch.randn(K, 1, generator=gen, device=dev)
        w_bf16 = (wq.float().reshape(K // e2.GROUP, e2.GROUP, N) * ws[:, None, :]).reshape(
            K, N).to(torch.bfloat16)
        xb = x.reshape(1, K).to(torch.bfloat16)
        m, mref = e2.stream_once(wq), e2.stream_once_plain(wq)
        y, yref = e2.vpu_once(x, wq, ws), e2.vpu_once_plain(x, wq, ws)
        torch.cuda.synchronize()
        s_err = (m - mref).abs().max().item()
        v_err, v_rel = rel_err(y, yref)
        log(f"  gemv_stream K={K} N={N}  max_abs_err={s_err}")
        log(f"  gemv_vpu    K={K} N={N}  max_abs_err={v_err:.3e} rel={v_rel:.2e}")
        if not torch.equal(m, mref):
            raise AssertionError(f"gemv_stream differs from its plain version by {s_err}")
        if not (torch.isfinite(y).all() and v_rel <= 1e-5):
            raise AssertionError(f"gemv_vpu: rel err {v_rel} > 1e-5")
        b_ms, b_by = bound(nbytes(wq, m), float(K * N), F32_FLOPS)
        r = {"K": K, "N": N,
             "ms": timer(lambda: e2.stream_once(wq)),
             "plain_ms": timer(lambda: e2.stream_once_plain(wq), iters=5),
             "library_ms": timer(lambda: torch.amax(wq.view(K // 8, 8, N), dim=0)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing stream {r}")
        out["gemv_stream"]["cases"].append({"K": K, "N": N, "max_abs_err": float(s_err)})
        out["gemv_stream"]["shapes"][key] = r
        b_ms, b_by = bound(nbytes(wq, ws, x, y), 2.0 * K * N, F32_FLOPS)
        r = {"K": K, "N": N,
             "ms": timer(lambda: e2.vpu_once(x, wq, ws)),
             "plain_ms": timer(lambda: e2.vpu_once_plain(x, wq, ws), iters=5),
             # a yardstick over other inputs: the weight dequantized to bf16 beforehand
             "library_ms": timer(lambda: torch.matmul(xb, w_bf16)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing vpu {r}")
        out["gemv_vpu"]["cases"].append({"K": K, "N": N, "max_abs_err": v_err, "rel": v_rel})
        out["gemv_vpu"]["shapes"][key] = r
        del wq, ws, w_bf16
    return out


def gemv_model_cases(dev, timer, gen) -> dict:
    """E3's two kernels at the five Llama-3-8B projection shapes (q4 packed,
    f16 scales, tile_k 2048), both exact: stream_read's value and digest,
    and qgemv_bf16, which rounds to bf16 in its plain version's order (an
    H100 gives equal bits at every shape)."""
    from chatllm_tpu_torch.experiments import gemv_model_bench as e3
    from chatllm_tpu_torch.ops.qmm import dequant_arrays

    out = {name: {"cases": [], "shapes": {}} for name in ("stream_read", "qgemv_bf16")}
    for sname, (K, N) in SHAPES_8B.items():
        q = torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
        s = (torch.rand(K // 32, N, generator=gen, device=dev) * 0.01 + 1e-3).half()
        x = torch.randn(1, K, generator=gen, device=dev)
        (y, dg), (yr, dgr) = e3.stream_read(x, q, s), e3.stream_read_plain(x, q, s)
        b, br = e3.qgemv_bf16(x, q, s), e3.qgemv_bf16_plain(x, q, s)
        torch.cuda.synchronize()
        s_err = (y - yr).abs().max().item()
        b_err, b_rel = rel_err(b, br)
        log(f"  stream_read K={K:5d} N={N:6d}  max_abs_err={s_err} digest_equal="
            f"{torch.equal(dg, dgr)}")
        log(f"  qgemv_bf16  K={K:5d} N={N:6d}  max_abs_err={b_err:.3e} rel={b_rel:.2e}")
        if not (torch.equal(y, yr) and torch.equal(dg, dgr)):
            raise AssertionError(f"stream_read {K}x{N} differs from its plain version")
        if not (torch.isfinite(b).all() and torch.equal(b, br)):
            raise AssertionError(f"qgemv_bf16 {K}x{N} differs from its plain version: rel "
                                 f"err {b_rel}")
        out["stream_read"]["cases"].append({"K": K, "N": N, "max_abs_err": s_err})
        out["qgemv_bf16"]["cases"].append({"K": K, "N": N, "max_abs_err": b_err, "rel": b_rel})
        b_ms, b_by = bound(nbytes(q, s, x, y, dg), K * N / 8.0, F32_FLOPS)
        r = {"K": K, "N": N,
             "ms": timer(lambda: e3.stream_read(x, q, s)),
             "plain_ms": timer(lambda: e3.stream_read_plain(x, q, s), iters=5),
             "library_ms": timer(lambda: torch.sum(q, dtype=torch.int64)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing stream_read {r}")
        out["stream_read"]["shapes"][sname] = r
        w_bf16 = dequant_arrays(q, s, None, group=32, packed=True, zero_point=0,
                                dtype=torch.bfloat16)
        xb = x.to(torch.bfloat16)
        b_ms, b_by = bound(nbytes(q, s, x, b), 2.0 * K * N, F32_FLOPS)
        r = {"K": K, "N": N,
             "ms": timer(lambda: e3.qgemv_bf16(x, q, s)),
             "plain_ms": timer(lambda: e3.qgemv_bf16_plain(x, q, s), iters=5),
             # a yardstick over other inputs: the weight dequantized to bf16 beforehand
             "library_ms": timer(lambda: torch.matmul(xb, w_bf16)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing qgemv_bf16 {r}")
        out["qgemv_bf16"]["shapes"][sname] = r
        del q, s, w_bf16
    return out


def unpack_cases(dev, timer, gen) -> dict:
    """E4's kernel in its four modes at 4096 x 14336 on a random q4_k
    weight: 1e-5 of the output scale against its plain version, 1e-4 against
    K1 (the sum of its 8 rows), and each mode's own check (2048 x 256)."""
    from chatllm_tpu_torch.experiments import gemv_unpack as e4
    from chatllm_tpu_torch.models.synthetic import synth_linear
    from chatllm_tpu_torch.ops.cuda.gemv_kernel import qgemv
    from chatllm_tpu_torch.ops.qmm import dequant_weight

    K, N = e4.K, e4.N
    lin = synth_linear(K, N, "q4k", gen=gen, zeros=False, device=dev)
    arrays = (lin.q, lin.s, lin.b, lin.d, lin.dm)
    x = torch.randn(K, generator=gen, device=dev)
    k1 = qgemv(x[None], lin.q, lin.s, lin.b, None, group=32, packed=True, zero_point=0,
               d=lin.d, dm=lin.dm, sb=8)
    w_bf16 = dequant_weight(lin, torch.bfloat16)
    xb = x[None].to(torch.bfloat16)
    res = {"cases": [], "shapes": {}}
    for mode in e4.MODES:
        out, ref = e4.unpack_gemv(x, *arrays, mode=mode), e4.unpack_gemv_plain(x, *arrays,
                                                                               mode=mode)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        _, rel_k1 = rel_err(out.sum(dim=0, keepdim=True), k1)
        chk = e4.check(mode, device=dev)
        log(f"  unpack_gemv {mode} K={K} N={N}  max_abs_err={err:.3e} rel={rel:.2e} "
            f"vs K1 rel={rel_k1:.2e}; check {chk:.2e}")
        if not (torch.isfinite(out).all() and rel <= 1e-5 and rel_k1 <= 1e-4
                and chk < e4.CHECK_TOL):
            raise AssertionError(f"unpack_gemv {mode}: rel {rel} (limit 1e-5), against K1 "
                                 f"{rel_k1} (limit 1e-4), check {chk} (limit 1e-4)")
        res["cases"].append({"mode": mode, "K": K, "N": N, "max_abs_err": err, "rel": rel,
                             "rel_vs_k1": rel_k1, "check": chk})
        b_ms, b_by = bound(nbytes(*arrays, x, out), 8.0 * K * N, F32_FLOPS)
        r = {"K": K, "N": N,
             "ms": timer(lambda: e4.unpack_gemv(x, *arrays, mode=mode)),
             "plain_ms": timer(lambda: e4.unpack_gemv_plain(x, *arrays, mode=mode), iters=5),
             # a yardstick over other inputs: the weight dequantized to bf16 beforehand
             "library_ms": timer(lambda: torch.matmul(xb, w_bf16)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing {mode} {r}")
        res["shapes"][mode] = r
    return res


def dma_case(dev, timer, gen) -> dict:
    """E5's copy-only pass over a random uint8 [2048, 14336] (K2's q4
    weight at 4096 x 14336) in 1024 x 512 tiles, exact against its plain
    version."""
    from chatllm_tpu_torch.experiments import qmm_m32 as e5

    q = torch.randint(0, 256, (e5.K // 2, e5.N), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint8)
    c = torch.tensor([0.25], device=dev)
    got, want = e5.dma_sums(q, c), e5.dma_sums_plain(q, c)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"  qmm_dma K={e5.K} N={e5.N} tiles {e5.DMA_TILE_K}x{e5.DMA_TILE_N}: "
        f"max_abs_err={err}, last tile {got[-1, -1].item():.9g}")
    if not torch.equal(got, want):
        raise AssertionError(f"qmm_dma differs from its plain version by {err}")
    b_ms, b_by = bound(nbytes(q, c, got), float(q.numel()), F32_FLOPS)
    r = {"bytes": q.numel(),
         "ms": timer(lambda: e5.dma_sums(q, c)),
         "plain_ms": timer(lambda: e5.dma_sums_plain(q, c), iters=5),
         "library_ms": timer(lambda: torch.sum(q, dtype=torch.int64)),
         "bound_ms": b_ms, "bound_by": b_by}
    log(f"    timing {r}")
    return {"cases": [{"bytes": q.numel(), "max_abs_err": err}], "shapes": {"4096x14336": r}}


# K3's limit on |o - plain| / (|plain| + 4 sqrt(sum_j p_j^2 v_j^2)) per
# element, p the attention probabilities.  bf16: the kernel rounds its
# output (at most 2^-8 of |o|) and each probability (2^-8) to bf16; the
# probability roundings add errors of random sign, whose sum has a standard
# deviation of 2^-8 / sqrt(3) * sqrt(sum_j p_j^2 v_j^2), so 4 * 2^-8 * that
# root is ~7 deviations (and the worst case up to 16 visible keys).  Both
# terms can sit near their bounds in one element, so the limit is twice
# 2^-8.  f32: summation order only.
FLASH_SCALED_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}
FLASH_ATOL = 2e-2


def attention_probs(q, k, n_past: int, n_tokens: int, *, scale: float, causal: bool = True,
                    sliding_window: int = 0, logit_softcap: float = 0.0) -> torch.Tensor:
    """The K3 mask contract's probabilities in f32, [B, Hkv, G, T, S]."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    s = torch.einsum("bthgd,bshd->bhgts", q.float().reshape(B, T, Hkv, Hq // Hkv, D),
                     k.float()) * scale
    if logit_softcap > 0.0:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    q_pos = n_past + torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    valid = k_pos < n_past + n_tokens
    if causal:
        valid = valid & (k_pos <= q_pos)
    if sliding_window > 0:
        valid = valid & (k_pos > q_pos - sliding_window)
    return torch.softmax(s.masked_fill(~valid, -1e30), dim=-1)


def flash_errors(o, q, k, v, n_past: int, n_tokens: int, **kw) -> tuple[float, float]:
    """(max abs error, max scaled error as in FLASH_SCALED_TOL) of a K3
    output against its plain version on the same inputs."""
    from chatllm_tpu_torch.ops.cuda.flash import flash_attention_plain

    B, T, Hq, D = q.shape
    ref = flash_attention_plain(q, k, v, n_past, n_tokens, **kw).float()
    p2 = attention_probs(q, k, n_past, n_tokens, **kw).square_()
    rms = torch.einsum("bhgts,bshd->bthgd", p2, v.float().square()).sqrt_()
    del p2
    diff = (o.float() - ref).abs()
    denom = ref.abs() + 4.0 * rms.reshape(B, T, Hq, D) + 1e-6
    return diff.max().item(), (diff / denom).max().item()


# K4's limits, per element as for K3: the kernel rounds each probability
# to bf16 against its 64-key tile's running max, the plain version against
# the row's max, so with bf16 dots the two round p * v_scale differently
# (each at most 2^-9 relative) and the output once each (q's dtype).  f32
# dots over an f32 query round nothing: summation order only.
DECODE_SCALED_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}
DECODE_ATOL = 2e-2


def flash_decode_errors(o, q, k, v, n_past, n_tokens: int, *, sinks=None, v_scale=None,
                        **kw) -> tuple[float, float]:
    """(max abs error, max scaled error as in DECODE_SCALED_TOL) of a K4
    output against its plain version on the same inputs."""
    from chatllm_tpu_torch.ops.cuda.flash_decode import decode_scores, flash_decode_plain

    B, T, Hq, _ = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    ref = flash_decode_plain(q, k, v, n_past, n_tokens, sinks=sinks, v_scale=v_scale,
                             **kw).float()
    s = decode_scores(q, k, n_past, n_tokens, scale=kw["scale"],
                      sliding_window=kw.get("sliding_window", 0),
                      logit_softcap=kw.get("logit_softcap", 0.0),
                      k_scale=kw.get("k_scale"), qk_dtype=kw.get("qk_dtype"))
    m = s.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(Hkv, Hq // Hkv)[None, :, :, None, None]
        m = torch.maximum(m, sk)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        den = den + torch.exp(sk - m)
    p2 = (p / den).square_()
    del s, p
    vf = v.float() if v_scale is None else v.float() * v_scale[..., None]
    rms = torch.einsum("bhgts,bshd->bthgd", p2, vf.square()).sqrt_()
    del p2, vf
    diff = (o.float() - ref).abs()
    denom = ref.abs() + 4.0 * rms.reshape(B, T, Hq, Dv) + 1e-6
    return diff.max().item(), (diff / denom).max().item()


# The first decode step's logits with K4's int8 dots against the bf16-dot
# run's: 0.03 of the logit scale, the JAX package's own bound on the
# int8-dot attention output (0.03 of its row max,
# tests/test_flash_decode.py::test_flash_decode_batched_int8_dots) carried
# to the logits row, and the same argmax (PERF.md section 6).
INT8_LOGIT_TOL = 0.03

# K4's int8 dots against their plain version: both quantize q and p * v_scale
# to int8 and sum integer products exactly, so they differ only where float
# rounding (exp, the division by psc) moves a quantized q or p by one step.
# One step of pq in key j's block moves an output by psc * |v8_j| / l <=
# max_i(P_i * v_scale_i) * max_j |v8_j| / 127, P the row's probabilities
# (`int8_step`).  The limit is DECODE_INT8_STEPS such steps per element,
# beside the output's rounding to q's dtype: both round to bf16, and a
# rounding on either side of a boundary differs by one bf16 ulp, at most
# 2^-7 of the larger value.
DECODE_INT8_STEPS = 2.0


def int8_step(q, k, v, n_past, n_tokens: int, *, k_scale, v_scale, sinks=None,
              **kw) -> torch.Tensor:
    """One quantization step of pq as an output difference, per row: [B, T, Hq, 1]."""
    from chatllm_tpu_torch.ops.cuda.flash_decode import decode_scores

    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    s = decode_scores(q, k, n_past, n_tokens, scale=kw["scale"],
                      sliding_window=kw.get("sliding_window", 0),
                      logit_softcap=kw.get("logit_softcap", 0.0), k_scale=k_scale,
                      qk_dtype="int8")
    m = s.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(Hkv, Hq // Hkv)[None, :, :, None, None]
        m = torch.maximum(m, sk)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        den = den + torch.exp(sk - m)
    pv = (p / den * v_scale.float().transpose(1, 2)[:, :, None, None, :]).amax(dim=-1)
    vmax = v.float().abs().amax(dim=(1, 3))[:, :, None, None]                # [B, Hkv, 1, 1]
    return (pv * vmax / 127.0).permute(0, 3, 1, 2).reshape(B, T, Hq, 1)


def flash_decode_int8_errors(o, q, k, v, n_past, n_tokens: int, **kw) -> tuple[float, float]:
    """(max abs error, max error in steps as in DECODE_INT8_STEPS) of a K4
    int8-dot output against its plain version on the same inputs."""
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode_plain

    ref = flash_decode_plain(q, k, v, n_past, n_tokens, qk_dtype="int8", **kw).float()
    step = int8_step(q, k, v, n_past, n_tokens, **kw)
    diff = (o.float() - ref).abs()
    if o.dtype == torch.bfloat16:
        diff = (diff - 2.0 ** -7 * torch.maximum(o.float().abs(), ref.abs())).clamp_(min=0.0)
    return (o.float() - ref).abs().max().item(), (diff / (step + 1e-30)).max().item()


def flash_cases(dev, timer, gen) -> dict:
    """K3 in its three modes (bf16; f32 cache; f32 query over a bf16 cache)
    on every case, each launched twice and bit-identical, held to
    FLASH_ATOL and FLASH_SCALED_TOL; the f32 modes' split (blocks per
    cluster) as the kernel chose it, checked against its schedule.  The
    timed shapes also time the plain version and two library calls: SDPA
    with a mask over the whole cache, and at n_past 0 SDPA over the live
    keys with is_causal.  Mode 2's library calls take the f32 query over
    the cache cast to f32: its function without the bf16 rounding of p."""
    from chatllm_tpu_torch.ops.cuda.flash import (MODES, cluster_slots, f32_rows,
                                                  flash_attention, flash_attention_plain,
                                                  last_splits, prefill_geometry)

    L3, QW = (32, 8, 128), (14, 2, 64)     # Llama-3-8B; Qwen2.5-0.5B (7 heads per kv head)
    A3 = (32, 4, 128)                      # Qwen3-30B-A3B: 8 query heads per kv head
    G3, G2, G1 = (16, 8, 256), (16, 8, 256), (4, 1, 256)   # Gemma-3-12B, -2-9B, -3-1B
    GL = (32, 2, 128)                      # GLM-4-9B: 16 query heads per kv head
    P35, P2 = (32, 32, 96), (32, 32, 80)   # Phi-3.5-mini, Phi-2: MHA at D 96 / 80
    cases = [  # (heads, T, S, n_past, n_tokens, window, softcap, timed as)
        (L3, 128, 1024, 0, 128, 0, 0.0, None),
        (L3, 512, 8192, 1000, 512, 0, 0.0, None),
        (L3, 128, 1024, 0, 100, 0, 0.0, None),         # padded prefill chunk
        (L3, 512, 8192, 1000, 512, 256, 0.0, None),    # sliding window
        (L3, 128, 1024, 64, 128, 0, 30.0, None),       # softcap
        (L3, 1024, 8192, 0, 1000, 0, 0.0, "prefill_1000"),   # the 1000-token chunk
        (QW, 128, 1024, 0, 100, 0, 0.0, None),
        (QW, 512, 8192, 1000, 512, 0, 0.0, None),
        (QW, 1024, 8192, 0, 1000, 0, 0.0, "prefill_1000_qwen"),
        # the edges of the bf16 kernel's 128 x 128 tiles: n_past off the tile
        # grid, the cache's last tile, a window crossing key tiles, softcap
        # with a window, T off the tile grid, 7 heads per kv head at T 1024
        (L3, 128, 1024, 37, 128, 0, 0.0, None),
        (L3, 512, 8192, 1001, 512, 0, 0.0, None),
        (L3, 128, 8192, 8064, 128, 0, 0.0, "prefill_8064"),   # a chunk at the cache's end
        (L3, 512, 8192, 1001, 512, 300, 0.0, None),
        (L3, 320, 2048, 700, 320, 300, 30.0, None),
        (QW, 200, 1024, 37, 180, 0, 0.0, None),
        (QW, 1024, 8192, 37, 1024, 0, 0.0, None),
        # the f32 kernel's tiles (128 or 64 rows) and split walks (clusters of
        # 2-8 blocks, logged as C): a window crossing split boundaries, T off
        # the row grid with padded rows over a split, softcap over a split, a
        # one-tile query at the cache's end, n_past off the row grid
        (L3, 128, 8192, 5000, 128, 1000, 0.0, None),
        (QW, 100, 8192, 3000, 90, 0, 0.0, None),
        (QW, 128, 8192, 6000, 128, 0, 30.0, None),
        (QW, 64, 8192, 8128, 64, 0, 0.0, None),
        (L3, 192, 2048, 1001, 192, 0, 0.0, None),
        (QW, 128, 8192, 8064, 128, 0, 0.0, "prefill_8064_qwen"),
        # 128-row f32 blocks (Llama-3-8B, T >= 1024): T and n_past off the
        # row grid; a window with a softcap and padded rows
        (L3, 1000, 8192, 37, 1000, 0, 0.0, None),
        (L3, 1024, 4096, 500, 1000, 300, 30.0, None),
        # InternVL3.5-8B's image prefill: the 3424-token spliced prompt in its
        # 4096-row bucket (timed in mode 2, the chat path's)
        (L3, 4096, 8192, 0, IVL_PROMPT_TOKENS, 0, 0.0, "ivl_prefill"),
        # Qwen3-30B-A3B's prefill chunks of 512 and 2048 tokens (timed in mode
        # 2, the chat path's), and a chunk after a prompt, off the row grid
        (A3, 512, 8192, 0, 512, 0, 0.0, "a3b_prefill_512"),
        (A3, 2048, 8192, 0, 2048, 0, 0.0, "a3b_prefill_2048"),
        (A3, 512, 8192, 1001, 500, 0, 0.0, None),
        # Mistral-7B's dense windowed route (max_length 4608, window 4096):
        # the 4400-token prompt's 4096-row chunk and its 304-token tail in a
        # 512-row bucket past the window (timed in mode 2, the chat path's)
        (L3, 4096, 4608, 0, 4096, 4096, 0.0, "mistral_prefill_4096"),
        (L3, 512, 4608, 4096, 304, 4096, 0.0, "mistral_prefill_tail"),
        # head dim 256 (the Gemma family): Gemma-3-12B's 512-token chunks
        # over its global layers' 8192 slots (timed in all three modes), the
        # last chunk of its GEMMA3_PROMPT in a 512-row bucket, its dense
        # windowed route's 1024-row chunk over 1536 slots with window 1024
        # across the 64-key tiles (timed), a chunk deep in the cache,
        # Gemma-2's softcap 50 with and without its window, and Gemma-3-1B's
        # 4 query heads on one kv head
        (G3, 512, 8192, 1024, 512, 0, 0.0, "g3_prefill_512"),
        (G3, 512, 8192, 1536, 464, 0, 0.0, None),
        (G3, 1024, 1536, 0, 1024, 1024, 0.0, "g3_dense_prefill_1024"),
        (G3, 512, 1536, 1024, 476, 1024, 0.0, None),
        (G3, 256, 8192, 7500, 256, 0, 0.0, None),
        (G2, 512, 8192, 512, 512, 0, 50.0, "g2_prefill_softcap"),
        (G2, 320, 2048, 700, 320, 300, 50.0, None),
        (G1, 200, 2048, 37, 180, 300, 0.0, None),
        # GLM-4-9B's 1000-token prompt in its 1024-row bucket over 8192 slots
        # (timed in mode 2, the chat path's), a chunk after it off the row
        # grid, and a chunk deep in the cache
        (GL, 1024, 8192, 0, 1000, 0, 0.0, "glm_prefill_1000"),
        (GL, 512, 8192, 1001, 500, 0, 0.0, None),
        (GL, 128, 8192, 8064, 128, 0, 0.0, None),
        # head dims 80 and 96 (D 128's tiles, the columns past D zero): the
        # 1000-token prompt of Phi-3.5-mini (its window of 262145 over 8192
        # slots) and of Phi-2 (4096 slots), timed in all three modes; a
        # chunk that ends at the cache's last slot, a window with the softcap
        (P35, 1024, 8192, 0, 1000, PHI35_WINDOW, 0.0, "phi35_prefill_1000"),
        (P2, 1024, 4096, 0, 1000, 0, 0.0, "phi2_prefill_1000"),
        (P35, 200, 4000, 3800, 200, 0, 0.0, None),
        (P2, 320, 2048, 700, 320, 300, 50.0, None),
    ]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the clusters of each f32 kernel the card holds at once, which the
    # kernel's split and its schedule's twin both read
    slots = {(D, mode, bq): cluster_slots(D, mode, bq)
             for D, bqs in ((128, (128, 64)), (64, (64,)), (80, (64,)), (96, (64,)),
                            (256, (64,)))
             for mode in (1, 2) for bq in bqs}
    log(f"  f32 kernels' cluster slots (D, mode, rows): {slots}")
    out = {"cases": [], "shapes": {},
           "cluster_slots": {"/".join(map(str, k)): v for k, v in slots.items()}}
    # --cache_dtype bf16 / f32, and an f32 query over a bf16 cache (the chat
    # path's projections return f32; --compute_dtype f32)
    for qdt, dtype, tag in ((torch.bfloat16, torch.bfloat16, ""),
                            (torch.float32, torch.float32, "_f32"),
                            (torch.float32, torch.bfloat16, "_f32q")):
        mode = MODES[(qdt, dtype)]
        for (Hq, Hkv, D), T, S, n_past, n_tok, win, cap, timed in cases:
            q = torch.randn(1, T, Hq, D, generator=gen, device=dev).to(qdt)
            k = torch.zeros(1, S, Hkv, D, device=dev, dtype=dtype)
            v = torch.zeros_like(k)
            kv_len = n_past + n_tok
            k[:, :kv_len] = torch.randn(1, kv_len, Hkv, D, generator=gen, device=dev).to(dtype)
            v[:, :kv_len] = torch.randn(1, kv_len, Hkv, D, generator=gen, device=dev).to(dtype)
            kw = dict(scale=D ** -0.5, causal=True, sliding_window=win, logit_softcap=cap)
            o = flash_attention(q, k, v, n_past, n_tok, **kw)
            splits = last_splits() if mode else 1
            bq = f32_rows(D, T, Hq, 1, sms)
            want = prefill_geometry(T, S, n_past, n_tok, D, mode=mode, heads=Hq, window=win,
                                    sms=sms, slots=slots.get((D, mode, bq)))["splits"]
            # every mode's second launch is bit-identical (no atomics)
            same = torch.equal(flash_attention(q, k, v, n_past, n_tok, **kw), o)
            err, scaled = flash_errors(o, q, k, v, n_past, n_tok, **kw)
            name = f"{str(qdt)[6:]}/{str(dtype)[6:]}"
            log(f"  flash {name:17s} Hq={Hq} Hkv={Hkv} D={D} T={T:4d} S={S:5d} n_past={n_past:4d} "
                f"n_tokens={n_tok:4d} window={win} softcap={cap} C={splits}  "
                f"max_abs_err={err:.3e} scaled={scaled:.2e}")
            lim = FLASH_SCALED_TOL[dtype]
            if not (o.dtype == qdt and torch.isfinite(o).all() and err <= FLASH_ATOL
                    and scaled <= lim and same and splits == want):
                case = (Hq, Hkv, D, T, S, n_past, n_tok, win, cap)
                raise AssertionError(f"flash {name} case {case}: "
                                     f"{o.dtype}, err {err} (limit {FLASH_ATOL}), scaled "
                                     f"{scaled} (limit {lim}), second launch same: {same}, "
                                     f"split {splits} (schedule {want})")
            out["cases"].append({"dtype": str(dtype), "q_dtype": str(qdt), "Hq": Hq, "Hkv": Hkv,
                                 "D": D, "T": T, "S": S,
                                 "n_past": n_past, "n_tokens": n_tok, "window": win,
                                 "softcap": cap, "splits": splits, "max_abs_err": err,
                                 "scaled_err": scaled, "second_launch_same": same})
            if timed and (mode == 2 or not timed.startswith(("ivl_", "a3b_", "mistral_",
                                                              "g3_dense", "g2_", "glm_"))):
                # visible (query, key) pairs: causal rows inside the window;
                # padded rows see all keys
                qpos = n_past + np.arange(T)
                lo = np.maximum(qpos - win + 1, 0) if win else 0
                pairs = int((np.minimum(qpos + 1, kv_len) - lo).sum())
                peak = BF16_TC_FLOPS if mode == 0 else F32_FLOPS
                nb = nbytes(q, o) + 2 * kv_len * Hkv * D * k.element_size()
                flops = 4.0 * D * Hq * pairs
                b_ms, b_by = bound(nb, flops, peak)
                G = Hq // Hkv
                qt = q.transpose(1, 2)
                kt = k.transpose(1, 2).repeat_interleave(G, dim=1).to(qdt)
                vt = v.transpose(1, 2).repeat_interleave(G, dim=1).to(qdt)
                qp = torch.arange(T, device=dev)[:, None] + n_past
                kp = torch.arange(S, device=dev)[None, :]
                mask = (kp < kv_len) & (kp <= qp)
                if win:
                    mask = mask & (kp > qp - win)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                # K3's function in one library call at n_past 0 without a
                # window: the live keys only, is_causal's top-left alignment
                # (row i sees keys j <= i; the padding rows past kv_len see
                # them all)
                causal_ms = None
                if n_past == 0 and not win:
                    kc = kt[:, :, :kv_len]
                    vc = vt[:, :, :kv_len]
                    lib = sdpa(qt, kc, vc, is_causal=True, scale=kw["scale"]).transpose(1, 2)
                    l_scaled = flash_errors(lib, q, k, v, n_past, n_tok, **kw)[1]
                    if not l_scaled <= FLASH_SCALED_TOL[dtype]:
                        raise AssertionError(f"flash {timed + tag}: the causal library "
                                             f"yardstick is {l_scaled} from the plain version")
                    del lib
                    causal_ms = timer(lambda: sdpa(qt, kc, vc, is_causal=True,
                                                   scale=kw["scale"]))
                shape = {
                    "T": T, "S": S, "n_past": n_past, "n_tokens": n_tok, "dtype": str(dtype),
                    "q_dtype": str(qdt), "Hq": Hq, "D": D, "splits": splits,
                    "ms": timer(lambda: flash_attention(q, k, v, n_past, n_tok, **kw)),
                    "plain_ms": timer(lambda: flash_attention_plain(q, k, v, n_past, n_tok,
                                                                    **kw), iters=5),
                    "library_ms": timer(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                     scale=kw["scale"])),
                    "library_causal_ms": causal_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "flops": flops}
                shape["tflops"] = shape["flops"] / shape["ms"] * 1e-9
                shape["share_of_bound"] = b_ms / shape["ms"]
                tc = ""
                if mode == 2:
                    # mode 2's products are all exact on the tensor cores
                    # (ROADMAP §2): Q.K^T as three bf16 passes over q's bf16
                    # planes and P.V as one, twice the f32 route's flops
                    shape["bound_tc_ms"] = bound(nb, 2 * flops, BF16_TC_FLOPS)[0]
                    shape["share_of_tc_bound"] = shape["bound_tc_ms"] / shape["ms"]
                    tc = f", {100 * shape['share_of_tc_bound']:.1f}% of the tensor-core bound"
                out["shapes"][timed + tag] = shape
                log(f"    timing {shape}")
                log(f"    {timed + tag}: {shape['tflops']:.1f} TFLOP/s, "
                    f"{100 * shape['share_of_bound']:.1f}% of the bound{tc}")
            del q, k, v, o
    return out


DECODE_S = 8192
DECODE_CASES = [  # (B, T, Hq, Hkv, D, n_past, cache, dots, extra, timed as)
    (1, 1, 32, 8, 128, [1000], "int8", "bfloat16", {}, "decode_1000"),
    (1, 1, 32, 8, 128, [8000], "int8", "bfloat16", {}, "decode_8000"),
    (4, 1, 32, 8, 128, [10, 1000, 4095, 8000], "int8", "bfloat16", {}, "serve_4"),
    # InternVL3.5-8B's q8 decode after the 3424-token image prompt
    (1, 1, 32, 8, 128, [3440], "int8", "bfloat16", {}, "ivl_decode_3440"),
    (2, 2, 32, 8, 128, [3000, 6000], "int8", "bfloat16", {}, None),
    (1, 1, 32, 8, 128, [5000], "int8", "bfloat16",
     {"sliding_window": 256, "logit_softcap": 30.0}, None),
    (1, 1, 32, 8, 128, [3000], "int8", "bfloat16", {"sinks": True}, None),
    (1, 1, 32, 8, 128, [6000], "bfloat16", "bfloat16", {}, None),
    (1, 1, 8, 4, 64, [5000], "int8", "float32", {}, None),    # the per-head case
    (1, 1, 32, 8, 128, [5000], "int8", "float32", {}, None),
    # Qwen2.5-0.5B: head dim 64, 7 query heads per kv head
    (1, 1, 14, 2, 64, [1000], "int8", "bfloat16", {}, "decode_1000_qwen"),
    (2, 1, 14, 2, 64, [10, 8000], "int8", "bfloat16", {}, None),
    (1, 2, 14, 2, 64, [4000], "int8", "float32", {}, None),
    # CHATLLM_TPU_FLASH_DECODE=1 sends T <= 8 over any cache: up to 64 rows
    (1, 8, 14, 2, 64, [1000], "bfloat16", "float32", {}, None),   # Qwen, G*T = 56
    (2, 8, 32, 8, 128, [500, 3000], "bfloat16", "bfloat16", {}, None),
    (1, 8, 32, 4, 128, [7000], "int8", "bfloat16", {}, None),     # G*T = 64
    # Qwen3-30B-A3B: 32 query heads over 4 kv heads (G 8), 8 and 16 rows per
    # kv head; at B 2 the A3B server's 2-slot step
    (1, 1, 32, 4, 128, [1000], "int8", "bfloat16", {}, "a3b_decode_1000"),
    (1, 2, 32, 4, 128, [3000], "int8", "bfloat16", {}, None),
    (2, 1, 32, 4, 128, [1000, 7000], "int8", "bfloat16", {}, "a3b_serve_2"),
    (2, 2, 32, 4, 128, [40, 8000], "int8", "bfloat16", {}, None),
    # Mistral-7B's dense windowed route: a q8 decode step past the window
    # 4096 in a 4608-slot cache (extra "S": the cache's slots)
    (1, 1, 32, 8, 128, [4500], "int8", "bfloat16", {"sliding_window": 4096, "S": 4608},
     "mistral_decode_4500"),
    # head dim 256: Gemma-3-12B's q8 decode on its global layers past 4096
    # (bf16 and f32 dots), its 2-slot server's per-row step, Gemma-2-9B's
    # softcap 50 (and its window), 32 rows per kv head (Gemma-3-1B's G 4 at
    # T 8, the forced route's most), bf16 and f32 caches with sinks
    (1, 1, 16, 8, 256, [5000], "int8", "bfloat16", {}, "g3_decode_5000"),
    (1, 1, 16, 8, 256, [5000], "int8", "float32", {}, None),
    (2, 1, 16, 8, 256, [2100, 6000], "int8", "bfloat16", {}, "g3_serve_2"),
    (1, 1, 16, 8, 256, [6000], "int8", "bfloat16", {"logit_softcap": 50.0}, "g2_decode_6000"),
    (1, 2, 16, 8, 256, [6000], "int8", "float32",
     {"logit_softcap": 50.0, "sliding_window": 4096}, None),
    (1, 8, 4, 1, 256, [3000], "int8", "bfloat16", {}, None),
    (2, 8, 4, 1, 256, [10, 7000], "float32", "float32", {"sinks": True}, None),
    (1, 4, 16, 8, 256, [4095], "bfloat16", "bfloat16", {"sinks": True}, None),
    (1, 1, 16, 8, 256, [0], "int8", "bfloat16", {}, None),
    (1, 1, 16, 8, 256, [8191], "int8", "float32", {}, None),
    # GLM-4-9B: 32 query heads over 2 kv heads (G 16), its q8 decode after
    # the 1000-token prompt (16 rows a kv head, the most the route sends),
    # f32 dots, and the 2-slot server's per-row step (32 rows a kv head,
    # which the route leaves to the chunked einsum; the kernel takes it)
    (1, 1, 32, 2, 128, [1064], "int8", "bfloat16", {}, "glm_decode_1064"),
    (1, 1, 32, 2, 128, [6000], "int8", "float32", {}, None),
    (2, 1, 32, 2, 128, [1000, 2100], "int8", "bfloat16", {}, None),
    # head dims 96 and 80 (Phi-3.5-mini, Phi-2: 32 kv heads, one row each):
    # their q8 decode after the 1000-token prompt with the f32 dots the
    # route takes there (the JAX package's per-head kernel), the 2-slot
    # server's per-row step, bf16 dots, 64 rows a kv head with sinks
    (1, 1, 32, 32, 96, [1064], "int8", "float32", {"sliding_window": PHI35_WINDOW},
     "phi35_decode_1064"),
    (1, 1, 32, 32, 80, [1064], "int8", "float32", {"S": 4096}, "phi2_decode_1064"),
    (2, 1, 32, 32, 96, [1000, 1100], "int8", "float32", {}, "phi35_serve_2"),
    (1, 1, 32, 32, 96, [3000], "bfloat16", "bfloat16", {}, None),
    (1, 8, 8, 1, 80, [2000], "float32", "float32", {"sinks": True}, None),
    # GPT-OSS-20B's full-attention layers: 64 query heads over 8 kv heads of 64
    # (G 8) with sinks, the f32 dots its route takes (the JAX package's
    # per-head kernel: D 64 is not lane-aligned and there are 8 kv heads);
    # its q8 decode after the 1000-token prompt and deep in the context, and
    # the 2-slot server's per-row step (16 rows a kv head)
    (1, 1, 64, 8, 64, [1064], "int8", "float32", {"sinks": True}, "go_decode_1064"),
    (1, 1, 64, 8, 64, [8000], "int8", "float32", {"sinks": True}, "go_decode_8000"),
    (2, 1, 64, 8, 64, [1000, 1100], "int8", "float32", {"sinks": True}, "go_serve_2"),
    (1, 1, 64, 8, 64, [0], "int8", "float32", {"sinks": True}, None),        # one live key
    (1, 1, 64, 8, 64, [3000], "bfloat16", "float32", {"sinks": True}, None),
]

# The bf16 / f32 dots on the edges of their design: 64-key tiles aligned at
# multiples of 64 (a lane scores keys j and 32 + j), and C blocks per (batch
# row, kv head) splitting the live tiles in rank order
# (ops/cuda/flash_decode.py::decode_geometry: C = 16 at B * Hkv <= 16, 8 at
# 32, 1 at 256).  Same columns as DECODE_CASES.
DECODE_EDGE_CASES = [
    (1, 1, 32, 8, 128, [0], "int8", "bfloat16", {}, "decode_floor"),   # one live key
    (1, 1, 32, 8, 128, [1], "int8", "float32", {}, None),
    (1, 1, 32, 8, 128, [31], "int8", "bfloat16", {}, None),      # the lanes' first keys
    (1, 1, 32, 8, 128, [32], "int8", "float32", {}, None),       # one key of the second half
    (1, 1, 32, 8, 128, [62], "int8", "bfloat16", {}, None),      # tile - 1 live keys
    (1, 1, 32, 8, 128, [63], "int8", "float32", {}, None),       # one whole tile
    (1, 1, 32, 8, 128, [64], "bfloat16", "bfloat16", {}, None),  # tile + 1
    # 16 live tiles, one per block: the last share one key short of its
    # edge, on it, one key past it (17 tiles)
    (1, 1, 32, 8, 128, [1022], "int8", "bfloat16", {}, None),
    (1, 1, 32, 8, 128, [1023], "int8", "float32", {}, None),
    (1, 1, 32, 8, 128, [1024], "int8", "bfloat16", {}, None),
    (1, 1, 14, 2, 64, [1024], "int8", "float32", {}, None),     # Qwen's route: f32 dots
    (1, 1, 32, 8, 128, [8191], "int8", "bfloat16", {}, None),    # a row ending at S
    (4, 1, 32, 8, 128, [0, 33, 1000, 8191], "int8", "float32", {}, None),
    # 2 live tiles: 14 of 16 blocks have an empty share
    (1, 1, 32, 8, 128, [5000], "int8", "bfloat16", {"sliding_window": 64}, None),
    (1, 2, 32, 8, 128, [2047], "int8", "float32",
     {"sliding_window": 1000, "sinks": True, "logit_softcap": 30.0}, None),
    (32, 1, 32, 8, 128, [i * 263 % 8192 for i in range(32)], "int8", "bfloat16", {}, None),  # C = 1
    (32, 1, 32, 8, 128, [i * 263 % 8192 for i in range(32)], "bfloat16", "float32", {}, None),
    (1, 8, 32, 4, 128, [7000], "int8", "float32", {}, None),     # 64 rows
    (1, 8, 32, 4, 128, [33], "float32", "bfloat16", {}, None),
    (1, 8, 14, 2, 64, [1000], "bfloat16", "bfloat16", {}, None), # Qwen, 56 rows
    (2, 8, 14, 2, 64, [0, 4000], "float32", "float32", {}, None),
]

# K4's int8 dots at Llama-3-8B's q8 shapes, S 8192, block_k 512 (the route's),
# timed at the float dots' four shapes
# (B, T, Hq, Hkv, D, n_past, extra, timed as)
DECODE_INT8_CASES = [
    (1, 1, 32, 8, 128, [1000], {}, "decode_1000"),
    (1, 1, 32, 8, 128, [8000], {}, "decode_8000"),
    (4, 1, 32, 8, 128, [10, 1000, 4095, 8000], {}, "serve_4"),
    (2, 2, 32, 8, 128, [3000, 6000], {}, None),
    (1, 1, 32, 8, 128, [5000], {"sliding_window": 256, "logit_softcap": 30.0}, None),
    (1, 1, 32, 8, 128, [3000], {"sinks": True}, None),
    (1, 1, 32, 8, 128, [1000], {"q": torch.float32}, None),
    (1, 1, 32, 8, 128, [2500], {"block_k": 256}, None),
    (2, 8, 32, 4, 128, [100, 7000], {}, None),                     # G*T = 64
    (1, 1, 8, 1, 128, [2000], {}, None),                           # one kv head
    (1, 4, 32, 8, 128, [3000], {}, None),                         # G*T = 16
    # head dim 64 (Qwen2.5-0.5B's heads): 7, 14 and 56 rows per kv head
    (2, 1, 14, 2, 64, [10, 5000], {}, None),
    (1, 2, 14, 2, 64, [4000], {}, None),
    (1, 8, 14, 2, 64, [1000], {"q": torch.float32}, None),
    # head dim 256 (Gemma): 256 products per dot; the q8 decode of Gemma-3-12B
    # past 4096, Gemma-2-9B's softcap, per-row n_past at B 2, 32 rows
    (1, 1, 16, 8, 256, [5000], {}, "g3_decode_5000"),
    (1, 1, 16, 8, 256, [6000], {"logit_softcap": 50.0, "sliding_window": 4096}, None),
    (2, 1, 16, 8, 256, [2100, 6000], {"sinks": True}, None),
    (1, 8, 4, 1, 256, [3000], {"q": torch.float32}, None),
    (1, 1, 16, 8, 256, [511], {}, None),
    # head dims 96 and 80 (Phi-3.5-mini, Phi-2): 6 and 5 16-byte chunks a
    # row, 32 kv heads (the batched kernel's block 256 at D 96), 64 rows
    (1, 1, 32, 32, 96, [1064], {}, "phi35_decode_1064"),
    (1, 1, 32, 32, 80, [1064], {}, "phi2_decode_1064"),
    (1, 8, 8, 1, 80, [3000], {"sinks": True}, None),
]

# The int8 dots on the edges of their design (csrc `int8_share`): a row with
# fewer live quantization blocks than the cluster's C ranks splits each
# block's 64-key tiles over a group of ranks that exchange the block's
# maxima; with C or more each rank takes whole blocks (C = 16 at B = 1, 8 at
# B = 4, 1 at B = 32).  Same columns as DECODE_INT8_CASES.
DECODE_INT8_EDGE_CASES = [
    (1, 1, 32, 8, 128, [0], {}, "decode_floor"),                  # one live key
    (1, 1, 32, 8, 128, [1], {}, None),
    (1, 1, 32, 8, 128, [31], {}, None),
    (1, 1, 32, 8, 128, [63], {}, None),                           # one whole tile
    (1, 1, 32, 8, 128, [64], {}, None),                           # tile + 1
    # one 512-key block, then one and two keys of the second
    (1, 1, 32, 8, 128, [511], {}, None),
    (1, 1, 32, 8, 128, [512], {}, None),
    (1, 1, 32, 8, 128, [513], {}, None),
    # a 256-key block one key short, whole, one key past
    (1, 1, 32, 8, 128, [254], {"block_k": 256}, None),
    (1, 1, 32, 8, 128, [255], {"block_k": 256}, None),
    (1, 1, 32, 8, 128, [256], {"block_k": 256}, None),
    (1, 1, 32, 8, 128, [1023], {}, None),
    (1, 1, 32, 8, 128, [1024], {}, None),
    (1, 1, 32, 8, 128, [8191], {}, None),                         # 16 blocks, a row ending at S
    (32, 1, 32, 8, 128, [i * 263 % 8192 for i in range(32)], {}, None),   # C = 1
    (1, 1, 32, 8, 128, [600], {"sliding_window": 200}, None),    # a window across key 512
    (1, 8, 32, 4, 128, [3000], {"sinks": True, "logit_softcap": 30.0}, None),   # G*T = 64
]


def decode_cases(dev, timer, gen) -> dict:
    """K4 at Llama-3-8B's and Qwen2.5-0.5B's attention shapes and on its
    design's edges over an 8192-slot cache; each case launched twice,
    bit-identical."""
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain

    out = {"cases": [], "shapes": {}}
    for B, T, Hq, Hkv, D, n_past, cache, dots, extra, timed in DECODE_CASES + DECODE_EDGE_CASES:
        S = extra.get("S", DECODE_S)
        # bf16 dots take the model's bf16 query; f32 dots an f32 one
        q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(getattr(torch, dots))
        k = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
        v = torch.randn(B, S, Hkv, D, generator=gen, device=dev)
        kw = dict(scale=D ** -0.5, qk_dtype=dots, sliding_window=extra.get("sliding_window", 0),
                  logit_softcap=extra.get("logit_softcap", 0.0))
        if extra.get("sinks"):
            kw["sinks"] = torch.randn(Hq, generator=gen, device=dev)
        if cache == "int8":
            (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
        else:
            k, v = k.to(getattr(torch, cache)), v.to(getattr(torch, cache))
        npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
        o = flash_decode(q, k, v, npv, T, **kw)
        same = torch.equal(flash_decode(q, k, v, npv, T, **kw), o)
        err, scaled = flash_decode_errors(o, q, k, v, npv, T, **kw)
        name = (f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} n_past={n_past} {cache} {dots} dots "
                f"{extra}")
        log(f"  flash_decode {name}  max_abs_err={err:.3e} scaled={scaled:.2e}")
        lim = DECODE_SCALED_TOL[dots]
        if not (o.dtype == q.dtype and torch.isfinite(o).all() and err <= DECODE_ATOL
                and scaled <= lim and same):
            raise AssertionError(f"flash_decode {name}: err {err} (limit {DECODE_ATOL}), "
                                 f"scaled {scaled} (limit {lim}), second launch "
                                 f"{'bit-identical' if same else 'differs'}")
        out["cases"].append({"B": B, "T": T, "Hq": Hq, "Hkv": Hkv, "D": D, "n_past": n_past,
                             "cache": cache, "dots": dots, "extra": str(extra),
                             "max_abs_err": err, "scaled_err": scaled})
        if timed:
            # the keys a row's queries see: past the window's start when there is one
            win = kw["sliding_window"]
            live = [min(n + T, S) - (max(0, n - win + 1) if win else 0) for n in n_past]
            per_key = Hkv * (2 * D * k.element_size() + (8 if cache == "int8" else 0))
            b_ms, b_by = bound(nbytes(q, o) + sum(live) * per_key,
                               4.0 * D * Hq * T * sum(live),
                               BF16_TC_FLOPS if dots == "bfloat16" else F32_FLOPS)
            out["shapes"][timed] = {
                "B": B, "T": T, "S": S, "n_past": n_past, "live_keys": live,
                "ms": timer(lambda: flash_decode(q, k, v, npv, T, **kw)),
                "plain_ms": timer(lambda: flash_decode_plain(q, k, v, npv, T, **kw), iters=5),
                "library_ms": timer(_sdpa_over_dequantized(q, k, v, npv, T, kw["scale"],
                                                           kw["k_scale"], kw["v_scale"],
                                                           window=win, sinks=kw.get("sinks"))),
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"    timing {out['shapes'][timed]}")
        del q, k, v, o
    return out


# K4 at DeepSeek-V2-Lite's expanded MLA cache: K 192 wide (128 nope + 64 rope
# dims), V 128, 16 kv heads of one query head each; the route takes f32 dots
# there (the JAX package's per-head kernel).  (B, T, n_past, cache, dots,
# extra, timed as); Hq = Hkv = 16, S = DECODE_S.
MLA_HEADS, MLA_DK, MLA_DV = 16, 192, 128
MLA_DECODE_CASES = [
    (1, 1, [1000], "int8", "float32", {}, "dsv2_1000"),
    (1, 1, [8000], "int8", "float32", {}, "dsv2_8000"),
    (4, 1, [10, 1000, 4095, 8000], "int8", "float32", {}, "dsv2_serve_4"),
    (1, 1, [0], "int8", "float32", {}, None),             # one live key
    (1, 1, [63], "int8", "float32", {}, None),            # one whole tile
    (1, 1, [64], "int8", "float32", {}, None),            # tile + 1
    (1, 1, [1023], "int8", "float32", {}, None),
    (1, 1, [8191], "int8", "float32", {}, None),          # a row ending at S
    (2, 2, [3000, 6000], "int8", "float32", {}, None),
    (1, 8, [7000], "int8", "float32", {}, None),          # 8 rows, the most
    (32, 1, [i * 263 % 8192 for i in range(32)], "int8", "float32", {}, None),
    (1, 1, [5000], "int8", "float32", {"sliding_window": 256, "logit_softcap": 30.0}, None),
    (2, 1, [700, 5], "bfloat16", "float32", {}, None),
    (1, 4, [2000], "float32", "float32", {}, None),
    (1, 1, [3000], "int8", "bfloat16", {}, None),
    (1, 2, [100], "bfloat16", "bfloat16", {}, None),
]


def mla_decode_cases(dev, timer, gen) -> dict:
    """K4 at (D, Dv) = (192, 128) over an 8192-slot cache, each case launched
    twice, bit-identical, against its plain version (DECODE_SCALED_TOL);
    timed at DeepSeek-V2-Lite's decode shapes beside SDPA over the cache
    dequantized beforehand (V of width 128) and the bytes bound."""
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain

    out = {"cases": [], "shapes": {}}
    H, S = MLA_HEADS, DECODE_S
    for B, T, n_past, cache, dots, extra, timed in MLA_DECODE_CASES:
        q = torch.randn(B, T, H, MLA_DK, generator=gen, device=dev).to(getattr(torch, dots))
        k = torch.randn(B, S, H, MLA_DK, generator=gen, device=dev)
        v = torch.randn(B, S, H, MLA_DV, generator=gen, device=dev)
        kw = dict(scale=MLA_DK ** -0.5, qk_dtype=dots,
                  sliding_window=extra.get("sliding_window", 0),
                  logit_softcap=extra.get("logit_softcap", 0.0))
        if cache == "int8":
            (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
        else:
            k, v = k.to(getattr(torch, cache)), v.to(getattr(torch, cache))
        npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
        o = flash_decode(q, k, v, npv, T, **kw)
        same = torch.equal(flash_decode(q, k, v, npv, T, **kw), o)
        err, scaled = flash_decode_errors(o, q, k, v, npv, T, **kw)
        name = f"B={B} T={T} (192, 128) n_past={n_past} {cache} {dots} dots {extra}"
        log(f"  flash_decode {name}  max_abs_err={err:.3e} scaled={scaled:.2e}")
        lim = DECODE_SCALED_TOL[dots]
        if not (o.dtype == q.dtype and tuple(o.shape) == (B, T, H, MLA_DV)
                and torch.isfinite(o).all() and err <= DECODE_ATOL and scaled <= lim and same):
            raise AssertionError(f"flash_decode {name}: shape {tuple(o.shape)}, err {err} "
                                 f"(limit {DECODE_ATOL}), scaled {scaled} (limit {lim}), "
                                 f"second launch {'bit-identical' if same else 'differs'}")
        out["cases"].append({"B": B, "T": T, "D": MLA_DK, "Dv": MLA_DV, "n_past": n_past,
                             "cache": cache, "dots": dots, "extra": str(extra),
                             "max_abs_err": err, "scaled_err": scaled})
        if timed:
            live = [min(n + T, S) for n in n_past]
            per_key = H * ((MLA_DK + MLA_DV) * k.element_size() + (8 if cache == "int8" else 0))
            b_ms, b_by = bound(nbytes(q, o) + sum(live) * per_key,
                               2.0 * (MLA_DK + MLA_DV) * H * T * sum(live), F32_FLOPS)
            out["shapes"][timed] = {
                "B": B, "T": T, "S": S, "n_past": n_past, "live_keys": live,
                "ms": timer(lambda: flash_decode(q, k, v, npv, T, **kw)),
                "plain_ms": timer(lambda: flash_decode_plain(q, k, v, npv, T, **kw), iters=5),
                "library_ms": timer(_sdpa_over_dequantized(q, k, v, npv, T, kw["scale"],
                                                           kw["k_scale"], kw["v_scale"])),
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"    timing {out['shapes'][timed]}")
        del q, k, v, o
    return out


def _sdpa_over_dequantized(q, k, v, npv, T: int, scale: float, k_scale=None, v_scale=None,
                           head_major: bool = False, window: int = 0, sinks=None):
    """The library yardstick of K4: SDPA over the cache dequantized to bf16
    beforehand, causal mask by position, inside the `window` when one is
    given (returns a zero-argument call).  With `sinks` ([Hq]) the same
    function: one more key and value of zeros, whose additive mask entry is
    the head's sink (its score is then the sink, its value nothing)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, _, Hq, _ = q.shape
    if k_scale is not None:
        k, v = ((t.float() * sc[..., None]).to(torch.bfloat16)
                for t, sc in ((k, k_scale), (v, v_scale)))
    # [B, Hkv, S, D]
    kt, vt = (t if head_major else t.transpose(1, 2) for t in (k, v))
    G = Hq // kt.shape[1]
    kt, vt = kt.repeat_interleave(G, dim=1), vt.repeat_interleave(G, dim=1)
    qt = q.transpose(1, 2).to(kt.dtype)
    S = kt.shape[2]
    qp = npv[:, None, None, None] + torch.arange(T, device=q.device)[None, None, :, None]
    kp = torch.arange(S, device=q.device)[None, None, None, :]
    mask = kp <= qp
    if window:
        mask = mask & (kp > qp - window)
    if sinks is not None:
        zero = kt.new_zeros(B, Hq, 1, kt.shape[-1])
        kt, vt = torch.cat([kt, zero], dim=2), torch.cat([vt, zero], dim=2)
        fmask = torch.where(mask, 0.0, float("-inf")).expand(B, Hq, T, S)
        sink = sinks.float()[None, :, None, None].expand(B, Hq, T, 1)
        mask = torch.cat([fmask, sink], dim=-1).to(qt.dtype)
    return lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=scale)


def decode_int8_cases(dev, timer, gen) -> dict:
    """K4's int8 dots against their plain version (DECODE_INT8_STEPS) at
    Llama-3-8B's q8 shapes and on their design's edges over an 8192-slot
    cache; each case launched twice, bit-identical."""
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain

    out = {"cases": [], "shapes": {}}
    for B, T, Hq, Hkv, D, n_past, extra, timed in DECODE_INT8_CASES + DECODE_INT8_EDGE_CASES:
        S = DECODE_S
        q = torch.randn(B, T, Hq, D, generator=gen, device=dev).to(extra.get("q", torch.bfloat16))
        (k, ks), (v, vs) = (quantize_kv(torch.randn(B, S, Hkv, D, generator=gen, device=dev))
                            for _ in range(2))
        kw = dict(scale=D ** -0.5, k_scale=ks, v_scale=vs, block_k=extra.get("block_k", 512),
                  sliding_window=extra.get("sliding_window", 0),
                  logit_softcap=extra.get("logit_softcap", 0.0))
        if extra.get("sinks"):
            kw["sinks"] = torch.randn(Hq, generator=gen, device=dev)
        npv = torch.tensor(n_past, dtype=torch.int64, device=dev)
        o = flash_decode(q, k, v, npv, T, qk_dtype="int8", **kw)
        same = torch.equal(flash_decode(q, k, v, npv, T, qk_dtype="int8", **kw), o)
        err, steps = flash_decode_int8_errors(o, q, k, v, npv, T, **kw)
        name = f"B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} n_past={n_past} q {q.dtype} {extra}"
        log(f"  flash_decode int8 {name}  max_abs_err={err:.3e} steps={steps:.3f}")
        if not (o.dtype == q.dtype and torch.isfinite(o).all() and steps <= DECODE_INT8_STEPS
                and same):
            raise AssertionError(f"flash_decode int8 {name}: {steps} steps (limit "
                                 f"{DECODE_INT8_STEPS}), err {err}, second launch "
                                 f"{'bit-identical' if same else 'differs'}")
        out["cases"].append({"B": B, "T": T, "Hq": Hq, "Hkv": Hkv, "D": D, "n_past": n_past,
                             "extra": str(extra), "max_abs_err": err, "steps": steps})
        if timed:
            live = [min(n + T, S) for n in n_past]
            b_ms, b_by = bound(nbytes(q, o) + sum(live) * Hkv * (2 * D + 8),
                               4.0 * D * Hq * T * sum(live), BF16_TC_FLOPS)
            out["shapes"][timed] = {
                "B": B, "T": T, "S": S, "n_past": n_past, "live_keys": live,
                "ms": timer(lambda: flash_decode(q, k, v, npv, T, qk_dtype="int8", **kw)),
                "plain_ms": timer(lambda: flash_decode_plain(q, k, v, npv, T, qk_dtype="int8",
                                                             **kw), iters=5),
                "library_ms": timer(_sdpa_over_dequantized(q, k, v, npv, T, kw["scale"], ks, vs)),
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"    timing {out['shapes'][timed]}")
        del q, k, v, o
    return out


# E7's attention on K4: B 32, Llama-3-8B's heads, a head-major [B, Hkv, S, D]
# cache of 1024 slots read as a permuted view, f32 dots, an f32 query
E7_CASES = [(47, "int8", "e7_step_q8"), (47, "bfloat16", "e7_step_bf16"), (0, "int8", None),
            (700, "int8", None), (511, "bfloat16", None)]


def e7_cases(dev, timer, gen) -> dict:
    """K4 under experiments/bhsd_decode.py's call site, against its plain
    version on the same views (DECODE_SCALED_TOL, f32)."""
    from chatllm_tpu_torch.experiments import bhsd_decode as e7
    from chatllm_tpu_torch.ops.attention import quantize_kv
    from chatllm_tpu_torch.ops.cuda.flash_decode import flash_decode_plain

    B, T, Hq, Hkv, D, S = e7.B, 1, 32, 8, 128, e7.CTX
    out = {"cases": [], "shapes": {}}
    for n_past, cache, timed in E7_CASES:
        q = torch.randn(B, T, Hq, D, generator=gen, device=dev)
        k, v = (torch.randn(B, Hkv, S, D, generator=gen, device=dev) for _ in range(2))
        kw = {}
        if cache == "int8":
            (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        o = e7.pallas_decode_bhsd(q, k, v, n_past, scale=D ** -0.5, **kw)
        views = dict(k_scale=kw["k_scale"].permute(0, 2, 1),
                     v_scale=kw["v_scale"].permute(0, 2, 1)) if kw else {}
        kv, vv = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        npv = torch.full((B,), n_past, dtype=torch.int64, device=dev)
        err, scaled = flash_decode_errors(o, q, kv, vv, npv, T, scale=D ** -0.5,
                                          qk_dtype="float32", **views)
        log(f"  flash_decode (E7, head-major) B={B} n_past={n_past} {cache}  "
            f"max_abs_err={err:.3e} scaled={scaled:.2e}")
        lim = DECODE_SCALED_TOL["float32"]
        if not (torch.isfinite(o).all() and err <= DECODE_ATOL and scaled <= lim):
            raise AssertionError(f"flash_decode E7 n_past={n_past} {cache}: err {err}, "
                                 f"scaled {scaled} (limit {lim})")
        out["cases"].append({"B": B, "n_past": n_past, "cache": cache, "max_abs_err": err,
                             "scaled_err": scaled})
        if timed:
            live = n_past + T
            per_key = Hkv * (2 * D * k.element_size() + (8 if cache == "int8" else 0))
            b_ms, b_by = bound(nbytes(q, o) + B * live * per_key, 4.0 * D * Hq * T * live * B,
                               F32_FLOPS)
            out["shapes"][timed] = {
                "B": B, "S": S, "n_past": n_past, "cache": cache,
                "ms": timer(lambda: e7.pallas_decode_bhsd(q, k, v, n_past, scale=D ** -0.5,
                                                          **kw)),
                "plain_ms": timer(lambda: flash_decode_plain(q, kv, vv, n_past, T,
                                                             scale=D ** -0.5,
                                                             qk_dtype="float32", **views),
                                  iters=5),
                "library_ms": timer(_sdpa_over_dequantized(
                    q, k, v, npv, T, D ** -0.5, kw.get("k_scale"), kw.get("v_scale"),
                    head_major=True)),
                "bound_ms": b_ms, "bound_by": b_by}
            log(f"    timing {out['shapes'][timed]}")
        del q, k, v, o
    return out


E6_TOL = 1e-5       # of the output scale: the same bf16 roundings, f32 sums in another order


def e6_cases(dev, timer, gen) -> dict:
    """E6's two kernels at M 32, K 4096, N 14336 on a random q4_k weight:
    each template-(a) variant and each diagnostic mode against its plain
    version (E6_TOL), timed (the weight fits the 50 MB L2: the timer
    flushes it before every launch)."""
    from chatllm_tpu_torch.experiments import qmm_unpack_variants as e6
    from chatllm_tpu_torch.models.synthetic import synth_linear
    from chatllm_tpu_torch.ops.qmm import dequant_weight

    lin = synth_linear(e6.K, e6.N, "q4k", gen=gen, zeros=False, device=dev)
    arrays = (lin.q, lin.s, lin.b, lin.d, lin.dm)
    x = torch.randn(e6.M, e6.K, generator=gen, device=dev)
    xs = e6.group_sums(x)
    xb, w_bf16 = x.to(torch.bfloat16), dequant_weight(lin, torch.bfloat16)
    out = {name: {"cases": [], "shapes": {}} for name in ("qmm_unpack", "qmm_unpack_diag")}
    runs = [("qmm_unpack", name, dict(unpack=u, biasdot=b)) for name, u, b in e6.VARIANTS]
    runs += [("qmm_unpack_diag", f"diag_{m}", dict(mode=m)) for m in e6.DIAG_MODES]
    for kernel, name, kw in runs:
        if kernel == "qmm_unpack":
            def fn(kw=kw):
                return e6.qmm_unpack(x, xs, *arrays, **kw)

            def plain(kw=kw):
                return e6.qmm_unpack_plain(x, xs, *arrays, **kw)
        else:
            def fn(kw=kw):
                return e6.qmm_unpack_diag(x, *arrays, **kw)

            def plain(kw=kw):
                return e6.qmm_unpack_diag_plain(x, *arrays, **kw)
        y, ref = fn(), plain()
        torch.cuda.synchronize()
        err, rel = rel_err(y, ref)
        log(f"  {kernel} {name:16s} M={e6.M} K={e6.K} N={e6.N}  max_abs_err={err:.3e} "
            f"rel={rel:.2e}")
        if not (torch.isfinite(y).all() and rel <= E6_TOL):
            raise AssertionError(f"{kernel} {name}: rel err {rel} > {E6_TOL}")
        out[kernel]["cases"].append({"variant": name, "max_abs_err": err, "rel": rel})
        b_ms, b_by = bound(nbytes(*arrays, x, y) + (nbytes(xs) if kw.get("biasdot") else 0),
                           2.0 * e6.M * e6.K * e6.N, BF16_TC_FLOPS)
        r = {"M": e6.M, "K": e6.K, "N": e6.N, "ms": timer(fn), "plain_ms": timer(plain, iters=5),
             # a yardstick over other inputs: the weight dequantized to bf16 beforehand
             "library_ms": timer(lambda: torch.matmul(xb, w_bf16)),
             "bound_ms": b_ms, "bound_by": b_by}
        log(f"    timing {name} {r}")
        out[kernel]["shapes"][name] = r
    return out


# --------------------------------------------------------- llama3_8b phase
def decode_launches(new_tokens: int, block: int = DECODE_BLOCK) -> int:
    """Decode steps one greedy generate launches: its `new_tokens` - 1
    decode steps after the prompt run as ceil(. / b) whole blocks of b =
    min(block, new_tokens) steps (the last block's extra steps are
    speculative)."""
    b = min(block, new_tokens)
    return -(-(new_tokens - 1) // b) * b


def chat_phase(dev, cfg, params) -> dict:
    """The chat path at full width (Llama-3-8B, and Qwen2.5-0.5B from
    qwen2_phase): bf16 cache (K1-K3), then a q8 cache (K4 on every decode
    step), each path's launches counted from 0.  Each engine runs its
    prompts once on the cache it keeps (capturing its decode graphs), then
    again, counted: every decode block of the counted run replays a graph,
    and the launches are exact per replayed step."""
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.cuda.flash import MODE_LAUNCHES, reset_mode_launches
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine, PerfInfo

    rng = np.random.default_rng(0)
    prompts = {"prompt_40": rng.integers(0, cfg.vocab_size, 40).tolist(),
               "prompt_1000": rng.integers(0, cfg.vocab_size, 1000).tolist()}
    gcfg = GenerationConfig(do_sample=False, max_new_tokens=64)

    def run(engine, kv, name, ids, before):
        perf = PerfInfo()
        dec = engine.decoder
        was = (dec.num_graphs(), dec.eager_steps, dec.replayed_steps)
        out, _, n_past = engine.generate(ids, gcfg, perf=perf, cache=kv)
        torch.cuda.synchronize()
        after = launch_counts()
        # the first token comes out of the prefill; gen_ms times the
        # len(out) - 1 decode steps after it
        steps = len(out) - 1
        r = {"prompt_tokens": len(ids), "prefill_ms": perf.prompt_ms,
             "gen_tokens": perf.gen_tokens, "decode_steps": steps,
             "decode_ms": perf.gen_ms, "decode_tok_s": steps / perf.gen_ms * 1e3,
             "replayed_steps": dec.replayed_steps - was[2],
             "launches": {k: after[k] - before[k] for k in after}}
        log(f"  {name}: {r}")
        want = decode_launches(gcfg.max_new_tokens)
        if len(out) != gcfg.max_new_tokens or n_past != len(ids) + len(out) - 1:
            raise AssertionError(f"{name}: {len(out)} tokens, n_past {n_past}")
        if (dec.num_graphs(), dec.eager_steps) != was[:2] or r["replayed_steps"] != want:
            raise AssertionError(f"{name}: graphs / warm-up steps {was[:2]} -> "
                                 f"{(dec.num_graphs(), dec.eager_steps)}, replayed "
                                 f"{r['replayed_steps']} steps (expected {want}): a decode "
                                 "block of the counted run did not replay a graph")
        return r, after

    eng = InferenceEngine(cfg, params, device=dev)
    kv = eng.new_cache(1)
    # warm: the 1000-token prompt captures the buckets of both prompts
    # (1024 and 2048 slots; the 40-token one stays in the first)
    eng.generate(prompts["prompt_1000"], gcfg, cache=kv)
    res = {"graphs": eng.decoder.num_graphs(), "capture_ms": eng.decoder.capture_ms}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    reset_mode_launches()
    before = launch_counts()
    for name, ids in prompts.items():
        res[name], before = run(eng, kv, name, ids, before)
    res["launches"] = launch_counts()
    # the projections return f32, so K3 takes an f32 query over the bf16
    # cache: mode 2 (ops/cuda/flash.py MODES)
    res["flash_modes"] = dict(MODE_LAUNCHES)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"  main-path launches {res['launches']} (K3 by mode {res['flash_modes']}), peak "
        f"memory {res['peak_mem_gib']:.2f} GiB, {res['graphs']} decode graphs captured in "
        f"{res['capture_ms']:.0f} ms (warm-up blocks included)")
    for k in ("qgemv", "qmm", "flash_attention"):
        if res["launches"][k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    if res["flash_modes"][2] <= 0:
        raise AssertionError(f"K3's f32 kernel (mode 2) was not launched on the main path: "
                             f"{res['flash_modes']}")
    del eng, kv
    torch.cuda.empty_cache()

    # --cache_dtype q8_0: the 1000-token prompt, 64 greedy tokens
    eng = InferenceEngine(replace(cfg, cache_dtype="int8"), params, device=dev)
    kv = eng.new_cache(1)
    eng.generate(prompts["prompt_1000"], gcfg, cache=kv)              # warm
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    r, _ = run(eng, kv, "q8_prompt_1000", prompts["prompt_1000"], launch_counts())
    r["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    r["flash_decode_per_step"] = r["launches"]["flash_decode"] / r["replayed_steps"]
    res["q8_prompt_1000"] = r
    log(f"  q8 cache: prefill {r['prefill_ms']:.1f} ms, {r['decode_tok_s']:.2f} decode "
        f"steps/s, peak memory {r['peak_mem_gib']:.2f} GiB, K4 launches "
        f"{r['launches']['flash_decode']} ({r['flash_decode_per_step']:.0f} per replayed step)")
    # 63 decode steps in blocks of 16: 4 replayed blocks, 64 steps, 32 K4 each
    want = cfg.num_hidden_layers * decode_launches(gcfg.max_new_tokens)
    if r["launches"]["flash_decode"] != want:
        raise AssertionError(f"q8 run: K4 launched {r['launches']['flash_decode']} times, "
                             f"expected {want} (layers x replayed steps)")
    return res


def _profile_block(eng, kv, n_past: int, trace: bool = True) -> dict:
    """One replayed decode block of 16 greedy steps at `n_past` (its graph
    already captured) timed with CUDA events, then, with `trace`, once more
    under torch.profiler: the kernels' device time by name, and their sum
    over the block's time on the card (the device's busy share; None when
    the profiler sees no device time)."""
    from chatllm_tpu_torch.runtime.generate import GenerationConfig

    scfg = GenerationConfig(do_sample=False).sampler_config()    # the engine's key
    dec, st = eng.decoder, eng.decoder.state(1)
    kv_len = eng.decode_kv_len(kv, n_past + DECODE_BLOCK)

    def block():
        st.n_past.fill_(n_past)
        return dec.run(st, kv, scfg, DECODE_BLOCK, kv_len)

    graphs = dec.num_graphs()
    block()
    torch.cuda.synchronize()
    if dec.num_graphs() != graphs:
        raise AssertionError("the profiled block captured a new graph")
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        t0.record()
        block()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    block_ms = float(np.median(times))
    if not trace:
        return {"block_ms": block_ms, "step_ms": block_ms / DECODE_BLOCK}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        block()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1000.0
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:10]
    return {"block_ms": block_ms, "step_ms": block_ms / DECODE_BLOCK,
            "kernel_ms": dev_ms or None,
            "busy_share": dev_ms / block_ms if dev_ms else None,
            "top_kernels_ms": {k: v for k, v in top}, "kernels_ms": by_name}


def graph_decode_phase(dev, cfg, params, name: str, *, tied: bool = False) -> dict:
    """CUDA-graph decode against the uncaptured loop at full width (max_length
    8192): over a bf16 and a q8 cache, the 1000-token prompt and 64 greedy
    tokens through InferenceEngine, once with its decode blocks uncaptured
    (`cuda_graphs=False`, the reference) and once replayed from graphs, each
    counted after one warm run on the cache it keeps.  The tokens must be
    identical.  (The uncaptured engine needs no warm run: the kernels are
    loaded.)  Both runs launch 64 steps (63 decode steps in 4 blocks of
    16), exactly: K1 7 x layers per step (+ the lm_head when untied; + one
    for the prefill's last row), K4 once per layer and step over the q8
    cache.  Recorded: eager and graph decode steps/s in the same call, the
    graphs and their capture ms, peak memory, and one replayed block timed
    and profiled (`_profile_block`)."""
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine, PerfInfo

    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 1000).tolist()
    gcfg = GenerationConfig(do_sample=False, max_new_tokens=64)
    L = cfg.num_hidden_layers
    steps = decode_launches(gcfg.max_new_tokens)
    res = {}
    for cache in ("bfloat16", "int8"):
        c = replace(cfg, cache_dtype=cache)
        want = {"qgemv": (7 * L + (0 if tied else 1)) * steps + (0 if tied else 1),
                "flash_decode": L * steps if cache == "int8" else 0}
        runs = {}
        for mode in ("eager", "graph"):
            eng = InferenceEngine(c, params, device=dev, cuda_graphs=mode == "graph")
            kv = eng.new_cache(1)
            t0 = time.perf_counter()
            if mode == "graph":
                eng.generate(ids, gcfg, cache=kv)               # warm: captures
            warm_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launch_counts()
            perf = PerfInfo()
            out, kv, n_past = eng.generate(ids, gcfg, perf=perf, cache=kv)
            torch.cuda.synchronize()
            got = launch_counts()
            dec = eng.decoder
            r = {"tokens": out, "n_past": n_past, "prefill_ms": perf.prompt_ms,
                 "decode_ms": perf.gen_ms, "decode_steps_s": (len(out) - 1) / perf.gen_ms * 1e3,
                 "launched_steps_s": steps / perf.gen_ms * 1e3, "warm_run_s": warm_s,
                 "graphs": dec.num_graphs(), "capture_ms": dec.capture_ms,
                 "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                 "launches": {k: got[k] for k in ("qgemv", "qmm", "flash_attention",
                                                  "flash_decode", "flash_decode_int8")}}
            if mode == "graph":
                r["profiled_block"] = _profile_block(eng, kv, len(ids) + 48)
            runs[mode] = r
            log(f"  {name} {cache} cache, {mode}: {r['decode_steps_s']:.2f} decode steps/s "
                f"({r['decode_ms']:.1f} ms), prefill {r['prefill_ms']:.1f} ms, warm run "
                f"{warm_s:.2f} s, {r['graphs']} graphs captured in {r['capture_ms']:.0f} ms, "
                f"peak {r['peak_mem_gib']:.2f} GiB, launches {r['launches']}")
            if len(out) != gcfg.max_new_tokens or n_past != len(ids) + len(out) - 1:
                raise AssertionError(f"{name} {cache} {mode}: {len(out)} tokens, n_past {n_past}")
            if any(got[k] != v for k, v in want.items()):
                raise AssertionError(f"{name} {cache} {mode}: launches {r['launches']}, "
                                     f"expected {want} ({steps} launched steps)")
            del eng, kv
            torch.cuda.empty_cache()
        pb = runs["graph"]["profiled_block"]
        log(f"  {name} {cache} cache: replayed block {pb['block_ms']:.2f} ms "
            f"({pb['step_ms']:.3f} per step), kernels {pb['kernel_ms']} ms, busy share "
            f"{pb['busy_share']}; top kernels {pb['top_kernels_ms']}")
        if runs["graph"]["tokens"] != runs["eager"]["tokens"]:
            raise AssertionError(f"{name} {cache}: graph tokens differ from the eager loop's:\n"
                                 f"{runs['graph']['tokens']}\n{runs['eager']['tokens']}")
        runs["graph_over_eager"] = (runs["graph"]["decode_steps_s"]
                                    / runs["eager"]["decode_steps_s"])
        res[cache] = runs
    return res


def _to_device(tree, device):
    """A parameter tree (dicts, tuples, tensors, linears) on `device`."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_device(v, device) for v in tree)
    return tree.to(device)


def _cfg_cut(cfg, n_layers: int):
    """The config of cfg's first n_layers."""
    return replace(cfg, num_hidden_layers=n_layers, layer_specs=cfg.layer_specs[:n_layers])


def _depth_cut(cfg, params, n_layers: int) -> tuple:
    """(cfg, params) of the first n_layers, the params' tensors shared."""
    return _cfg_cut(cfg, n_layers), dict(params, layers=params["layers"][:n_layers])


def _cut(params, n_layers: int, device) -> dict:
    """The first n_layers of the parameters, on `device`."""
    return _to_device(dict(params, layers=params["layers"][:n_layers]), device)


def _compare_logits(name: str, g, c, tol: float = 1e-3) -> dict:
    """Card logits g against the CPU's c: within `tol` of the logit scale,
    and the same argmax."""
    g, c = g.float().cpu(), c.float()
    if g.shape != c.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: logits shape {tuple(g.shape)} or not finite")
    err, rel = rel_err(g, c)
    r = {"max_abs_err": err, "rel_to_logit_scale": rel,
         "argmax_equal": bool(torch.equal(g.argmax(-1), c.argmax(-1))),
         "logit_scale": c.abs().max().item()}
    log(f"  {name}: {r}")
    if rel > tol or not r["argmax_equal"]:
        raise AssertionError(f"{name}: logits differ from the CPU run: rel {rel} > {tol}, "
                             "or an argmax differs")
    return r


def two_layer_phase(dev, cfg, params, tol: float = 1e-3) -> dict:
    """2-layer cuts at full width, the card (kernels) against the CPU (plain
    versions): a 40-token prefill over a bf16 cache, and one batched decode
    step of 4 slots at per-row n_past over a q8 cache (K4), both within
    `tol` of the logit scale and with the same argmax."""
    from chatllm_tpu_torch.nn.transformer import init_cache, transformer_forward
    from chatllm_tpu_torch.runtime.generate import InferenceEngine

    cfg2 = replace(cfg, num_hidden_layers=2)
    p2, p2_cpu = _cut(params, 2, dev), _cut(params, 2, "cpu")
    res = {}
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 40).tolist()
    outs = []
    for p, d in ((p2, dev), (p2_cpu, "cpu")):
        eng = InferenceEngine(cfg2, p, device=d)
        outs.append(eng.prefill(ids, eng.new_cache(1, 1024), 0)[0])
    res["two_layer_vs_cpu"] = _compare_logits("2-layer prefill card vs cpu", *outs, tol)

    cfg_q8 = replace(cfg2, cache_dtype="int8")
    gen = torch.Generator().manual_seed(5)
    caches = [init_cache(cfg_q8, 4, 8192, device=d) for d in (dev, "cpu")]
    for i in range(2):           # random q8 contents, the same on both sides
        for name in ("k", "v"):
            q8 = torch.randint(-127, 128, caches[1].k[i].shape, generator=gen,
                               dtype=torch.int32).to(torch.int8)
            sc = torch.rand(caches[1].k_scale[i].shape, generator=gen) * 0.02 + 1e-3
            for c in caches:
                getattr(c, name)[i].copy_(q8)
                getattr(c, name + "_scale")[i].copy_(sc)
    toks = torch.tensor([[11], [2024], [77777], [128000]]) % cfg.vocab_size
    n_past = torch.tensor([5, 1000, 4095, 8000])
    outs = [transformer_forward(cfg_q8, p, toks.to(d), c, n_past.to(d))[0][:, 0]
            for p, c, d in ((p2, caches[0], dev), (p2_cpu, caches[1], "cpu"))]
    res["batched_decode_vs_cpu"] = _compare_logits(
        "2-layer batched q8 decode step (4 slots) card vs cpu", *outs, tol)
    return res


# ----------------------------------------------------------- pipeline phase
PIPE_MAX_LEN = 4096                # q8 decode over >= 4096 slots takes K4
PIPE_SYS_BYTES = 190               # ~200 tokens with the template's
PIPE_TURN_BYTES = 990              # ~1000 tokens a user turn
PIPE_TURNS = 6                     # Shift fires at turns 4 and 6
PIPE_NEW = 64
SHIFT_SCALE_TOL = 1e-6             # k scales, card shift against the CPU's
SHIFT_OFF_SHARE = 1e-5             # int8 keys one step from the CPU shift's


def _llama3_tokenizer(cfg):
    """Llama-3's tokenizer and chat template over a byte-level vocab of the
    model's size (a narrow GGMM written for its vocab, every reserved id a
    visible piece)."""
    from chatllm_tpu_torch.ggmm.reader import GGMMFile
    from chatllm_tpu_torch.models.base import BaseConfig
    from chatllm_tpu_torch.models.llama import make_llama3_tokenizer
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = write_llama3_ggmm(BUILD_DIR / f"smoke_llama3_vocab{cfg.vocab_size}.bin",
                             vocab_pad=cfg.vocab_size, hidden=64, heads=2, kv_heads=1,
                             layers=1, inter=128, dtype=0, visible_reserved=True)
    gf = GGMMFile.open(str(path))
    return make_llama3_tokenizer(gf, BaseConfig.parse(gf)[0])


def _pipe_texts(seed: int = 0) -> tuple[str, list]:
    """The system prompt and the user turns: lowercase words, one token a
    byte under the byte-level vocab."""
    rng = np.random.default_rng(seed)

    def text(n):
        words, size = [], 0
        while size < n:
            w = "".join(chr(97 + c) for c in rng.integers(0, 26, int(rng.integers(2, 9))))
            words.append(w)
            size += len(w) + 1
        return " ".join(words)[:n]
    return text(PIPE_SYS_BYTES), [text(PIPE_TURN_BYTES) for _ in range(PIPE_TURNS)]


class _Tokens:
    """A streamer that keeps the streamed ids."""
    tokenizer = None

    def __init__(self):
        self.ids = []

    def put(self, ids):
        self.ids.extend(int(t) for t in ids)

    def end(self):
        pass


def _pipe_model(cfg, params, tok, dev):
    """A chat model (BaseLLM) over the given parameters and tokenizer, its
    engine holding PIPE_MAX_LEN slots."""
    from chatllm_tpu_torch.models.base import BaseLLM
    from chatllm_tpu_torch.models.model_types import ModelType
    from chatllm_tpu_torch.runtime.generate import InferenceEngine

    m = BaseLLM(ModelType.LLAMA3, cfg, params, tok, torch.device(dev))
    m._engine = InferenceEngine(cfg, params, device=dev, max_length=PIPE_MAX_LEN)
    return m


def _cache_tensors(c) -> list:
    return [*c.k, *c.v, *(c.k_scale or ()), *(c.v_scale or ())]


def _cache_ptrs(c) -> list:
    return [t.data_ptr() for t in _cache_tensors(c)]


def _cache_copy(c, device):
    """A copy of cache `c` on `device`."""
    from chatllm_tpu_torch.nn.transformer import KVCache

    def cp(ts):
        return None if ts is None else [t.to(device, copy=True) for t in ts]
    return KVCache(k=cp(c.k), v=cp(c.v), k_scale=cp(c.k_scale), v_scale=cp(c.v_scale))


def shift_vs_cpu(card, cpu, keep: int) -> dict:
    """The card's shifted cache against the port's shift run on the CPU over
    a copy of the same cache: V, the scales of V and the kept rows
    bit-equal; k int8 values at most one step apart (a requantization that
    rounds a tie apart: the two devices' cos/sin and products may differ in
    the last bit), counted, in at most SHIFT_OFF_SHARE of the entries (full
    width reads 7.2e-7 to 7.5e-7: ties are rare, a biased or tie-blind
    requantization moves far more); k scales within SHIFT_SCALE_TOL
    relative."""
    off, n, scale_rel = 0, 0, 0.0
    for i in range(len(cpu.k)):
        for name in ("v", "v_scale"):
            if not torch.equal(getattr(card, name)[i].cpu(), getattr(cpu, name)[i]):
                raise AssertionError(f"shift: layer {i} {name} differs from the CPU shift")
        kg, kc = card.k[i].cpu(), cpu.k[i]
        if not torch.equal(kg[:, :keep], kc[:, :keep]):
            raise AssertionError(f"shift: layer {i} kept rows differ")
        d = (kg.int() - kc.int()).abs()
        if d.max().item() > 1:
            raise AssertionError(f"shift: layer {i} int8 keys {d.max().item()} steps apart")
        off += int((d > 0).sum())
        n += d.numel()
        sg, sc = card.k_scale[i].cpu(), cpu.k_scale[i]
        rel = ((sg - sc).abs() / sc.abs().clamp_min(1e-30)).max().item()
        scale_rel = max(scale_rel, rel)
    if scale_rel > SHIFT_SCALE_TOL:
        raise AssertionError(f"shift: k scales {scale_rel} relative from the CPU's")
    if off > SHIFT_OFF_SHARE * n:
        raise AssertionError(f"shift: {off} of {n} int8 keys one step from the CPU shift's, "
                             f"above the share {SHIFT_OFF_SHARE}")
    return {"int8_off_by_one": off, "int8_entries": n, "off_by_one_share": off / n,
            "k_scale_max_rel": scale_rel}


def _pipe_run(dev, model, method, sys_prompt, turns, *, save_after=None, on_shift=None,
              on_prefill=None, check_launches=True):
    """Chat `turns` through a Pipeline over `model` with its system prompt
    pre-evaluated; per turn: the reply's ids, n_past, decode steps/s, the
    graphs it captured (none for a bucket captured before), and, with
    `check_launches`, K1 (225) and K4 (32, q8 cache) launches per decode
    step, warm-up and replayed, counted apart from the prefill's.  Shifts go
    through `on_shift(cache, shift, keep, n_past, run)` when given."""
    from chatllm_tpu_torch.ops.cuda.build import launch_counts
    from chatllm_tpu_torch.ops.cuda.flash import MODE_LAUNCHES
    from chatllm_tpu_torch.runtime.generate import GenerationConfig
    from chatllm_tpu_torch.runtime.pipeline import ExtendingMethod, Pipeline

    eng, dec = model.engine, model.engine.decoder
    cfg = model.cfg
    L = cfg.num_hidden_layers
    q8 = cfg.cache_dtype == "int8"
    pipe = Pipeline(model, extending=ExtendingMethod(method))
    pipe.gen_config = GenerationConfig(do_sample=False, max_new_tokens=PIPE_NEW)
    model.tokenizer.sys_prompt = sys_prompt
    pipe.eval_sys_prompt()
    n0 = pipe.initial_n_past
    sys_rows = [t[:, :n0].clone() for t in _cache_tensors(pipe._cache)]
    res = {"initial_n_past": n0, "turns": [], "shifts": [], "prefills": []}
    pre = {"k1": 0, "k4": 0, "modes": 0}
    prefill = eng.prefill

    def counted_prefill(ids, cache, n_past, **kw):
        b, m = launch_counts(), MODE_LAUNCHES[2]
        out = prefill(ids, cache, n_past, **kw)
        a = launch_counts()
        pre["k1"] += a["qgemv"] - b["qgemv"]
        pre["k4"] += a["flash_decode"] - b["flash_decode"]
        pre["modes"] += MODE_LAUNCHES[2] - m
        res["prefills"].append({"tokens": len(ids), "n_past": n_past})
        if on_prefill is not None:
            on_prefill(ids, n_past, out)
        return out

    shift_impl = eng.shift_cache

    def shifted(cache, shift, keep, n_past):
        ev = {"turn": len(res["turns"]), "shift": shift, "keep": keep, "n_past_before": n_past,
              "n_past_after": n_past - shift}
        ptrs = _cache_ptrs(cache)
        out = on_shift(cache, shift, keep, n_past, ev, shift_impl) if on_shift else \
            shift_impl(cache, shift, keep, n_past)
        if out is not cache or _cache_ptrs(cache) != ptrs:
            raise AssertionError("the shift did not write the cache in place")
        res["shifts"].append(ev)
        return out

    eng.prefill, eng.shift_cache = counted_prefill, shifted
    try:
        for ti, text in enumerate(turns):
            buckets = {k[2] for k in dec._graphs}
            graphs, warm, rep = dec.num_graphs(), dec.eager_steps, dec.replayed_steps
            pre.update(k1=0, k4=0, modes=0)
            before, perf0 = launch_counts(), (model.perf.gen_ms, model.perf.gen_tokens)
            toks = _Tokens()
            torch.cuda.synchronize()
            pipe.chat(text, toks)
            torch.cuda.synchronize()
            after = launch_counts()
            steps = (dec.eager_steps - warm) + (dec.replayed_steps - rep)
            new = [k[2] for k in list(dec._graphs)[graphs:]]
            gen_ms = model.perf.gen_ms - perf0[0]
            t = {"reply_ids": toks.ids, "n_past": pipe.n_past, "decode_steps": steps,
                 "replayed_steps": dec.replayed_steps - rep,
                 "decode_steps_s": (len(toks.ids) - 1) / gen_ms * 1e3 if gen_ms else None,
                 "captured_buckets": new, "k3_mode2_in_prefill": pre["modes"],
                 "k1_decode": after["qgemv"] - before["qgemv"] - pre["k1"],
                 "k4_decode": after["flash_decode"] - before["flash_decode"] - pre["k4"]}
            res["turns"].append(t)
            if not all(torch.equal(t_[:, :n0], r_) for t_, r_ in
                       zip(_cache_tensors(pipe._cache), sys_rows)):
                raise AssertionError(f"turn {ti}: the system prompt's cache rows changed")
            if any(b in buckets for b in new):
                raise AssertionError(f"turn {ti}: captured a graph for a bucket captured "
                                     f"before ({new} over {sorted(buckets)})")
            if check_launches:
                want_k1, want_k4 = (7 * L + 1) * steps, (L * steps if q8 else 0)
                if (t["k1_decode"], t["k4_decode"]) != (want_k1, want_k4) or pre["k4"]:
                    raise AssertionError(f"turn {ti}: K1 {t['k1_decode']} / K4 {t['k4_decode']}"
                                         f" decode launches, expected {want_k1} / {want_k4} "
                                         f"({steps} steps; K4 in the prefill {pre['k4']})")
            if save_after is not None and ti == save_after[0]:
                t0 = time.perf_counter()
                pipe.save_session(save_after[1])
                res["session_save_ms"] = (time.perf_counter() - t0) * 1e3
                res["session_bytes"] = Path(save_after[1]).stat().st_size
    finally:
        del eng.prefill, eng.shift_cache
    res["graphs"], res["capture_ms"] = dec.num_graphs(), dec.capture_ms
    res["pipe"] = pipe
    return res


def _session_continue(dev, model, method, path, turn_text, want_ids) -> dict:
    """A fresh Pipeline loads the session and runs one turn: its greedy ids
    must equal the uninterrupted pipeline's; the captures of the new cache
    are counted and timed."""
    from chatllm_tpu_torch.runtime.generate import GenerationConfig
    from chatllm_tpu_torch.runtime.pipeline import ExtendingMethod, Pipeline

    dec = model.engine.decoder
    pipe = Pipeline(model, extending=ExtendingMethod(method))
    pipe.gen_config = GenerationConfig(do_sample=False, max_new_tokens=PIPE_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.load_session(path)
    torch.cuda.synchronize()
    r = {"load_ms": (time.perf_counter() - t0) * 1e3, "n_past": pipe.n_past}
    graphs, cap = dec.num_graphs(), dec.capture_ms
    toks = _Tokens()
    pipe.chat(turn_text, toks)
    torch.cuda.synchronize()
    r.update(captures=dec.num_graphs() - graphs, capture_ms=dec.capture_ms - cap,
             tokens_equal=toks.ids == want_ids, n_past_after=pipe.n_past)
    if toks.ids != want_ids:
        raise AssertionError(f"{method} session: the loaded pipeline's turn differs:\n"
                             f"{toks.ids}\n{want_ids}")
    del pipe
    return r


def _smi_clocks() -> str:
    """The card's SM and memory clocks, temperature and power draw now."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
                           "power.draw", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def pipeline_phase(dev, cfg, params, card: str) -> dict:
    """The chat Pipeline at full Llama-3-8B width (the llama3_8b phase's
    random q4_k weights, Llama-3's NORMAL rope layout, a byte-level Llama-3
    chat tokenizer of the model's vocab, PIPE_MAX_LEN slots): a ~200-token
    system prompt pre-evaluated, then ~1000-token turns of 64 greedy tokens.
      - q8 cache, Shift: at least two Shifts, each in place (every cache
        tensor's data_ptr kept), timed and held against the port's shift run
        on the CPU over a copy of the cache taken just before it
        (`shift_vs_cpu`); no turn captures a graph for a bucket captured
        before; K1 7 a layer + 1 and K4 one a layer per decode step in every
        turn;
      - a session saved after turn 2 and loaded into a fresh Pipeline, whose
        turn 3 has the uninterrupted pipeline's greedy ids;
      - bf16 cache, Restart, four turns: K3's mode 2 in each ~1000-token
        prefill; after the overflow the prefill starts at initial_n_past and
        the system prompt's rows are bit-equal to before; its session too;
      - a 2-layer cut of the same Shift chat against the CPU: at each
        Shift the CPU takes the card's cache as it was just before, shifts
        it, prefills the next turn and takes one decode step on the card's
        token; the logits of both (the first steps that read the shifted
        cache) within 1e-3 of the logit scale, argmax equal.  The cut runs
        first; its CPU side runs in a worker thread during the full-width
        runs and is compared after them.  `spans_s` gives the seconds of
        each part."""
    from chatllm_tpu_torch.ops.rope import ROPE_NORMAL
    from chatllm_tpu_torch.nn.transformer import transformer_forward
    from chatllm_tpu_torch.runtime.generate import InferenceEngine, shift_cache

    t_phase = time.perf_counter()
    spans = {}                     # seconds of each part, for the phase's budget
    mark = [t_phase]

    def span(name):
        now = time.perf_counter()
        spans[name] = spans.get(name, 0.0) + now - mark[0]
        mark[0] = now
    cfg = replace(cfg, max_length=PIPE_MAX_LEN, rope=replace(cfg.rope, layout=ROPE_NORMAL))
    tok = _llama3_tokenizer(cfg)
    sys_prompt, turns = _pipe_texts()
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR

    out_dir = BUILD_DIR            # sessions of hundreds of MB: kept out of OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {"card": card, "smi_start": _smi_clocks()}
    span("setup")

    # ---- a 2-layer cut of the Shift chat against the CPU: the card side
    # first; the CPU side (~35 s of plain versions on the host) runs in a
    # worker thread while the full-width runs below keep the card busy, and
    # is compared after them
    cfg2 = replace(cfg, cache_dtype="int8", num_hidden_layers=2)
    p2, p2_cpu = _cut(params, 2, dev), _cut(params, 2, "cpu")
    model2 = _pipe_model(cfg2, p2, tok, dev)
    cpu_eng = InferenceEngine(cfg2, p2_cpu, device="cpu", max_length=PIPE_MAX_LEN)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 2))  # host cores left for the card's dispatch
    worker = ThreadPoolExecutor(1)
    pending, cuts = {}, []

    def keep_snapshot(cache, shift, keep, n_past, ev, impl):
        pending.update(snap=_cache_copy(cache, "cpu"), shift=shift, keep=keep)
        return impl(cache, shift, keep, n_past)

    @torch.inference_mode()
    def cpu_side(ids, n_past, snap, shift, keep, tok_):
        snap = shift_cache(cfg2, snap, shift, keep)
        lc, snap, n_cpu = cpu_eng.prefill(ids, snap, n_past)
        return lc, transformer_forward(cfg2, p2_cpu, tok_, snap, n_cpu)[0][:, -1]

    def compare_after_shift(ids, n_past, out):
        if not pending:
            return
        logits, cache, n_end = out
        tok_ = logits.argmax(-1).reshape(1, 1)
        kv_card = _cache_copy(cache, dev)       # the card's step runs on a copy
        with torch.inference_mode():
            step_card = transformer_forward(cfg2, p2, tok_, kv_card, n_end)[0][:, -1]
        cuts.append((logits.float().cpu(), step_card.float().cpu(),
                     worker.submit(cpu_side, ids, n_past, pending["snap"], pending["shift"],
                                   pending["keep"], tok_.cpu())))
        pending.clear()

    r2 = _pipe_run(dev, model2, "shift", sys_prompt, turns, on_shift=keep_snapshot,
                   on_prefill=compare_after_shift, check_launches=False)
    r2.pop("pipe")
    if len(cuts) < 2:
        raise AssertionError(f"2-layer cut: {len(cuts)} Shifts compared, expected >= 2")
    del model2, p2
    torch.cuda.empty_cache()
    span("cut_card")

    # ---- q8 cache, Shift, at full width
    cfg_q8 = replace(cfg, cache_dtype="int8")
    model = _pipe_model(cfg_q8, params, tok, dev)
    span("setup")

    def check_shift(cache, shift, keep, n_past, ev, impl):
        span("q8_turns")
        snap = _cache_copy(cache, "cpu")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = impl(cache, shift, keep, n_past)
        torch.cuda.synchronize()
        ev["shift_ms"] = (time.perf_counter() - t0) * 1e3
        ev.update(shift_vs_cpu(cache, shift_cache(cfg_q8, snap, shift, keep), keep))
        span("q8_cpu_shift_check")
        log(f"  q8 Shift at turn {ev['turn']}: n_past {n_past} -> {n_past - shift} (keep "
            f"{keep}), {ev['shift_ms']:.2f} ms; vs the CPU shift: "
            f"{ev['int8_off_by_one']} of {ev['int8_entries']} int8 keys one step apart, "
            f"k scales within {ev['k_scale_max_rel']:.2e}")
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    sess_q8 = str(out_dir / "smoke_q8.session")
    r = _pipe_run(dev, model, "shift", sys_prompt, turns, save_after=(1, sess_q8),
                  on_shift=check_shift)
    r["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    span("q8_turns")
    pipe = r.pop("pipe")        # alive over the load: the new cache gets new storage
    if len(r["shifts"]) < 2:
        raise AssertionError(f"q8 Shift pipeline: {len(r['shifts'])} Shifts, expected >= 2")
    for t in r["turns"]:
        log(f"  q8 turn: n_past {t['n_past']}, {len(t['reply_ids'])} tokens, "
            f"{t['decode_steps_s']:.2f} decode steps/s, captured {t['captured_buckets']}")
    log(f"  q8 Shift pipeline: {r['graphs']} graphs captured in {r['capture_ms']:.0f} ms, "
        f"peak {r['peak_mem_gib']:.2f} GiB; session after turn 2: {r['session_bytes']} "
        f"bytes saved in {r['session_save_ms']:.1f} ms")
    r["session"] = _session_continue(dev, model, "shift", sess_q8, turns[2],
                                     r["turns"][2]["reply_ids"])
    log(f"  q8 session: loaded in {r['session']['load_ms']:.1f} ms, turn 3 equal; "
        f"{r['session']['captures']} captures in {r['session']['capture_ms']:.0f} ms after "
        "the load")
    res["q8_shift"] = r
    Path(sess_q8).unlink()
    del model, pipe
    torch.cuda.empty_cache()
    span("q8_session")

    # ---- bf16 cache, Restart, four turns
    cfg_bf = replace(cfg, cache_dtype="bfloat16")
    model = _pipe_model(cfg_bf, params, tok, dev)
    sess_bf = str(out_dir / "smoke_bf16.session")
    r = _pipe_run(dev, model, "restart", sys_prompt, turns[:4], save_after=(1, sess_bf))
    span("bf16_turns")
    pipe = r.pop("pipe")
    n0 = r["initial_n_past"]
    starts = [p["n_past"] for p in r["prefills"]]
    restarts = [i for i, (a, b) in enumerate(zip(starts, starts[1:])) if b < a]
    if not restarts or starts[restarts[0] + 1] != n0:
        raise AssertionError(f"Restart: prefill starts {starts}, initial n_past {n0}")
    for t in r["turns"]:
        if t["k3_mode2_in_prefill"] < cfg.num_hidden_layers:
            raise AssertionError(f"Restart: K3 mode 2 launched {t['k3_mode2_in_prefill']} "
                                 "times in a ~1000-token prefill")
    r["restart_prefill_starts"] = starts
    log(f"  bf16 Restart pipeline: prefills start at {starts} (initial {n0}), K3 mode 2 "
        f"{[t['k3_mode2_in_prefill'] for t in r['turns']]} a turn, {r['graphs']} graphs in "
        f"{r['capture_ms']:.0f} ms")
    r["session"] = _session_continue(dev, model, "restart", sess_bf, turns[2],
                                     r["turns"][2]["reply_ids"])
    log(f"  bf16 session: {r['session_bytes']} bytes, saved in {r['session_save_ms']:.1f} ms, "
        f"loaded in {r['session']['load_ms']:.1f} ms, turn 3 equal; "
        f"{r['session']['captures']} captures in {r['session']['capture_ms']:.0f} ms")
    res["bf16_restart"] = r
    Path(sess_bf).unlink()
    del model, pipe
    torch.cuda.empty_cache()
    span("bf16_session")

    # ---- the 2-layer cut's CPU side, against the card's logits
    compared = []
    for i, (logits, step_card, fut) in enumerate(cuts):
        lc, step_cpu = fut.result()
        compared.append({"prefill": _compare_logits(f"2-layer Shift {i} prefill card vs cpu",
                                                    logits, lc),
                         "decode_step": _compare_logits(f"2-layer Shift {i} first decode "
                                                        "step card vs cpu", step_card,
                                                        step_cpu)})
    worker.shutdown()
    torch.set_num_threads(threads)
    res["two_layer_cut"] = {"shifts": r2["shifts"], "compared": compared}
    span("cut_cpu_wait")
    res["seconds"], res["spans_s"] = time.perf_counter() - t_phase, spans
    res["smi_end"] = _smi_clocks()
    log(f"  card at the phase's start / end: {res['smi_start']} / {res['smi_end']}")
    log(f"  pipeline phase: {res['seconds']:.1f} s on {card}; seconds by part "
        f"{ {k: round(v, 2) for k, v in spans.items()} }")
    return res


# ------------------------------------------------------------- serve phase
SERVE_PROMPT_BYTES = (20, 80, 150, 260, 400, 560, 760, 980)


def serve_phase(dev, cfg, params, *, model_type=None, tok=None, name="llama3-8b-synthetic",
                prompt_bytes=SERVE_PROMPT_BYTES, max_new: int = 32, slots: int = 4) -> dict:
    """Full-width Llama-3-8B (q8 cache, max_length 8192) behind the HTTP
    server with 4 slots: 8 chat requests of ~30 to ~1000 tokens, 32 greedy
    tokens each, first one at a time, then all at once from 8 threads.
    Another model passes its type, its tokenizer, the prompts' lengths in
    bytes, the tokens per request and the slots."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from chatllm_tpu_torch.models import load_model
    from chatllm_tpu_torch.models.base import BaseLLM
    from chatllm_tpu_torch.models.model_types import ModelType
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR, launch_counts, reset_launch_counts
    from chatllm_tpu_torch.runtime.generate import GenerationConfig
    from chatllm_tpu_torch.serve.server import ApiServer, _make_handler

    # the tokenizer of a narrow GGMM with Llama-3's vocab size, so that every
    # id the random model emits decodes, to visible text; its weights stay
    # unused
    if tok is None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = write_llama3_ggmm(BUILD_DIR / "smoke_vocab128256.bin", vocab_pad=cfg.vocab_size,
                                 hidden=64, heads=2, kv_heads=1, layers=1, inter=128,
                                 dtype=0, visible_reserved=True)           # GGMLType.F32
        tok = load_model(str(path), device="cpu").tokenizer
    model = BaseLLM(int(model_type or ModelType.LLAMA3), replace(cfg, cache_dtype="int8"),
                    params, tok, dev)
    api = ApiServer(model, model_name=name, max_slots=slots, device=dev,
                    gen_config=GenerationConfig(do_sample=False, max_new_tokens=max_new))
    produced = []                 # token ids per request, in submission order
    submit = api.batch.submit

    def counting_submit(ids, **kw):
        h, toks = submit(ids, **kw), []
        produced.append((tuple(ids), toks))

        class Counted:
            def __iter__(self):
                for t in h:
                    toks.append(t)
                    yield t
        return Counted()

    api.batch.submit = counting_submit
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(api))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}/v1/chat/completions"
    rng = np.random.default_rng(3)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    prompts = ["".join(rng.choice(letters, n)) for n in prompt_bytes]

    def request(text, rec):
        body = json.dumps({"messages": [{"role": "user", "content": text}],
                           "stream": True}).encode()
        t0 = time.perf_counter()
        req = urllib.request.Request(url, body, {"Content-Type": "application/json"})
        parts, first = [], None
        with urllib.request.urlopen(req, timeout=600) as r:
            for line in r:
                line = line.strip()
                if not line.startswith(b"data: ") or line == b"data: [DONE]":
                    continue
                if first is None:
                    first = time.perf_counter() - t0
                parts.append(json.loads(line[6:])["choices"][0]["delta"].get("content", ""))
        rec.update(text="".join(parts), ttfb_s=first, total_s=time.perf_counter() - t0)

    request(prompts[0][:10], {})                            # warm-up
    produced.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    seq = [{} for _ in prompts]
    t0 = time.perf_counter()
    for text, rec in zip(prompts, seq):
        request(text, rec)
    seq_s = time.perf_counter() - t0
    seq_tokens = dict(produced)
    produced.clear()
    conc = [{} for _ in prompts]
    threads = [threading.Thread(target=request, args=(text, rec))
               for text, rec in zip(prompts, conc)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    conc_s = time.perf_counter() - t0
    launches = launch_counts()
    httpd.shutdown()
    api.batch.shutdown()
    conc_tokens = dict(produced)          # prompt ids -> generated ids
    n_seq = sum(map(len, seq_tokens.values()))
    n_conc = sum(map(len, conc_tokens.values()))
    res = {"prompt_tokens": [len(api._encode_chat([{"role": "user", "content": t}]))
                             for t in prompts],
           "sequential": {"wall_s": seq_s, "gen_tokens": n_seq,
                          "decode_tok_s": n_seq / seq_s, "requests": seq},
           "concurrent": {"wall_s": conc_s, "gen_tokens": n_conc,
                          "decode_tok_s": n_conc / conc_s, "requests": conc},
           "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    for name in ("sequential", "concurrent"):
        r = res[name]
        log(f"  serve {name}: {r['gen_tokens']} tokens in {r['wall_s']:.2f} s "
            f"({r['decode_tok_s']:.2f} tok/s aggregate); ttfb s "
            f"{[round(x['ttfb_s'], 3) for x in r['requests']]}, last byte s "
            f"{[round(x['total_s'], 3) for x in r['requests']]}")
    log(f"  serve launches {launches}, peak memory {res['peak_mem_gib']:.2f} GiB, "
        f"prompt tokens {res['prompt_tokens']}")
    if [r["text"] for r in conc] != [r["text"] for r in seq] or not all(
            r["text"] for r in seq):
        raise AssertionError("concurrent replies differ from the sequential ones:\n"
                             f"{[r['text'] for r in seq]}\n{[r['text'] for r in conc]}")
    if conc_tokens != seq_tokens or len(seq_tokens) != len(prompts) or n_seq == 0:
        raise AssertionError("concurrent token ids differ from the sequential ones")
    for k in ("qmm", "flash_decode"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the server")
    res["replies"] = [r["text"] for r in seq]
    return res


# --------------------------------------------------------------- cli phase
CLI_WORKERS = 8                    # CLI processes at a time, on 8 host cores
# one intra-op thread a CLI process: with PyTorch's default of one a core,
# eight processes' narrow CPU chats spin their OpenMP threads against each
# other (six --device cpu chats took 29.4 s so and 3.7 s with one thread
# each on an 8-core host; transcripts identical)
# The machine's interpreter writes no bytecode, so every process compiles
# PyTorch's Python sources again (9-10 s an import there): the processes
# this script starts cache them under the build directory (5.4 s an import)
SUBPROCESS_ENV = dict(os.environ, PYTHONDONTWRITEBYTECODE="",
                      PYTHONPYCACHEPREFIX=str(ROOT / "chatllm_tpu_torch" / "_build" / "pycache"))
CLI_ENV = dict(SUBPROCESS_ENV, OMP_NUM_THREADS="1")
CLI_POOL = ThreadPoolExecutor(CLI_WORKERS)   # the CLI processes' threads, one queue for all
CLI_SYS = "You are a terse assistant on an H100."
CLI_TURNS = 7                      # Shift fires several times in 256 slots


def _start_cli(jobs: dict) -> dict:
    """Start `python -m chatllm_tpu_torch.main` once per job (name -> (argv,
    stdin or None)) on CLI_POOL, CLI_WORKERS processes at a time, the jobs
    of every phase in one queue; returns name -> the future of (stdout,
    seconds).  The jobs are independent, so running them side by side only
    moves the perf lines, which no check compares."""
    def one(name, args, stdin):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "chatllm_tpu_torch.main", *args], cwd=ROOT,
                           capture_output=True, text=True, timeout=300, input=stdin, env=CLI_ENV)
        if r.returncode != 0:
            raise AssertionError(f"cli {name} {args} exit {r.returncode}:\n{r.stdout}\n"
                                 f"{r.stderr}")
        return r.stdout, time.perf_counter() - t0

    return {name: CLI_POOL.submit(one, name, args, stdin)
            for name, (args, stdin) in jobs.items()}


def _cli_outputs(futs: dict, what: str) -> dict:
    """Wait for `_start_cli`'s jobs; returns name -> stdout and logs the
    processes' seconds."""
    done = {name: f.result() for name, f in futs.items()}
    secs = sorted(t for _, t in done.values())
    log(f"  {what}: {len(secs)} CLI processes of {secs[0]:.1f} to {secs[-1]:.1f} s, median "
        f"{secs[len(secs) // 2]:.1f} s")
    return {name: out for name, (out, _) in done.items()}


def _run_cli(jobs: dict, what: str = "cli") -> dict:
    """`_start_cli` and wait: name -> stdout."""
    return _cli_outputs(_start_cli(jobs), what)


def _chat_lines(s: str) -> list:
    """A transcript without its two perf lines."""
    return [ln for ln in s.splitlines() if "eval time:" not in ln]


def _replies(out: str) -> list:
    """The A.I. replies of a --test or -i transcript, in order."""
    out = out[:out.index("prompt eval time")]
    segs = [s.split("A.I. > ", 1)[1] for s in out.split("You  > ")[1:] if "A.I. > " in s]
    return [s[:-1] if s.endswith("\n") else s for s in segs]


def cli_start() -> dict:
    """`cli_phase`'s GGMMs written and its calls but the two that load a
    session started on CLI_POOL, so that they run beside the phases before
    `cli_phase` collects them."""
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR

    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = write_llama3_ggmm(BUILD_DIR / "smoke_llama3_q4k.bin")
    path_q8 = write_llama3_ggmm(BUILD_DIR / "smoke_llama3_q4k_4096.bin", max_len=4096)
    path_qwen = write_qwen2_ggmm(BUILD_DIR / "smoke_qwen2_q8_0.bin")
    path_ds = write_deepseek_v2_ggmm(BUILD_DIR / "smoke_dsv2_q4k_4096.bin", max_len=4096)
    chat = ["-p", "Hello from the H100!", "-t", "0", "--max_new_tokens", "8"]
    models = (("transcript", ["-m", str(path)]),
              ("transcript_q8", ["-m", str(path_q8), "--cache_dtype", "q8_0"]),
              ("transcript_qwen2", ["-m", str(path_qwen)]),
              ("transcript_dsv2_q8", ["-m", str(path_ds), "--mla_cache", "speed",
                                      "--cache_dtype", "q8_0"]),
              ("transcript_dsv2_latent", ["-m", str(path_ds), "--mla_cache", "memory"]))
    jobs = {(name, i): (chat + extra, None) for name, extra in models for i in range(2)}
    # a narrow InternVL (q4_k Qwen3 behind a 2-layer InternViT) asked about a
    # 120 x 90 PNG through --multimedia_file_tags, on the card and on the CPU
    # (f32 activations: the two runs' logits differ at the f32 level only)
    path_ivl = write_internvl_ggmm(BUILD_DIR / "smoke_internvl_q4k.bin")
    png = write_png(BUILD_DIR / "smoke_internvl_120x90.png", ivl_image(5, (90, 120)))
    ivl = ["-m", str(path_ivl), "--multimedia_file_tags", "{{", "}}", "-p",
           f"What is in this picture? {{{{image:{png}}}}}", "-t", "0", "--max_new_tokens", "8",
           "--compute_dtype", "f32"]
    jobs.update({("transcript_internvl", "card"): (ivl, None),
                 ("transcript_internvl", "cpu"): (ivl + ["--device", "cpu"], None)})
    pipe_jobs, check_pipe = cli_pipeline_jobs(path)
    return {"t0": t0, "models": models, "calls": len(jobs) + len(pipe_jobs) + 2,
            "check_pipe": check_pipe, "futures": _start_cli({**jobs, **pipe_jobs})}


def cli_phase(started: dict) -> dict:
    """Greedy CLI chats, two per model, whose transcripts must be
    byte-identical: a narrow Llama-3 over a bf16 cache, the same with
    `--cache_dtype q8_0` at a 4096-token context (K4 on every decode step),
    a narrow Qwen2 (ChatML control tokens, biased q/k/v, tied head, q8_0
    weights), and a narrow DeepSeek-V2 (q4_k, 8 routed experts + 2 shared,
    MLA's 192 / 128 head widths, YaRN) at a 4096-token context with
    `--mla_cache speed --cache_dtype q8_0` (K4 at (192, 128) on every
    decode step) and `--mla_cache memory` (the latent cache, bf16); a narrow
    InternVL asked about a PNG through `--multimedia_file_tags` on the card
    and on the CPU (`--device cpu`), whose transcripts must be equal; then
    the chat pipeline's flags (`cli_pipeline_jobs`).  Every call but the two
    that load a session was started by `cli_start`."""
    outs = _cli_outputs(started["futures"], "cli")
    models, check_pipe = started["models"], started["check_pipe"]
    res = {}
    card, cpu = outs[("transcript_internvl", "card")], outs[("transcript_internvl", "cpu")]
    log("  transcript_internvl:\n" + card.rstrip())
    if card != cpu or "A.I. > " not in card:
        raise AssertionError(f"the InternVL image transcript differs between the card and the "
                             f"CPU:\n{card}\n---\n{cpu}")
    res["transcript_internvl"] = card
    for name, _ in models:
        runs = [outs[(name, i)] for i in range(2)]
        log(f"  {name}:\n" + runs[0].rstrip())
        for s in runs:
            if sum("eval time:" in ln for ln in s.splitlines()) != 2:
                raise AssertionError(f"perf lines missing:\n{s}")
        if _chat_lines(runs[0]) != _chat_lines(runs[1]):
            raise AssertionError(f"greedy transcripts differ:\n{runs[0]}\n---\n{runs[1]}")
        res[name] = runs[0]
    res["pipeline_flags"] = check_pipe(outs)
    res["calls"] = started["calls"]
    res["seconds"] = time.perf_counter() - started["t0"]
    log(f"  cli phase: {res['calls']} calls, {CLI_WORKERS} at a time, in {res['seconds']:.1f} s")
    return res


def cli_pipeline_jobs(path):
    """The chat pipeline's CLI flags on the narrow q4_k Llama-3: the jobs of
    seven calls for `_run_cli`, and the function that checks their outputs
    after running the two calls that need one of them:
      - `--test` of seven turns with `--extending shift -l 256 -s ... --cache_dtype
        q8_0 --re_quantize q8_0 --layer_spec 0:2,1:2` (the reference);
      - the same flags with `-i`, the first six turns on stdin, and
        `--save_session`: its six replies equal the reference's;
      - `--load_session` of that file with the seventh turn as `-p`, twice:
        byte-identical transcripts, the reply equal to the reference's
        seventh;
      - a sampled chat (`-t 0.8 -k 40 -q 0.9 --seed 7 --repeat_penalty 1.1
        --penalty_window 64 --format completion`) and one with `--sampling
        tfs --tfs_z 0.9`, each twice: byte-identical transcripts;
      - `--tokenize`: the ids the port's tokenizer gives in this process."""
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR

    rng = np.random.default_rng(7)
    turns = [f"turn {i}: " + " ".join("".join(chr(97 + c) for c in rng.integers(0, 26, 5))
                                      for _ in range(12)) for i in range(CLI_TURNS)]
    test_file = BUILD_DIR / "smoke_turns.txt"
    test_file.write_text("\n".join(turns) + "\n", encoding="utf-8")
    sess = BUILD_DIR / "smoke_cli.session"
    sess.unlink(missing_ok=True)
    m = ["-m", str(path)]
    chat_flags = m + ["-t", "0", "--max_new_tokens", "8", "--extending", "shift", "-l", "256",
                      "-s", CLI_SYS, "--cache_dtype", "q8_0", "--re_quantize", "q8_0",
                      "--layer_spec", "0:2,1:2"]
    sampled = m + ["-p", "Hello from the H100!", "--max_new_tokens", "16", "--seed", "7",
                   "-t", "0.8"]
    samplings = (("top_p", ["-k", "40", "-q", "0.9", "--repeat_penalty", "1.1",
                            "--penalty_window", "64", "--format", "completion"]),
                 ("tfs", ["--sampling", "tfs", "--tfs_z", "0.9"]))
    text = "Tokenize this, H100: 1 2 3 ok?"
    jobs = {"test": (chat_flags + ["--test", str(test_file)], None),
            "interactive": (chat_flags + ["-i", "--save_session", str(sess)],
                            "\n".join(turns[:-1]) + "\n"),
            "tokenize": (m + ["-p", text, "--tokenize"], None)}
    jobs.update({(name, i): (sampled + extra, None) for name, extra in samplings
                 for i in range(2)})

    def check(outs: dict) -> dict:
        res = {}
        ref = _replies(outs["test"])
        res["session_bytes"] = sess.stat().st_size
        if len(ref) != CLI_TURNS or _replies(outs["interactive"]) != ref[:-1]:
            raise AssertionError(f"-i replies differ from --test's:\n"
                                 f"{_replies(outs['interactive'])}\n{ref}")
        loads = _run_cli({i: (chat_flags + ["--load_session", str(sess), "-p", turns[-1]], None)
                          for i in range(2)})
        loads = [loads[0], loads[1]]
        if _chat_lines(loads[0]) != _chat_lines(loads[1]):
            raise AssertionError(f"--load_session transcripts differ:\n{loads[0]}\n{loads[1]}")
        if _replies(loads[0]) != ref[-1:]:
            raise AssertionError(f"the loaded session's reply {_replies(loads[0])} is not the "
                                 f"uninterrupted run's {ref[-1:]}")
        res.update(test_replies=ref, load_transcript=loads[0])
        log(f"  pipeline flags: --test of {CLI_TURNS} turns with Shift = -i of "
            f"{CLI_TURNS - 1} + --save_session ({res['session_bytes']} bytes) + "
            f"--load_session; reply 7: {ref[-1]!r}")
        for name, _ in samplings:
            runs = [_chat_lines(outs[(name, i)]) for i in range(2)]
            if runs[0] != runs[1]:
                raise AssertionError(f"sampled ({name}) transcripts differ with one seed:\n"
                                     f"{runs}")
            res[f"sampled_{name}"] = runs[0]
            log(f"  sampled {name}, seed 7, twice: {runs[0][1]!r}")
        from chatllm_tpu_torch.ggmm.reader import GGMMFile
        from chatllm_tpu_torch.models.base import BaseConfig
        from chatllm_tpu_torch.models.llama import make_llama3_tokenizer

        got = outs["tokenize"].strip()
        gf = GGMMFile.open(str(path))
        want = str(make_llama3_tokenizer(gf, BaseConfig.parse(gf)[0]).encode(text))
        if got != want:
            raise AssertionError(f"--tokenize printed {got}, expected {want}")
        res["tokenize"] = got
        return res

    return jobs, check


# -------------------------------------------------------------- bench phase
BENCH_KEYS = ("value", "ttft_ms_512", "ttft_ms_2048", "batched8_tok_s", "batched32_tok_s",
              "batched32_q8kv_tok_s", "bw_measured_gb_s", "bw_achieved_gb_s",
              "roofline_tok_s", "vs_baseline", "prefill_mfu")


def _forced_decode(cfg, params, cache, feed):
    """Feed `feed[:, i]` at position i; returns (the argmax after every
    step [B, steps], the last step's logits [B, V])."""
    from chatllm_tpu_torch.nn.transformer import transformer_forward

    toks = []
    with torch.inference_mode():
        for i in range(feed.shape[1]):
            logits, _ = transformer_forward(cfg, params, feed[:, i:i + 1], cache, i)
            toks.append(logits[:, -1, :].argmax(dim=-1))
    return torch.stack(toks, dim=1), logits[:, -1, :].float()


def bench_section_steps(n_past: int, steps: int, ctx: int) -> int:
    """Decode steps one bench section launches: its two calls (warm, timed)
    replay ceil(steps / b) blocks of b = min(16, steps) each, and the warm
    call first runs one uncaptured warm-up block per KV bucket it captures."""
    from chatllm_tpu_torch.bench import DECODE_BLOCK
    from chatllm_tpu_torch.runtime.decode_graph import kv_bucket

    b = min(DECODE_BLOCK, steps)
    starts = range(n_past, n_past + steps, b)
    return b * len({kv_bucket(i + b, ctx) for i in starts}) + 2 * b * len(starts)


def bench_phase(dev, cfg, params) -> dict:
    """The bench's `run_bench` on the full-width params already on the card,
    launches counted from 0; then the batched section under
    CHATLLM_TPU_QMM_V2=1 (K5 in place of K2), K5 against K2 on one token
    history, and `bench_entry_point`."""
    import os

    from chatllm_tpu_torch import bench
    from chatllm_tpu_torch.nn.transformer import init_cache
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    steps, ctx, B = 48, 2048, 8
    per_step = cfg.num_hidden_layers * 7 + 1       # quantized projections + lm_head
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    line = bench.run_bench(cfg, params, dev, ctx=ctx, steps=steps, batch=B)
    res = {"line": line, "seconds": time.perf_counter() - t0, "launches": launch_counts(),
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    log("  bench " + json.dumps(line))
    log(f"  bench took {res['seconds']:.1f} s, launches {res['launches']}, peak memory "
        f"{res['peak_mem_gib']:.2f} GiB")
    for k in BENCH_KEYS:
        if not (np.isfinite(line[k]) and line[k] > 0):
            raise AssertionError(f"bench: {k} = {line[k]}")
    if not 1000 <= line["bw_measured_gb_s"] <= 3350:
        raise AssertionError(f"bench: measured read bandwidth {line['bw_measured_gb_s']} GB/s "
                             "is outside 1000..3350 (above the H100's peak is an error)")
    # every section runs twice (warm, timed): 4 prefills (K3 on each layer, K1
    # for the one-row lm_head), a single-stream decode section (K1) and 3
    # batched ones (K2), each its warm-up blocks and two runs of replays,
    # and the probe (K6)
    L = cfg.num_hidden_layers
    one, batched = bench_section_steps(512, steps, ctx), bench_section_steps(0, steps, ctx)
    res["section_steps"] = {"single": one, "batched": batched}
    want = {"flash_attention": 4 * L, "qgemv": one * per_step + 4,
            "qmm": 3 * batched * per_step, "qmm_decode": 0, "flash_decode": 0}
    got = res["launches"]
    if any(got[k] != v for k, v in want.items()) or got["bw_probe"] <= 0:
        raise AssertionError(f"bench launches {got}, expected {want} and bw_probe > 0")

    os.environ["CHATLLM_TPU_QMM_V2"] = "1"
    try:
        reset_launch_counts()
        v2_rate = bench.batched_decode_rate(cfg, params, dev, B, ctx, steps)
        v2 = launch_counts()
        log(f"  bench B={B} under CHATLLM_TPU_QMM_V2=1: {v2_rate:.1f} tok/s (K2: "
            f"{line['batched8_tok_s']}), launches {v2}")
        if v2["qmm_decode"] != batched * per_step or v2["qmm"] != 0:
            raise AssertionError(f"V2 run: launches {v2}, expected K5 {batched * per_step} "
                                 "and K2 0")
        # K5 against K2 on K2's own token history (so a flipped argmax does
        # not send the two runs down different paths)
        first = (torch.arange(B, device=dev) * 1009 + 17) % cfg.vocab_size
        del os.environ["CHATLLM_TPU_QMM_V2"]
        # the host's speed drifts within a call: K2's section once more, so
        # that K5's rate lies between two of K2's
        k2_after = bench.batched_decode_rate(cfg, params, dev, B, ctx, steps)
        log(f"  bench B={B} with K2 again, after the K5 run: {k2_after:.1f} tok/s")
        k2_toks = bench.greedy_decode(cfg, params, init_cache(cfg, B, ctx, device=dev),
                                      first, 0, steps)
        feed = torch.cat([first[:, None], k2_toks[:, :-1]], dim=1)
        again, k2_logits = _forced_decode(cfg, params, init_cache(cfg, B, ctx, device=dev), feed)
        os.environ["CHATLLM_TPU_QMM_V2"] = "1"
        k5_toks, k5_logits = _forced_decode(cfg, params, init_cache(cfg, B, ctx, device=dev),
                                            feed)
    finally:
        os.environ.pop("CHATLLM_TPU_QMM_V2", None)
    torch.cuda.synchronize()
    if not torch.equal(again, k2_toks):
        raise AssertionError("K2's decode does not repeat on its own token history")
    err, rel = rel_err(k5_logits, k2_logits)
    same = (k5_toks == k2_toks).float().mean().item()
    res["v2"] = {"batched8_tok_s": v2_rate, "k2_batched8_tok_s_after": k2_after,
                 "launches": v2, "tokens_equal_share": same,
                 "last_logits_max_abs_err": err, "last_logits_rel": rel,
                 "logit_scale": k2_logits.abs().max().item()}
    log(f"  K5 vs K2 over {steps} steps x {B} rows: {same:.3f} of the tokens equal, last-step "
        f"logits differ by {err:.3e} ({rel:.2e} of the logit scale)")
    # K5 rounds the affine term into each bf16 weight, K2 adds it in f32:
    # 5e-3 of the logit scale, and at least 0.9 of the tokens equal
    if not (torch.isfinite(k5_logits).all() and rel <= 5e-3 and same >= 0.9):
        raise AssertionError(f"K5 against K2: last-step logits differ by {rel} of the logit "
                             f"scale (limit 5e-3), {same} of the tokens equal (limit 0.9)")
    res["entry_point"] = bench_entry_point()
    return res


def bench_entry_point() -> dict:
    """`python -m chatllm_tpu_torch.bench` as a user runs it (its own
    constant-weight Llama-3-8B params, the BENCH_* knobs from the
    environment), with 8 steps per section: over the bf16 cache, and with
    BENCH_CACHE=q8_0, which sends every section over the q8 cache (the long
    prefill through the chunked attention, single-stream decode through
    K4).  Each must exit 0 and print one JSON line of positive rates."""
    import os

    res = {}
    for name, extra in (("bf16", {}), ("q8_0", {"BENCH_CACHE": "q8_0"})):
        env = dict(SUBPROCESS_ENV, BENCH_STEPS="8", **extra)
        env.pop("CHATLLM_TPU_QMM_V2", None)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "chatllm_tpu_torch.bench"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"bench exit {r.returncode}:\n{r.stdout}\n{r.stderr}")
        lines = r.stdout.strip().splitlines()
        if len(lines) != 1:
            raise AssertionError(f"bench printed {len(lines)} lines, expected one:\n{r.stdout}")
        line = json.loads(lines[0])
        log(f"  python -m chatllm_tpu_torch.bench, BENCH_STEPS=8, {name} cache, "
            f"{time.perf_counter() - t0:.1f} s: {lines[0]}")
        for k in BENCH_KEYS:
            if not (np.isfinite(line[k]) and line[k] > 0):
                raise AssertionError(f"bench entry point ({name}): {k} = {line[k]}")
        if not 1000 <= line["bw_measured_gb_s"] <= 3350:
            raise AssertionError(f"bench entry point ({name}): measured read bandwidth "
                                 f"{line['bw_measured_gb_s']} GB/s is outside 1000..3350")
        res[name] = line
    return res


# -------------------------------------------------------------- qwen2 phase
def qwen2_phase(dev) -> dict:
    """Full-width Qwen2.5-0.5B: q8_0 weights (unpacked int8) with non-zero
    q/k/v biases, head dim 64, 14 query heads over 2 kv heads, a tied
    lm_head (a dense product, not a kernel).  The chat path over bf16 and q8
    caches with exact launch counts, then the 2-layer cuts against the CPU."""
    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, qwen2_5_0_5b_config

    cfg = replace(qwen2_5_0_5b_config(max_length=8192), num_hidden_layers=QWEN_DEPTH)
    params = build_synthetic_params(cfg, "q8", zeros=False, seed=0, device=dev)
    torch.cuda.synchronize()
    res = chat_phase(dev, cfg, params)
    L = cfg.num_hidden_layers
    steps = decode_launches(64)   # 63 decode steps: 4 blocks of 16
    per_token = 7 * L                       # quantized projections a token
    # bf16: two prompts x 64 replayed decode steps (K1); the 40-token prompt
    # is one 64-row chunk (K2); the 1000-token prompt one 1024-row chunk (K3)
    want = {"qgemv": 2 * steps * per_token, "qmm": per_token, "flash_attention": L,
            "flash_decode": 0}
    got = res["launches"]
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"qwen2 bf16 launches {got}, expected {want}")
    want = {"qgemv": steps * per_token, "qmm": 0, "flash_attention": 0,
            "flash_decode": steps * L}
    got = res["q8_prompt_1000"]["launches"]
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"qwen2 q8 launches {got}, expected {want}")
    # 1e-2 of the logit scale, where Llama-3-8B's cut is held to 1e-3: these
    # logits are O(1) (a tied head over a small embedding, no outlier to
    # measure against), and on the CPU alone an f32-level perturbation moves
    # them by 7e-3 to 9e-3 of their scale, because the quantized matmuls round
    # their input to bf16 and the flips compound
    # (tests/test_torch_qwen.py::test_two_layer_cut_logits_move_with_an_f32_level_perturbation).
    # The card read 2.1e-3 (prefill) and 4.5e-3 (batched q8 step), same argmax.
    res["two_layer"] = two_layer_phase(dev, cfg, params, tol=1e-2)
    res["graph_decode"] = graph_decode_phase(dev, cfg, params, "qwen2_5_0_5b", tied=True)
    return res


def e2_phase() -> dict:
    """The E2 probe's own entry point, every variant, launches counted."""
    from chatllm_tpu_torch.experiments import gemv_probe2
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = gemv_probe2.main([])
    res["launches"] = launch_counts()
    want = 2 * gemv_probe2.ITERS
    got = res["launches"]
    if got["gemv_stream"] != want or got["gemv_vpu"] != want or got["qmm"] != want:
        raise AssertionError(f"e2 launches {got}, expected {want} of stream, vpu and qmm")
    return res


def e1_phase() -> dict:
    """The E1 probe's own entry point, all seven variants (16 layers x 8
    steps, each run three times through the wrappers: warm-up, eager and
    the CUDA-graph capture, whose replays go through no wrapper), launches
    counted."""
    from chatllm_tpu_torch.experiments import gemv_probe
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = gemv_probe.main([])
    res["launches"] = launch_counts()
    want = 3 * gemv_probe.L * gemv_probe.STEPS
    got = res["launches"]
    if any(got[k] != want for k in ("gemv_stream", "gemv_vpu", "qmm")):
        raise AssertionError(f"e1 launches {got}, expected {want} of stream, vpu and qmm")
    for name in gemv_probe.VARIANTS:
        r = res[name]
        log(f"  e1 {name:11s} eager {r['eager_ms_per_step']:.3f} ms/step, graph "
            f"{r['graph_ms_per_step']:.3f} ms/step")
    return res


def e3_phase() -> dict:
    """The E3 bench's own entry point over its 3.93 GB of Llama-3-8B-shaped
    q4 weights, all four variants in one sweep: each 32-token loop run
    eagerly twice (warm-up, timed) and captured once into a CUDA graph,
    whose replays go through no wrapper."""
    from chatllm_tpu_torch.experiments import gemv_model_bench as e3
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = e3.main(["sweep", *e3.VARIANTS])
    gc.collect()
    torch.cuda.empty_cache()
    res["launches"] = got = launch_counts()
    want = 3 * e3.TOKENS * e3.L * len(e3.SHAPES)
    kernels = {"vpu": "qgemv", "stream": "stream_read", "vpu_bf16": "qgemv_bf16", "mxu": "qmm"}
    if any(got[k] != want for k in kernels.values()):
        raise AssertionError(f"e3 launches {got}, expected {want} of {list(kernels.values())}")
    for name in e3.VARIANTS:
        r = res[name]
        log(f"  e3 {name:8s} eager {r['eager_ms_per_token']:.3f} ms/token, graph "
            f"{r['graph_ms_per_token']:.3f} ms/token (host dispatch "
            f"{r['eager_ms_per_token'] - r['graph_ms_per_token']:.3f} ms/token)")
    return res


def e4_phase() -> dict:
    """The E4 probe's own entry point: each mode checked against K1, then
    REPS chained calls captured once into a CUDA graph and replayed."""
    from chatllm_tpu_torch.experiments import gemv_unpack as e4
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = e4.main([])
    res["launches"] = got = launch_counts()
    want = len(e4.MODES) * (e4.REPS + 2)          # check, warm-up, capture
    if got["unpack_gemv"] != want or got["qgemv"] != len(e4.MODES):
        raise AssertionError(f"e4 launches {got}, expected {want} of unpack_gemv and "
                             f"{len(e4.MODES)} of qgemv")
    if any("ms" not in res[m] for m in e4.MODES):
        raise AssertionError(f"e4: a mode missed its check against K1: {res}")
    return res


def e5_phase() -> dict:
    """The E5 probe's own entry point: the copy-only pass and K2 at M = 32
    for q4k, q8 and q4, each REPS chained calls replayed from a CUDA graph."""
    from chatllm_tpu_torch.experiments import qmm_m32 as e5
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = e5.main()
    res["launches"] = got = launch_counts()
    want = e5.REPS + 1                            # warm-up, capture
    if got["qmm_dma"] != want or got["qmm"] != len(e5.FORMATS) * want:
        raise AssertionError(f"e5 launches {got}, expected {want} of qmm_dma and "
                             f"{len(e5.FORMATS) * want} of qmm")
    return res


def e6_phase(dev) -> dict:
    """The E6 probe's own entry point at the original's sizes: the five
    diagnostic bodies and the three variants, each checked against K2 and
    timed over REPS chained calls replayed from a CUDA graph.  K2 adds the
    affine term in f32 from group sums of x, as biasdot does, so the biasdot
    variants are held to the original's 1e-3; v0 rounds it into every bf16
    weight and misses 1e-3 by design, so its error is held to the plain
    versions' on the CPU (the same check, 1.84e-3) within 1e-4."""
    from chatllm_tpu_torch.experiments import qmm_unpack_variants as e6
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = e6.main([])
    res["launches"] = got = launch_counts()
    want = {"qmm_unpack": len(e6.VARIANTS) * (e6.REPS + 2),       # check, warm-up, capture
            "qmm_unpack_diag": len(e6.DIAG_MODES) * (e6.REPS + 1), "qmm": len(e6.VARIANTS)}
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"e6 launches {got}, expected {want}")
    for name, unpack, biasdot in e6.VARIANTS:
        err, cpu = res[name]["err"], e6.check_correct(unpack, biasdot, device="cpu")
        res[name]["err_cpu"] = cpu
        log(f"  e6 {name:15s} check against K2 {err:.3e} (plain versions on the CPU "
            f"{cpu:.3e}); {res[name]['ms']:.4f} ms, {res[name]['gb_s']:.1f} GB/s")
        if (biasdot and err > e6.CHECK_TOL) or abs(err - cpu) > 1e-4:
            raise AssertionError(f"e6 {name}: check against K2 {err}, on the CPU {cpu}")
    return res


E7_STEPS = 4      # the original's 48 cut to a twelfth: the rates are per step, and
#                   the plain einsum variants' eager loops took ~3 minutes (16
#                   steps ~58 s; halved again to make room for the pipeline phase,
#                   and again for the Gemma phases)


def e7_phase() -> dict:
    """The E7 probe's own entry point at B 32, ctx 1024, E7_STEPS steps: all
    8 combinations, each loop run eagerly 4 times (warm-up, 3 timed) and
    captured once into a CUDA graph, whose replays go through no
    wrapper."""
    from chatllm_tpu_torch.experiments import bhsd_decode as e7
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = e7.main([], steps=E7_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    res["launches"] = got = launch_counts()
    passes = 5 * E7_STEPS                        # warm-up, 3 eager, capture
    per_step = N_LAYERS * 7 + 1                  # K2 projections + the lm_head
    n_k4 = sum(v == "pallas_bhsd" for _, v in e7.COMBOS)
    want = {"qmm": len(e7.COMBOS) * passes * per_step, "flash_decode": n_k4 * passes * N_LAYERS,
            "flash_decode_int8": 0, "qgemv": 0}
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"e7 launches {got}, expected {want}")
    for key, r in res.items():
        if key != "launches":
            log(f"  e7 {key:22s} eager {r['tok_s']:8.1f} tok/s, graph {r['graph_tok_s']:8.1f} "
                f"tok/s")
    return res


def int8_engine_phase(dev, cfg, params) -> dict:
    """Llama-3-8B at full width over a q8 cache under CHATLLM_TPU_FLASH_QK=int8:
    the first decode step after the 1000-token prompt against the bf16-dot
    run's (INT8_LOGIT_TOL of the logit scale, the same argmax), then 16
    greedy tokens with K4's int8 dots on every layer of every decode step
    (one block of 16 steps, warmed once, then counted as a replay), and
    their decode rate (recorded, not checked)."""
    import os

    from chatllm_tpu_torch.nn.transformer import transformer_forward
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine, PerfInfo

    eng = InferenceEngine(replace(cfg, cache_dtype="int8"), params, device=dev)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 1000).tolist()
    first, res = {}, {}
    try:
        for mode in ("bf16", "int8"):
            os.environ["CHATLLM_TPU_FLASH_QK"] = mode
            cache = eng.new_cache(1)
            reset_launch_counts()
            with torch.inference_mode():
                logits, cache, n = eng.prefill(ids, cache, 0)
                tok = logits[0].argmax().reshape(1, 1)
                step, _ = transformer_forward(eng.cfg, params, tok, cache, n)
            first[mode] = step[0, -1].float()
            res[f"first_step_launches_{mode}"] = launch_counts()
            del cache
        cmp = _compare_logits("first decode step, int8 dots vs bf16 dots", first["int8"],
                              first["bf16"].cpu(), INT8_LOGIT_TOL)
        res["first_step"] = cmp
        want = {"flash_decode_int8": N_LAYERS, "flash_decode": 0}
        got = res["first_step_launches_int8"]
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"int8 first step launches {got}, expected {want}")
        gcfg = GenerationConfig(do_sample=False, max_new_tokens=16)
        kv = eng.new_cache(1)
        eng.generate(ids, gcfg, cache=kv)                   # warm: captures the block
        reset_launch_counts()
        perf = PerfInfo()
        out, _, _ = eng.generate(ids, gcfg, perf=perf, cache=kv)
        torch.cuda.synchronize()
        res["launches"] = got = launch_counts()
        res["tokens_int8"] = out
        del kv
    finally:
        os.environ.pop("CHATLLM_TPU_FLASH_QK", None)
    steps = len(out) - 1
    launched = decode_launches(16)      # 15 decode steps: one block of 16
    res["decode_tok_s"] = steps / perf.gen_ms * 1e3
    log(f"  int8 dots: 16 greedy tokens {out}, {res['decode_tok_s']:.2f} decode steps/s, "
        f"launches {got}")
    if (len(out) != 16 or got["flash_decode_int8"] != N_LAYERS * launched
            or got["flash_decode"]):
        raise AssertionError(f"int8 run: {len(out)} tokens, K4 int8 launched "
                             f"{got['flash_decode_int8']} times (expected {N_LAYERS * launched}: "
                             f"layers x replayed steps), bf16-dot K4 {got['flash_decode']}")
    res["flash_decode_int8_per_step"] = got["flash_decode_int8"] / launched
    return res


def f32_engine_phase(dev, cfg, params) -> dict:
    """K3's f32 modes on the chat path, Llama-3-8B at full width through
    InferenceEngine: the 1000-token prompt over an f32 cache (mode 1), and
    again with f32 activations (the embedding in f32, as --compute_dtype f32
    loads it) over a bf16 cache (mode 2), 16 greedy tokens each; K3 must
    launch exactly 32 times in each run (the one 1024-token prefill chunk),
    all in the run's mode; prefill ms and peak memory are recorded.  Then a
    2-layer full-width cut over an f32 cache, a 256-token prompt into a
    1024-slot cache (T 256, S 1024: the K3 route), the card (mode 1)
    against the CPU (the plain version), within 1e-3 of the logit scale and
    with the same argmax."""
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.cuda.flash import MODE_LAUNCHES, reset_mode_launches
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine, PerfInfo

    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, 1000).tolist()
    gcfg = GenerationConfig(do_sample=False, max_new_tokens=16)
    res = {}
    for name, mode, c, p in (
            ("f32_cache", 1, replace(cfg, cache_dtype="float32"), params),
            ("f32_compute", 2, cfg, dict(params, embed=params["embed"].float()))):
        eng = InferenceEngine(c, p, device=dev)
        kv = eng.new_cache(1)
        eng.generate(ids, gcfg, cache=kv)        # warm-up: captures the decode graph
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        reset_mode_launches()
        perf = PerfInfo()
        out, kv, n_past = eng.generate(ids, gcfg, perf=perf, cache=kv)
        torch.cuda.synchronize()
        got = launch_counts()
        steps = len(out) - 1
        r = {"mode": mode, "prompt_tokens": len(ids), "prefill_ms": perf.prompt_ms,
             "decode_steps": steps, "decode_tok_s": steps / perf.gen_ms * 1e3,
             "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
             "launches": got, "flash_modes": dict(MODE_LAUNCHES), "tokens": out}
        res[name] = r
        log(f"  {name} (K3 mode {mode}): prefill {r['prefill_ms']:.1f} ms, "
            f"{r['decode_tok_s']:.2f} decode steps/s, peak memory {r['peak_mem_gib']:.2f} GiB, "
            f"K3 launches {got['flash_attention']} by mode {r['flash_modes']}")
        if (len(out) != gcfg.max_new_tokens or n_past != len(ids) + steps
                or got["flash_attention"] != N_LAYERS or MODE_LAUNCHES[mode] != N_LAYERS):
            raise AssertionError(f"{name}: {len(out)} tokens, n_past {n_past}, K3 launched "
                                 f"{got['flash_attention']} times by mode {MODE_LAUNCHES} "
                                 f"(expected {N_LAYERS} in mode {mode})")
        del eng, p, kv
        torch.cuda.empty_cache()

    cfg2 = replace(cfg, num_hidden_layers=2, cache_dtype="float32")
    ids = rng.integers(0, cfg.vocab_size, 256).tolist()
    outs = []
    for d in (dev, "cpu"):
        eng = InferenceEngine(cfg2, _cut(params, 2, d), device=d)
        reset_launch_counts()
        reset_mode_launches()
        outs.append(eng.prefill(ids, eng.new_cache(1, 1024), 0)[0])
        if d == dev:
            torch.cuda.synchronize()
            res["two_layer_flash_modes"] = dict(MODE_LAUNCHES)
            if MODE_LAUNCHES[1] != 2 or launch_counts()["flash_attention"] != 2:
                raise AssertionError(f"2-layer f32 cut: K3 launches by mode {MODE_LAUNCHES}, "
                                     "expected 2 in mode 1")
        del eng
    res["two_layer_vs_cpu"] = _compare_logits(
        "2-layer f32-cache prefill (K3 mode 1) card vs cpu", *outs)
    return res


def switch_phase(dev, cfg, params) -> dict:
    """The attention switches on the card: CHATLLM_TPU_FLASH_DECODE=1 (the
    forced mode) on a bf16 cache at B = 8 through BatchedEngine takes K4 on
    every layer of every batched decode step, =0 none; CHATLLM_TPU_FLASH=0
    takes no K3 on the 1000-token prefill."""
    import os

    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.sampling import SamplerConfig
    from chatllm_tpu_torch.runtime import batching
    from chatllm_tpu_torch.runtime.generate import InferenceEngine

    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, 20 + 7 * i).tolist() for i in range(8)]
    res = {}
    try:
        for value in ("1", "0"):
            os.environ["CHATLLM_TPU_FLASH_DECODE"] = value
            reset_launch_counts()
            eng = batching.BatchedEngine(cfg, params, max_slots=8, max_length=2048,
                                         decode_block=4, scfg=SamplerConfig(do_sample=False),
                                         device=dev)
            try:
                toks = [list(h) for h in [eng.submit(p, max_new=16) for p in prompts]]
            finally:
                eng.shutdown()
            torch.cuda.synchronize()
            got = launch_counts()
            # batched steps launched: the uncaptured warm-up blocks and the
            # replayed ones (the slots' prefills are single-row forwards)
            dec = eng.decoder
            steps = dec.eager_steps + dec.replayed_steps
            res[f"flash_decode_{value}"] = {"launches": got, "batched_steps": steps,
                                           "replayed_steps": dec.replayed_steps,
                                           "graphs": dec.num_graphs(), "tokens": toks}
            log(f"  CHATLLM_TPU_FLASH_DECODE={value}, bf16 cache, B=8: {steps} batched steps "
                f"({dec.replayed_steps} replayed from {dec.num_graphs()} graphs), K4 launches "
                f"{got['flash_decode']}")
            want = N_LAYERS * steps if value == "1" else 0
            if (got["flash_decode"] != want or dec.replayed_steps == 0
                    or any(len(t) != 16 for t in toks)):
                raise AssertionError(f"CHATLLM_TPU_FLASH_DECODE={value}: K4 {got['flash_decode']} "
                                     f"(expected {want}), {steps} steps, {toks}")
    finally:
        os.environ.pop("CHATLLM_TPU_FLASH_DECODE", None)
    a, b = res["flash_decode_1"]["tokens"], res["flash_decode_0"]["tokens"]
    res["tokens_equal_share"] = float(np.mean([x == y for s, t in zip(a, b) for x, y in zip(s, t)]))
    log(f"  forced K4 against the dense path: {res['tokens_equal_share']:.3f} of the tokens equal")

    eng = InferenceEngine(cfg, params, device=dev)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 1000).tolist()
    logits = {}
    for value in ("0", None):
        if value is not None:
            os.environ["CHATLLM_TPU_FLASH"] = value
        try:
            reset_launch_counts()
            logits[value] = eng.prefill(ids, eng.new_cache(1, 8192), 0)[0]
            torch.cuda.synchronize()
            got = launch_counts()
        finally:
            os.environ.pop("CHATLLM_TPU_FLASH", None)
        want = 0 if value == "0" else N_LAYERS
        log(f"  CHATLLM_TPU_FLASH={value}: 1000-token prefill, K3 launches "
            f"{got['flash_attention']}")
        if got["flash_attention"] != want:
            raise AssertionError(f"CHATLLM_TPU_FLASH={value}: K3 launched "
                                 f"{got['flash_attention']} times, expected {want}")
    err, rel = rel_err(logits["0"], logits[None])
    res["flash_off_vs_on"] = {"max_abs_err": err, "rel": rel}
    log(f"  prefill logits without K3 against K3's: {rel:.2e} of the logit scale")
    return res


# ------------------------------------------------------- deepseek_v2_lite
DSV2_PROMPT, DSV2_NEW = 1000, 64
DSV2_SERVE_BYTES = (30, 200, 500, 980)          # ~40 to ~1000 prompt tokens


def dsv2_step_launches(cfg) -> int:
    """K1 launches per DeepSeek-V2-Lite decode token: q, d_kv, u_k_nope, u_v
    and o in every layer (k_pe's and the router's 64 columns take the
    dequant route), the dense layer's down (its gate and up, 10944 columns,
    are not multiples of 128: the dequant route), each MoE layer's shared
    gate, up and down, and the lm_head."""
    L = cfg.num_hidden_layers
    moe = sum(cfg.layer_spec(i).is_moe for i in range(L))
    return 5 * L + (L - moe) + 3 * moe + 1


def _dsv2_tokenizer(cfg):
    """DeepSeek's tokenizer and chat template over a byte-level vocab of the
    model's size (a narrow GGMM written for its vocab, every reserved id a
    visible piece)."""
    from chatllm_tpu_torch.ggmm.reader import GGMMFile
    from chatllm_tpu_torch.models.base import BaseConfig
    from chatllm_tpu_torch.models.deepseek import make_deepseek_v1_tokenizer
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = write_llama3_ggmm(BUILD_DIR / f"smoke_vocab{cfg.vocab_size}.bin",
                             vocab_pad=cfg.vocab_size, hidden=64, heads=2, kv_heads=1,
                             layers=1, inter=128, dtype=0, visible_reserved=True)
    gf = GGMMFile.open(str(path))
    return make_deepseek_v1_tokenizer(gf, BaseConfig.parse(gf)[0])


def _step_breakdown(kernels_ms: dict, step_ms: float) -> dict:
    """A profiled block's kernel time per decode step by kind: K1, K4, the
    cuBLAS products (the expert products above all) and the rest."""
    kinds = {"k1": 0.0, "k4": 0.0, "cublas": 0.0, "rest": 0.0}
    for name, ms in kernels_ms.items():
        n = name.lower()
        kind = ("k1" if "qgemv" in n else "k4" if "decode_kernel" in n else
                "cublas" if any(w in n for w in ("gemm", "gemv", "nvjet", "cutlass", "xmma"))
                else "rest")
        kinds[kind] += ms / DECODE_BLOCK
    return {**{k + "_ms": v for k, v in kinds.items()},
            **{k + "_share": v / step_ms for k, v in kinds.items()}}


# The 2-layer DeepSeek-V2-Lite cut on the card against the CPU, at the
# positions whose expert picks agree: 2e-2 of the logit scale, the tolerance
# of a quantized model against the JAX package.  Not 1e-3 as for Llama-3-8B:
# on the CPU alone, norm weights of 1 + 1e-6 * randn (an f32-level
# difference) move the cut's logits by ~1e-2 of their scale and flip the
# picks of near-tied experts (tests/test_torch_deepseek.py::
# test_two_layer_cut_moves_with_an_f32_level_perturbation).
DSV2_CUT_TOL = 2e-2
# The router scores (softmax over 64 experts) of the cut on the card against
# the CPU's: at most 1e-2 apart (sound runs read 3.2e-3, the CPU perturbation
# test ~3e-3), and at least 0.9 of the tokens pick the same experts (sound
# runs read 60 of 64 in prefill, 4 of 4 in the decode step).
DSV2_SCORE_DIFF_MAX = 1e-2
DSV2_PICKS_AGREE_MIN = 0.9

_TAPE = threading.local()          # the tape this thread has open, if any
_TAPES_OPEN = {"n": 0, "route": None, "lock": threading.Lock()}


def _router_scores(c, p, xt) -> tuple:
    """The router's logits [N, E] (f32, with GPT-OSS's bias) and its scores
    over every expert: their sigmoid under moe_score_func "sigmoid", else
    their softmax."""
    from chatllm_tpu_torch.ops.qmm import matmul

    logits = matmul(xt, p["gate"]).float()
    if "gate_linear_bias" in p:
        logits = logits + p["gate_linear_bias"].float()
    if c.moe_score_func == "sigmoid":
        return logits, torch.sigmoid(logits)
    return logits, torch.softmax(logits, dim=-1)


def _weigh(c, logits, probs, topi):
    """The weights `moe_route` gives the experts `topi`: the softmax over
    their logits (softmax_topk), else their scores, normalized under
    moe_norm_topk_prob, times moe_routed_scale."""
    if c.moe_score_func == "softmax_topk":
        return torch.softmax(torch.gather(logits, -1, topi), dim=-1)
    topv = torch.gather(probs, -1, topi)
    if c.moe_norm_topk_prob:
        topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-20)
    return topv * c.moe_routed_scale


def _taped_route(c, p, xt):
    topi, topv = _TAPES_OPEN["route"](c, p, xt)
    tape = getattr(_TAPE, "tape", None)
    if tape is None:
        return topi, topv
    logits, probs = _router_scores(c, p, xt)
    own = (torch.sort(topi, dim=-1).values.cpu(), probs.cpu())
    if tape.replay is not None:
        topi = tape.replay[len(tape)][0].to(xt.device)
        topv = _weigh(c, logits, probs, topi)
    tape.append(own)
    return topi, topv


class _Tape(list):
    def __init__(self, replay):
        super().__init__()
        self.replay = replay


@contextmanager
def pick_tape(replay=None):
    """A tape of this thread's `moe_route` calls while it is open: each call
    appends (its sorted picks [N, K], its router scores [N, E]) on the CPU.
    Given `replay` (a tape of the same calls on the CPU), each call goes on
    with the replayed picks at its index, weighed as the router weighs them
    (`_weigh`) from its own logits: a flip that rounding decides in one
    layer would otherwise reach every later position through the next
    layer's attention.  `moe_route` is patched only while a tape is open,
    and other threads' calls pass through it."""
    from chatllm_tpu_torch.nn import transformer as T

    tape = _Tape(replay)
    with _TAPES_OPEN["lock"]:
        if not _TAPES_OPEN["n"]:
            _TAPES_OPEN["route"], T.moe_route = T.moe_route, _taped_route
        _TAPES_OPEN["n"] += 1
    _TAPE.tape = tape
    try:
        yield tape
    finally:
        _TAPE.tape = None
        with _TAPES_OPEN["lock"]:
            _TAPES_OPEN["n"] -= 1
            if not _TAPES_OPEN["n"]:
                T.moe_route = _TAPES_OPEN["route"]


def _moe_picks(name: str, card, cpu) -> tuple[torch.Tensor, dict]:
    """The MoE layer's picks on the card against the CPU's, per token: each
    side's sorted picks [N, K] and router scores [N, E].  The scores may
    differ by at most DSV2_SCORE_DIFF_MAX, at least DSV2_PICKS_AGREE_MIN of
    the tokens must pick the same experts, and a pick may differ only
    between experts whose CPU scores are closer than twice the largest
    difference of the card's and the CPU's scores (a near-tie that the
    rounding decides).  Returns the mask of tokens whose picks agree."""
    (gi, gp), (ci, cp) = card, cpu
    rows = (gi != ci).any(dim=-1)
    dp = (gp - cp).abs().max().item()
    gaps = []
    for t in torch.nonzero(rows).flatten().tolist():
        a, b = set(gi[t].tolist()), set(ci[t].tolist())
        gaps.append(max(min(abs(cp[t, e] - cp[t, e2]).item() for e2 in b - a) for e in a - b))
    share = 1.0 - rows.float().mean().item()
    r = {"tokens": int(gi.shape[0]), "picks_differ": int(rows.sum()), "picks_agree_share": share,
         "max_score_diff": dp, "differing_score_gaps": gaps}
    log(f"  {name}: expert picks {r}")
    if dp > DSV2_SCORE_DIFF_MAX or share < DSV2_PICKS_AGREE_MIN:
        raise AssertionError(f"{name}: router scores differ by {dp} (limit "
                             f"{DSV2_SCORE_DIFF_MAX}), or only {share} of the tokens pick the "
                             f"same experts (limit {DSV2_PICKS_AGREE_MIN})")
    if any(g > 2 * dp for g in gaps):
        raise AssertionError(f"{name}: a pick differs between experts whose scores are "
                             f"further apart ({gaps}) than twice the card's and the CPU's "
                             f"scores differ ({dp})")
    return ~rows, r


def _compare_agreeing(name: str, g, c, agree, tol: float = DSV2_CUT_TOL) -> dict:
    """Card logits g against the CPU's c ([N, V]) at the rows whose expert
    picks agree: within `tol` of the logit scale, the same argmax at the
    last of them (and the share of them with the same argmax)."""
    g, c = g.float().cpu(), c.float()
    if g.shape != c.shape or not torch.isfinite(g).all() or not agree.any():
        raise AssertionError(f"{name}: logits shape {tuple(g.shape)}, not finite, or no row "
                             "with equal picks")
    err, rel = rel_err(g[agree], c[agree])
    last = int(torch.nonzero(agree).max())
    r = {"rows_compared": int(agree.sum()), "max_abs_err": err, "rel_to_logit_scale": rel,
         "argmax_equal_last": bool(g[last].argmax() == c[last].argmax()),
         "argmax_equal_share": float((g[agree].argmax(-1) == c[agree].argmax(-1)).float().mean()),
         "logit_scale": c.abs().max().item()}
    log(f"  {name}: {r}")
    if rel > tol or not r["argmax_equal_last"]:
        raise AssertionError(f"{name}: logits differ from the CPU run: rel {rel} > {tol}, or "
                             "the argmax differs")
    return r


def dsv2_two_layer(dev, cfg, params, slots: int = 4) -> dict:
    """2-layer cuts of DeepSeek-V2-Lite (layer 0 dense, layer 1 MoE) at full
    width, the card (kernels) against the CPU (plain versions): a 64-token
    prefill over a bf16 cache (logits at every position), and one batched
    decode step of `slots` slots at per-row n_past over a q8 cache with
    random contents (K4 at (192, 128)).  The expert picks first
    (`_moe_picks`, every MoE layer's), then the logits where the picks of
    every layer agree (`_compare_agreeing`).  The CPU runs first; where the
    card's own picks differ from its (near-ties, which `_moe_picks` checks),
    the card goes on with the CPU's picks, weighed by its own scores
    (`pick_tape`).  Another MoE model (Qwen3-30B-A3B: both layers MoE) takes
    the same cuts; the CPU side is a copy of the two layers on the host."""
    import chatllm_tpu_torch.nn.transformer as T

    cfg2 = _cfg_cut(cfg, 2)
    p2, p2_cpu = _cut(params, 2, dev), _cut(params, 2, "cpu")
    rec = {}
    res = {}
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 64)))
    cfg_q8 = replace(cfg2, cache_dtype="int8")
    gen = torch.Generator().manual_seed(5)
    caches = {d: T.init_cache(cfg_q8, slots, 8192, device=d) for d in ("cpu", dev)}
    for i in range(2):           # random q8 contents, the same on both sides
        for name in ("k", "v"):
            q8 = torch.randint(-127, 128, getattr(caches["cpu"], name)[i].shape, generator=gen,
                               dtype=torch.int32).to(torch.int8)
            sc = torch.rand(caches["cpu"].k_scale[i].shape, generator=gen) * 0.02 + 1e-3
            for c in caches.values():
                getattr(c, name)[i].copy_(q8)
                getattr(c, name + "_scale")[i].copy_(sc)
    toks = torch.tensor([[11], [2024], [77777], [100000]])[:slots] % cfg.vocab_size
    n_past = torch.tensor([5, 1000, 4095, 8000])[-slots:]
    logits = {}
    with torch.inference_mode():
        for p, d, side in ((p2_cpu, "cpu", "cpu"), (p2, dev, "card")):
            with pick_tape(rec.get("cpu")) as rec[side]:
                pre = T.transformer_forward(cfg2, p, ids.to(d),
                                            T.init_cache(cfg2, 1, 1024, device=d), 0)[0][0]
                dec = T.transformer_forward(cfg_q8, p, toks.to(d), caches[d],
                                            n_past.to(d))[0][:, 0]
            logits[str(d)] = (pre, dec)
    n_moe = sum(s.is_moe for s in cfg2.layer_specs)
    for run, part in enumerate(("prefill", "decode")):
        what = "prefill (64 tokens)" if part == "prefill" else f"q8 decode step ({slots} slots)"
        agree = torch.ones(logits["cpu"][run].shape[0], dtype=torch.bool)
        res[part + "_picks"] = []
        for i in range(run * n_moe, (run + 1) * n_moe):
            a, pr = _moe_picks(f"2-layer {what}, MoE layer {i % n_moe}", rec["card"][i],
                               rec["cpu"][i])
            agree &= a
            res[part + "_picks"].append(pr)
        key = "prefill_vs_cpu" if part == "prefill" else "batched_decode_vs_cpu"
        res[key] = _compare_agreeing(f"2-layer {what} card vs cpu", logits[str(dev)][run],
                                     logits["cpu"][run], agree)
    return res


def expert_products(dev, cfg, mlp, n_moe: int) -> dict:
    """The expert products of one MoE layer (`mlp`) at one token, alone, L2
    flushed: ms, the stacks' bytes, GB/s, the read bound, and the ms of a
    decode step's `n_moe` layers."""
    import chatllm_tpu_torch.nn.transformer as T
    from chatllm_tpu_torch.models.synthetic import param_bytes

    timer = Timer(dev)
    xt = torch.randn(1, cfg.hidden_size, device=dev).to(torch.bfloat16)
    topi, topv = T.moe_route(cfg, mlp, xt)
    ms = timer(lambda: T._experts_out(cfg, mlp["experts"], xt, topi, topv, cfg.moe_num_experts))
    nb = param_bytes(mlp["experts"])
    r = {"ms_per_layer": ms, "bytes_per_layer": nb, "gb_s": nb / ms / 1e6,
         "bound_ms": nb / HBM_BYTES_PER_S * 1e3, "ms_per_step": ms * n_moe}
    log(f"  expert products of one MoE layer at one token: {r}")
    del timer
    torch.cuda.empty_cache()
    return r


def deepseek_phase(dev) -> dict:
    """Full-width DeepSeek-V2-Lite (`deepseek_v2_lite_config`, its depth cut
    to DSV2_DEPTH of 27 layers: 64 routed experts of which 6 per token plus
    2 shared, MLA with the expanded cache, max_length 8192), random
    zero-centred q4_k projections and bf16 expert stacks from a seed, built
    on the card:
      - the chat path (1000-token prompt, 64 greedy tokens) over a bf16
        cache with the decode blocks uncaptured and replayed from graphs in
        one call (tokens identical, launches exact per replayed step), then
        over a q8 cache (K4 at (192, 128) once per layer and step), and over the q8
        cache with K4 off (CHATLLM_TPU_FLASH_DECODE=0, the einsum route):
        the share of tokens that agree and the first decode step's logits;
        one replayed block profiled (busy share, time by kind) and one MoE
        layer's expert products timed alone;
      - the latent cache (`mla_cache="memory"`, bf16): a 256-token prompt,
        16 tokens, against the expanded mode's;
      - 2-layer cuts (layer 0 dense, layer 1 MoE) on the card against the
        CPU (`dsv2_two_layer`): a 64-token prefill and a batched q8 decode
        step (K4 with per-row n_past);
      - BatchedEngine behind the server, 4 slots over a q8 cache, 4 chat
        requests of ~40 to ~1000 tokens, 16 tokens each, one at a time then
        all at once (replies identical; K4 with per-row n_past)."""
    import os

    import chatllm_tpu_torch.nn.transformer as T
    from chatllm_tpu_torch.models.deepseek import absorb_mla
    from chatllm_tpu_torch.models.model_types import ModelType
    from chatllm_tpu_torch.models.synthetic import (build_synthetic_params,
                                                    deepseek_v2_lite_config, param_bytes)
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine, PerfInfo

    res = {}
    cfg = deepseek_v2_lite_config(max_length=8192)
    cfg = _cfg_cut(cfg, DSV2_DEPTH)
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev, centered=True)
    torch.cuda.synchronize()
    res["build"] = {"seconds": time.perf_counter() - t0, "param_bytes": param_bytes(params),
                    "expert_bytes": param_bytes([lay["mlp"].get("experts")
                                                 for lay in params["layers"]]),
                    "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    log(f"  built: {res['build']}")

    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, DSV2_PROMPT).tolist()
    gcfg = GenerationConfig(do_sample=False, max_new_tokens=DSV2_NEW)
    steps = decode_launches(DSV2_NEW)
    chat = {}
    for key, cache, mode, switch in (("bfloat16_eager", "bfloat16", "eager", None),
                                     ("bfloat16_graph", "bfloat16", "graph", None),
                                     ("int8_graph", "int8", "graph", None),
                                     ("int8_k4_off", "int8", "graph", "0")):
        if switch is not None:
            os.environ["CHATLLM_TPU_FLASH_DECODE"] = switch
        try:
            eng = InferenceEngine(replace(cfg, cache_dtype=cache), params, device=dev,
                                  cuda_graphs=mode == "graph")
            kv = eng.new_cache(1)
            if mode == "graph":
                eng.generate(ids, gcfg, cache=kv)                 # warm: captures
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launch_counts()
            perf = PerfInfo()
            out, kv, n_past = eng.generate(ids, gcfg, perf=perf, cache=kv)
            torch.cuda.synchronize()
            got = launch_counts()
            dec = eng.decoder
            r = {"tokens": out, "prefill_ms": perf.prompt_ms,
                 "decode_steps_s": (len(out) - 1) / perf.gen_ms * 1e3,
                 "graphs": dec.num_graphs(), "capture_ms": dec.capture_ms,
                 "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                 "launches": {k: got[k] for k in ("qgemv", "qmm", "flash_attention",
                                                  "flash_decode", "flash_decode_int8")}}
            if key in ("bfloat16_graph", "int8_graph"):
                pb = _profile_block(eng, kv, len(ids) + 48)
                pb["by_kind"] = _step_breakdown(pb.pop("kernels_ms"), pb["step_ms"])
                r["profiled_block"] = pb
        finally:
            os.environ.pop("CHATLLM_TPU_FLASH_DECODE", None)
        log(f"  {key}: {r['decode_steps_s']:.2f} decode steps/s, prefill "
            f"{r['prefill_ms']:.1f} ms, {r['graphs']} graphs in {r['capture_ms']:.0f} ms, "
            f"peak {r['peak_mem_gib']:.2f} GiB, launches {r['launches']}"
            + (f"; replayed block {r['profiled_block']}" if "profiled_block" in r else ""))
        want = {"qgemv": dsv2_step_launches(cfg) * steps + 1,
                "flash_decode": L * steps if key == "int8_graph" else 0}
        if len(out) != DSV2_NEW or n_past != len(ids) + len(out) - 1:
            raise AssertionError(f"deepseek {key}: {len(out)} tokens, n_past {n_past}")
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"deepseek {key}: launches {r['launches']}, expected {want} "
                                 f"({steps} launched steps)")
        chat[key] = r
        del eng, kv
        torch.cuda.empty_cache()
    if chat["bfloat16_graph"]["tokens"] != chat["bfloat16_eager"]["tokens"]:
        raise AssertionError("deepseek: graph tokens differ from the eager loop's")
    # a copy of one layer's expert stacks would be 1.1 GB more
    if chat["bfloat16_graph"]["peak_mem_gib"] > chat["bfloat16_eager"]["peak_mem_gib"] + 0.5:
        raise AssertionError("deepseek: the replayed decode holds more memory than the eager one")
    chat["graph_over_eager"] = (chat["bfloat16_graph"]["decode_steps_s"]
                                / chat["bfloat16_eager"]["decode_steps_s"])
    chat["flash_decode_per_step"] = chat["int8_graph"]["launches"]["flash_decode"] / steps
    a, b = chat["int8_graph"]["tokens"], chat["int8_k4_off"]["tokens"]
    chat["k4_off_tokens_equal_share"] = float(np.mean([x == y for x, y in zip(a, b)]))

    # the first decode step's logits after the prompt, K4 on and off
    c8 = replace(cfg, cache_dtype="int8")
    eng = InferenceEngine(c8, params, device=dev)
    first = []
    with torch.inference_mode():
        for switch in (None, "0"):
            if switch is not None:
                os.environ["CHATLLM_TPU_FLASH_DECODE"] = switch
            try:
                reset_launch_counts()
                last, kv, n_past = eng.prefill(ids, eng.new_cache(1), 0)
                tok = last.argmax(-1).reshape(1, 1)
                first.append(T.transformer_forward(c8, params, tok, kv, n_past)[0][0, 0].float())
                first.append(launch_counts()["flash_decode"])
            finally:
                os.environ.pop("CHATLLM_TPU_FLASH_DECODE", None)
            del kv
    (on, k4_on), (off, k4_off) = first[:2], first[2:]
    err, rel = rel_err(off, on)
    chat["k4_off_first_step"] = {"max_abs_err": err, "rel_to_logit_scale": rel,
                                 "argmax_equal": bool(on.argmax() == off.argmax()),
                                 "k4_launches": [k4_on, k4_off]}
    log(f"  q8 cache, K4 off against on: {chat['k4_off_tokens_equal_share']:.3f} of the tokens "
        f"equal; first decode step {chat['k4_off_first_step']}")
    if (k4_on, k4_off) != (L, 0) or not torch.isfinite(on).all():
        raise AssertionError(f"deepseek first step: K4 launched {k4_on} / {k4_off} times "
                             f"(expected {L} / 0), or the logits are not finite")
    del eng
    res["chat"] = chat

    res["expert_products"] = expert_products(dev, cfg, params["layers"][1]["mlp"], L - 1)

    # the latent cache against the expanded one, bf16
    lat = {}
    for name, c in (("expanded", cfg), ("latent", replace(cfg, mla_compressed=True))):
        p = params if name == "expanded" else dict(params, layers=tuple(
            dict(lay, attn={**lay["attn"], **absorb_mla(lay["attn"], cfg, torch.bfloat16)})
            for lay in params["layers"]))
        eng = InferenceEngine(c, p, device=dev)
        perf = PerfInfo()
        out = eng.generate(ids[:256], GenerationConfig(do_sample=False, max_new_tokens=16),
                           perf=perf)[0]
        lat[name] = {"tokens": out, "prefill_ms": perf.prompt_ms,
                     "decode_ms": perf.gen_ms, "cache_k_shape": list(eng.new_cache(1).k[0].shape)}
        del eng, p
        torch.cuda.empty_cache()
    lat["tokens_equal_share"] = float(np.mean([x == y for x, y in
                                               zip(lat["latent"]["tokens"],
                                                   lat["expanded"]["tokens"])]))
    log(f"  latent cache against expanded: {lat}")
    if len(lat["latent"]["tokens"]) != 16:
        raise AssertionError("deepseek latent: fewer than 16 tokens")
    res["latent"] = lat

    # 2-layer cuts against the CPU: a 64-token prefill, and one batched
    # decode step of 4 slots at per-row n_past over a q8 cache (K4)
    res["two_layer"] = dsv2_two_layer(dev, cfg, params)
    torch.cuda.empty_cache()

    res["serve"] = serve_phase(dev, cfg, params, model_type=ModelType.DEEPSEEK_V2_LIGHT,
                               tok=_dsv2_tokenizer(cfg), name="deepseek-v2-lite-synthetic",
                               prompt_bytes=DSV2_SERVE_BYTES, max_new=16)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------ qwen3_30b_a3b phase
A3B_PROMPT, A3B_NEW = 1000, 64
A3B_PREFILL = (512, 2048)           # the prefill chunks timed
A3B_SERVE_BYTES = (200, 980)        # two chat requests, ~200 and ~1000 tokens


def a3b_step_launches(cfg) -> int:
    """K1 launches per Qwen3-30B-A3B decode token: q, k, v, o and the router
    (2048 -> 128, stored quantized) in every layer, and the lm_head.  The
    expert products are cuBLAS's dense bf16 products over all 128 stacks, as
    the JAX package's einsum."""
    return 5 * cfg.num_hidden_layers + 1


def qwen3_a3b_phase(dev) -> dict:
    """Full-width Qwen3-30B-A3B (`qwen3_30b_a3b_config`, its depth cut to
    A3B_DEPTH of 48 MoE layers: 128 experts, 8 a token, no shared expert; 32
    query heads over 4 kv heads of 128, max_length 8192), random
    zero-centred q4_k projections and bf16 expert stacks from a seed, built
    on the card:
      - prefill of 512 and 2048 tokens over a bf16 cache (K3 mode 2, one
        launch a layer and chunk), timed warm;
      - the 1000-token prompt and 64 greedy tokens over a bf16 and a q8
        cache, each uncaptured and replayed from CUDA graphs (tokens
        identical; K1 5 L + 1 launches and, over q8, K4 L per replayed step);
        one replayed q8 block profiled; one MoE layer's expert products
        timed alone;
      - 2-layer cuts against the CPU (`dsv2_two_layer` over both MoE layers,
        the CPU side from two layers copied to the host, never a second copy
        of the stacks on the card): a 64-token prefill and a q8 decode step
        of 2 slots (K4 at G 8, 16 rows): router scores within
        DSV2_SCORE_DIFF_MAX, at least DSV2_PICKS_AGREE_MIN of the tokens with
        the CPU's picks, logits within DSV2_CUT_TOL where they agree;
      - the server with 2 slots over a q8 cache: two chat requests one at a
        time and then at once, replies identical (K2 and K4 launched)."""
    from chatllm_tpu_torch.models.model_types import ModelType
    from chatllm_tpu_torch.models.synthetic import (build_synthetic_params, param_bytes,
                                                    qwen3_30b_a3b_config)
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.cuda.flash import MODE_LAUNCHES, reset_mode_launches
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine, PerfInfo

    held = torch.cuda.memory_allocated(dev) / 2 ** 30
    if held > 2.0:
        raise AssertionError(f"qwen3_30b_a3b: {held:.2f} GiB of earlier phases still held")
    res = {"held_before_gib": held}
    cfg = qwen3_30b_a3b_config(max_length=8192)
    cfg = _cfg_cut(cfg, A3B_DEPTH)
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev, centered=True)
    torch.cuda.synchronize()
    res["build"] = {"seconds": time.perf_counter() - t0, "param_bytes": param_bytes(params),
                    "expert_bytes": param_bytes([lay["mlp"]["experts"]
                                                 for lay in params["layers"]]),
                    "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    log(f"  built: {res['build']}")

    # prefill chunks over a bf16 cache: K3's mode 2, L launches a chunk
    rng = np.random.default_rng(0)
    eng = InferenceEngine(cfg, params, device=dev)
    pre = {}
    with torch.inference_mode():
        for n in A3B_PREFILL:
            ids = rng.integers(0, cfg.vocab_size, n).tolist()
            kv = eng.new_cache(1)
            eng.prefill(ids, kv, 0)                               # warm
            torch.cuda.synchronize()
            reset_launch_counts()
            reset_mode_launches()
            t0 = time.perf_counter()
            logits = eng.prefill(ids, kv, 0)[0]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = launch_counts()
            f32q = MODE_LAUNCHES[2]
            pre[n] = {"ms": ms, "flash_attention_f32q": f32q, "qgemv": got["qgemv"]}
            log(f"  prefill {n} tokens: {ms:.1f} ms, K3 mode 2 {f32q} launches, K1 "
                f"{got['qgemv']}")
            if f32q != L or got["flash_attention"] != L or not torch.isfinite(logits).all():
                raise AssertionError(f"a3b prefill {n}: K3 launched {got['flash_attention']} "
                                     f"times ({f32q} in mode 2), expected {L}")
            del kv
    res["prefill"] = pre
    del eng

    ids = rng.integers(0, cfg.vocab_size, A3B_PROMPT).tolist()
    gcfg = GenerationConfig(do_sample=False, max_new_tokens=A3B_NEW)
    steps = decode_launches(A3B_NEW)
    chat = {}
    for key, cache, graphs in (("bfloat16_eager", "bfloat16", False),
                               ("bfloat16_graph", "bfloat16", True),
                               ("int8_eager", "int8", False), ("int8_graph", "int8", True)):
        eng = InferenceEngine(replace(cfg, cache_dtype=cache), params, device=dev,
                              cuda_graphs=graphs)
        kv = eng.new_cache(1)
        if graphs:
            eng.generate(ids, gcfg, cache=kv)                     # warm: captures
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        perf = PerfInfo()
        out, kv, n_past = eng.generate(ids, gcfg, perf=perf, cache=kv)
        torch.cuda.synchronize()
        got = launch_counts()
        dec = eng.decoder
        r = {"tokens": out, "prefill_ms": perf.prompt_ms,
             "decode_steps_s": (len(out) - 1) / perf.gen_ms * 1e3,
             "graphs": dec.num_graphs(), "capture_ms": dec.capture_ms,
             "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
             "launches": {k: got[k] for k in ("qgemv", "qmm", "flash_attention",
                                              "flash_decode")}}
        if key == "int8_graph":
            pb = _profile_block(eng, kv, len(ids) + 48)
            pb["by_kind"] = _step_breakdown(pb.pop("kernels_ms"), pb["step_ms"])
            r["profiled_block"] = pb
        log(f"  {key}: {r['decode_steps_s']:.2f} decode steps/s, prefill "
            f"{r['prefill_ms']:.1f} ms, {r['graphs']} graphs in {r['capture_ms']:.0f} ms, "
            f"peak {r['peak_mem_gib']:.2f} GiB, launches {r['launches']}"
            + (f"; replayed block {r['profiled_block']}" if "profiled_block" in r else ""))
        # the prompt takes K3 over the bf16 cache (a q8 one: the chunked
        # einsum), each decode step K4 over the q8 cache
        want = {"qgemv": a3b_step_launches(cfg) * steps + 1,
                "flash_attention": L if cache == "bfloat16" else 0,
                "flash_decode": L * steps if cache == "int8" else 0}
        if len(out) != A3B_NEW or n_past != len(ids) + len(out) - 1:
            raise AssertionError(f"a3b {key}: {len(out)} tokens, n_past {n_past}")
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"a3b {key}: launches {r['launches']}, expected {want} "
                                 f"({steps} launched steps)")
        chat[key] = r
        del eng, kv
        torch.cuda.empty_cache()
    for c in ("bfloat16", "int8"):
        if chat[c + "_graph"]["tokens"] != chat[c + "_eager"]["tokens"]:
            raise AssertionError(f"a3b {c}: graph tokens differ from the eager loop's")
    chat["per_step"] = {"qgemv": a3b_step_launches(cfg), "flash_decode_q8": L,
                        "flash_attention_f32q_per_chunk": L}
    res["chat"] = chat

    res["expert_products"] = expert_products(dev, cfg, params["layers"][0]["mlp"], L)

    res["two_layer"] = dsv2_two_layer(dev, cfg, params, slots=2)
    torch.cuda.empty_cache()

    res["serve"] = serve_phase(dev, cfg, params, model_type=ModelType.QWEN3,
                               tok=_ivl_tokenizer(cfg), name="qwen3-30b-a3b-synthetic",
                               prompt_bytes=A3B_SERVE_BYTES, max_new=16, slots=2)
    res["peak_mem_gib"] = max([res["build"]["peak_mem_gib"], res["serve"]["peak_mem_gib"]]
                              + [chat[k]["peak_mem_gib"] for k in chat if k != "per_step"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------- families phase
FAMILY_PROMPT = 32                 # prompt tokens of the families' card-vs-CPU logits
# at least this share of the prompt's tokens must pick the CPU's experts in
# every MoE layer of a narrow q4_k model (bf16 activations: a near-tie of 8
# experts may flip); the logits are compared where the picks agree
FAMILY_PICKS_AGREE_MIN = 0.75
FAMILY_TOL = {"f32": 1e-4, "q4_k": 2e-2}
# --test chats too
FAMILY_CHATS = (("llama2", "codellama", "mistral", "mixtral", "mistral2") + GEMMA_FAMILIES
                + GLM_FAMILIES + ("phi2", "phi2_v1", "dolphinphi2", "phi3", "phi3_su2",
                                  "phi3_su3", "phi4", "gpt_oss"))
# the families whose card-vs-CPU logits take the FAMILY_RING_PROMPT tokens
# that wrap their rings: RING_FAMILIES and GPT-OSS (its layer 0; its chat
# turns stay short: its byte-level vocab takes a token a byte)
RING_PROMPT_FAMILIES = RING_FAMILIES + ("gpt_oss",)


def family_turns(fam: str) -> list:
    """Two user turns for a family's `--test` chat: short ones, or for the
    ring families ~400 bytes each, so that the chat wraps their 576-slot
    rings inside the 1024-token context."""
    if fam not in RING_FAMILIES:
        return ["Hello from the H100!", "And once more, with feeling."]
    words = ("the", "hello", "world", "in", "a", "ring", "of", "keys", "is", "at", "2024",
             "and", "on", "window", "to", "wrap", "中文", "µ")
    rng = np.random.default_rng(len(fam))
    return [" ".join(rng.choice(words, 160)).capitalize() + "." for _ in range(2)]


def same_params(a, b, where="params"):
    """Card parameters `a` against the CPU's `b`: the same structure and
    fields, every tensor on the card with the CPU tensor's dtype, shape and
    bits."""
    same = True
    if isinstance(b, dict):
        same = set(a) == set(b)
        for k in b if same else ():
            same_params(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (tuple, list)):
        same = type(a) is type(b) and len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b) if same else ()):
            same_params(x, y, f"{where}[{i}]")
    elif hasattr(b, "__dataclass_fields__"):
        same = type(a) is type(b)
        for f in b.__dataclass_fields__ if same else ():
            same_params(getattr(a, f), getattr(b, f), f"{where}.{f}")
    elif isinstance(b, torch.Tensor):
        same = a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b)
    else:
        same = a == b
    if not same:
        raise AssertionError(f"{where}: the card's parameters differ from the CPU's")


def row_logit_errors(g, c, tol: float) -> dict:
    """Card logits g [N, V] against the CPU's c, row by row: the largest
    error over its row's logit scale, and whether the argmax is the CPU's
    wherever the CPU's top two are further apart than twice `tol` of that
    scale (random weights leave near-ties that f32-level differences flip)."""
    scale = c.abs().amax(-1)
    top2 = c.topk(2, dim=-1).values
    clear = top2[:, 0] - top2[:, 1] > 2 * tol * scale
    same = g.argmax(-1) == c.argmax(-1)
    return {"rel_to_logit_scale": ((g - c).abs().amax(-1) / scale).max().item(),
            "max_abs_err": (g - c).abs().max().item(), "clear_rows": int(clear.sum()),
            "argmax_equal_share": same.float().mean().item(),
            "argmax_equal_where_clear": bool(same[clear].all())}


def _family_logits(model, ids) -> tuple:
    """The prompt's logits at every position, the next token's logits (one
    decode step fed the prompt's greedy token) and each MoE layer's sorted
    picks [N, K] over the prompt, in order.  A model with rings takes the
    prompt in chunks of its engine's cap (SWA_EXTRA), as its engine does."""
    from chatllm_tpu_torch.nn import transformer as T

    eng = model.engine
    chunk = eng._chunk_cap or len(ids)
    with torch.inference_mode(), pick_tape() as tape:
        kv = eng.new_cache(1)
        full = torch.cat([model.forward_logits(ids[n:n + chunk], n, cache=kv)[0][0]
                          .float().cpu() for n in range(0, len(ids), chunk)])
        picks = [t[0] for t in tape]
        n_moe = len(picks)
        tok = torch.tensor([[int(full[-1].argmax())]], device=model.device)
        step = T.transformer_forward(model.cfg, model.params, tok, kv, len(ids))[0]
    per = n_moe // -(-len(ids) // chunk)          # MoE layers: picks come chunk by chunk
    return full, step[0, 0].float().cpu(), [torch.cat(picks[i:n_moe:per]) for i in range(per)]


def families_phase(dev) -> dict:
    """Every model type this port registers over blocks already on the card
    (FAMILIES: LLAMA3_2, the three DeepSeek-R1 distills, Qwen3-MoE with a
    sparse and a dense layer, Qwen2-MoE's gated shared expert, DeepSeek V1
    and V1-MoE, DeepSeek-V3 with a low-rank q and grouped sigmoid routing,
    Moonlight, V3-Light, Llama-2, CodeLlama, Mistral and Mixtral over rings
    of 576 slots, Mistral2's 128-wide heads, the Gemmas' heads of 256, the
    GLM families' fused qkv and gate_up, the Phi families' LayerNorm
    decoder, parallel residual and LongRoPE, GPT-OSS's sinks, biased
    softmax-top-k router and swiglu_oai experts over a ring and a full
    layer), written narrow by
    `write_family_ggmm` in f32 and in q4_k and loaded on the card and on the
    CPU: the same config and every parameter bit-equal; the logits of a
    32-token prompt (FAMILY_RING_PROMPT tokens for RING_PROMPT_FAMILIES,
    which wraps their rings) at every position and of one decode step within
    FAMILY_TOL of the CPU's logit scale (q4_k: at the positions whose expert
    picks agree, at least FAMILY_PICKS_AGREE_MIN of them), the same argmax
    wherever the CPU's top two are further apart than twice the tolerance.
    Then the narrow Qwen3-MoE and each new family (FAMILY_CHATS) chat two
    turns through `main.py --test` on the card and on the CPU (f32
    activations and cache): equal transcripts (the ring families' turns
    wrap their rings)."""
    from chatllm_tpu_torch.ggmm.quants import GGMLType
    from chatllm_tpu_torch.models import RuntimeConfig, load_model
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR, launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = {}
    rng = np.random.default_rng(2)
    short = rng.integers(0, 380, FAMILY_PROMPT).tolist()
    long = rng.integers(0, 380, FAMILY_RING_PROMPT).tolist()
    # the narrow Qwen3-MoE and the new families chat through the CLI on the
    # card and on the CPU, in processes that run beside the loads below
    jobs = {}
    for fam in ("qwen3_moe",) + FAMILY_CHATS:
        path = write_family_ggmm(BUILD_DIR / f"smoke_{fam}_f32_cli.bin", fam,
                                 dtype=GGMLType.F32, seed=4)
        turns = BUILD_DIR / f"smoke_{fam}_turns.txt"
        turns.write_text("\n".join(family_turns(fam)) + "\n")
        argv = ["-m", str(path), "--test", str(turns), "-t", "0", "--max_new_tokens", "12",
                "--compute_dtype", "f32", "--cache_dtype", "f32"]
        jobs[fam + ":card"] = (argv, None)
        jobs[fam + ":cpu"] = (argv + ["--device", "cpu"], None)
    chats = _start_cli(jobs)
    reset_launch_counts()
    for fam in FAMILIES:
        ids = long if fam in RING_PROMPT_FAMILIES else short
        for fmt, tol in FAMILY_TOL.items():
            path = write_family_ggmm(BUILD_DIR / f"smoke_{fam}_{fmt}.bin", fam,
                                     dtype=GGMLType.F32 if fmt == "f32" else None)
            compute = "float32" if fmt == "f32" else "bfloat16"
            rt = RuntimeConfig(compute_dtype=compute, cache_dtype=compute)
            card = load_model(str(path), rt, device=dev)
            cpu = load_model(str(path), rt, device="cpu")
            if card.cfg != cpu.cfg or type(card) is not type(cpu):
                raise AssertionError(f"{fam} {fmt}: the card's config differs from the CPU's")
            same_params(card.params, cpu.params)
            (gf, gs, gp), (cf, cs, cp) = _family_logits(card, ids), _family_logits(cpu, ids)
            agree = torch.ones(len(ids), dtype=torch.bool)
            for a, b in zip(gp, cp):
                agree &= (a == b).all(dim=-1)
            g, c = torch.cat([gf[agree], gs[None]]), torch.cat([cf[agree], cs[None]])
            r = {"model": type(card).__name__, "moe_layers": len(cp),
                 "picks_agree_share": agree.float().mean().item(),
                 **row_logit_errors(g, c, tol)}
            log(f"  {fam} {fmt}: {r}")
            if (agree.float().mean() < FAMILY_PICKS_AGREE_MIN or (fmt == "f32" and not agree.all())
                    or r["rel_to_logit_scale"] > tol or not r["argmax_equal_where_clear"]
                    or not torch.isfinite(g).all()):
                raise AssertionError(f"{fam} {fmt}: the card's logits differ from the CPU's "
                                     f"({r}; tolerance {tol})")
            res[f"{fam}_{fmt}"] = r
            del card, cpu
    res["launches"] = launch_counts()
    for k in ("qgemv", "qmm"):
        if res["launches"][k] <= 0:
            raise AssertionError(f"families: kernel {k} was not launched")

    outs = _cli_outputs(chats, "families' chats")
    for fam in ("qwen3_moe",) + FAMILY_CHATS:
        card, cpu = outs[fam + ":card"], outs[fam + ":cpu"]
        log(f"  {fam} --test transcript:\n" + card.rstrip())
        if _chat_lines(card) != _chat_lines(cpu) or len(_replies(card)) != 2:
            raise AssertionError(f"the {fam} --test transcript differs between the card and "
                                 f"the CPU:\n{card}\n---\n{cpu}")
        res[f"transcript_{fam}"] = card
    res["seconds"] = time.perf_counter() - t0
    log(f"  families phase: {len(FAMILIES)} model types in f32 and q4_k, {res['seconds']:.1f} s")
    return res


# ------------------------------------------------------------ mistral_7b phase
MISTRAL_PROMPT = 4480              # prompt tokens, fed to the rings in chunks of SWA_EXTRA
MISTRAL_NEW = 512                  # greedy tokens: decode crosses the wrap at n_past 4608
MISTRAL_EAGER_NEW = 192            # the uncaptured reference's: 64 steps past the wrap
MISTRAL_RING = 4608                # every layer's ring: window 4096 + SWA_EXTRA 512
MISTRAL_DENSE_CTX = 4608           # max_length of the dense windowed route (no ring)
MISTRAL_DENSE_NEW = 64             # q8 decode on the dense route: n_past 4480 -> 4543
# ring against dense windowed prefill logits (the ring's f32 einsum against K3's
# mode 2, which rounds p to bf16 for P.V), of the logit scale
MISTRAL_RING_DENSE_TOL = 2e-2
MISTRAL_CUT_POSITIONS = 4720       # the 2-layer cut's prompt: wraps the ring at 4608
MISTRAL_CUT_STEPS = 2              # then decode steps, a 0-d device offset on the card
# the 2-layer cut's logits, of the logit scale: over bf16 rings the Llama-3-8B
# cut's (two_layer_phase); over q8 rings each side quantizes the keys it
# computed: layer 0's from the same embeddings (f32-level differences, so at
# most one int8 step apart), layer 1's from layer 0's bf16 output, where a
# rounding flip moves a key by 2^-8 of it (up to two steps, in 1.04e-3 of
# the two layers' entries in the first runs on the card); that moved the
# logits by 1.54e-3 of their scale there
MISTRAL_CUT_TOL = {"bfloat16": 1e-3, "int8": 4e-3}
MISTRAL_SERVE = (4560, 4590)       # the 2-slot server's prompts: wrap after 48 and 18 tokens
MISTRAL_SERVE_NEW = 64


class _DequantOnce:
    """While active, `ops/qmm.py`'s dequantize-then-matmul route takes each
    CPU weight's dequantized bf16 values from a memo, held as f32 (which
    `dot_f32` on the CPU computes in anyway): the values its every call
    computes, made once; and the tied head's `dot_f32` takes the f32 copy
    of the CPU embedding it makes on every call from a memo too.  CUDA
    tensors pass through."""

    def __enter__(self):
        from chatllm_tpu_torch.nn import transformer
        from chatllm_tpu_torch.ops import qmm

        self.qmm, self.real, memo = qmm, qmm.dequant_weight, {}
        self.tr, self.dot, tables = transformer, transformer.dot_f32, {}

        def once(lin, dtype=torch.bfloat16):
            if lin.q.is_cuda:
                return self.real(lin, dtype)
            key = (id(lin), dtype)
            if key not in memo:
                memo[key] = self.real(lin, dtype).float()
            return memo[key]

        def dot_once(x, w):
            if x.is_cuda or x.dtype == torch.float32:
                return self.dot(x, w)
            key = (w.data_ptr(), tuple(w.shape), w.stride())
            if key not in tables:
                tables[key] = w.float()
            return torch.matmul(x.float(), tables[key])

        qmm.dequant_weight, transformer.dot_f32 = once, dot_once
        return self

    def __exit__(self, *exc):
        self.qmm.dequant_weight, self.tr.dot_f32 = self.real, self.dot


def _ring_cut(cfg2, params, ids, device, cache: str, *, slots=(MISTRAL_RING,) * 2,
              end: int = MISTRAL_CUT_POSITIONS) -> tuple:
    """A 2-layer cut's logits at every position [N, V] (f32, on the CPU) and
    its caches (on the CPU): the first `end` ids in chunks of SWA_EXTRA into
    caches of `slots` slots a layer (rings of MISTRAL_RING by default), then
    one-token steps for the rest, their offset a 0-d tensor on the card (the
    captured decode block's form) and an int on the CPU."""
    from chatllm_tpu_torch.nn import transformer as T

    c2 = replace(cfg2, cache_dtype=cache)
    kv = T.init_cache(c2, 1, cfg2.max_length, device=device)
    if tuple(t.shape[1] for t in kv.k) != tuple(slots):
        raise AssertionError(f"2-layer cut: cache slots {[t.shape[1] for t in kv.k]}")
    outs, n = [], 0
    with torch.inference_mode():
        while n < len(ids):
            m = min(T.SWA_EXTRA, end - n) if n < end else 1
            x = torch.as_tensor(ids[None, n:n + m], device=device)
            off = n if n < end or device == "cpu" else torch.tensor(n, device=device)
            outs.append(T.transformer_forward(c2, params, x, kv, off)[0][0].float().cpu())
            n += m
    return torch.cat(outs), _cache_copy(kv, "cpu")


def _cut_compare(name: str, g, c, tol: float, strict: bool = True) -> dict:
    """Card logits g [N, V] against the CPU's c (`row_logit_errors`): finite,
    within `tol`, the argmax equal where clear (r["within_tolerance"]; with
    `strict`, raises where not)."""
    if g.shape != c.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: logits shape {tuple(g.shape)} or not finite")
    r = {"positions": int(g.shape[0]), **row_logit_errors(g, c, tol)}
    r["within_tolerance"] = r["rel_to_logit_scale"] <= tol and r["argmax_equal_where_clear"]
    log(f"  {name}: {r}")
    if strict and not r["within_tolerance"]:
        raise AssertionError(f"{name}: logits differ from the CPU run ({r}; tolerance {tol})")
    return r


def _timed_generate(eng, kv, ids, new: int, name: str) -> tuple[list, dict]:
    """`new` greedy tokens of `ids` through the engine on the cache `kv`:
    the tokens, and the prefill and decode times, the decode block's eager
    and replayed steps and captures, and the launch counts (K3's by mode)
    of this call."""
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.cuda.flash import MODE_LAUNCHES, reset_mode_launches
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, PerfInfo

    dec = eng.decoder
    was = (dec.eager_steps, dec.replayed_steps, dec.capture_ms)
    reset_launch_counts()
    reset_mode_launches()
    perf = PerfInfo()
    out, _, n_past = eng.generate(ids, GenerationConfig(do_sample=False, max_new_tokens=new),
                                  perf=perf, cache=kv)
    torch.cuda.synchronize()
    eager, replayed = dec.eager_steps - was[0], dec.replayed_steps - was[1]
    capture_ms = dec.capture_ms - was[2]
    steps = len(out) - 1
    r = {"prompt_tokens": len(ids), "prefill_ms": perf.prompt_ms, "gen_tokens": len(out),
         "decode_ms": perf.gen_ms, "decode_steps_s": steps / perf.gen_ms * 1e3,
         "eager_steps": eager, "replayed_steps": replayed, "capture_ms": capture_ms,
         "graphs": dec.num_graphs(), "launches": launch_counts(),
         "flash_modes": dict(MODE_LAUNCHES)}
    if replayed:
        # the decode span without the warm-up block and the capture
        r["replayed_steps_s"] = replayed / (perf.gen_ms - capture_ms) * 1e3
    if len(out) != new or n_past != len(ids) + new - 1:
        raise AssertionError(f"{name}: {len(out)} tokens, n_past {n_past}")
    return out, r


def _mistral_config():
    from chatllm_tpu_torch.models.synthetic import mistral_7b_config

    cfg = mistral_7b_config(max_length=8192)
    return _cfg_cut(cfg, MISTRAL_DEPTH)


def mistral_setup(dev) -> dict:
    """The mistral_7b phase's 2-layer cut, its CPU side started in a worker
    thread ahead of the phase, beside the card's work of the phases before
    it: Mistral-7B's parameters are built on the card from seed 0, the cut's
    two layers copied to the CPU and the card's copy freed (the phase builds
    the same parameters again).  The worker runs on all host cores but one,
    which the card's dispatch keeps; the phase restores the count."""
    from chatllm_tpu_torch.models.synthetic import build_synthetic_params

    cfg = _mistral_config()
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev)
    cfg2 = _cfg_cut(cfg, 2)
    p2_cpu = _cut(params, 2, "cpu")
    del params
    torch.cuda.empty_cache()
    cut_ids = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                MISTRAL_CUT_POSITIONS + MISTRAL_CUT_STEPS)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 1))    # a host core left for the card's dispatch
    worker = ThreadPoolExecutor(1)

    def cpu_cuts():
        with _DequantOnce():
            return {c: _ring_cut(cfg2, p2_cpu, cut_ids, "cpu", c) for c in ("bfloat16", "int8")}

    return {"cfg2": cfg2, "cut_ids": cut_ids, "threads": threads, "worker": worker,
            "cpu": worker.submit(cpu_cuts)}


def mistral_phase(dev, setup: dict) -> dict:
    """Mistral-7B at full width, cut to MISTRAL_DEPTH of its 32 layers
    (`mistral_7b_config`: sliding window 4096, random q4_k weights from seed
    0) through the port's entry points.

      - The ring route (max_length 8192: 32 rings of 4608 slots), over a
        bf16 and a q8 cache: a MISTRAL_PROMPT-token prompt in chunks of
        SWA_EXTRA, then MISTRAL_NEW greedy tokens, so decode crosses the
        wrap at n_past 4608 while keys leave the window; replayed from one
        CUDA graph (the rings are read whole, so no KV bucket splits the
        keys), launches exact (K1 7 L + 1 per launched step and once per
        prefill chunk, no K3, no K4), one replayed block past the wrap timed and
        profiled; then the uncaptured loop, whose first MISTRAL_EAGER_NEW
        tokens must be the replayed ones.
      - The dense windowed route (max_length 4608: no ring): the same prompt
        over a bf16 cache, K3 in mode 2 with window 4096 (2 chunks x L
        launches), its last logits against the ring route's within
        MISTRAL_RING_DENSE_TOL; then a q8 decode of MISTRAL_DENSE_NEW tokens
        from n_past MISTRAL_PROMPT (past the window), K4 with window 4096 on
        every layer of every launched step, its tokens' agreement with the
        ring route's recorded.
      - The server's engine (BatchedEngine, 2 slots, q8 rings): two requests
        of MISTRAL_SERVE tokens, the second submitted once the first
        streams, 64 greedy tokens each, wrapping at different ring phases;
        each reply must equal the single-stream InferenceEngine's tokens;
        K2 launched 7 L + 1 times per batched step.
      - A 2-layer cut against the CPU over MISTRAL_CUT_POSITIONS positions
        (across the wrap) and MISTRAL_CUT_STEPS decode steps, bf16 and q8
        rings, within MISTRAL_CUT_TOL of the logit scale, layer 0's q8
        entries at most one int8 step from the CPU's.  The CPU side runs in
        a worker thread (`mistral_setup`, started before the qwen3_30b_a3b
        phase) beside the card's work (each weight dequantized once,
        `_DequantOnce`); the uncaptured runs wait for it, so that their host
        is not shared."""
    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, param_bytes
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.cuda.flash import MODE_LAUNCHES, reset_mode_launches
    from chatllm_tpu_torch.ops.sampling import SamplerConfig
    from chatllm_tpu_torch.runtime.batching import BatchedEngine
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine

    t_phase = time.perf_counter()
    spans = {}

    def span(name):
        spans[name] = time.perf_counter() - t_phase - sum(spans.values())

    cfg = _mistral_config()
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    per_step = 7 * L + 1                       # K1 per decode step: 7 projections x L + lm_head
    torch.cuda.reset_peak_memory_stats(dev)
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev)
    torch.cuda.synchronize()
    res = {"param_gib": param_bytes(params) / 2 ** 30, "spans_s": spans}
    prompt = np.random.default_rng(0).integers(0, V, MISTRAL_PROMPT).tolist()
    chunks = -(-MISTRAL_PROMPT // 512)
    cfg2, cut_ids = setup["cfg2"], setup["cut_ids"]
    cut_cpu, worker, threads = setup["cpu"], setup["worker"], setup["threads"]
    span("setup")

    def generate(eng, kv, ids, new: int) -> tuple[list, dict]:
        return _timed_generate(eng, kv, ids, new, "mistral")

    # ---- the ring route, replayed from CUDA graphs
    ring, logits_ring = {}, None
    for cache in ("bfloat16", "int8"):
        eng = InferenceEngine(replace(cfg, cache_dtype=cache), params, device=dev)
        kv = eng.new_cache(1)
        if any(t.shape[1] != MISTRAL_RING for t in kv.k):
            raise AssertionError(f"ring slots {[t.shape[1] for t in kv.k]}")
        toks, r = generate(eng, kv, prompt, MISTRAL_NEW)
        launched = r["eager_steps"] + r["replayed_steps"]
        want = {"qgemv": per_step * launched + chunks, "qmm": 0, "flash_attention": 0,
                "flash_decode": 0}
        got = {k: r["launches"][k] for k in want}
        log(f"  ring {cache}: prefill {r['prefill_ms']:.1f} ms ({chunks} chunks), "
            f"{r.get('replayed_steps_s', 0):.2f} replayed steps/s, {r['graphs']} graph(s) "
            f"captured in {r['capture_ms']:.0f} ms, launches {got}")
        if got != want or r["graphs"] != 1 or r["replayed_steps"] < MISTRAL_NEW - 1:
            raise AssertionError(f"ring {cache}: launches {got} (expected {want}), "
                                 f"{r['graphs']} graphs, {r['replayed_steps']} replayed steps")
        r["profiled_block"] = pb = _profile_block(eng, kv, MISTRAL_PROMPT + MISTRAL_NEW - 32)
        r["profiled_steps_s"] = 1e3 / pb["step_ms"]
        log(f"  ring {cache}: replayed block past the wrap {pb['block_ms']:.2f} ms "
            f"({r['profiled_steps_s']:.2f} steps/s), kernels {pb['kernel_ms']} ms, busy share "
            f"{pb['busy_share']}; top kernels {pb['top_kernels_ms']}")
        if cache == "bfloat16":
            with torch.inference_mode():
                logits_ring = eng.prefill(prompt, eng.new_cache(1), 0)[0].float().cpu()
        ring[cache] = {"graph": r, "tokens": toks}
        del eng, kv
        torch.cuda.empty_cache()
    res["ring"] = ring
    span("ring_graphs")

    # ---- the dense windowed route (no ring): K3 and K4 with window 4096
    dense = {}
    cfg_d = replace(cfg, max_length=MISTRAL_DENSE_CTX)
    eng = InferenceEngine(cfg_d, params, device=dev)
    kv = eng.new_cache(1)
    if any(t.shape[1] != MISTRAL_DENSE_CTX for t in kv.k) or eng._chunk_cap:
        raise AssertionError("dense windowed route: ring layers or a chunk cap")
    reset_launch_counts()
    reset_mode_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits_dense = eng.prefill(prompt, kv, 0)[0].float().cpu()
    dense["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    dense["launches"], dense["flash_modes"] = launch_counts(), dict(MODE_LAUNCHES)
    err, rel = rel_err(logits_dense, logits_ring)
    dense["vs_ring"] = {"max_abs_err": err, "rel_to_logit_scale": rel,
                        "argmax_equal": bool(logits_dense.argmax() == logits_ring.argmax()),
                        "logit_scale": logits_ring.abs().max().item()}
    log(f"  dense windowed bf16 prefill: {dense['prefill_ms']:.1f} ms, K3 by mode "
        f"{dense['flash_modes']}; last logits against the ring route's {dense['vs_ring']}")
    if dense["flash_modes"][2] != 2 * L or dense["flash_modes"][0] or rel > MISTRAL_RING_DENSE_TOL:
        raise AssertionError(f"dense windowed prefill: K3 by mode {dense['flash_modes']} "
                             f"(expected {2 * L} in mode 2), {rel} of the logit scale from the "
                             f"ring route (limit {MISTRAL_RING_DENSE_TOL})")
    del eng, kv
    torch.cuda.empty_cache()
    eng = InferenceEngine(replace(cfg_d, cache_dtype="int8"), params, device=dev)
    toks, r = generate(eng, eng.new_cache(1), prompt, MISTRAL_DENSE_NEW)
    launched = r["eager_steps"] + r["replayed_steps"]
    r["tokens_equal_ring_share"] = float(np.mean(
        [a == b for a, b in zip(toks, ring["int8"]["tokens"])]))
    r["tokens"] = toks
    dense["q8"] = r
    log(f"  dense windowed q8 decode from n_past {MISTRAL_PROMPT}: "
        f"{r.get('replayed_steps_s', 0):.2f} replayed steps/s, K4 launches "
        f"{r['launches']['flash_decode']} ({launched} launched steps), "
        f"{r['tokens_equal_ring_share']:.3f} of the tokens equal the ring route's")
    if r["launches"]["flash_decode"] != L * launched or launched < MISTRAL_DENSE_NEW - 1:
        raise AssertionError(f"dense windowed q8: K4 {r['launches']['flash_decode']}, "
                             f"expected {L * launched}")
    res["dense"] = dense
    del eng
    torch.cuda.empty_cache()
    span("dense")

    # ---- the server's engine: 2 slots over q8 rings, staggered requests
    rng = np.random.default_rng(5)
    sprompts = [rng.integers(0, V, n).tolist() for n in MISTRAL_SERVE]
    c8 = replace(cfg, cache_dtype="int8")
    eng = InferenceEngine(c8, params, device=dev)
    kv = eng.new_cache(1)
    with torch.inference_mode():
        single = [eng.generate(p, GenerationConfig(do_sample=False,
                                                   max_new_tokens=MISTRAL_SERVE_NEW),
                               cache=kv)[0] for p in sprompts]
    del eng, kv
    be = BatchedEngine(c8, params, max_slots=2, scfg=SamplerConfig(do_sample=False),
                       device=dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        h1 = iter(be.submit(sprompts[0], max_new=MISTRAL_SERVE_NEW))
        first = next(h1)                   # the first request is in its slot and streams
        h2 = be.submit(sprompts[1], max_new=MISTRAL_SERVE_NEW)
        replies = [[first] + list(h1), list(h2)]
    finally:
        be.shutdown()
    torch.cuda.synchronize()
    dec = be.decoder
    sr = {"wall_s": time.perf_counter() - t0, "launches": launch_counts(),
          "batched_steps": dec.eager_steps + dec.replayed_steps,
          "replayed_steps": dec.replayed_steps, "graphs": dec.num_graphs(), "replies": replies}
    res["serve"] = sr
    log(f"  2-slot q8 ring server: {sr['wall_s']:.2f} s, {sr['batched_steps']} batched steps "
        f"({sr['replayed_steps']} replayed from {sr['graphs']} graph(s)), K2 "
        f"{sr['launches']['qmm']}")
    if replies != single or any(len(t) != MISTRAL_SERVE_NEW for t in replies):
        raise AssertionError(f"2-slot server: the staggered replies differ from the "
                             f"single-stream engine's:\n{replies}\n{single}")
    if sr["launches"]["qmm"] != per_step * sr["batched_steps"]:
        raise AssertionError(f"2-slot server: K2 {sr['launches']['qmm']}, expected "
                             f"{per_step} x {sr['batched_steps']} batched steps")
    del be
    torch.cuda.empty_cache()
    span("serve")

    # ---- the 2-layer cut on the card, against the CPU's
    p2 = _cut(params, 2, dev)
    card = {c: _ring_cut(cfg2, p2, cut_ids, dev, c) for c in ("bfloat16", "int8")}
    t0 = time.perf_counter()
    cpu = cut_cpu.result()
    res["cut"] = {"cpu_wait_s": time.perf_counter() - t0}
    worker.shutdown()
    torch.set_num_threads(threads)
    for cache in ("bfloat16", "int8"):
        (g, g_kv), (c, c_kv) = card[cache], cpu[cache]
        r = res["cut"][cache] = _cut_compare(
            f"2-layer {cache} ring cut card vs cpu over {len(cut_ids)} positions", g, c,
            MISTRAL_CUT_TOL[cache])
        if cache == "int8":
            for i in range(2):
                steps = torch.cat([(a.int() - b.int()).abs().flatten()
                                   for a, b in ((g_kv.k[i], c_kv.k[i]), (g_kv.v[i], c_kv.v[i]))])
                r[f"layer{i}_int8_steps"] = {"max": int(steps.max()),
                                             "one_step_share": (steps == 1).float().mean().item()}
            log(f"  q8 rings card vs cpu, int8 entries apart: layer 0 {r['layer0_int8_steps']}, "
                f"layer 1 {r['layer1_int8_steps']}")
            if r["layer0_int8_steps"]["max"] > 1:
                raise AssertionError(f"q8 rings: layer 0's int8 entries up to "
                                     f"{r['layer0_int8_steps']['max']} steps from the CPU's")
    del p2, card, cpu
    span("cut")

    # ---- the uncaptured loop: the replayed tokens' reference over their first
    # MISTRAL_EAGER_NEW, across the wrap (the host to itself)
    for cache in ("bfloat16", "int8"):
        eng = InferenceEngine(replace(cfg, cache_dtype=cache), params, device=dev,
                              cuda_graphs=False)
        toks, r = generate(eng, eng.new_cache(1), prompt, MISTRAL_EAGER_NEW)
        ring[cache]["eager"] = r
        ring[cache]["graph_over_eager"] = (ring[cache]["graph"]["profiled_steps_s"]
                                           / r["decode_steps_s"])
        log(f"  ring {cache}, uncaptured: {r['decode_steps_s']:.2f} decode steps/s, prefill "
            f"{r['prefill_ms']:.1f} ms")
        if toks != ring[cache]["tokens"][:MISTRAL_EAGER_NEW]:
            raise AssertionError(f"ring {cache}: replayed tokens differ from the uncaptured "
                                 f"loop's:\n{ring[cache]['tokens']}\n{toks}")
        if r["launches"]["qgemv"] != per_step * r["eager_steps"] + chunks:
            raise AssertionError(f"ring {cache} uncaptured: K1 {r['launches']['qgemv']}")
        del eng
        torch.cuda.empty_cache()
    span("uncaptured")
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  mistral_7b phase: params {res['param_gib']:.2f} GiB, peak device memory "
        f"{res['peak_mem_gib']:.2f} GiB, {res['seconds']:.1f} s ({spans})")
    return res


# ------------------------------------------------------------ gemma3_12b phase
GEMMA3_PROMPT = 2048               # prompt tokens: 4 chunks of SWA_EXTRA wrap the 1536-slot
#                                    rings; decode then stays in one KV bucket (3072), one graph
GEMMA3_NEW = 256                   # greedy tokens, replayed and uncaptured
GEMMA3_RING = 1536                 # the local layers' rings: window 1024 + SWA_EXTRA 512
GEMMA3_GLOBAL = (5, 11, 17, 23, 29, 35, 41, 47)    # layer i global iff (i + 1) % 6 == 0
GEMMA3_DENSE_CTX = 1536            # max_length of the dense windowed route (no ring)
GEMMA3_DENSE_PROMPT = 1500         # its prompt: the ring route's first 1500 tokens
# The dense windowed route's last logits against the ring route's, of the
# logit scale, both at f32 activations (the embedding in f32, as
# --compute_dtype f32 loads it): Mistral-7B's bound.  At bf16 activations
# the two read 2.14e-2 apart (NVIDIA H100 80GB HBM3, 700 W): 48 layers of
# bf16 hidden states round the routes' f32 sums (K3's mode 2 over 1024-row
# chunks against the ring's einsum over 512-row ones) apart, and the tied
# head's zero-mean logits have no common component to dwarf that.  At f32
# activations those roundings go; a wrong window or rope table would still
# move every score.  The argmax must be equal too.
GEMMA3_RING_DENSE_TOL = 2e-2
GEMMA3_CUT_LAYERS = (4, 5)         # the 2-layer cut: a local layer, then a global one
GEMMA3_CUT_POSITIONS = 1600        # its prompt: wraps the local ring at 1536
GEMMA3_SERVE = (2150, 2170)        # the 2-slot server's prompts: they wrap the rings in
#                                    prefill, at other phases; their last chunks (102, 122
#                                    rows) take no K2
GEMMA3_SERVE_NEW = 64
# The Gemma cuts' logits against the CPU's, of the logit scale, each cut
# also run on the card with its attention scale one f32 step up (the
# witness, against the card: a difference at the size of two f32 sum
# orders' parting) and with a fault (the control: Gemma-3's local layer on
# the global rope table, Gemma-2 without its sandwich norms).  The bound
# must pass the witness and fail the control.  The quantized matmuls round
# their inputs to bf16 at any activation dtype (K2's twin, like the Pallas
# kernel, adds the group minimum's term from f32 x): an f32-level
# difference flips some roundings, each flip moves the next outputs by a
# bf16 step of an input times a weight, and within two layers the two sides
# part at the bf16 level; the zero-mean tied head leaves the logits no
# component common to the vocabulary (the Llama and Mistral cuts' untied,
# positive-biased heads inflate their scale so), so that shows at its own
# size.  Readings over bf16 / q8 caches (NVIDIA H100 80GB HBM3, 700 W):
# card against CPU 7.96e-3 / 8.55e-3 (Gemma-3) and 7.85e-3 / 8.68e-3
# (Gemma-2); the witness 6.40e-3 / 6.11e-3 and 6.20e-3 / 6.92e-3; the
# control 1.255 and 1.086 (PERF.md).  The bound: 2.3x the largest card
# reading, 54x under the smaller control.  Argmax: equal wherever the CPU's
# top two are further apart than twice the bound; the share equal where
# they are 2e-3 of the scale apart is recorded.
GEMMA_CUT_TOL = {"bfloat16": 2e-2, "int8": 2e-2}
# The 2-slot server's replies against the single-stream engine's logits,
# teacher-forced on each reply (its prefill of the prompt, then of the
# reply but its last token): at every step the server's token must be the
# argmax there, or within this share of the logit scale of it.  Both run at
# f32 activations; their routes (K2 at 2 rows and K4 at a per-row n_past
# against the prefill's matmuls, K3 and ring einsum) part at the bf16 level
# of the matmuls' inputs.  Readings (NVIDIA H100 80GB HBM3, 700 W): 125 of
# 128 steps the argmax, the other three 5.5e-4, 1.2e-3 and 2.2e-3 below it;
# free-running at bf16 activations the replies parted at gaps of 2.2e-3 and
# 7.7e-3.
GEMMA3_SERVE_TIE = 8e-3
GEMMA3_UNCAPTURED_TIMEOUT = 600    # seconds the uncaptured reference's process may take
# The uncaptured reference's model: Gemma-3-12B's first 12 of 48 layers (ten
# local, two global), so that its host-bound steps (6.88 / 5.22 steps/s at
# 48 layers) leave room in the script; its tokens are held against replayed
# ones of the same cut in its own process
GEMMA3_UNCAPTURED_DEPTH = 12


def gemma3_setup(dev) -> dict:
    """The gemma3_12b phase's 2-layer cut (GEMMA3_CUT_LAYERS), its CPU side
    queued on CUT_WORKER ahead of Gemma-2's, so that both run while the card
    works through the gemma3_12b phase: Gemma-3-12B's parameters are built on
    the card from seed 0, the cut's layers copied to the CPU and the card's
    copy freed (the phase builds the same parameters again)."""
    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, gemma3_12b_config

    t0 = time.perf_counter()
    cfg = gemma3_12b_config(max_length=8192)
    a, b = GEMMA3_CUT_LAYERS
    cfg2 = replace(cfg, num_hidden_layers=2, layer_specs=cfg.layer_specs[a:b + 1])
    params = build_synthetic_params(cfg, "q4k", zeros=False, centered=True, seed=0, device=dev)
    sel = _to_device(dict(params, layers=params["layers"][a:b + 1]), "cpu")
    del params
    torch.cuda.empty_cache()
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, GEMMA3_CUT_POSITIONS + 2)
    kw = dict(slots=(GEMMA3_RING, cfg.max_length), end=GEMMA3_CUT_POSITIONS)
    return {"cfg2": cfg2, "sel": sel, "ids": ids, "kw": kw,
            "cpu": _cpu_cuts("gemma3_12b", cfg2, sel, ids, kw),
            "setup_s": time.perf_counter() - t0}


def gemma3_phase(dev, setup: dict) -> dict:
    """Gemma-3-12B at full width and depth (`gemma3_12b_config`: 48 layers of
    head_dim 256, 40 local layers over 1024-key windows on the local rope
    table beside 8 global ones, sandwich norms, random zero-centred q4_k
    weights from seed 0, the tied bf16 head) through the port's entry points.

      - The ring route (max_length 8192: 40 rings of 1536 slots, 8 global
        layers of 8192), over a bf16 and a q8 cache: a GEMMA3_PROMPT-token
        prompt in chunks of SWA_EXTRA (K3 in mode 2 on the 8 global layers of
        every chunk over bf16), then GEMMA3_NEW greedy tokens replayed from
        CUDA graphs, launches exact (K1 336 per launched step, K4 8 per q8
        step), one replayed block timed and profiled.  The uncaptured
        reference runs at a depth cut, GEMMA3_UNCAPTURED_DEPTH layers, in a
        process of its own (`gemma3_uncaptured_start`): its GEMMA3_NEW
        uncaptured tokens against replayed ones of the same cut, checked
        after the cli phase.
      - The dense windowed route (max_length 1536: no ring): the prompt's
        first GEMMA3_DENSE_PROMPT tokens over a bf16 cache at f32
        activations, K3 in mode 2 on all 48 layers (window 1024 on the local
        ones), its last logits against the ring route's on the same tokens
        and activations within GEMMA3_RING_DENSE_TOL, the same argmax.
      - The server's engine (BatchedEngine, 2 slots, q8, f32 activations):
        two requests of GEMMA3_SERVE tokens, the second submitted once the
        first streams, 64 greedy tokens each, their rings wrapping at other
        phases; the replies must equal the same server's taking the requests
        one at a time bit for bit, and at every step be the single-stream
        engine's greedy choice on the same prefix, teacher-forced, up to
        GEMMA3_SERVE_TIE; K2 336 and K4 8 per batched step (per-row n_past).
      - A 2-layer cut (GEMMA3_CUT_LAYERS: local, global) against the CPU
        over GEMMA3_CUT_POSITIONS positions and 2 decode steps, bf16 and q8,
        within GEMMA_CUT_TOL of the logit scale, beside its witness and its
        control (`_gemma_cut_check`); its CPU side on CUT_WORKER from
        `gemma3_setup`.
      - Peak device memory."""
    from chatllm_tpu_torch.models.synthetic import (build_synthetic_params, gemma3_12b_config,
                                                    param_bytes)
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.cuda.flash import MODE_LAUNCHES, reset_mode_launches
    from chatllm_tpu_torch.runtime.generate import InferenceEngine

    t_phase = time.perf_counter()
    spans = {}

    def span(name):
        spans[name] = time.perf_counter() - t_phase - sum(spans.values())

    cfg = gemma3_12b_config(max_length=8192)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    glob = [i for i in range(L) if not cfg.layer_spec(i).sliding_window]
    if tuple(glob) != GEMMA3_GLOBAL:
        raise AssertionError(f"gemma3: global layers {glob}")
    per_step = 7 * L                  # K1 per decode step (the tied head is dot_f32)
    n_glob = len(glob)
    torch.cuda.reset_peak_memory_stats(dev)
    params = build_synthetic_params(cfg, "q4k", zeros=False, centered=True, seed=0, device=dev)
    torch.cuda.synchronize()
    res = {"param_gib": param_bytes(params) / 2 ** 30, "spans_s": spans,
           "k1_per_step": per_step, "k4_per_q8_step": len(glob)}
    prompt = gemma3_prompt(V)
    chunks = -(-GEMMA3_PROMPT // 512)
    slots = [GEMMA3_RING if cfg.layer_spec(i).sliding_window else cfg.max_length
             for i in range(L)]
    p32 = dict(params, embed=params["embed"].float())    # f32 activations

    # ---- the 2-layer cut's CPU side, on CUT_WORKER since gemma3_setup
    a, b = GEMMA3_CUT_LAYERS
    cfg2, sel, cut_ids, cut_kw = setup["cfg2"], setup["sel"], setup["ids"], setup["kw"]
    res["cut_setup_s"] = setup["setup_s"]
    span("setup")

    # ---- the ring route, replayed from CUDA graphs
    ring = {}
    for cache in ("bfloat16", "int8"):
        eng = InferenceEngine(replace(cfg, cache_dtype=cache), params, device=dev)
        kv = eng.new_cache(1)
        if [t.shape[1] for t in kv.k] != slots or eng._chunk_cap != 512:
            raise AssertionError(f"gemma3 ring slots {[t.shape[1] for t in kv.k]}")
        toks, r = _timed_generate(eng, kv, prompt, GEMMA3_NEW, "gemma3")
        launched = r["eager_steps"] + r["replayed_steps"]
        q8 = cache == "int8"
        want = {"qgemv": per_step * launched, "qmm": 0,
                "flash_attention": 0 if q8 else n_glob * chunks,
                "flash_decode": n_glob * launched if q8 else 0}
        got = {k: r["launches"][k] for k in want}
        log(f"  ring {cache}: prefill {r['prefill_ms']:.1f} ms ({chunks} chunks), "
            f"{r.get('replayed_steps_s', 0):.2f} replayed steps/s, {r['graphs']} graph(s) "
            f"captured in {r['capture_ms']:.0f} ms, launches {got}, K3 by mode "
            f"{r['flash_modes']}")
        if (got != want or r["flash_modes"][2] != want["flash_attention"] or r["graphs"] != 1
                or r["replayed_steps"] < GEMMA3_NEW - DECODE_BLOCK or len(set(toks)) < 8):
            raise AssertionError(f"gemma3 ring {cache}: launches {got} (expected {want}), K3 "
                                 f"by mode {r['flash_modes']}, {r['replayed_steps']} replayed "
                                 f"steps, {len(set(toks))} distinct tokens")
        # one replayed block timed, and over bf16 traced (the profiler's trace
        # of a 16-step block of 48 layers takes it seconds)
        r["profiled_block"] = pb = _profile_block(eng, kv, GEMMA3_PROMPT + GEMMA3_NEW - 32,
                                                  trace=not q8)
        r["profiled_steps_s"] = 1e3 / pb["step_ms"]
        log(f"  ring {cache}: replayed block {pb['block_ms']:.2f} ms "
            f"({r['profiled_steps_s']:.2f} steps/s), kernels {pb.get('kernel_ms')} ms, busy "
            f"share {pb.get('busy_share')}; top kernels {pb.get('top_kernels_ms')}")
        ring[cache] = {"graph": r, "tokens": toks}
        del eng, kv
        torch.cuda.empty_cache()
    res["ring"] = ring
    span("ring_graphs")

    # ---- the dense windowed route (no ring): K3 on every layer, window 1024;
    # against the ring route, both at f32 activations
    dense = {}
    with torch.inference_mode():
        eng = InferenceEngine(cfg, p32, device=dev)
        logits_ring = eng.prefill(prompt[:GEMMA3_DENSE_PROMPT], eng.new_cache(1),
                                  0)[0].float().cpu()
        eng = InferenceEngine(replace(cfg, max_length=GEMMA3_DENSE_CTX), p32, device=dev)
        kv = eng.new_cache(1)
        if any(t.shape[1] != GEMMA3_DENSE_CTX for t in kv.k) or eng._chunk_cap:
            raise AssertionError("gemma3 dense windowed route: ring layers or a chunk cap")
        torch.cuda.synchronize()
        reset_launch_counts()
        reset_mode_launches()
        t0 = time.perf_counter()
        logits_dense = eng.prefill(prompt[:GEMMA3_DENSE_PROMPT], kv, 0)[0].float().cpu()
    dense["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    dense["launches"], dense["flash_modes"] = launch_counts(), dict(MODE_LAUNCHES)
    err, rel = rel_err(logits_dense, logits_ring)
    dense["vs_ring"] = {"max_abs_err": err, "rel_to_logit_scale": rel,
                        "argmax_equal": bool(logits_dense.argmax() == logits_ring.argmax()),
                        "logit_scale": logits_ring.abs().max().item()}
    d_chunks = 2                       # a 1024-row chunk and the rest in a 512-row bucket
    log(f"  dense windowed prefill of {GEMMA3_DENSE_PROMPT} (f32 activations, bf16 cache): "
        f"{dense['prefill_ms']:.1f} ms, K3 by mode {dense['flash_modes']}; last logits "
        f"against the ring route's {dense['vs_ring']}")
    if (dense["flash_modes"][2] != d_chunks * L or dense["flash_modes"][0]
            or rel > GEMMA3_RING_DENSE_TOL or not dense["vs_ring"]["argmax_equal"]):
        raise AssertionError(f"gemma3 dense windowed prefill: K3 by mode {dense['flash_modes']} "
                             f"(expected {d_chunks * L} in mode 2), {rel} of the logit scale "
                             f"from the ring route (limit {GEMMA3_RING_DENSE_TOL}), argmax "
                             f"equal {dense['vs_ring']['argmax_equal']}")
    res["dense"] = dense
    del eng, kv
    torch.cuda.empty_cache()
    span("dense")

    # ---- the server's engine: 2 slots over q8 rings, staggered requests,
    # f32 activations
    rng = np.random.default_rng(5)
    sprompts = [rng.integers(0, V, n).tolist() for n in GEMMA3_SERVE]
    c8 = replace(cfg, cache_dtype="int8")
    sr = _staggered_server(dev, c8, p32, sprompts, GEMMA3_SERVE_NEW, "gemma3")
    steps, replies = sr["batched_steps"], sr["replies"]
    if (sr["launches"]["qmm"] != per_step * steps
            or sr["launches"]["flash_decode"] != n_glob * steps):
        raise AssertionError(f"gemma3 2-slot server: K2 {sr['launches']['qmm']}, K4 "
                             f"{sr['launches']['flash_decode']}, expected {per_step} and "
                             f"{n_glob} x {steps} batched steps")
    # the single-stream engine, teacher-forced on each reply
    eng = InferenceEngine(c8, p32, device=dev)
    sr["single"] = [_reply_gaps(_forced_rows(eng, p, got), got)
                    for p, got in zip(sprompts, replies)]
    res["serve"] = sr
    log(f"  2-slot q8 server (f32 activations): {sr['wall_s']:.2f} s, {steps} batched steps "
        f"({sr['replayed_steps']} replayed from {sr['graphs']} graph(s)), K2 "
        f"{sr['launches']['qmm']}, K4 {sr['launches']['flash_decode']}; against the "
        f"single-stream engine, teacher-forced {sr['single']}")
    if any(a["largest_gap"] > GEMMA3_SERVE_TIE for a in sr["single"]):
        raise AssertionError(f"gemma3 2-slot server: a reply's token is not the single-stream "
                             f"engine's greedy choice on its prefix ({sr['single']}; limit "
                             f"{GEMMA3_SERVE_TIE} of the logit scale)")
    del eng
    torch.cuda.empty_cache()
    span("serve")

    # ---- the 2-layer cut on the card, against the CPU's; the control: the
    # local layer on the global rope table
    p2 = _to_device(sel, dev)
    card = {c: _ring_cut(cfg2, p2, cut_ids, dev, c, **cut_kw)[0] for c in ("bfloat16", "int8")}
    witness, control = _witness_and_control(cfg2, p2, cut_ids, cut_kw,
                                            replace(cfg2, rope_local=None))
    t0 = time.perf_counter()
    cpu = setup["cpu"].result()
    wait = time.perf_counter() - t0
    res["cut"] = dict(_gemma_cut_check(f"gemma3 2-layer cut (layers {a}, {b})", card, cpu,
                                       witness, control,
                                       "the local layer on the global rope table"),
                      cpu_wait_s=wait, layers=list(GEMMA3_CUT_LAYERS))
    del p2, card, cpu, witness, control, p32, sel
    span("cut")
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  gemma3_12b phase: params {res['param_gib']:.2f} GiB, peak device memory "
        f"{res['peak_mem_gib']:.2f} GiB, {res['seconds']:.1f} s ({spans})")
    return res


def _run_s() -> float:
    """Seconds since the first phase began."""
    return time.perf_counter() - PHASE_STARTS[0][1] if PHASE_STARTS else 0.0


def _cpu_cuts(name: str, cfg2, p_cpu, ids, kw, caches=("bfloat16", "int8"),
              picks: bool = False):
    """A cut's CPU side over a bf16 and a q8 cache (or `caches`), queued on
    CUT_WORKER (one cut at a time, on all host cores but one: the card's
    dispatch keeps it; each weight dequantized once).  CUT_JOBS[name] gets
    when it was queued, began and ended, in seconds into the run.  Returns
    the future of {cache: logits}, or with `picks` of {cache: (logits, the
    tape of its expert picks)} (`pick_tape`)."""
    queued = _run_s()

    def one(c):
        if not picks:
            return _ring_cut(cfg2, p_cpu, ids, "cpu", c, **kw)[0]
        with pick_tape() as tape:
            return _ring_cut(cfg2, p_cpu, ids, "cpu", c, **kw)[0], tape

    def run():
        began = _run_s()
        torch.set_num_threads(max(1, HOST_THREADS - 1))
        try:
            with _DequantOnce():
                return {c: one(c) for c in caches}
        finally:
            torch.set_num_threads(HOST_THREADS)
            CUT_JOBS[name] = {"queued_s": queued, "began_s": began, "ended_s": _run_s()}

    return CUT_WORKER.submit(run)


def _witness_and_control(cfg2, params, ids, kw, fault_cfg) -> tuple:
    """A Gemma cut's witness on the card, {cache: logits} over a bf16 and a
    q8 cache with the attention scale one f32 step up (every score moved by
    about the parting of two f32 sum orders), and its control: the cut
    under `fault_cfg` over bf16."""
    dev = params["embed"].device
    witness = {c: _ring_cut(_scale_step(cfg2), params, ids, dev, c, **kw)[0]
               for c in ("bfloat16", "int8")}
    return witness, _ring_cut(fault_cfg, params, ids, dev, "bfloat16", **kw)[0]


def _gemma_cut_check(name: str, card: dict, cpu: dict, witness: dict, control,
                     fault: str) -> dict:
    """A Gemma cut's card logits against the CPU's, per cache, beside the
    witness against the card (`_witness_and_control`) and, over bf16, the control
    (the card's cut with `fault`) against the CPU: the card and the witness
    within GEMMA_CUT_TOL, the argmax equal where clear, the control outside
    it.  Also records, for both, the share of equal argmaxes on the rows
    whose top two are more than 2e-3 of the scale apart."""
    res = {}
    for cache in ("bfloat16", "int8"):
        res[cache] = {}
        for side, g, c in (("card", card[cache], cpu[cache]),
                           ("witness", witness[cache], card[cache])):
            top2 = c.topk(2, dim=-1).values
            clear = top2[:, 0] - top2[:, 1] > 2e-3 * c.abs().amax(-1)
            ref = "cpu" if side == "card" else "card"
            r = _cut_compare(f"{name} {cache}, {side} vs {ref} over {len(c)} positions", g, c,
                             GEMMA_CUT_TOL[cache], strict=False)
            same = g.argmax(-1) == c.argmax(-1)
            r["argmax_equal_share_at_2e-3"] = same[clear].float().mean().item()
            r["rows_at_2e-3"] = int(clear.sum())
            res[cache][side] = r
    res["control"] = {"fault": fault, "rel_to_logit_scale": row_logit_errors(
        control, cpu["bfloat16"], 0.0)["rel_to_logit_scale"]}
    log(f"  {name}: control ({fault}) {res['control']['rel_to_logit_scale']:.4g} of the logit "
        f"scale")
    bad = [f"{cache} {side}" for cache in ("bfloat16", "int8") for side in ("card", "witness")
           if not res[cache][side]["within_tolerance"]]
    if bad or res["control"]["rel_to_logit_scale"] <= GEMMA_CUT_TOL["bfloat16"]:
        raise AssertionError(f"{name}: {bad or 'the control'} outside the bounds ({res}; "
                             f"bounds {GEMMA_CUT_TOL})")
    return res


def gemma3_prompt(vocab: int) -> list:
    """The gemma3_12b phase's prompt, from seed 0."""
    return np.random.default_rng(0).integers(0, vocab, GEMMA3_PROMPT).tolist()


def gemma3_uncaptured_main(out: str) -> int:
    """`python3 chip_smoke.py --gemma3-uncaptured OUT`: the gemma3_12b
    phase's uncaptured reference in a process of its own, so that its
    host-bound loop (each step dispatches every op of its layers) runs
    beside the phases that follow.  The model is Gemma-3-12B's first
    GEMMA3_UNCAPTURED_DEPTH layers (ten local, two global; the same
    parameters, seed 0) with its prompt: GEMMA3_NEW greedy tokens over a
    bf16 and a q8 ring cache with CUDA graphs off, then replayed from graphs
    on a fresh engine; writes both runs' tokens, times and launch counts to
    OUT as JSON (`gemma3_uncaptured_check` compares them)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 2
    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, gemma3_12b_config
    from chatllm_tpu_torch.runtime.generate import InferenceEngine

    torch.set_num_threads(1)           # the parent's phases keep the other host cores
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    full = gemma3_12b_config(max_length=8192)
    n = GEMMA3_UNCAPTURED_DEPTH
    # the draws run embedding, then layer by layer: these are the full
    # model's first n layers
    cfg = _cfg_cut(full, n)
    params = build_synthetic_params(cfg, "q4k", zeros=False, centered=True, seed=0, device=dev)
    prompt = gemma3_prompt(cfg.vocab_size)
    res = {"layers": n, "global_layers": [i for i in range(n)
                                          if not cfg.layer_spec(i).sliding_window]}
    for cache in ("bfloat16", "int8"):
        res[cache] = {}
        for mode in ("eager", "graph"):
            eng = InferenceEngine(replace(cfg, cache_dtype=cache), params, device=dev,
                                  cuda_graphs=mode == "graph")
            toks, r = _timed_generate(eng, eng.new_cache(1), prompt, GEMMA3_NEW, "gemma3")
            res[cache][mode] = dict(r, tokens=toks)
            log(f"  ring {cache}, {n} layers, {mode}: {r['decode_steps_s']:.2f} decode steps/s "
                f"({r.get('replayed_steps_s', 0):.2f} replayed), prefill "
                f"{r['prefill_ms']:.1f} ms")
            del eng
            torch.cuda.empty_cache()
    Path(out).write_text(json.dumps(res))
    return 0


def gemma3_uncaptured_start() -> dict:
    """Start `gemma3_uncaptured_main` in a child process (in CHILDREN, which
    `main` stops if it fails first); `gemma3_uncaptured_check` takes it."""
    OUT_DIR.mkdir(exist_ok=True)
    out, logf = OUT_DIR / "gemma3_uncaptured.json", OUT_DIR / "gemma3_uncaptured.log"
    out.unlink(missing_ok=True)
    with open(logf, "w") as fh:
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                 "--gemma3-uncaptured", str(out)], cwd=ROOT, stdout=fh,
                                stderr=subprocess.STDOUT, env=SUBPROCESS_ENV)
    CHILDREN.append(proc)
    return {"proc": proc, "out": out, "log": logf, "t0": time.perf_counter()}


def gemma3_uncaptured_check(job: dict, g3: dict) -> dict:
    """Wait for the uncaptured reference's process: exit 0, and over each
    cache its GEMMA3_NEW uncaptured tokens equal to the replayed ones of the
    same cut, K1 7 x depth launches per launched step and K4 one per global
    layer and q8 step, none replayed in the uncaptured run, the rest of the
    replayed run's steps from graphs.  g3: the gemma3_12b phase's report,
    which takes the rates."""
    t0 = time.perf_counter()
    try:
        rc = job["proc"].wait(timeout=GEMMA3_UNCAPTURED_TIMEOUT)
    except subprocess.TimeoutExpired:
        job["proc"].kill()
        raise
    text = job["log"].read_text()
    if rc != 0:
        raise AssertionError(f"gemma3 uncaptured reference: exit {rc}:\n{text[-4000:]}")
    print(text, end="", flush=True)
    got = json.loads(job["out"].read_text())
    n, n_glob = got["layers"], len(got["global_layers"])
    res = {"waited_s": time.perf_counter() - t0, "seconds": time.perf_counter() - job["t0"],
           "layers": n, "global_layers": got["global_layers"]}
    if n != GEMMA3_UNCAPTURED_DEPTH or got["global_layers"] != [5, 11]:
        raise AssertionError(f"gemma3 uncaptured reference: {n} layers, global "
                             f"{got['global_layers']}")
    for cache in ("bfloat16", "int8"):
        eager, graph = got[cache]["eager"], got[cache]["graph"]
        te, tg = eager.pop("tokens"), graph.pop("tokens")
        if te != tg:
            raise AssertionError(f"gemma3 {n}-layer cut, ring {cache}: replayed tokens differ "
                                 f"from the uncaptured loop's:\n{tg}\n{te}")
        for mode, r in (("eager", eager), ("graph", graph)):
            launched = r["eager_steps"] + r["replayed_steps"]
            k4 = n_glob * launched if cache == "int8" else 0
            bad = (r["replayed_steps"] if mode == "eager"
                   else r["replayed_steps"] < GEMMA3_NEW - DECODE_BLOCK)
            if (bad or r["launches"]["qgemv"] != 7 * n * launched
                    or r["launches"]["flash_decode"] != k4):
                raise AssertionError(f"gemma3 {n}-layer cut, ring {cache} {mode}: "
                                     f"{r['eager_steps']} eager / {r['replayed_steps']} "
                                     f"replayed steps, launches {r['launches']}")
        g3["ring"][cache]["cut_uncaptured"] = {"eager": eager, "graph": graph}
        res[cache] = {"tokens_equal": True, "distinct_tokens": len(set(te)),
                      "decode_steps_s": eager["decode_steps_s"],
                      "replayed_steps_s": graph.get("replayed_steps_s"),
                      "graph_over_eager": graph.get("replayed_steps_s", 0)
                      / eager["decode_steps_s"]}
    log(f"  gemma3_12b uncaptured reference ({n}-layer cut): {res}")
    return res


# ------------------------------------------------------------- glm4_9b phase
GLM_PROMPT = 1000                  # prompt tokens: one 1024-row chunk, K3 on every layer
GLM_NEW = 64                       # greedy tokens, replayed from CUDA graphs
GLM_STEP_K1 = 4 * GLM_LAYERS + 1   # K1 launches a decode step: qkv, o, gate_up, down + head
GLM_CUT_POSITIONS = 640            # the 2-layer cut's prompt (a 512- and a 128-row chunk,
#                                    K3 on both), then 2 decode steps (K4 over q8)
# The 2-layer cut's logits against the CPU's, of the logit scale: Mistral's
# bounds (bf16 / q8: each side quantizes its own keys).  A miss is reported
# beside the witness (the card's cut with its attention scale one f32 step
# up, against the card) and stands as a miss only where the card is also
# further from the CPU than twice the witness from the card; the control
# (rope over whole heads instead of half) must fail the bound.
GLM_CUT_TOL = {"bfloat16": 1e-3, "int8": 4e-3}
GLM_SERVE = (1000, 1100)           # the 2-slot server's prompts: one 1024-row chunk, and
#                                    1024 + 76 rows (a tail of 64 rows or fewer would take K2)
GLM_SERVE_NEW = 64
GLM_SERVE_TIE = GEMMA3_SERVE_TIE   # the 2-slot server, teacher-forced: Gemma-3's bound
GLM_SERVE_DEPTH = 4                # the depth cut at which the server's tie is held
GLM_EAGER_DEPTH = 4                # the uncaptured-against-replayed check's depth cut
FUSED_TOL = 1e-3                   # the fused Llama against the unfused, teacher-forced
FUSED_CLEAR = 2e-3                 # argmax held where the unfused top two are this far apart


def _teacher_forced(eng, ids, tokens) -> torch.Tensor:
    """The engine's logits [len(tokens), V] (f32, on the CPU) at every step of
    greedy decoding forced onto `tokens`: the prompt's prefill, then one
    token at a time at an int offset (one row: K1 on every projection),
    uncaptured."""
    from chatllm_tpu_torch.nn import transformer as T

    with torch.inference_mode():
        kv = eng.new_cache(1)
        first, kv, n = eng.prefill(ids, kv, 0)
        rows = [first.float().cpu()]
        for t in tokens[:-1]:
            x = torch.tensor([[t]], device=eng.device)
            rows.append(T.transformer_forward(eng.cfg, eng.params, x, kv, n)[0][0]
                        .float().cpu())
            n += 1
    return torch.cat(rows)


def fused_decode_phase(dev, cfg, params, gd: dict) -> dict:
    """The graph_decode phase's Llama-3-8B through `fuse_decode_streams`
    (q|k|v and gate|up of every layer concatenated: K1 4 x 32 + 1 launches
    a decode step instead of 7 x 32 + 1), over a bf16 cache: the 1000-token
    prompt and 64 greedy tokens replayed from CUDA graphs, launches exact,
    one replayed block timed.  Then both parameter sets teacher-forced on
    the unfused replayed run's 64 tokens (gd: that phase's report): the
    fused logits within FUSED_TOL of the unfused logit scale at every step,
    the same argmax wherever the unfused top two are FUSED_CLEAR of it
    apart.  K1 splits K by N, so the fused sums may round in another
    order."""
    from chatllm_tpu_torch.runtime.fuse import fuse_decode_streams
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine

    L = cfg.num_hidden_layers
    fused = fuse_decode_streams(cfg, params)
    if any(set(lp["attn"]) != {"qkv", "o"} or set(lp["mlp"]) != {"gate_up", "down"}
           for lp in fused["layers"]):
        raise AssertionError("fused llama3_8b: a layer kept separate projections")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 1000).tolist()
    unfused = gd["bfloat16"]["graph"]["tokens"]
    eng = InferenceEngine(cfg, fused, device=dev)
    kv = eng.new_cache(1)
    gcfg = GenerationConfig(do_sample=False, max_new_tokens=64)
    eng.generate(ids, gcfg, cache=kv)                       # warm: captures
    toks, r = _timed_generate(eng, kv, ids, 64, "fused llama3_8b")
    steps = decode_launches(64)
    want = {"qgemv": (4 * L + 1) * steps + 1, "qmm": 0}
    got = {k: r["launches"][k] for k in ("qgemv", "qmm", "flash_attention", "flash_decode")}
    pb = _profile_block(eng, kv, len(ids) + 48, trace=False)
    res = {"launches": got, "k1_per_step": 4 * L + 1, "replayed_steps": r["replayed_steps"],
           "decode_steps_s": r["decode_steps_s"], "profiled_block": pb,
           "replayed_steps_s": 1e3 / pb["step_ms"], "tokens_equal_unfused": toks == unfused}
    unf = gd["bfloat16"]["graph"]["profiled_block"]
    res["unfused_replayed_steps_s"] = 1e3 / unf["step_ms"]
    log(f"  fused llama3_8b bf16 cache: {res['replayed_steps_s']:.2f} replayed steps/s "
        f"(unfused {res['unfused_replayed_steps_s']:.2f}), launches {got}, tokens equal to "
        f"the unfused run's: {res['tokens_equal_unfused']}")
    if any(got[k] != v for k, v in want.items()) or r["replayed_steps"] != steps:
        raise AssertionError(f"fused llama3_8b: launches {got}, expected {want}; "
                             f"{r['replayed_steps']} replayed steps")
    del eng, kv
    torch.cuda.empty_cache()
    # teacher-forced on the unfused run's tokens, both parameter sets
    lg = {}
    for name, p in (("unfused", params), ("fused", fused)):
        lg[name] = _teacher_forced(InferenceEngine(cfg, p, device=dev), ids, unfused)
    tf = row_logit_errors(lg["fused"], lg["unfused"], FUSED_CLEAR / 2)
    tf["unfused_argmax_is_run"] = bool(torch.equal(lg["unfused"].argmax(-1),
                                                   torch.tensor(unfused)))
    res["teacher_forced"] = tf
    log(f"  fused llama3_8b, teacher-forced on the unfused tokens: {tf}")
    if tf["rel_to_logit_scale"] > FUSED_TOL or not tf["argmax_equal_where_clear"]:
        raise AssertionError(f"fused llama3_8b: {tf} (bound {FUSED_TOL} of the logit scale, "
                             f"argmax where the top two are {FUSED_CLEAR} apart)")
    del fused
    torch.cuda.empty_cache()
    return res


def _scale_step(cfg):
    """`cfg` with its attention scale one f32 step up (a witness's nudge:
    every score moves by about the parting of two f32 sum orders)."""
    d = cfg.resolved_head_dim()
    scale = cfg.attention_scale if cfg.attention_scale > 0 else d ** -0.5
    return replace(cfg, attention_scale=float(np.nextafter(np.float32(scale), np.float32(1.0))))


def _forced_rows(eng, prompt, reply, ahead: int = 0) -> torch.Tensor:
    """The engine's logits [len(reply), V] (f32, on the CPU) teacher-forced
    along `reply`: the prompt's prefill gives the first row, then the reply
    but its last token in one chunk the rest, written `ahead` positions past
    the prompt's end (0: right after it; more: a faulty position, a
    control's)."""
    from chatllm_tpu_torch.nn import transformer as T

    with torch.inference_mode():
        kv = eng.new_cache(1)
        first, kv, n = eng.prefill(prompt, kv, 0)
        x = torch.tensor([reply[:-1]], device=eng.device)
        rows = T.transformer_forward(eng.cfg, eng.params, x, kv, n + ahead)[0][0]
        return torch.cat([first, rows]).float().cpu()


def _reply_gaps(lg, reply) -> dict:
    """A reply's tokens against logits [len(reply), V] along it: at each
    step the pick's gap below the top, over the row's logit scale."""
    top = lg.max(-1).values
    pick = lg.gather(-1, torch.tensor(reply)[:, None])[:, 0]
    gaps = (top - pick) / lg.abs().amax(-1)
    return {"argmax_steps": int((gaps == 0).sum()), "largest_gap": gaps.max().item(),
            "gaps_nonzero": [round(g, 6) for g in gaps.tolist() if g]}


def _staggered_server(dev, cfg8, params, prompts, new: int, name: str) -> dict:
    """The server's engine (BatchedEngine, 2 slots, greedy) over `prompts`:
    one request at a time, then the second submitted once the first streams,
    `new` tokens each.  The same steps' shapes and kernels, so the replies
    must be bit-equal.  Returns the staggered run's wall time, launches,
    batched and replayed steps, graphs and replies."""
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.sampling import SamplerConfig
    from chatllm_tpu_torch.runtime.batching import BatchedEngine

    be = BatchedEngine(cfg8, params, max_slots=2, scfg=SamplerConfig(do_sample=False),
                       device=dev)
    dec = be.decoder
    try:
        alone = [list(be.submit(p, max_new=new)) for p in prompts]
        was = (dec.eager_steps, dec.replayed_steps)
        reset_launch_counts()
        t0 = time.perf_counter()
        h1 = iter(be.submit(prompts[0], max_new=new))
        first = next(h1)                   # the first request is in its slot and streams
        h2 = be.submit(prompts[1], max_new=new)
        replies = [[first] + list(h1), list(h2)]
    finally:
        be.shutdown()
    torch.cuda.synchronize()
    sr = {"wall_s": time.perf_counter() - t0, "launches": launch_counts(),
          "batched_steps": dec.eager_steps + dec.replayed_steps - sum(was),
          "replayed_steps": dec.replayed_steps - was[1], "graphs": dec.num_graphs(),
          "replies": replies}
    del be
    torch.cuda.empty_cache()
    if replies != alone or any(len(t) != new for t in replies):
        raise AssertionError(f"{name} 2-slot server: the staggered replies differ from the "
                             f"same server's one at a time:\n{replies}\n{alone}")
    return sr


def _glm_server(dev, cfg8, params, prompts, name: str) -> dict:
    """`_staggered_server` over GLM-4-9B's q8 cache at cfg8's depth, its
    launches held: K2 on every projection of every batched step (B.G = 32
    leaves K4 for the chunked einsum, as in the JAX package), no K4."""
    sr = _staggered_server(dev, cfg8, params, prompts, GLM_SERVE_NEW, name)
    per_step = 4 * cfg8.num_hidden_layers + 1
    if (sr["launches"]["qmm"] != per_step * sr["batched_steps"]
            or sr["launches"]["flash_decode"]):
        raise AssertionError(f"{name} 2-slot server: K2 {sr['launches']['qmm']} (expected "
                             f"{per_step} x {sr['batched_steps']} batched steps), K4 "
                             f"{sr['launches']['flash_decode']} (expected none at B.G = 32)")
    return sr


def _serve_cut(dev, c8, p32, prompts, name: str = "glm4_9b", server=None) -> dict:
    """The 2-slot q8 server (`server`, `_glm_server` by default, which holds
    its launches) at GLM_SERVE_DEPTH layers, teacher-forced on the
    single-stream engine of the same cut: every token of both replies its
    greedy choice or within GLM_SERVE_TIE of the logit scale below it, and
    at least 8 distinct tokens a reply.  The same measure is taken of the
    greedy choices of two other single streams, teacher-forced on the same
    prefixes: the witness (its attention scale one f32 step up) must pass
    the tie, and the control (its n_past one ahead after the prompt: a hole
    in the cache, every reply position off by one) must fail it.  How far
    each one's logits part from the single stream's is recorded."""
    from chatllm_tpu_torch.runtime.generate import InferenceEngine

    n = GLM_SERVE_DEPTH
    cfgc = replace(c8, num_hidden_layers=n)
    pc = dict(p32, layers=p32["layers"][:n])
    sr = (server or _glm_server)(dev, cfgc, pc, prompts, f"{name} {n}-layer cut")
    eng, wit = (InferenceEngine(c, pc, device=dev) for c in (cfgc, _scale_step(cfgc)))
    sr["single"] = []
    for p, got in zip(prompts, sr["replies"]):
        lg, lw = _forced_rows(eng, p, got), _forced_rows(wit, p, got)
        lc = _forced_rows(eng, p, got, ahead=1)
        scale = lg.abs().amax(-1)
        sr["single"].append(dict(
            _reply_gaps(lg, got), distinct_tokens=len(set(got)),
            witness=((lw - lg).abs().amax(-1) / scale).max().item(),
            witness_gap=_reply_gaps(lg, lw.argmax(-1).tolist())["largest_gap"],
            control=((lc - lg).abs().amax(-1) / scale).max().item(),
            control_gap=_reply_gaps(lg, lc.argmax(-1).tolist())["largest_gap"]))
    del eng, wit, pc
    torch.cuda.empty_cache()
    single = sr["single"]
    log(f"  2-slot q8 server at {n} layers: {sr['batched_steps']} batched steps, K2 "
        f"{sr['launches']['qmm']}; against the single-stream engine, teacher-forced {single} "
        f"(limit {GLM_SERVE_TIE} of the logit scale)")
    if any(a["distinct_tokens"] < 8 or a["largest_gap"] > GLM_SERVE_TIE for a in single):
        raise AssertionError(f"{name} 2-slot server at {n} layers: a reply's token is not the "
                             f"single-stream engine's greedy choice on its prefix ({single}; "
                             f"limit {GLM_SERVE_TIE} of the logit scale)")
    if any(a["witness_gap"] > GLM_SERVE_TIE for a in single):
        raise AssertionError(f"{name} 2-slot server at {n} layers: the witness (attention "
                             f"scale one f32 step up) fails the tie ({single})")
    if max(a["control_gap"] for a in single) <= GLM_SERVE_TIE:
        raise AssertionError(f"{name} 2-slot server at {n} layers: the control (n_past one "
                             f"ahead) passes the tie ({single})")
    return sr


def glm4_phase(dev) -> dict:
    """GLM-4-9B at full width and depth (`glm4_9b_config`: 40 layers, 32
    query heads over 2 kv heads of 128 (G 16), the fused biased qkv and
    gate_up, rope on half of each head at base 5e6, random q4_k weights
    from seed 0 with the 13696-wide down projection in q8_0, as the
    converter stores it, the untied 151552-row head) through the port's
    entry points.

      - Over a bf16 and a q8 cache (max_length 8192): the GLM_PROMPT-token
        prompt and GLM_NEW greedy tokens, run once to capture, then counted:
        every decode step replayed, K1 GLM_STEP_K1 launches a step and one
        for the prefill's head, K3 in mode 2 on all 40 layers over bf16, K4
        on all 40 a q8 step (16 rows a kv head), no K2; one replayed block
        profiled into its kernels over bf16, timed over q8.
      - A 2-layer cut against the CPU over GLM_CUT_POSITIONS positions and 2
        decode steps, bf16 and q8, within GLM_CUT_TOL of the logit scale,
        its witness and control beside it; its CPU side on CUT_WORKER.
      - On zero-centred weights (seed 1), whose greedy tokens vary (at
        least 8 distinct in each reply; the positive-biased ones above
        repeat one token): the server's engine (BatchedEngine, 2 slots, q8,
        f32 activations), two requests of GLM_SERVE tokens, staggered,
        GLM_SERVE_NEW tokens each, bit-equal to the same server one at a
        time (B.G = 32 takes the chunked einsum, as in the JAX package), K2
        GLM_STEP_K1 a batched step, each token's gap below the single-stream
        engine's greedy choice, teacher-forced, recorded; the same server
        at GLM_SERVE_DEPTH layers with every token that cut's greedy
        choice, teacher-forced, up to GLM_SERVE_TIE of the logit scale,
        beside a witness that must pass the tie and a control that must
        fail it (`_serve_cut`); and at a depth cut of GLM_EAGER_DEPTH
        layers, the
        uncaptured loop's GLM_NEW tokens equal to the replayed ones over
        both caches.
      - Params and peak device memory."""
    from chatllm_tpu_torch.models.synthetic import (build_synthetic_params, glm4_9b_config,
                                                    param_bytes)
    from chatllm_tpu_torch.ops.qtensor import QuantLinear
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine

    t_phase = time.perf_counter()
    spans = {}

    def span(name):
        spans[name] = time.perf_counter() - t_phase - sum(spans.values())

    cfg = glm4_9b_config(max_length=8192)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    torch.cuda.reset_peak_memory_stats(dev)
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev, fused=True,
                                    k_fallback="q8")
    torch.cuda.synchronize()
    lp = params["layers"][0]
    down, qkv = lp["mlp"]["down"], lp["attn"]["qkv"]
    if (not isinstance(down, QuantLinear) or down.sb or down.packed or not qkv.sb
            or qkv.shape_in_out != (4096, 4608) or qkv.bias is None
            or lp["mlp"]["gate_up"].shape_in_out != (4096, 27392)):
        raise AssertionError("glm4_9b: params are not q4_k with a q8_0 down, fused qkv "
                             "(with its bias) and gate_up")
    res = {"param_gib": param_bytes(params) / 2 ** 30, "spans_s": spans,
           "k1_per_step": GLM_STEP_K1}
    prompt = np.random.default_rng(0).integers(0, V, GLM_PROMPT).tolist()

    # ---- the 2-layer cut's CPU side, on CUT_WORKER from here on
    cfg2 = _cfg_cut(cfg, 2)
    sel = _to_device(dict(params, layers=params["layers"][:2]), "cpu")
    cut_ids = np.random.default_rng(3).integers(0, V, GLM_CUT_POSITIONS + 2)
    cut_cpu = _cpu_cuts("glm4_9b", cfg2, sel, cut_ids,
                        dict(slots=(cfg2.max_length,) * 2, end=GLM_CUT_POSITIONS))
    span("setup")

    # ---- the chat path over bf16 and q8, replayed from CUDA graphs
    steps = decode_launches(GLM_NEW)
    gcfg = GenerationConfig(do_sample=False, max_new_tokens=GLM_NEW)
    chat = {}
    for cache in ("bfloat16", "int8"):
        q8 = cache == "int8"
        eng = InferenceEngine(replace(cfg, cache_dtype=cache), params, device=dev)
        kv = eng.new_cache(1)
        t0 = time.perf_counter()
        eng.generate(prompt, gcfg, cache=kv)                # warm: captures
        warm_s = time.perf_counter() - t0
        toks, r = _timed_generate(eng, kv, prompt, GLM_NEW, f"glm4_9b {cache}")
        r["warm_run_s"] = warm_s
        want = {"qgemv": GLM_STEP_K1 * steps + 1, "qmm": 0,
                "flash_attention": 0 if q8 else L, "flash_decode": L * steps if q8 else 0}
        got = {k: r["launches"][k] for k in want}
        t0 = time.perf_counter()
        r["profiled_block"] = pb = _profile_block(eng, kv, GLM_PROMPT + 48, trace=not q8)
        r["profile_s"] = time.perf_counter() - t0
        r["profiled_steps_s"] = 1e3 / pb["step_ms"]
        log(f"  {cache} cache: prefill {r['prefill_ms']:.1f} ms, {r['profiled_steps_s']:.2f} "
            f"replayed steps/s (block {pb['block_ms']:.2f} ms), warm run {warm_s:.2f} s, "
            f"profiled in {r['profile_s']:.1f} s, {len(set(toks))} distinct tokens, "
            f"launches {got}, K3 by mode {r['flash_modes']}; kernels {pb.get('kernel_ms')} ms, "
            f"busy share {pb.get('busy_share')}; top kernels {pb.get('top_kernels_ms')}")
        if (got != want or r["flash_modes"][2] != want["flash_attention"]
                or r["replayed_steps"] != steps):
            raise AssertionError(f"glm4_9b {cache}: launches {got} (expected {want}), K3 by "
                                 f"mode {r['flash_modes']}, {r['replayed_steps']} replayed "
                                 f"steps")
        chat[cache] = {"graph": r, "tokens": toks, "distinct_tokens": len(set(toks))}
        del eng, kv
        torch.cuda.empty_cache()
    res["chat"] = chat
    span("chat")

    # ---- zero-centred weights (seed 1) for the token checks: the
    # positive-biased ones above give one greedy token over and over, so a
    # reply could match its reference without its steps being right
    del params, lp, down, qkv
    gc.collect()
    torch.cuda.empty_cache()
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=1, device=dev, fused=True,
                                    k_fallback="q8", centered=True)
    span("centred_params")

    # ---- the server's engine: 2 slots over q8, staggered requests, f32
    # activations.  At full depth its replies are held against the same
    # server's one at a time and its launches counted; their teacher-forced
    # gaps below the single-stream engine's greedy choice are recorded, not
    # held: there one f32 step of the attention scale parts the logits by
    # 3.9e-2 / 4.7e-2 of their scale, more than the tie.  The tie is held at
    # GLM_SERVE_DEPTH layers (`_serve_cut`).
    p32 = dict(params, embed=params["embed"].float())
    rng = np.random.default_rng(5)
    sprompts = [rng.integers(0, V, n).tolist() for n in GLM_SERVE]
    c8 = replace(cfg, cache_dtype="int8")
    sr = _glm_server(dev, c8, p32, sprompts, "glm4_9b")
    eng = InferenceEngine(c8, p32, device=dev)
    sr["single"] = [dict(_reply_gaps(_forced_rows(eng, p, got), got),
                         distinct_tokens=len(set(got)))
                    for p, got in zip(sprompts, sr["replies"])]
    log(f"  2-slot q8 server (f32 activations, centred weights): {sr['wall_s']:.2f} s, "
        f"{sr['batched_steps']} batched steps ({sr['replayed_steps']} replayed from "
        f"{sr['graphs']} graph(s)), K2 {sr['launches']['qmm']}; against the single-stream "
        f"engine, teacher-forced (recorded) {sr['single']}")
    if any(a["distinct_tokens"] < 8 for a in sr["single"]):
        raise AssertionError(f"glm4_9b 2-slot server: a reply repeats its tokens "
                             f"({sr['single']})")
    del eng
    torch.cuda.empty_cache()
    sr["cut"] = _serve_cut(dev, c8, p32, sprompts)
    res["serve"] = sr
    del p32
    torch.cuda.empty_cache()
    span("serve")

    # ---- uncaptured against replayed at a depth cut
    res["eager_cut"] = _eager_vs_replayed(dev, cfg, params, prompt, "glm4_9b", GLM_STEP_K1, True,
                                          GLM_EAGER_DEPTH, GLM_NEW)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    span("eager_cut")

    # ---- the 2-layer cut (the first weights) on the card against the CPU's,
    # beside its witness and its control (rope over whole heads)
    p2 = _to_device(sel, dev)
    kw = dict(slots=(cfg.max_length,) * 2, end=GLM_CUT_POSITIONS)
    card = {c: _ring_cut(cfg2, p2, cut_ids, dev, c, **kw)[0] for c in ("bfloat16", "int8")}
    witness = {c: _ring_cut(_scale_step(cfg2), p2, cut_ids, dev, c, **kw)[0]
               for c in ("bfloat16", "int8")}
    fault = replace(cfg2, rope=replace(cfg2.rope, rot_dim=-1))
    control = _ring_cut(fault, p2, cut_ids, dev, "bfloat16", **kw)[0]
    t0 = time.perf_counter()
    cpu = cut_cpu.result()
    cut = {"cpu_wait_s": time.perf_counter() - t0, "bounds": GLM_CUT_TOL}
    for cache in ("bfloat16", "int8"):
        tol = GLM_CUT_TOL[cache]
        c = {"card": _cut_compare(f"glm4_9b 2-layer cut {cache}, card vs cpu", card[cache],
                                  cpu[cache], tol, strict=False),
             "witness": _cut_compare(f"glm4_9b 2-layer cut {cache}, witness vs card",
                                     witness[cache], card[cache], tol, strict=False)}
        c["bound_met"] = c["card"]["within_tolerance"]
        cut[cache] = c
        # a miss stands only at the size of the witness's own parting
        if not c["bound_met"] and (
                c["card"]["rel_to_logit_scale"] > 2 * c["witness"]["rel_to_logit_scale"]
                or not c["card"]["argmax_equal_where_clear"]):
            raise AssertionError(f"glm4_9b 2-layer cut {cache}: the card is {c['card']} from "
                                 f"the CPU, beyond {tol} and twice its witness's {c['witness']}")
    cut["control"] = {"fault": "rope over whole heads", "rel_to_logit_scale": row_logit_errors(
        control, cpu["bfloat16"], 0.0)["rel_to_logit_scale"]}
    log(f"  glm4_9b 2-layer cut: control {cut['control']}, bounds met "
        f"{ {k: cut[k]['bound_met'] for k in ('bfloat16', 'int8')} }")
    if cut["control"]["rel_to_logit_scale"] <= GLM_CUT_TOL["int8"]:
        raise AssertionError(f"glm4_9b 2-layer cut: the control passes the bound ({cut})")
    res["cut"] = cut
    del p2, card, cpu, witness, control, sel
    span("cut")
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  glm4_9b phase: params {res['param_gib']:.2f} GiB, peak device memory "
        f"{res['peak_mem_gib']:.2f} GiB, {res['seconds']:.1f} s ({spans})")
    return res


# ------------------------------------------------------ phi3_5_mini, phi2 phases
PHI_PROMPT = 1000                  # prompt tokens: one 1024-row chunk, K3 on every layer
PHI_NEW = 64                       # greedy tokens, replayed from CUDA graphs
PHI_LAYERS = 32
PHI_CUT_POSITIONS = 640            # the 2-layer cut's prompt (a 512- and a 128-row chunk,
#                                    K3 on both over bf16), then 2 decode steps (K4 over q8)
# The 2-layer cut's logits against the CPU's, of the logit scale: Mistral's
# and GLM-4-9B's bounds.  Phi-3.5-mini's cut is held to them.  Phi-2's (its
# LayerNorm over zero-centred weights) is held as GLM-4-9B's is, with a second
# witness beside the first: a miss fails on a clear argmax, or beyond twice
# the larger of the witness (the card's cut with its attention scale one f32
# step up, against the card) and the f32 witness (the card's cut at f32
# activations against the CPU's at bf16: what the CPU's own bf16 rounding of
# the activations leaves; `_phi_cut`).
PHI_CUT_TOL = GLM_CUT_TOL
PHI_SERVE = GLM_SERVE              # the 2-slot server's prompts (1000 and 1100 tokens)
PHI_SERVE_NEW = 32
PHI_EAGER_DEPTH = 4                # the uncaptured-against-replayed check's depth cut
# Each model's builder and max_length, its build_synthetic_params options,
# its K1 launches a decode step and whether the head is one of them
# (Phi-3.5-mini's N 32064 is not a multiple of 128: the dequantize-then-matmul
# route, as in the JAX package), whether it runs the 2-slot server, and its
# cut's control and whether a miss of its bound may stand beside the
# witnesses (`strict`).  Phi-2's weights are zero-centred throughout: on
# positive-biased ones its 2-layer cut parted from the CPU, and its witness
# from the card, by several hundredths of the logit scale; the phase records
# that cut beside both witnesses (`_phi_cut`, bf16 cache, not held).
PHI_MODELS = {
    "phi3_5_mini": dict(config="phi3_5_mini_config", max_length=8192, opts={},
                        k1_step=7 * PHI_LAYERS, head_k1=False, serve=True, strict=True,
                        control="LongRoPE's factors dropped",
                        fault=lambda c: replace(c, rope=replace(c.rope, freq_factors=None))),
    "phi2": dict(config="phi2_config", max_length=4096,
                 opts=dict(mlp="plain", centered=True),
                 k1_step=6 * PHI_LAYERS + 1, head_k1=True, serve=False, strict=False,
                 control="rope over whole heads",
                 fault=lambda c: replace(c, rope=replace(c.rope, rot_dim=-1))),
}


def _phi_cut(name: str, cfg2, p2, ids, kw, cpu: dict, strict: bool) -> dict:
    """A Phi 2-layer cut on the card (params `p2`) against the CPU's logits
    `cpu` {cache: logits}, per cache, beside the witness (the card's cut
    with its attention scale one f32 step up, against the card) and the f32
    witness (the card's cut at f32 activations, against the CPU; and against
    the card).  `strict` True: each cut within PHI_CUT_TOL with the argmax
    equal where clear, or it raises; False: a miss raises on a clear argmax
    or beyond twice the larger witness; None: recorded, not held."""
    dev = p2["embed"].device
    p32 = dict(p2, embed=p2["embed"].float())
    res = {}
    for cache in cpu:
        tol = PHI_CUT_TOL[cache]
        card = _ring_cut(cfg2, p2, ids, dev, cache, **kw)[0]
        witness = _ring_cut(_scale_step(cfg2), p2, ids, dev, cache, **kw)[0]
        f32 = _ring_cut(cfg2, p32, ids, dev, cache, **kw)[0]
        what = f"{name} 2-layer cut {cache}"
        c = {"card": _cut_compare(f"{what}, card vs cpu", card, cpu[cache], tol, strict=False),
             "witness": _cut_compare(f"{what}, witness vs card", witness, card, tol,
                                     strict=False),
             "f32_witness": _cut_compare(f"{what}, card at f32 activations vs cpu", f32,
                                         cpu[cache], tol, strict=False),
             "f32_vs_card": _cut_compare(f"{what}, card at f32 activations vs card", f32,
                                         card, tol, strict=False)}
        c["bound_met"] = c["card"]["within_tolerance"]
        c["limit"] = 2 * max(c["witness"]["rel_to_logit_scale"],
                             c["f32_witness"]["rel_to_logit_scale"])
        res[cache] = c
        if strict is None or c["bound_met"]:
            continue
        if strict or (c["card"]["rel_to_logit_scale"] > c["limit"]
                      or not c["card"]["argmax_equal_where_clear"]):
            raise AssertionError(f"{what}: the card is {c['card']} from the CPU, beyond {tol}"
                                 + ("" if strict else f" and twice the larger witness ("
                                    f"{c['witness']}; f32 {c['f32_witness']})"))
    return res


def _phi_server(dev, cfg8, params, prompts, name: str) -> dict:
    """`_staggered_server` over a Phi model's q8 cache, its launches held:
    K2 on every quantized projection of every batched step, and K4 (per-row
    n_past, B.G = 2) on every layer of it."""
    sr = _staggered_server(dev, cfg8, params, prompts, PHI_SERVE_NEW, name)
    L, n = cfg8.num_hidden_layers, sr["batched_steps"]
    want = {"qmm": 7 * L * n, "flash_decode": L * n}
    got = {k: sr["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"{name} 2-slot server: launches {got}, expected {want} "
                             f"({n} batched steps)")
    return sr


def _eager_vs_replayed(dev, cfg, params, prompt, name: str, k1_step: int, head_k1: bool,
                       depth: int, new: int, chunks: int = 1) -> dict:
    """At a depth cut of `depth` layers, the uncaptured loop's `new` tokens
    against the replayed ones over a bf16 and a q8 cache: equal, at least 8
    distinct, the uncaptured run's K1 launches exact (`k1_step` a step at
    full depth, the head among them when `head_k1`, and then the head of
    each of the prefill's `chunks` too)."""
    from chatllm_tpu_torch.runtime.generate import InferenceEngine

    L = cfg.num_hidden_layers
    k1 = k1_step - (k1_step - int(head_k1)) // L * (L - depth)
    cfg4, p4 = _depth_cut(cfg, params, depth)
    res = {"layers": depth}
    for cache in ("bfloat16", "int8"):
        runs = {}
        for mode in ("eager", "graph"):
            eng = InferenceEngine(replace(cfg4, cache_dtype=cache), p4, device=dev,
                                  cuda_graphs=mode == "graph")
            runs[mode] = _timed_generate(eng, eng.new_cache(1), prompt, new,
                                         f"{name} {depth}-layer cut {mode}")
            del eng
        (te, re_), (tg, rg) = runs["eager"], runs["graph"]
        res[cache] = {"tokens_equal": te == tg, "distinct_tokens": len(set(te)),
                      "eager_steps_s": re_["decode_steps_s"],
                      "replayed_steps_s": rg.get("replayed_steps_s")}
        log(f"  {name} {depth}-layer cut (centred weights), {cache}: {res[cache]}")
        if (te != tg or len(set(te)) < 8 or re_["replayed_steps"]
                or rg["replayed_steps"] < new - DECODE_BLOCK
                or re_["launches"]["qgemv"] != k1 * re_["eager_steps"] + int(head_k1) * chunks):
            raise AssertionError(f"{name} {depth}-layer cut {cache}: replayed tokens {tg} "
                                 f"against uncaptured {te}; eager launches {re_['launches']}, "
                                 f"{re_['eager_steps']} eager steps")
    return res


def phi_phase(dev, name: str) -> dict:
    """Phi-3.5-mini (`phi3_5_mini_config`: 32 layers, 32 heads of 96 over 32
    kv heads, LongRoPE's long factors and mscale, every layer windowed over
    262145 keys, which no cache reaches: the dense windowed route; the
    untied head of 32064 rows) or Phi-2 (`phi2_config`: 32 layers, 32 heads
    of 80, LayerNorm with biases, NeoX rope on 32 of 80 dims, biased q/k/v,
    dense, fc1, fc2 and head, the parallel residual; max_length 4096, where
    a q8 cache takes K4) at full width and depth, random q4_k weights from
    seed 0 (Phi-2's zero-centred: PHI_MODELS), through the port's entry
    points.

      - Over a bf16 and a q8 cache: the PHI_PROMPT-token prompt and PHI_NEW
        greedy tokens, run once to capture, then counted: every decode step
        replayed, K1 on every quantized projection of every step (Phi-2: its
        head too, and the prefill's head), K3 in mode 2 on all 32 layers
        over bf16 (D 96 / 80), K4 on all 32 a q8 step (one row a kv head,
        the per-head kernel's f32 dots), no K2; one replayed block profiled
        into its kernels over bf16, timed over q8.
      - A 2-layer cut against the CPU over PHI_CUT_POSITIONS positions and 2
        decode steps, bf16 and q8, held to PHI_CUT_TOL of the logit scale
        beside its two witnesses (`_phi_cut`: Phi-3.5-mini strictly; for
        Phi-2 a miss fails on a clear argmax or beyond twice the larger
        witness), the control (`PHI_MODELS`) outside the bound; Phi-2's cut
        on positive-biased weights recorded beside its witnesses over bf16;
        the CPU sides on CUT_WORKER.
      - On zero-centred weights (Phi-3.5-mini's from seed 1), whose greedy
        tokens vary: at a
        depth cut of PHI_EAGER_DEPTH layers, the uncaptured loop's tokens
        equal to the replayed ones over both caches; Phi-3.5-mini's server
        engine (BatchedEngine, 2 slots, q8, f32 activations), two requests
        of PHI_SERVE tokens, staggered, PHI_SERVE_NEW tokens each, bit-equal
        to the same server one at a time, K2 on every projection and K4 with
        per-row n_past on every layer of every batched step, and at
        GLM_SERVE_DEPTH layers each token the single stream's greedy choice,
        teacher-forced, within GLM_SERVE_TIE (`_serve_cut`: its witness
        passes, its control fails).
      - Params and peak device memory."""
    from chatllm_tpu_torch.models import synthetic
    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, param_bytes
    from chatllm_tpu_torch.ops.qtensor import QuantLinear
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine

    m = PHI_MODELS[name]
    max_len, opts, k1_step, head_k1 = m["max_length"], m["opts"], m["k1_step"], m["head_k1"]
    t_phase = time.perf_counter()
    spans = {}

    def span(what):
        spans[what] = time.perf_counter() - t_phase - sum(spans.values())

    cfg = getattr(synthetic, m["config"])(max_length=max_len)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    torch.cuda.reset_peak_memory_stats(dev)
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev, **opts)
    torch.cuda.synchronize()
    lp = params["layers"][0]
    if not all(isinstance(x, QuantLinear) and x.sb
               for x in (*lp["attn"].values(), *lp["mlp"].values(), params["lm_head"])):
        raise AssertionError(f"{name}: params are not q4_k")
    res = {"param_gib": param_bytes(params) / 2 ** 30, "spans_s": spans, "k1_per_step": k1_step,
           "head_on_k1": head_k1}
    prompt = np.random.default_rng(0).integers(0, V, PHI_PROMPT).tolist()

    # ---- the 2-layer cut's CPU side, on CUT_WORKER from here on
    cfg2 = _cfg_cut(cfg, 2)
    sel = _to_device(dict(params, layers=params["layers"][:2]), "cpu")
    cut_ids = np.random.default_rng(3).integers(0, V, PHI_CUT_POSITIONS + 2)
    kw = dict(slots=(max_len,) * 2, end=PHI_CUT_POSITIONS)
    cut_cpu = _cpu_cuts(name, cfg2, sel, cut_ids, kw)
    if opts.get("centered"):
        # the same cut on positive-biased weights, recorded beside its
        # witnesses over a bf16 cache
        biased = _to_device(build_synthetic_params(
            cfg2, "q4k", zeros=False, seed=0, device=dev,
            **{k: v for k, v in opts.items() if k != "centered"}), "cpu")
        biased_cpu = _cpu_cuts(name + " positive-biased", cfg2, biased, cut_ids, kw,
                               caches=("bfloat16",))
    span("setup")

    # ---- the chat path over bf16 and q8, replayed from CUDA graphs
    steps = decode_launches(PHI_NEW)
    gcfg = GenerationConfig(do_sample=False, max_new_tokens=PHI_NEW)
    chat = {}
    for cache in ("bfloat16", "int8"):
        q8 = cache == "int8"
        eng = InferenceEngine(replace(cfg, cache_dtype=cache), params, device=dev)
        kv = eng.new_cache(1)
        t0 = time.perf_counter()
        eng.generate(prompt, gcfg, cache=kv)                # warm: captures
        warm_s = time.perf_counter() - t0
        toks, r = _timed_generate(eng, kv, prompt, PHI_NEW, f"{name} {cache}")
        r["warm_run_s"] = warm_s
        want = {"qgemv": k1_step * steps + int(head_k1), "qmm": 0,
                "flash_attention": 0 if q8 else L, "flash_decode": L * steps if q8 else 0}
        got = {k: r["launches"][k] for k in want}
        r["profiled_block"] = pb = _profile_block(eng, kv, PHI_PROMPT + 48, trace=not q8)
        r["profiled_steps_s"] = 1e3 / pb["step_ms"]
        log(f"  {name} {cache} cache: prefill {r['prefill_ms']:.1f} ms, "
            f"{r['profiled_steps_s']:.2f} replayed steps/s (block {pb['block_ms']:.2f} ms), "
            f"warm run {warm_s:.2f} s, {len(set(toks))} distinct tokens, launches {got}, K3 by "
            f"mode {r['flash_modes']}; kernels {pb.get('kernel_ms')} ms, busy share "
            f"{pb.get('busy_share')}; top kernels {pb.get('top_kernels_ms')}")
        if (got != want or r["flash_modes"][2] != want["flash_attention"]
                or r["replayed_steps"] != steps):
            raise AssertionError(f"{name} {cache}: launches {got} (expected {want}), K3 by "
                                 f"mode {r['flash_modes']}, {r['replayed_steps']} replayed "
                                 f"steps")
        chat[cache] = {"graph": r, "tokens": toks, "distinct_tokens": len(set(toks))}
        del eng, kv
        torch.cuda.empty_cache()
    res["chat"] = chat
    span("chat")

    # ---- the 2-layer cut (the seed-0 weights) on the card against the CPU's,
    # beside its witnesses and its control
    p2 = _to_device(sel, dev)
    control = _ring_cut(m["fault"](cfg2), p2, cut_ids, dev, "bfloat16", **kw)[0]
    t0 = time.perf_counter()
    cpu = cut_cpu.result()
    cut = {"cpu_wait_s": time.perf_counter() - t0, "bounds": PHI_CUT_TOL,
           **_phi_cut(name, cfg2, p2, cut_ids, kw, cpu, m["strict"])}
    cut["control"] = {"fault": m["control"], "rel_to_logit_scale": row_logit_errors(
        control, cpu["bfloat16"], 0.0)["rel_to_logit_scale"]}
    log(f"  {name} 2-layer cut: control {cut['control']}, bounds met "
        f"{ {k: cut[k]['bound_met'] for k in ('bfloat16', 'int8')} }")
    if cut["control"]["rel_to_logit_scale"] <= PHI_CUT_TOL["int8"]:
        raise AssertionError(f"{name} 2-layer cut: the control passes the bound ({cut})")
    if opts.get("centered"):
        t0 = time.perf_counter()
        bcpu = biased_cpu.result()
        cut["positive_biased"] = {"cpu_wait_s": time.perf_counter() - t0, **_phi_cut(
            f"{name} (positive-biased weights)", cfg2, _to_device(biased, dev), cut_ids, kw,
            bcpu, None)}
        del biased, bcpu
    res["cut"] = cut
    del p2, cpu, control, sel, lp
    span("cut")

    # ---- zero-centred weights (seed 1 unless they were from the start):
    # tokens that vary
    if not opts.get("centered"):
        del params
        gc.collect()
        torch.cuda.empty_cache()
        params = build_synthetic_params(cfg, "q4k", zeros=False, seed=1, device=dev,
                                        centered=True, **opts)
    res["eager_cut"] = _eager_vs_replayed(dev, cfg, params, prompt, name, k1_step, head_k1,
                                          PHI_EAGER_DEPTH, PHI_NEW)
    span("eager_cut")
    if m["serve"]:
        # the server's engine: 2 slots over q8, staggered requests, f32
        # activations; its tie to the single stream held at GLM_SERVE_DEPTH
        p32 = dict(params, embed=params["embed"].float())
        rng = np.random.default_rng(5)
        sprompts = [rng.integers(0, V, n).tolist() for n in PHI_SERVE]
        c8 = replace(cfg, cache_dtype="int8")
        sr = _phi_server(dev, c8, p32, sprompts, name)
        log(f"  {name} 2-slot q8 server (f32 activations, centred weights): {sr['wall_s']:.2f} s, "
            f"{sr['batched_steps']} batched steps ({sr['replayed_steps']} replayed from "
            f"{sr['graphs']} graph(s)), K2 {sr['launches']['qmm']}, K4 "
            f"{sr['launches']['flash_decode']}")
        sr["cut"] = _serve_cut(dev, c8, p32, sprompts, name, _phi_server)
        res["serve"] = sr
        del p32
        span("serve")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  {name} phase: params {res['param_gib']:.2f} GiB, peak device memory "
        f"{res['peak_mem_gib']:.2f} GiB, {res['seconds']:.1f} s ({spans})")
    return res


# ------------------------------------------------------------ gpt_oss_20b phase
GO_PROMPT = 1000                   # prompt tokens: two chunks of SWA_EXTRA (512 + 488)
GO_NEW = 64                        # greedy tokens, replayed from CUDA graphs
GO_RING = 640                      # a sliding layer's ring: window 128 + SWA_EXTRA 512
GO_CUT_POSITIONS = 704             # the 2-layer cut's prompt (chunks of 512 and 192: the
#                                    ring layer's 640 slots wrap), then 2 decode steps (K4
#                                    with sinks over q8 on the full layer)
# The 2-layer cut's logits against the CPU's, of the logit scale, where the
# expert picks agree (Mistral's, GLM-4-9B's and Phi's bounds).  Where the cut
# misses its bound, it is held as the Gemma and Phi-2 cuts are, to a limit of twice
# the larger of its witnesses (`_go_cut`: an f32-level nudge of the attention
# scale on the card, and the card at f32 activations against the CPU at
# bf16), its argmax equal to the CPU's wherever
# the CPU's top two are further apart than twice that limit; the miss is
# recorded beside the witness and the control.  The expert picks are held by
# the MoE rules of the DeepSeek and Qwen3-MoE cuts (`_moe_picks`: router
# scores, here the softmax over the biased logits, within
# DSV2_SCORE_DIFF_MAX, at least DSV2_PICKS_AGREE_MIN of the tokens with the
# CPU's picks, a differing pick only on a near-tie).
GO_CUT_TOL = {"bfloat16": 1e-3, "int8": 4e-3}
GO_SERVE = (1000, 1100)            # the 2-slot server's prompts
GO_SERVE_NEW = 32
GO_EAGER_DEPTH = 4                 # the uncaptured-against-replayed check's depth cut


def _go_cut_card(cfg2, p2, ids, kw, tape, cache: str) -> tuple:
    """The cut on the card over `cache`, on the CPU's picks (`tape`):
    (logits [N, V], the tape of the card's own picks)."""
    with pick_tape(tape) as own:
        g = _ring_cut(cfg2, p2, ids, p2["embed"].device, cache, **kw)[0]
    return g, own


def _per_layer(tape: list, n_moe: int) -> list:
    """A tape's (sorted picks, scores) per MoE layer over every position, in
    order (the calls come chunk by chunk, each chunk's layers in order)."""
    return [(torch.cat([t[0] for t in tape[i::n_moe]]), torch.cat([t[1] for t in tape[i::n_moe]]))
            for i in range(n_moe)]


def _go_cut(cfg2, p2, ids, kw, cpu: dict) -> dict:
    """The GPT-OSS 2-layer cut (a ring layer and a full one) on the card
    against the CPU's `cpu` {cache: (logits, tape of picks)}, per cache: the card's
    own picks against the CPU's in each MoE layer (`_moe_picks`), then the
    logits at the positions whose picks agree in both layers within
    GO_CUT_TOL, or else within the limit of twice the larger of two
    witnesses with the argmax equal where clear of it: the witness
    (attention scale one f32 step up, against the card) and the f32 witness
    (the card's cut at f32 activations and f32 expert stacks, against the
    CPU's at bf16: what the bf16 rounding of the activations alone moves);
    over bf16, the control (`swiglu_oai` replaced by the plain
    SiLU gate) and the card's cut without its sinks beyond it too."""
    n_moe = cfg2.num_hidden_layers
    res = {"bounds": GO_CUT_TOL}
    p32 = dict(p2, embed=p2["embed"].float(), layers=tuple(
        dict(lay, mlp=dict(lay["mlp"], experts={k: v.float()
                                                for k, v in lay["mlp"]["experts"].items()}))
        for lay in p2["layers"]))
    for cache in ("bfloat16", "int8"):
        tol, (c, tape) = GO_CUT_TOL[cache], cpu[cache]
        g, own = _go_cut_card(cfg2, p2, ids, kw, tape, cache)
        w = _go_cut_card(_scale_step(cfg2), p2, ids, kw, tape, cache)[0]
        f = _go_cut_card(cfg2, p32, ids, kw, tape, cache)[0]
        agree = torch.ones(len(ids), dtype=torch.bool)
        picks = []
        for i, (a, b) in enumerate(zip(_per_layer(own, n_moe),
                                       _per_layer(tape, n_moe))):
            m, r = _moe_picks(f"gpt_oss_20b 2-layer cut {cache}, MoE layer {i}", a, b)
            agree &= m
            picks.append(r)
        what = f"gpt_oss_20b 2-layer cut {cache} at {int(agree.sum())} positions"
        r = {"picks": picks,
             "card": _cut_compare(f"{what}, card vs cpu", g[agree], c[agree], tol, strict=False),
             "witness": _cut_compare(f"{what}, witness vs card", w[agree], g[agree], tol,
                                     strict=False),
             "f32_witness": _cut_compare(f"{what}, card at f32 activations vs cpu", f[agree],
                                         c[agree], tol, strict=False)}
        r["bound_met"] = r["card"]["within_tolerance"]
        r["limit"] = lim = max(tol, 2 * r["witness"]["rel_to_logit_scale"],
                               2 * r["f32_witness"]["rel_to_logit_scale"])
        r["card_at_limit"] = row_logit_errors(g[agree], c[agree], lim)
        log(f"  {what}: bound {tol} met {r['bound_met']}; limit {lim:.4g}, argmax equal where "
            f"the top two part by more than twice it: "
            f"{r['card_at_limit']['argmax_equal_where_clear']}")
        res[cache] = r
        if (r["card"]["rel_to_logit_scale"] > lim
                or not r["card_at_limit"]["argmax_equal_where_clear"]):
            raise AssertionError(f"{what}: the card is {r['card']} from the CPU, beyond {tol} "
                                 f"and twice the witness ({r['witness']})")
        if cache == "bfloat16":
            ctl = _go_cut_card(replace(cfg2, moe_act=""), p2, ids, kw, tape, cache)[0]
            bare = dict(p2, layers=tuple(dict(lay, attn={k: v for k, v in lay["attn"].items()
                                                         if k != "sinks"})
                                         for lay in p2["layers"]))
            ns = _go_cut_card(cfg2, bare, ids, kw, tape, cache)[0]
            res["control"] = {"fault": "swiglu_oai replaced by the SiLU gate",
                              "rel_to_logit_scale": row_logit_errors(
                                  ctl[agree], c[agree], 0.0)["rel_to_logit_scale"]}
            res["sinks_dropped"] = row_logit_errors(ns[agree], c[agree], 0.0)
            log(f"  {what}: control {res['control']}, without the sinks "
                f"{res['sinks_dropped']['rel_to_logit_scale']:.4g} of the logit scale")
            lim = max(r["limit"], GO_CUT_TOL["int8"])
            if (res["control"]["rel_to_logit_scale"] <= lim
                    or res["sinks_dropped"]["rel_to_logit_scale"] <= lim):
                raise AssertionError(f"{what}: the control or the cut without its sinks is "
                                     f"within {lim:.4g} of the logit scale ({res})")
    return res


def _go_server(dev, cfg8, params, prompts, name: str) -> dict:
    """`_staggered_server` over a GPT-OSS q8 cache at cfg8's depth, its
    launches held: K2 on q, k, v and the head of every batched step (o and
    the router take the dequantize-then-matmul route), K4 with sinks (per-row
    n_past, B.G = 16) on every full-attention layer of it."""
    sr = _staggered_server(dev, cfg8, params, prompts, GO_SERVE_NEW, name)
    L, n = cfg8.num_hidden_layers, sr["batched_steps"]
    full = sum(cfg8.layer_spec(i).sliding_window == 0 for i in range(L))
    want = {"qmm": (3 * L + 1) * n, "flash_decode": full * n}
    got = {k: sr["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"{name} 2-slot server: launches {got}, expected {want} "
                             f"({n} batched steps)")
    return sr


def gpt_oss_phase(dev) -> dict:
    """GPT-OSS-20B at full width and depth (`gpt_oss_20b_config`: 24 layers,
    64 query heads over 8 kv heads of 64, the even layers windowed over 128
    keys in rings of GO_RING slots, the odd ones full over max_length 8192,
    sinks on every layer, YaRN 32 over 4096, 32 experts of 2880 with the
    biased softmax-top-4 router and biased swiglu_oai experts, the untied
    201088-row head), random weights from seed 0 built on the card
    (`build_synthetic_params` with GPT_OSS_OPTS: zero-centred q4_k with
    q/k/v, the router and the head in q8_0 (K 2880), the embedding at N(0,
    0.02^2), bf16 expert stacks at N(0, 1 / fan-in), sinks N(0, 1), biases
    N(0, 0.1^2)), through the port's entry points:

      - over a bf16 and a q8 cache, the GO_PROMPT-token prompt (two chunks of
        SWA_EXTRA, which wrap the rings) and GO_NEW greedy tokens, run once
        to capture, then counted: every decode step replayed, K1 on q, k, v
        and the head every step (3 x 24 + 1) and on each prefill chunk's head, K4
        with sinks on the 12 full layers a q8 step, K3 never (the JAX
        package keeps sinks off its flash kernel), no K2; prefill ms,
        replayed steps/s, peak memory; one replayed block profiled into its
        kernels over bf16, timed over q8; one MoE layer's expert products
        timed alone;
      - at a depth cut of GO_EAGER_DEPTH layers, the uncaptured loop's
        tokens equal to the replayed ones over both caches (the graphs
        capture the sinks);
      - a 2-layer cut (a ring layer and a full one) against the CPU over
        GO_CUT_POSITIONS positions and 2 decode steps, bf16 and q8 (`_go_cut`:
        the picks by the MoE rules, the logits within GO_CUT_TOL where they
        agree, beside the witness and the control); the CPU side on
        CUT_WORKER;
      - the server's engine (BatchedEngine, 2 slots, q8), two requests of
        GO_SERVE tokens, staggered, GO_SERVE_NEW tokens each, bit-equal to
        the same server one at a time, K2 on every quantized projection and
        K4 with sinks (per-row n_past) on every full layer of every batched
        step."""
    from chatllm_tpu_torch.models.synthetic import (GPT_OSS_OPTS, build_synthetic_params,
                                                    gpt_oss_20b_config, param_bytes)
    from chatllm_tpu_torch.nn.transformer import SWA_EXTRA
    from chatllm_tpu_torch.ops.qtensor import QuantLinear
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine

    held = torch.cuda.memory_allocated(dev) / 2 ** 30
    if held > 2.0:
        raise AssertionError(f"gpt_oss_20b: {held:.2f} GiB of earlier phases still held")
    t_phase = time.perf_counter()
    spans = {}

    def span(what):
        spans[what] = time.perf_counter() - t_phase - sum(spans.values())

    cfg = gpt_oss_20b_config(max_length=8192)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    n_full = sum(s.sliding_window == 0 for s in cfg.layer_specs)
    k1_step = 3 * L + 1
    chunks = -(-GO_PROMPT // SWA_EXTRA)    # prefill chunks: each computes the head once
    torch.cuda.reset_peak_memory_stats(dev)
    params = build_synthetic_params(cfg, "q4k", zeros=False, centered=True, seed=0, device=dev,
                                    **GPT_OSS_OPTS)
    torch.cuda.synchronize()
    lp = params["layers"][0]
    q8 = [lp["attn"][k] for k in "qkv"] + [lp["mlp"]["gate"], params["lm_head"]]
    if not (all(isinstance(x, QuantLinear) and not x.packed and not x.sb for x in q8)
            and lp["attn"]["o"].sb and params["lm_head"].bias is None
            and lp["attn"]["sinks"].shape == (64,)):
        raise AssertionError("gpt_oss_20b: params are not GPT-OSS's layout")
    res = {"held_before_gib": held, "param_gib": param_bytes(params) / 2 ** 30,
           "expert_gib": param_bytes([lay["mlp"]["experts"] for lay in params["layers"]])
           / 2 ** 30, "build_s": time.perf_counter() - t_phase, "spans_s": spans,
           "k1_per_step": k1_step, "k4_per_q8_step": n_full}
    log(f"  built: params {res['param_gib']:.2f} GiB ({res['expert_gib']:.2f} of expert "
        f"stacks) in {res['build_s']:.1f} s")
    prompt = np.random.default_rng(0).integers(0, V, GO_PROMPT).tolist()

    # ---- the 2-layer cut's CPU side, with its expert picks, on CUT_WORKER
    cfg2 = _cfg_cut(cfg, 2)
    sel = _cut(params, 2, "cpu")
    cut_ids = np.random.default_rng(3).integers(0, V, GO_CUT_POSITIONS + 2)
    kw = dict(slots=(GO_RING, cfg.max_length), end=GO_CUT_POSITIONS)
    cut_cpu = _cpu_cuts("gpt_oss_20b", cfg2, sel, cut_ids, kw, picks=True)
    span("setup")

    # ---- the chat path over bf16 and q8, replayed from CUDA graphs
    steps = decode_launches(GO_NEW)
    gcfg = GenerationConfig(do_sample=False, max_new_tokens=GO_NEW)
    chat = {}
    for cache in ("bfloat16", "int8"):
        on_q8 = cache == "int8"
        eng = InferenceEngine(replace(cfg, cache_dtype=cache), params, device=dev)
        kv = eng.new_cache(1)
        t0 = time.perf_counter()
        eng.generate(prompt, gcfg, cache=kv)                # warm: captures
        warm_s = time.perf_counter() - t0
        toks, r = _timed_generate(eng, kv, prompt, GO_NEW, f"gpt_oss_20b {cache}")
        r["warm_run_s"] = warm_s
        want = {"qgemv": k1_step * steps + chunks, "qmm": 0, "flash_attention": 0,
                "flash_decode": n_full * steps if on_q8 else 0}
        got = {k: r["launches"][k] for k in want}
        r["profiled_block"] = pb = _profile_block(eng, kv, GO_PROMPT + 48, trace=not on_q8)
        r["profiled_steps_s"] = 1e3 / pb["step_ms"]
        r["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"  gpt_oss_20b {cache} cache: prefill {r['prefill_ms']:.1f} ms, "
            f"{r['profiled_steps_s']:.2f} replayed steps/s (block {pb['block_ms']:.2f} ms), "
            f"warm run {warm_s:.2f} s, peak {r['peak_mem_gib']:.2f} GiB, "
            f"{len(set(toks))} distinct tokens, launches {got} (K1 {k1_step} a step, K4 "
            f"{n_full if on_q8 else 0} a step, K3 0); kernels {pb.get('kernel_ms')} ms, "
            f"busy share {pb.get('busy_share')}; top kernels {pb.get('top_kernels_ms')}")
        if (got != want or sum(r["flash_modes"].values()) or r["replayed_steps"] != steps
                or len(set(toks)) < 8):
            raise AssertionError(f"gpt_oss_20b {cache}: launches {got} (expected {want}), "
                                 f"K3 by mode {r['flash_modes']}, {r['replayed_steps']} "
                                 f"replayed steps, tokens {toks}")
        chat[cache] = {"graph": r, "tokens": toks, "distinct_tokens": len(set(toks))}
        del eng, kv
        torch.cuda.empty_cache()
    res["chat"] = chat
    res["expert_products"] = expert_products(dev, cfg, params["layers"][1]["mlp"], L)
    span("chat")
    res["eager_cut"] = _eager_vs_replayed(dev, cfg, params, prompt, "gpt_oss_20b", k1_step,
                                          True, GO_EAGER_DEPTH, GO_NEW, chunks)
    span("eager_cut")

    # ---- the 2-layer cut on the card against the CPU's
    p2 = _to_device(sel, dev)
    t0 = time.perf_counter()
    cpu = cut_cpu.result()
    res["cut"] = {"cpu_wait_s": time.perf_counter() - t0,
                  **_go_cut(cfg2, p2, cut_ids, kw, cpu)}
    del p2, cpu, sel
    span("cut")

    # ---- the server's engine: 2 slots over q8, staggered requests
    rng = np.random.default_rng(5)
    sprompts = [rng.integers(0, V, n).tolist() for n in GO_SERVE]
    sr = _go_server(dev, replace(cfg, cache_dtype="int8"), params, sprompts, "gpt_oss_20b")
    log(f"  gpt_oss_20b 2-slot q8 server: {sr['wall_s']:.2f} s, {sr['batched_steps']} batched "
        f"steps ({sr['replayed_steps']} replayed from {sr['graphs']} graph(s)), K2 "
        f"{sr['launches']['qmm']}, K4 {sr['launches']['flash_decode']}, replies bit-equal to "
        f"the same server's one at a time")
    res["serve"] = sr
    span("serve")
    del params, lp, q8
    gc.collect()
    torch.cuda.empty_cache()
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  gpt_oss_20b phase: params {res['param_gib']:.2f} GiB, peak device memory "
        f"{res['peak_mem_gib']:.2f} GiB, {res['seconds']:.1f} s ({spans})")
    return res


# ------------------------------------------------------------ gemma2_9b phase
GEMMA2_CUT_POSITIONS = 640         # the cut's prompt: K3 on its global layer per chunk
GEMMA2_CUT_STEPS = 2               # then q8 / bf16 decode steps (K4 over q8)


def gemma2_setup(dev) -> dict:
    """The Gemma-2-9B cut's parameters, built on the card and kept on the
    CPU, and its CPU side queued on CUT_WORKER (`gemma2_phase` takes the
    result), so that it runs while the card works through the gemma3_12b
    phase, after that phase's CPU side (`gemma3_setup`)."""
    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, gemma2_9b_config

    t0 = time.perf_counter()
    cfg2 = _cfg_cut(gemma2_9b_config(max_length=8192), 2)
    if (cfg2.layer_spec(0).sliding_window, cfg2.layer_spec(1).sliding_window) != (4096, 0):
        raise AssertionError(f"gemma2 cut: layer specs {cfg2.layer_specs}")
    params = _to_device(build_synthetic_params(cfg2, "q4k", zeros=False, centered=True,
                                               seed=0, device=dev), "cpu")
    torch.cuda.empty_cache()
    ids = np.random.default_rng(4).integers(0, cfg2.vocab_size,
                                            GEMMA2_CUT_POSITIONS + GEMMA2_CUT_STEPS)
    kw = dict(slots=(4608, 8192), end=GEMMA2_CUT_POSITIONS)
    return {"cfg2": cfg2, "params": params, "ids": ids, "kw": kw,
            "cpu": _cpu_cuts("gemma2_9b", cfg2, params, ids, kw),
            "setup_s": time.perf_counter() - t0}


def gemma2_phase(dev, setup: dict) -> dict:
    """A full-width 2-layer cut of Gemma-2-9B (`gemma2_9b_config`, layers 0
    and 1: a ring of 4608 slots over the 4096-key window, then a global layer
    of 8192; attention softcap 50, final softcap 30; random zero-centred q4_k
    weights from seed 0) against the CPU (`gemma2_setup`, run beforehand):
    GEMMA2_CUT_POSITIONS positions in chunks of SWA_EXTRA (K3 in mode 2 with
    softcap 50 on the global layer of every chunk over bf16; the ring's
    einsum softcapped on layer 0), then GEMMA2_CUT_STEPS decode steps at a
    0-d device offset (K4 with softcap 50 over q8), bf16 and q8, within
    GEMMA_CUT_TOL of the logit scale, beside its witness and its control
    (the cut without its sandwich norms), as `_gemma_cut_check`."""
    from chatllm_tpu_torch.ops.cuda.build import launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.cuda.flash import MODE_LAUNCHES, reset_mode_launches

    t0 = time.perf_counter()
    cfg2, ids, kw = setup["cfg2"], setup["ids"], setup["kw"]
    params = _to_device(setup["params"], dev)
    res = {"setup_s": setup["setup_s"]}
    chunks = -(-GEMMA2_CUT_POSITIONS // 512)
    card = {}
    for cache in ("bfloat16", "int8"):
        reset_launch_counts()
        reset_mode_launches()
        card[cache] = _ring_cut(cfg2, params, ids, dev, cache, **kw)[0]
        torch.cuda.synchronize()
        launches, modes = launch_counts(), dict(MODE_LAUNCHES)
        got = {k: launches[k] for k in ("flash_attention", "flash_decode")}
        want = ({"flash_attention": 0, "flash_decode": GEMMA2_CUT_STEPS} if cache == "int8"
                else {"flash_attention": chunks, "flash_decode": 0})
        log(f"  gemma2 {cache}: K3 by mode {modes}, launches {got}")
        if got != want or modes[2] != want["flash_attention"]:
            raise AssertionError(f"gemma2 cut {cache}: launches {got}, K3 by mode {modes} "
                                 f"(expected {want})")
        res[cache] = {"launches": got}
    witness, control = _witness_and_control(cfg2, params, ids, kw,
                                            replace(cfg2, post_norms=False))
    t1 = time.perf_counter()
    cpu = setup["cpu"].result()
    res["cpu_wait_s"] = time.perf_counter() - t1
    res["cut"] = _gemma_cut_check("gemma2 2-layer cut", card, cpu, witness, control,
                                  "no sandwich norms")
    res["seconds"] = time.perf_counter() - t0
    log(f"  gemma2_9b cut: {res['seconds']:.1f} s here (waited {res['cpu_wait_s']:.1f} s for "
        f"the CPU), {res['setup_s']:.1f} s of setup before the gemma3_12b phase")
    return res


# ---------------------------------------------------------------- report
# ---------------------------------------------------------- internvl phase
IVL_IMAGE_HW = (1500, 2000)        # a 4:3 photo: a 4 x 3 grid, 12 tiles + thumbnail
IVL_TILES = 13
IVL_NEW = 32
IVL_QUESTION = "Describe this image in one sentence."
# the spliced prompt: the system prompt and ChatML's opening (45 ids), 13 x
# 256 image tokens, `</img>`, the question and the assistant's opening (51)
IVL_PROMPT_TOKENS = 3424
IVL_STEP_K1 = IVL_DEPTH * 7 + 1    # K1 launches per decode step (IVL_DEPTH x 7 + lm_head)
# 2-layer tower cut, card vs CPU, of the output scale: about 4x the first
# readings (1.15e-4 after the tower, 2.04e-3 after the projector, whose fc1
# takes bf16 input: one-ulp roundings of it move the output)
IVL_TOWER_TOL = {"tower": 5e-4, "projector": 1e-2}
IVL_CUT_TOL = 1e-3                 # 2-layer LLM cut over the spliced embeddings
IVL_CUT_SLOTS = 4096               # its cache: the 3424-token prompt in one 4096 bucket


def write_png(path, img: np.ndarray):
    """An 8-bit RGB PNG of img [H, W, 3], every row under filter type 0."""
    import zlib

    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n"
                           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                           + chunk(b"IEND", b""))
    return path


def ivl_image(seed: int, hw=IVL_IMAGE_HW) -> np.ndarray:
    """A seeded uint8 photo-sized image: a smooth colour field plus noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([np.sin(xx / (w / rng.uniform(2, 9)) + c) * np.cos(yy / (h / rng.uniform(2, 9)))
                     for c in rng.uniform(0, 6.3, 3)], axis=-1)
    img = 127.5 + 100 * base + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _ivl_tokenizer(cfg):
    """Qwen's tokenizer and ChatML template over a byte-level vocab of the
    model's size with `<img>` / `</img>` (a narrow INTERN_VL GGMM written
    for its vocab; its weights stay unused)."""
    from chatllm_tpu_torch.models.base import load_model
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = write_internvl_ggmm(BUILD_DIR / f"smoke_internvl_vocab{cfg.vocab_size}.bin",
                               vocab_pad=cfg.vocab_size, hidden=64, heads=2, kv_heads=1,
                               head_dim=32, layers=1, inter=128, dtype=0, vis_layers=1)
    return load_model(str(path), device="cpu").tokenizer


class _TimedTokens(_Tokens):
    """A streamer that keeps the streamed ids and when each arrived."""

    def __init__(self):
        super().__init__()
        self.times = []

    def put(self, ids):
        super().put(ids)
        self.times.extend(time.perf_counter() for _ in ids)


def internvl_phase(dev) -> dict:
    """Full-width InternVL3.5-8B (`internvl3_5_8b_config`: Qwen3-8B, cut to
    IVL_DEPTH of its 36 layers,
    random q4_k projections from seed 0; `internvit_300m_config`: the 24-layer
    InternViT tower and the projector in bf16 from seed 1), max_length 8192,
    through `InternVL.chat_image` on two seeded 2000 x 1500 PNGs (12 tiles and
    a thumbnail, 3328 image tokens, a 3424-token spliced prompt):
      - a bf16 cache: a warm-up chat on image 0 (its decode graphs
        captured); then, on image 1, preprocessing, the tower, the projector
        and the spliced prefill timed one by one (the functions chat_image
        calls), and the whole call on the same engine, counted: no capture and
        no warm-up step, every decode block replayed, K3 one launch a layer in mode
        2 (the 4096-row prefill bucket in one call) and none in mode 0, K1
        IVL_STEP_K1 per replayed step plus the prefill's lm_head row;
      - one OpenAI request to the server with image 0 as a data URI: its
        reply equals chat_image's, and it captures nothing;
      - a q8 cache likewise: K4 one launch a layer per replayed step;
      - 2-layer cuts against the CPU on the same weights: the tower and
        projector on one tile (IVL_TOWER_TOL of the output scale) and the
        LLM's prefill over the spliced embeddings (IVL_CUT_TOL of the logit
        scale, same argmax), whose CPU side runs in a worker thread."""
    import base64
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from chatllm_tpu_torch.models.internvl import InternVL, project
    from chatllm_tpu_torch.models.synthetic import (build_synthetic_params,
                                                     build_synthetic_vision,
                                                     internvit_300m_config,
                                                     internvl3_5_8b_config, param_bytes)
    from chatllm_tpu_torch.nn.vit import vit_forward
    from chatllm_tpu_torch.ops.cuda.build import BUILD_DIR, launch_counts, reset_launch_counts
    from chatllm_tpu_torch.ops.cuda.flash import MODE_LAUNCHES, reset_mode_launches
    from chatllm_tpu_torch.runtime.generate import GenerationConfig, InferenceEngine
    from chatllm_tpu_torch.runtime.vision import internvl_tiles, load_image
    from chatllm_tpu_torch.serve.server import ApiServer, _make_handler

    t_phase = time.perf_counter()
    cfg = replace(internvl3_5_8b_config(max_length=8192), num_hidden_layers=IVL_DEPTH)
    vcfg = internvit_300m_config()
    params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev)
    vp = build_synthetic_vision(vcfg, cfg.hidden_size, seed=1, device=dev)
    model = InternVL.from_parts(cfg, params, _ivl_tokenizer(cfg), vcfg, vp, dev)
    pngs = [write_png(BUILD_DIR / f"smoke_internvl_{i}.png", ivl_image(i)) for i in range(2)]
    res = {"llm_gib": param_bytes(params) / 2 ** 30, "vision_gib": param_bytes(vp) / 2 ** 30,
           "setup_s": time.perf_counter() - t_phase}
    log(f"  InternVL3.5-8B built: LLM {res['llm_gib']:.2f} GiB, tower and projector "
        f"{res['vision_gib']:.2f} GiB, in {res['setup_s']:.1f} s")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    g = GenerationConfig(do_sample=False, max_new_tokens=IVL_NEW)
    want_steps = decode_launches(IVL_NEW)

    def chat(png, name, counted: bool) -> dict:
        dec = model.engine.decoder
        was = (dec.num_graphs(), dec.eager_steps, dec.replayed_steps)
        if counted:
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launch_counts()
            reset_mode_launches()
        st = _TimedTokens()
        t0 = time.perf_counter()
        reply = model.chat_image(str(png), IVL_QUESTION, g, st)
        torch.cuda.synchronize()
        r = {"reply": reply, "tokens": len(st.ids), "wall_ms": (time.perf_counter() - t0) * 1e3,
             "first_token_ms": (st.times[0] - t0) * 1e3,
             "decode_steps_s": (len(st.ids) - 1) / (st.times[-1] - st.times[0]),
             "graphs": dec.num_graphs(), "new_graphs": dec.num_graphs() - was[0],
             "warmup_steps": dec.eager_steps - was[1],
             "replayed_steps": dec.replayed_steps - was[2], "capture_ms": dec.capture_ms}
        if counted:
            r.update(launches=launch_counts(), flash_modes=dict(MODE_LAUNCHES),
                     peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        log(f"  {name}: {r}")
        if len(st.ids) != IVL_NEW or not reply:
            raise AssertionError(f"{name}: {len(st.ids)} tokens, reply {reply!r}")
        if counted and (r["new_graphs"] or r["warmup_steps"] or r["replayed_steps"] != want_steps):
            raise AssertionError(f"{name}: a second image captured {r['new_graphs']} graphs, "
                                 f"warmed {r['warmup_steps']} steps, replayed "
                                 f"{r['replayed_steps']} (expected {want_steps})")
        if counted and r["launches"]["qgemv"] != IVL_STEP_K1 * want_steps + 1:
            raise AssertionError(f"{name}: K1 launched {r['launches']['qgemv']} times, expected "
                                 f"{IVL_STEP_K1 * want_steps + 1}")
        return r

    # ---- bf16 cache: warm on image 0, then image 1 counted
    eng = InferenceEngine(cfg, params, device=dev)
    model._engine = eng
    res["bf16_warm"] = chat(pngs[0], "bf16 cache, image 0 (captures)", False)
    # ---- the parts of chat_image on image 1, one by one, warm (the card's
    # libraries loaded by the chat above), the prefill into the kept cache
    with torch.inference_mode():
        img, load_ms = timed(lambda: load_image(pngs[1]))
        (tiles, grid), tile_ms = timed(lambda: internvl_tiles(
            img, image_size=vcfg.image_size, max_num=12, use_thumbnail=True,
            mean=model.image_mean, std=model.image_std))
        x, tower_ms = timed(lambda: vit_forward(vcfg, vp, torch.as_tensor(tiles, device=dev)))
        media, proj_ms = timed(lambda: project(vcfg, vp, x, model.downsample_ratio,
                                               torch.bfloat16))
        embeds = model.splice(media, *model.image_prompt(IVL_QUESTION))
        (logits, _, n_past), prefill_ms = timed(
            lambda: eng.prefill_embeds(embeds, model.image_cache(), 0))
        first = int(logits.argmax())
    parts = {"decode_png_ms": load_ms, "tiles_ms": tile_ms, "tower_ms": tower_ms,
             "projector_ms": proj_ms, "prefill_ms": prefill_ms, "first_token": first,
             "tiles": int(tiles.shape[0]), "grid": list(grid),
             "image_tokens": int(media.shape[0]), "prompt_tokens": int(embeds.shape[1])}
    res["parts"] = parts
    log(f"  parts of chat_image (image 1): {parts}")
    if (tuple(tiles.shape) != (IVL_TILES, 448, 448, 3) or tuple(grid) != (4, 3)
            or tuple(media.shape) != (IVL_TILES * 256, cfg.hidden_size)
            or not torch.isfinite(media).all() or embeds.shape[1] != IVL_PROMPT_TOKENS
            or n_past != IVL_PROMPT_TOKENS or not torch.isfinite(logits).all()):
        raise AssertionError(f"InternVL parts: tiles {tuple(tiles.shape)}, grid {grid}, media "
                             f"{tuple(media.shape)}, prompt {embeds.shape[1]}, n_past {n_past}")

    # ---- the 2-layer LLM cut: its CPU side in a worker thread from here on
    cfg2 = replace(cfg, num_hidden_layers=2)
    p2_cpu, emb_cpu = _cut(params, 2, "cpu"), embeds.cpu()

    def cpu_cut():
        with torch.inference_mode():
            e = InferenceEngine(cfg2, p2_cpu, device="cpu")
            return e.prefill_embeds(emb_cpu, e.new_cache(1, IVL_CUT_SLOTS), 0)[0]

    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 2))    # host cores left for the card's dispatch
    worker = ThreadPoolExecutor(1)
    cut_future = worker.submit(cpu_cut)
    del x, media, embeds

    r = res["bf16"] = chat(pngs[1], "bf16 cache, image 1 (counted)", True)
    if r["flash_modes"][2] != cfg.num_hidden_layers or r["flash_modes"][0] != 0:
        raise AssertionError(f"bf16 image prefill: K3 by mode {r['flash_modes']}, expected "
                             f"{cfg.num_hidden_layers} in mode 2 and none in mode 0")
    if r["launches"]["flash_decode"] != 0:
        raise AssertionError("bf16 cache: K4 launched")

    # ---- the server: one image_url request (image 0) on the same engine
    api = ApiServer(model, model_name="internvl3.5-8b-synthetic", max_slots=1, device=dev,
                    gen_config=g)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(api))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    uri = "data:image/png;base64," + base64.b64encode(Path(pngs[0]).read_bytes()).decode()
    body = json.dumps({"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": uri}},
        {"type": "text", "text": IVL_QUESTION}]}]}).encode()
    graphs = model.engine.decoder.num_graphs()
    t0 = time.perf_counter()
    req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_port}/v1/chat/completions",
                                 body, {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        served = json.loads(resp.read())["choices"][0]["message"]["content"]
    httpd.shutdown()
    httpd.server_close()
    res["serve"] = {"reply": served, "wall_ms": (time.perf_counter() - t0) * 1e3,
                    "request_bytes": len(body),
                    "new_graphs": model.engine.decoder.num_graphs() - graphs}
    log(f"  server image_url request: {res['serve']}")
    if served != res["bf16_warm"]["reply"] or res["serve"]["new_graphs"]:
        raise AssertionError(f"server reply {served!r} differs from chat_image's "
                             f"{res['bf16_warm']['reply']!r}, or it captured graphs")
    del api
    model._engine = model._image_cache = None
    del eng
    torch.cuda.empty_cache()

    # ---- q8 cache: K4 on every decode step
    model._engine = InferenceEngine(replace(cfg, cache_dtype="int8"), params, device=dev)
    res["q8_warm"] = chat(pngs[0], "q8 cache, image 0 (captures)", False)
    r = res["q8"] = chat(pngs[1], "q8 cache, image 1 (counted)", True)
    if r["launches"]["flash_decode"] != cfg.num_hidden_layers * want_steps:
        raise AssertionError(f"q8 cache: K4 launched {r['launches']['flash_decode']} times, "
                             f"expected {cfg.num_hidden_layers * want_steps}")
    model._engine = model._image_cache = None
    torch.cuda.empty_cache()

    # ---- 2-layer cuts against the CPU
    vcfg2 = replace(vcfg, num_hidden_layers=2)
    vp2 = dict(vp, layers=vp["layers"][:2])
    with torch.inference_mode():
        tile = torch.as_tensor(tiles[:1])
        outs = []
        for d in (dev, "cpu"):
            p = vp2 if d == dev else _to_device(vp2, "cpu")
            h = vit_forward(vcfg2, p, tile.to(d))
            outs.append((h, project(vcfg2, p, h, model.downsample_ratio, torch.bfloat16)))
    cut = {}
    for i, what in enumerate(("tower", "projector")):
        gpu, cpu = outs[0][i].float().cpu(), outs[1][i].float()
        err, rel = rel_err(gpu, cpu)
        cut[what] = {"max_abs_err": err, "rel_to_scale": rel, "scale": cpu.abs().max().item()}
        if not (torch.isfinite(gpu).all() and rel <= IVL_TOWER_TOL[what]):
            raise AssertionError(f"2-layer {what} cut: {rel} of the output scale > "
                                 f"{IVL_TOWER_TOL[what]}")
    res["tower_cut_vs_cpu"] = cut
    log(f"  2-layer tower + projector on one tile, card vs cpu: {cut}")
    with torch.inference_mode():
        e = InferenceEngine(cfg2, _cut(params, 2, dev), device=dev)
        emb = emb_cpu.to(dev)
        card = e.prefill_embeds(emb, e.new_cache(1, IVL_CUT_SLOTS), 0)[0]
        del e, emb
    res["llm_cut_vs_cpu"] = _compare_logits("2-layer LLM prefill over the spliced embeddings "
                                            "card vs cpu", card, cut_future.result(),
                                            IVL_CUT_TOL)
    worker.shutdown()
    torch.set_num_threads(threads)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  internvl phase: {res['seconds']:.1f} s")
    return res


def ivl_totals(kres: dict) -> dict:
    """K1, K3 and K4 summed over one unit of InternVL3.5-8B's path at its
    shapes: a decode token (36 x 7 projections + the lm_head), the image
    prefill (36 launches of K3 mode 2 over the 4096-row bucket) and a q8
    decode step (36 launches of K4)."""
    units = {"qgemv": (kres["qgemv"]["ivl_shapes"], _per_token(36, True)),
             "flash_attention_f32q": (kres["flash_attention"]["shapes"], {"ivl_prefill_f32q": 36}),
             "flash_decode": (kres["flash_decode"]["shapes"], {"ivl_decode_3440": 36})}
    return {name: {f: sum(mult[s] * shapes[s][f] for s in mult)
                   for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for name, (shapes, mult) in units.items()}


def a3b_totals(kres: dict) -> dict:
    """K1, K2, K3 and K4 summed over one unit of Qwen3-30B-A3B's path at its
    shapes: a decode token (48 x 5 projections + the lm_head), a 2-row
    batched step (K2, the lm_head included), a 512- and a 2048-token
    prefill chunk (48 launches of K3 mode 2 each) and a q8 decode step after
    1000 tokens (48 launches of K4)."""
    tok = {**{k: A3B_LAYERS * v for k, v in PER_LAYER_A3B.items()}, "lm_head": 1}
    units = {"qgemv": (kres["qgemv"]["a3b_shapes"], tok),
             "qmm": (kres["qmm"]["a3b_shapes"], tok),
             "flash_attention_f32q_512": (kres["flash_attention"]["shapes"],
                                          {"a3b_prefill_512_f32q": A3B_LAYERS}),
             "flash_attention_f32q_2048": (kres["flash_attention"]["shapes"],
                                           {"a3b_prefill_2048_f32q": A3B_LAYERS}),
             "flash_decode": (kres["flash_decode"]["shapes"], {"a3b_decode_1000": A3B_LAYERS})}
    return {name: {f: sum(mult[s] * shapes[s][f] for s in mult)
                   for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for name, (shapes, mult) in units.items()}


def g3_totals(kres: dict) -> dict:
    """K1, K2, K3 and K4 summed over one unit of Gemma-3-12B's path at its
    shapes: a decode token (48 x 7 projections; the tied head is dot_f32), a
    2-row batched step (K2), a 512-token prefill chunk over the ring route
    (8 launches of K3 mode 2, its global layers) and a 1024-row chunk of the
    dense windowed route (48 launches), and a q8 decode step past 4096 (8
    launches of K4, bf16 dots and int8 dots)."""
    tok = {k: G3_LAYERS * v for k, v in PER_LAYER_G3.items()}
    n_glob = len(GEMMA3_GLOBAL)
    units = {"qgemv": (kres["qgemv"]["g3_shapes"], tok),
             "qmm": (kres["qmm"]["g3_shapes"], tok),
             "flash_attention_f32q_512": (kres["flash_attention"]["shapes"],
                                          {"g3_prefill_512_f32q": n_glob}),
             "flash_attention_f32q_dense_1024": (kres["flash_attention"]["shapes"],
                                                 {"g3_dense_prefill_1024_f32q": G3_LAYERS}),
             "flash_decode": (kres["flash_decode"]["shapes"], {"g3_decode_5000": n_glob}),
             "flash_decode_int8": (kres["flash_decode_int8"]["shapes"],
                                   {"g3_decode_5000": n_glob})}
    return {name: {f: sum(mult[s] * shapes[s][f] for s in mult)
                   for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for name, (shapes, mult) in units.items()}


def glm_totals(kres: dict) -> dict:
    """K1, K2, K3 and K4 summed over one unit of GLM-4-9B's path at its
    shapes: a decode token (40 x 4 fused projections + the lm_head), a 2-row
    batched step (K2, the lm_head included), the 1000-token prompt's chunk
    (40 launches of K3 mode 2) and a q8 decode step after it (40 launches of
    K4)."""
    tok = {**{k: GLM_LAYERS * v for k, v in PER_LAYER_GLM.items()}, "lm_head": 1}
    units = {"qgemv": (kres["qgemv"]["glm_shapes"], tok),
             "qmm": (kres["qmm"]["glm_shapes"], tok),
             "flash_attention_f32q": (kres["flash_attention"]["shapes"],
                                      {"glm_prefill_1000_f32q": GLM_LAYERS}),
             "flash_decode": (kres["flash_decode"]["shapes"], {"glm_decode_1064": GLM_LAYERS})}
    return {name: {f: sum(mult[s] * shapes[s][f] for s in mult)
                   for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for name, (shapes, mult) in units.items()}


def phi_totals(kres: dict) -> dict:
    """K3 and K4 summed over one unit of each Phi model's path at its shapes:
    the 1000-token prompt's chunk (32 launches of K3 in each mode; mode 2 is
    the chat path's over a bf16 cache) and a q8 decode step after it (32
    launches of K4: the f32 dots the route takes, and the int8 dots)."""
    out = {}
    for model in ("phi35", "phi2"):
        fa = kres["flash_attention"]["shapes"]
        units = {**{f"flash_attention{tag}": (fa, {f"{model}_prefill_1000{tag}": PHI_LAYERS})
                    for tag in ("", "_f32", "_f32q")},
                 "flash_decode": (kres["flash_decode"]["shapes"],
                                  {f"{model}_decode_1064": PHI_LAYERS}),
                 "flash_decode_int8": (kres["flash_decode_int8"]["shapes"],
                                       {f"{model}_decode_1064": PHI_LAYERS})}
        out[model] = {name: {f: sum(mult[s] * shapes[s][f] for s in mult)
                             for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
                      for name, (shapes, mult) in units.items()}
    return out


def go_totals(kres: dict) -> dict:
    """K1, K2 and K4 summed over one unit of GPT-OSS-20B's path at its
    shapes: a decode token (24 x 3 q8_0 projections + the head; o and the
    router take the dequantize-then-matmul route), a 2-row batched step (K2,
    the head included) and a q8 decode step after the 1000-token prompt (12
    launches of K4 with sinks, f32 dots)."""
    tok = {**{k: GO_LAYERS * v for k, v in PER_LAYER_GO.items()}, "lm_head": 1}
    units = {"qgemv": (kres["qgemv"]["go_shapes"], tok),
             "qmm": (kres["qmm"]["go_shapes"], tok),
             "flash_decode": (kres["flash_decode"]["shapes"],
                              {"go_decode_1064": GO_FULL_LAYERS})}
    return {name: {f: sum(mult[s] * shapes[s][f] for s in mult)
                   for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for name, (shapes, mult) in units.items()}


KERNEL_META = {
    "qgemv": ("chatllm_tpu_torch/csrc/qgemv.cu",
              "chatllm_tpu/ops/pallas/gemv_kernel.py:161"),
    "qmm": ("chatllm_tpu_torch/csrc/qmm.cu", "chatllm_tpu/ops/pallas/qmm_kernel.py:141"),
    "flash_attention": ("chatllm_tpu_torch/csrc/flash_attention.cu",
                        "chatllm_tpu/ops/pallas/flash.py:113"),
    "flash_attention_f32": ("chatllm_tpu_torch/csrc/flash_attention.cu",
                            "chatllm_tpu/ops/pallas/flash.py:113"),
    "flash_attention_f32q": ("chatllm_tpu_torch/csrc/flash_attention.cu",
                             "chatllm_tpu/ops/pallas/flash.py:113"),
    "flash_decode": ("chatllm_tpu_torch/csrc/flash_decode.cu",
                     "chatllm_tpu/ops/pallas/flash_decode.py:114"),
    "flash_decode_mla": ("chatllm_tpu_torch/csrc/flash_decode.cu",
                         "chatllm_tpu/ops/pallas/flash_decode.py:155"),
    "flash_decode_sinks": ("chatllm_tpu_torch/csrc/flash_decode.cu",
                           "chatllm_tpu/ops/pallas/flash_decode.py:155"),
    "qmm_decode": ("chatllm_tpu_torch/csrc/qmm_decode.cu",
                   "chatllm_tpu/ops/pallas/qmm_decode.py:150"),
    "bw_probe": ("chatllm_tpu_torch/csrc/bw_probe.cu",
                 "chatllm_tpu/ops/pallas/bw_probe.py:29"),
    "gemv_stream": ("chatllm_tpu_torch/csrc/gemv_probe.cu",
                    "experiments/gemv_probe2.py:69, experiments/gemv_probe.py:211"),
    "gemv_vpu": ("chatllm_tpu_torch/csrc/gemv_probe.cu",
                 "experiments/gemv_probe2.py:117, experiments/gemv_probe.py:147"),
    "stream_read": ("chatllm_tpu_torch/csrc/gemv_model.cu",
                    "experiments/gemv_model_bench.py:46"),
    "qgemv_bf16": ("chatllm_tpu_torch/csrc/gemv_model.cu",
                   "experiments/gemv_model_bench.py:223"),
    "unpack_gemv": ("chatllm_tpu_torch/csrc/gemv_unpack.cu",
                    "experiments/gemv_unpack.py:99, experiments/gemv_unpack.py:146"),
    "qmm_dma": ("chatllm_tpu_torch/csrc/qmm_dma.cu", "experiments/qmm_m32.py:83"),
    "flash_decode_int8": ("chatllm_tpu_torch/csrc/flash_decode.cu",
                          "chatllm_tpu/ops/pallas/flash_decode.py:409"),
    "flash_decode_e7": ("chatllm_tpu_torch/csrc/flash_decode.cu", "experiments/bhsd_decode.py:51"),
    "qmm_unpack": ("chatllm_tpu_torch/csrc/qmm_unpack.cu",
                   "experiments/qmm_unpack_variants.py:230, experiments/qmm_unpack_variants.py:283"),
    "qmm_unpack_diag": ("chatllm_tpu_torch/csrc/qmm_unpack.cu",
                        "experiments/qmm_unpack_variants.py:230"),
}


def _per_token(n_layers: int, lm_head: bool) -> dict:
    m = {k: n_layers * v for k, v in PER_LAYER.items()}
    return {**m, "lm_head": 1} if lm_head else m


def kernels_line(kres: dict, launches: dict) -> dict:
    """One entry per kernel, its times summed over the main path's calls of
    one unit of work: qgemv = one decode token (32 x 7 projections + the
    lm_head), qmm = one <=64-token prefill chunk (32 x 7 at 64 rows),
    flash_attention = the 1000-token prompt's chunk (32 layers) in mode 0
    (bf16), flash_attention_f32 / _f32q the same chunk in mode 1 (f32 cache)
    / mode 2 (f32 query over a bf16 cache), flash_decode
    = one decode step after the 1000-token prompt over a q8 cache (32
    layers), qmm_decode = one batched decode step of 8 rows (32 x 7 + the
    lm_head), bw_probe = one pass over 256 MiB, gemv_stream / gemv_vpu = one
    call at 4096 x 16384 (E2's shape), stream_read / qgemv_bf16 = one decode
    token of E3 (32 x 7 projections), unpack_gemv = one call of each of its
    four modes at 4096 x 14336, qmm_dma = one pass over 4096 x 14336,
    flash_decode_mla = one DeepSeek-V2-Lite decode step after the
    1000-token prompt over a q8 cache (27 layers at (192, 128)),
    flash_decode_sinks = one GPT-OSS-20B decode step after the 1000-token
    prompt over a q8 cache (its 12 full-attention layers: sinks, D 64, 8
    query heads a kv head; its max_abs_err over every K4 case with sinks),
    flash_decode_int8 = one decode step after the 1000-token prompt (32
    layers), flash_decode_e7 = one E7 decode step over the q8 cache at
    n_past 47 (32 layers), qmm_unpack = one call of each of E6's three
    variants and qmm_unpack_diag of each of its five modes at M 32, K 4096,
    N 14336.  `launches` counts each kernel on its own path: K1-K3 on the
    bf16-cache chat path (K3 by mode: flash_attention its mode 0 launches
    there, none, since the projections return f32; _f32q its mode 2
    launches there; _f32 its mode 1 launches on the f32-cache engine run),
    K4 on the q8-cache one (at (192, 128) on DeepSeek-V2-Lite's q8-cache
    chat path, with sinks on GPT-OSS-20B's, its int8 dots on the
    int8 engine run, and under E7's call site in E7's main), K5 on the
    bench's batched section under CHATLLM_TPU_QMM_V2=1, K6 in the bench,
    E2's two in E2's and E1's mains together, the others in their probe's
    main."""
    mult = {"qgemv": _per_token(N_LAYERS, True), "qmm": _per_token(N_LAYERS, False),
            "flash_attention": {"prefill_1000": N_LAYERS},
            "flash_attention_f32": {"prefill_1000_f32": N_LAYERS},
            "flash_attention_f32q": {"prefill_1000_f32q": N_LAYERS},
            "flash_decode": {"decode_1000": N_LAYERS},
            "flash_decode_mla": {"dsv2_1000": DSV2_LAYERS},
            "flash_decode_sinks": {"go_decode_1064": GO_FULL_LAYERS},
            "qmm_decode": _per_token(N_LAYERS, True),
            "bw_probe": {"pass_256mb": 1},
            "gemv_stream": {"4096x16384": 1}, "gemv_vpu": {"4096x16384": 1},
            "stream_read": _per_token(N_LAYERS, False),
            "qgemv_bf16": _per_token(N_LAYERS, False),
            "unpack_gemv": {"v0": 1, "v1": 1, "v2": 1, "v3": 1},
            "qmm_dma": {"4096x14336": 1},
            "flash_decode_int8": {"decode_1000": N_LAYERS},
            "flash_decode_e7": {"e7_step_q8": N_LAYERS},
            "qmm_unpack": {name: 1 for name in ("v0_current", "v4_biasdot", "v5_f32+biasdot")},
            "qmm_unpack_diag": {f"diag_{m}": 1 for m in ("noscale", "nounpack", "storeonly",
                                                         "splitstore", "splitstore_bias")}}
    # K3's three modes share one wrapper and its table: each entry holds its
    # mode's cases
    k3 = {"flash_attention": ("torch.bfloat16", "torch.bfloat16"),
          "flash_attention_f32": ("torch.float32", "torch.float32"),
          "flash_attention_f32q": ("torch.float32", "torch.bfloat16")}
    entries = []
    for name, (src, rep) in KERNEL_META.items():
        r = (kres["flash_attention"] if name in k3 else
             kres["flash_decode"] if name == "flash_decode_sinks" else kres[name])
        cases = [c for c in r["cases"] if name not in k3
                 or (c["q_dtype"], c["dtype"]) == k3[name]]
        if name == "flash_decode_sinks":
            cases = [c for c in cases if "'sinks': True" in c["extra"]]
        entries.append(_line_entry(name, src, rep, r["shapes"], mult[name], cases,
                                   launches.get(name)))
    return {"kernels": entries}


def _line_entry(name, src, rep, shapes, mult, cases, launches) -> dict:
    tot = {f: sum(mult[s] * shapes[s][f] for s in mult)
           for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
    # what bounds the shape that contributes most to the bound
    top = max(mult, key=lambda s: mult[s] * shapes[s]["bound_ms"])
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": shapes[top]["bound_by"], "library_ms": tot["library_ms"]}


def kernel_shares(kres: dict, gd: dict, key: str, layers: int, head: bool,
                  k4_shape: str) -> dict:
    """K1's time per decode token and K4's per q8 step (this run's kernel
    table, L2 flushed before each launch) over the replayed step's time on
    the card (the profiled block's events), per cache."""
    k1 = sum(n * kres["qgemv"][key][s]["ms"] for s, n in _per_token(layers, head).items())
    k4 = layers * kres["flash_decode"]["shapes"][k4_shape]["ms"]
    out = {}
    for cache, runs in gd.items():
        step = runs["graph"]["profiled_block"]["step_ms"]
        out[cache] = {"step_ms": step, "k1_ms": k1, "k1_share": k1 / step}
        if cache == "int8":
            out[cache].update(k4_ms=k4, k4_share=k4 / step)
    return out


def k5_vs_k2(kres: dict) -> dict:
    """K5 beside K2, the library call and the bound, each summed over one
    8-row batched decode step (Llama-3-8B: 32 x 7 projections + the
    lm_head; Qwen2.5-0.5B: 24 x 7) and one 64-row chunk (no lm_head), from
    this run's kernel table."""
    out = {}
    for model, key, layers, head in (("llama3_8b", "shapes", N_LAYERS, True),
                                      ("qwen2_5_0_5b", "qwen_shapes", QWEN_LAYERS, False)):
        for rows, mult, k5_key, k2_key in ((8, _per_token(layers, head), key, key + "_b8"),
                                           (64, _per_token(layers, False), key + "_b64", key)):
            k5, k2 = kres["qmm_decode"][k5_key], kres["qmm"][k2_key]
            tot = {name: sum(mult[s] * shapes[s][f] for s in mult)
                   for name, shapes, f in (("k5_ms", k5, "ms"), ("k2_ms", k2, "ms"),
                                           ("library_ms", k5, "library_ms"),
                                           ("k2_library_ms", k2, "library_ms"),
                                           ("bound_ms", k5, "bound_ms"))}
            out[f"{model}_b{rows}"] = tot
            log(f"  {model} {rows} rows ({sum(mult.values())} launches): K5 {tot['k5_ms']:.3f} ms, "
                f"K2 {tot['k2_ms']:.3f}, library {tot['library_ms']:.3f} / "
                f"{tot['k2_library_ms']:.3f}, bound {tot['bound_ms']:.3f}")
    return out


def k4_int8_vs_float(kres: dict) -> dict:
    """K4's int8 dots beside its bf16 dots, per call at the four shapes both
    are timed at in this run, with the int8 dots' library time and bound."""
    out = {}
    for shape in ("decode_1000", "decode_8000", "serve_4", "decode_floor"):
        i8, fl = kres["flash_decode_int8"]["shapes"][shape], kres["flash_decode"]["shapes"][shape]
        out[shape] = {"int8_ms": i8["ms"], "bf16_ms": fl["ms"],
                      "int8_over_bf16": i8["ms"] / fl["ms"],
                      "library_ms": i8["library_ms"], "bound_ms": i8["bound_ms"]}
        log(f"  K4 {shape}: int8 dots {i8['ms']:.4f} ms, bf16 dots {fl['ms']:.4f} "
            f"({i8['ms'] / fl['ms']:.2f}x), library {i8['library_ms']:.4f}, "
            f"bound {i8['bound_ms']:.5f}")
    return out


def qwen_totals(kres: dict) -> dict:
    """K1-K5 summed over one unit of Qwen2.5-0.5B's path (24 layers, no
    quantized lm_head): per decode token, per 64-row chunk, per 1000-token
    chunk, per decode step after 1000 tokens, per 8-row batched step."""
    m = _per_token(QWEN_LAYERS, False)
    units = {"qgemv": (kres["qgemv"]["qwen_shapes"], m),
             "qmm": (kres["qmm"]["qwen_shapes"], m),
             "qmm_decode": (kres["qmm_decode"]["qwen_shapes"], m),
             # the chat path's K3 is mode 2 (an f32 query over the bf16 cache)
             "flash_attention": (kres["flash_attention"]["shapes"],
                                 {"prefill_1000_qwen_f32q": QWEN_LAYERS}),
             "flash_decode": (kres["flash_decode"]["shapes"],
                              {"decode_1000_qwen": QWEN_LAYERS})}
    return {name: {f: sum(mult[s] * shapes[s][f] for s in mult)
                   for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for name, (shapes, mult) in units.items()}


# The phases after build and kernels (which always run), in the order `main`
# runs them; `--phases a,b,...` runs the named ones in this order
PHASES = ("llama3_8b", "graph_decode", "fused_decode", "bench", "serve", "two_layer", "int8_engine",
          "f32_engine", "switches", "pipeline", "qwen2", "deepseek_v2_lite", "internvl",
          "qwen3_30b_a3b", "mistral_7b", "glm4_9b", "phi3_5_mini", "phi2", "gpt_oss_20b",
          "gemma3_12b",
          "gemma2_9b", "families",
          "cli", "e2", "e1", "e3", "e4", "e5", "e6", "e7")
LLAMA_PHASES = PHASES[:PHASES.index("qwen2")]       # the phases on Llama-3-8B's params
# The phases of the run without arguments: all but fused_decode, an opt-in
# transform's check that runs only when named
DEFAULT_PHASES = tuple(n for n in PHASES if n != "fused_decode")


def parse_phases(argv) -> tuple:
    """The phases `argv` selects: DEFAULT_PHASES with no argument, else those
    of `--phases a,b,...` (build and kernels run anyway and may be named;
    fused_decode brings graph_decode, whose run it is held against)."""
    if not argv:
        return DEFAULT_PHASES
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: python3 chip_smoke.py [--phases name,name,...]")
    names = [n for n in argv[1].split(",") if n and n not in ("build", "kernels")]
    bad = [n for n in names if n not in PHASES]
    if bad:
        raise SystemExit(f"unknown phases {bad}; the phases are build, kernels, "
                         f"{', '.join(PHASES)}")
    if "fused_decode" in names:
        names.append("graph_decode")
    return tuple(n for n in PHASES if n in names)


def last_line(selected, device: dict) -> dict:
    """The object printed last after the `selected` phases passed: the
    contract's `{"ok": true, ...}` only when every phase of the run without
    arguments ran; else the phases that passed, and no "ok", so that a part
    of the smoke is not read as the whole."""
    if set(DEFAULT_PHASES) <= set(selected):
        return {"ok": True, "device": device}
    return {"phases_passed": ["build", "kernels", *selected], "device": device}


def _at(tree, *path):
    """tree[path[0]][path[1]]..., or None where a phase did not run."""
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _total(*counts):
    """The sum of the counts that were taken (None when none was)."""
    taken = [c for c in counts if c is not None]
    return sum(taken) if taken else None


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    selected = parse_phases(list(argv))
    from chatllm_tpu_torch.ops.cuda.build import build_all

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "phases": list(selected)}
    t_start = time.perf_counter()

    log("== build")
    t0 = time.perf_counter()
    logs = build_all()
    report["build_s"] = time.perf_counter() - t0
    for name, text in logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  {name}: {ln.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    report["card"] = smi
    log(f"  built in {report['build_s']:.1f} s on {smi} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda})")

    log("== kernels")
    timer = Timer(dev)
    report["kernels"] = kernels_phase(dev, timer, fused="fused_decode" in selected)
    report["qwen_kernel_totals"] = qwen_totals(report["kernels"])
    log(f"  Qwen2.5-0.5B totals per unit of its path: {report['qwen_kernel_totals']}")
    report["glm_kernel_totals"] = glm_totals(report["kernels"])
    log(f"  GLM-4-9B totals per unit of its path: {report['glm_kernel_totals']}")
    report["phi_kernel_totals"] = phi_totals(report["kernels"])
    log(f"  Phi-3.5-mini and Phi-2 totals per unit of their paths: "
        f"{report['phi_kernel_totals']}")
    report["go_kernel_totals"] = go_totals(report["kernels"])
    report["k5_vs_k2"] = k5_vs_k2(report["kernels"])
    report["k4_int8_vs_float"] = k4_int8_vs_float(report["kernels"])
    del timer
    torch.cuda.empty_cache()

    def on(name):
        return name in selected

    if any(on(n) for n in LLAMA_PHASES):
        from chatllm_tpu_torch.models.synthetic import build_synthetic_params, llama3_8b_config

        log("== llama3_8b_params")
        cfg = llama3_8b_config(max_length=8192)
        t0 = time.perf_counter()
        params = build_synthetic_params(cfg, "q4k", zeros=False, seed=0, device=dev)
        torch.cuda.synchronize()
        log(f"  built {cfg.num_hidden_layers}-layer synthetic Llama-3-8B q4_k params in "
            f"{time.perf_counter() - t0:.1f} s")

        if on("llama3_8b"):
            log("== llama3_8b")
            report["llama3_8b"] = chat_phase(dev, cfg, params)
            torch.cuda.empty_cache()

        if on("graph_decode"):
            log("== graph_decode")
            gd = report["graph_decode"] = graph_decode_phase(dev, cfg, params, "llama3_8b")
            gd["kernel_shares"] = kernel_shares(report["kernels"], dict(gd), "shapes",
                                                N_LAYERS, True, "decode_1000")
            log(f"  kernel shares of a replayed step: {gd['kernel_shares']}")
            torch.cuda.empty_cache()

        if on("fused_decode"):
            log("== fused_decode")
            gd = report["graph_decode"]
            gd["fused"] = fused_decode_phase(dev, cfg, params, gd)
            kq = report["kernels"]["qgemv"]
            sh, fs = kq["shapes"], kq["fused_shapes"]
            gd["fused"]["k1_ms_per_token"] = {
                "unfused": sum(n * sh[k]["ms"] for k, n in _per_token(N_LAYERS, True).items()),
                "fused": N_LAYERS * (fs["qkv"]["ms"] + fs["gate_up"]["ms"] + sh["q_o"]["ms"]
                                     + sh["down"]["ms"]) + sh["lm_head"]["ms"]}
            log(f"  K1 per decode token from the kernel table: {gd['fused']['k1_ms_per_token']}")
            torch.cuda.empty_cache()

        if on("bench"):
            log("== bench")
            report["bench"] = bench_phase(dev, *_depth_cut(cfg, params, BENCH_DEPTH))
            torch.cuda.empty_cache()
        for name, phase in (("serve", serve_phase), ("two_layer", two_layer_phase),
                            ("int8_engine", int8_engine_phase),
                            ("f32_engine", f32_engine_phase), ("switches", switch_phase)):
            if on(name):
                log(f"== {name}")
                report[name] = phase(dev, cfg, params)
                torch.cuda.empty_cache()

        if on("pipeline"):
            log("== pipeline")
            report["pipeline"] = pipeline_phase(dev, *_depth_cut(cfg, params, PIPE_DEPTH), smi)
        del params
        gc.collect()              # the server's objects held the params in cycles
        torch.cuda.empty_cache()

    if on("qwen2"):
        log("== qwen2")
        report["qwen2"] = qwen2_phase(dev)
        report["qwen2"]["graph_decode"]["kernel_shares"] = kernel_shares(
            report["kernels"], report["qwen2"]["graph_decode"], "qwen_shapes", QWEN_DEPTH,
            False, "decode_1000_qwen")
        log(f"  Qwen2.5-0.5B kernel shares of a replayed step: "
            f"{report['qwen2']['graph_decode']['kernel_shares']}")
        torch.cuda.empty_cache()

    # Mistral's cut's CPU side runs beside the deepseek_v2_lite, internvl and
    # qwen3_30b_a3b phases
    mistral = mistral_setup(dev) if on("mistral_7b") else None
    if on("deepseek_v2_lite"):
        log("== deepseek_v2_lite")
        t0 = time.perf_counter()
        report["deepseek_v2_lite"] = deepseek_phase(dev)
        report["deepseek_v2_lite"]["seconds"] = time.perf_counter() - t0
        log(f"  deepseek_v2_lite phase: {report['deepseek_v2_lite']['seconds']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

    if on("internvl"):
        log("== internvl")
        report["internvl"] = internvl_phase(dev)
        report["internvl"]["kernel_totals"] = ivl_totals(report["kernels"])
        log(f"  InternVL3.5-8B totals per unit of its path: "
            f"{report['internvl']['kernel_totals']}")
        gc.collect()
        torch.cuda.empty_cache()

    if on("qwen3_30b_a3b"):
        log("== qwen3_30b_a3b")
        report["qwen3_30b_a3b"] = qwen3_a3b_phase(dev)
        report["qwen3_30b_a3b"]["kernel_totals"] = a3b_totals(report["kernels"])
        log(f"  Qwen3-30B-A3B totals per unit of its path: "
            f"{report['qwen3_30b_a3b']['kernel_totals']}")
        gc.collect()
        torch.cuda.empty_cache()

    if on("mistral_7b"):
        log("== mistral_7b")
        report["mistral_7b"] = mistral_phase(dev, mistral)
        del mistral
        gc.collect()
        torch.cuda.empty_cache()

    if on("glm4_9b"):
        log("== glm4_9b")
        report["glm4_9b"] = glm4_phase(dev)
        report["glm4_9b"]["kernel_totals"] = report["glm_kernel_totals"]
        gc.collect()
        torch.cuda.empty_cache()

    for name, key in (("phi3_5_mini", "phi35"), ("phi2", "phi2")):
        if on(name):
            log(f"== {name}")
            report[name] = phi_phase(dev, name)
            report[name]["kernel_totals"] = report["phi_kernel_totals"][key]
            gc.collect()
            torch.cuda.empty_cache()

    if on("gpt_oss_20b"):
        log("== gpt_oss_20b")
        report["gpt_oss_20b"] = gpt_oss_phase(dev)
        report["gpt_oss_20b"]["kernel_totals"] = report["go_kernel_totals"]
        log(f"  GPT-OSS-20B totals per unit of its path: {report['go_kernel_totals']}")
        gc.collect()
        torch.cuda.empty_cache()

    # the Gemma cuts' CPU sides, Gemma-3's first, run beside the gemma3_12b
    # phase, and the uncaptured Gemma-3 reference's process beside the phases
    # after it
    gemma3 = gemma3_setup(dev) if on("gemma3_12b") else None
    gemma2 = gemma2_setup(dev) if on("gemma2_9b") else None
    g3_uncaptured = None
    if on("gemma3_12b"):
        log("== gemma3_12b")
        report["gemma3_12b"] = gemma3_phase(dev, gemma3)
        del gemma3
        g3_uncaptured = gemma3_uncaptured_start()
        report["gemma3_12b"]["kernel_totals"] = g3_totals(report["kernels"])
        log(f"  Gemma-3-12B totals per unit of its path: "
            f"{report['gemma3_12b']['kernel_totals']}")
        gc.collect()
        torch.cuda.empty_cache()

    if on("gemma2_9b"):
        log("== gemma2_9b")
        report["gemma2_9b"] = gemma2_phase(dev, gemma2)
        del gemma2
        gc.collect()
        torch.cuda.empty_cache()

    # the cli phase's processes run beside the families phase's
    cli = cli_start() if on("cli") else None
    if on("families"):
        log("== families")
        report["families"] = families_phase(dev)
        gc.collect()
        torch.cuda.empty_cache()

    if on("cli"):
        log("== cli")
        report["cli"] = cli_phase(cli)

    if g3_uncaptured is not None:
        log("== gemma3_uncaptured")
        report["gemma3_12b"]["uncaptured"] = gemma3_uncaptured_check(g3_uncaptured,
                                                                    report["gemma3_12b"])
        torch.cuda.empty_cache()

    for name, phase in (("e2", e2_phase), ("e1", e1_phase), ("e3", e3_phase),
                        ("e4", e4_phase), ("e5", e5_phase), ("e6", lambda: e6_phase(dev)),
                        ("e7", e7_phase)):
        if on(name):
            log(f"== {name}")
            report[name] = phase()
            torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t_start
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter()]
    report["phase_s"] = {name: end - t for (name, t), end in zip(PHASE_STARTS, ends)}
    report["cut_jobs"] = CUT_JOBS
    log(f"  seconds by phase: {report['phase_s']}")
    log(f"  the cuts' CPU sides on CUT_WORKER (queued, began, ended; s into the run): "
        f"{CUT_JOBS}")
    log(f"== all {len(selected) + 2} phases passed in {report['seconds']:.0f} s")

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    # each kernel's launches on its own path (None where that phase did not run)
    ll = report.get("llama3_8b", {})
    launches = dict(ll.get("launches", {}),
                    flash_attention=_at(ll, "flash_modes", 0),
                    flash_attention_f32=_at(report, "f32_engine", "f32_cache", "flash_modes", 1),
                    flash_attention_f32q=_at(ll, "flash_modes", 2),
                    flash_decode=_at(ll, "q8_prompt_1000", "launches", "flash_decode"),
                    flash_decode_mla=_at(report, "deepseek_v2_lite", "chat", "int8_graph",
                                         "launches", "flash_decode"),
                    flash_decode_sinks=_at(report, "gpt_oss_20b", "chat", "int8", "graph",
                                           "launches", "flash_decode"),
                    qmm_decode=_at(report, "bench", "v2", "launches", "qmm_decode"),
                    bw_probe=_at(report, "bench", "launches", "bw_probe"),
                    gemv_stream=_total(_at(report, "e2", "launches", "gemv_stream"),
                                       _at(report, "e1", "launches", "gemv_stream")),
                    gemv_vpu=_total(_at(report, "e2", "launches", "gemv_vpu"),
                                    _at(report, "e1", "launches", "gemv_vpu")),
                    stream_read=_at(report, "e3", "launches", "stream_read"),
                    qgemv_bf16=_at(report, "e3", "launches", "qgemv_bf16"),
                    unpack_gemv=_at(report, "e4", "launches", "unpack_gemv"),
                    qmm_dma=_at(report, "e5", "launches", "qmm_dma"),
                    flash_decode_int8=_at(report, "int8_engine", "launches",
                                          "flash_decode_int8"),
                    flash_decode_e7=_at(report, "e7", "launches", "flash_decode"),
                    qmm_unpack=_at(report, "e6", "launches", "qmm_unpack"),
                    qmm_unpack_diag=_at(report, "e6", "launches", "qmm_unpack_diag"))
    print(json.dumps(kernels_line(report["kernels"], launches)))
    print(smi)
    print(json.dumps(last_line(selected, {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()})))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--gemma3-uncaptured"]:
            sys.exit(gemma3_uncaptured_main(sys.argv[2]))
        sys.exit(main(sys.argv[1:]))
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
