"""CLI entry point (counterpart of the JAX package's `main.py`: the same
flags, spellings, `Args` fields and defaults, and the same transcripts).

    python -m chatllm_tpu_torch.main -m model.bin -p "hi"      # one-shot
    python -m chatllm_tpu_torch.main -m model.bin -i           # interactive
    python -m chatllm_tpu_torch.main -m model.bin --test turns.txt --extending shift

Runs on the card; `--device cpu` runs on the CPU instead.  A flag whose
module the port does not have yet (RAG, beam search, TTS, the logit lens,
multi-host, the HLO dump, model downloads) exits with a message that names
the module (UNPORTED); so does a `{{video:...}}` or `{{audio:...}}` tag of
`--multimedia_file_tags` (the port's models take images only).
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field


@dataclass
class Args:
    model_path: str = ""
    system: str | None = None
    prompt: str = "你好"
    ai_prefix: str = ""
    reversed_role: bool = False
    sampling: str = "top_p"
    extending: str = "restart"
    test_fn: str = ""
    load_session: str = ""
    save_session: str = ""
    cache_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    weight_dtype: str = "auto"
    re_quantize: str = ""
    mla_cache: str = "speed"
    max_length: int = -1
    max_context_length: int = 512
    interactive: bool = False
    show: bool = False
    show_devices: bool = False
    show_kernel_dispatch: bool = False
    top_k: int = 20
    top_p: float = 0.7
    temp: float = 0.7
    tfs_z: float = 0.95
    presence_penalty: float = 0.0
    repeat_penalty: float = 1.0
    frequency_penalty: float = 0.0
    penalty_window: int = 256
    seed: int = -1
    multi_line: bool = False
    batch_size: int = 4096
    max_new_tokens: int = -1
    detect_thoughts: bool = False
    single_turn: bool = False
    show_banner: bool = True
    log_level: int = 4
    beam_size: int = -1
    tokenize: bool = False
    format: str = "chat"
    profile_dir: str = ""      # torch.profiler trace output dir
    additional: dict = field(default_factory=dict)
    opt_speed: bool = True
    layer_spec: str = ""
    dump_tensors: set = field(default_factory=set)
    # RAG (chatllm.cpp src/main.cpp:40-58)
    embedding_model_path: str = ""
    reranker_model_path: str = ""
    vector_stores: dict = field(default_factory=dict)  # name -> [files]
    cur_vs_name: str = "default"
    init_vs: str = ""
    merge_vs: str = ""
    distance_strategy: str = "max_inner_product"
    retrieve_top_n: int = 2
    rerank_top_n: int = 1
    rerank_score_thres: float = 0.35
    rag_template: str = ""
    rag_context_sep: str = ""
    retrieve_rewrite_template: str = ""
    rag_post_extending: int = 0
    emb_rank_query_sep: str = ""
    hide_reference: bool = False
    rag_dump: bool = False
    thought_tags: tuple = ()
    multimedia_file_tags: tuple = ()
    tts_export: str = ""
    lens_layers: str = ""
    lens_fn: str = ""
    max_proj_length: int = -1
    dump_dot: str = ""
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = 0
    serve_rpc: bool = False    # --rpc_endpoints / --serve_rpc were given
    device: str = "cuda"       # the port's own: cuda | cpu


_DTYPES = {"f16": "bfloat16", "bf16": "bfloat16", "f32": "float32"}
_CACHE_DTYPES = {**_DTYPES, "q8_0": "int8"}     # q8_0: int8 K/V + f32 scales

# (Args fields, flags, the JAX package's module that serves them, where the
# port's queue holds it): given, they exit naming the module
_RAG = ("embedding_model_path", "reranker_model_path", "vector_stores", "cur_vs_name",
        "init_vs", "merge_vs", "distance_strategy", "retrieve_top_n", "rerank_top_n",
        "rerank_score_thres", "rag_template", "rag_context_sep",
        "retrieve_rewrite_template", "rag_post_extending", "emb_rank_query_sep",
        "hide_reference", "rag_dump")
UNPORTED = (
    (_RAG, "--embedding_model, --reranker_model, --vector_store, --set_vs_name, --init_vs, "
     "--merge_vs and the other RAG options", "rag/ (RAG)", "ROADMAP.md section 1, M15"),
    (("beam_size",), "--beam_size > 1", "runtime/beam.py (beam search)",
     "ROADMAP.md section 1, M15"),
    (("tts_export",), "--tts_export", "the TTS models and codecs",
     "ROADMAP.md section 1, M17"),
    (("lens_layers", "lens_fn"), "--lens", "tools/lens.py (logit lens)",
     "ROADMAP.md section 1, M18"),
    (("dump_dot",), "--dump_dot", "the compiled-graph dump (the JAX package dumps XLA HLO)",
     "ROADMAP.md section 1, M18"),
    (("show_devices",), "--show_devices", "parallel/mesh.py", "ROADMAP.md section 1, M19"),
    (("coordinator", "num_processes", "process_id", "serve_rpc"),
     "--coordinator, --num_processes, --process_id, --rpc_endpoints, --serve_rpc",
     "parallel/distributed.py (multi-host)", "ROADMAP.md section 1, M19"),
)


def unported(a: Args) -> str | None:
    """The message for the first flag given whose module is not ported."""
    d = Args()
    for fields, flags, module, where in UNPORTED:
        if any(getattr(a, f) != getattr(d, f) and (f != "beam_size" or a.beam_size > 1)
               for f in fields):
            return (f"chatllm_tpu_torch: {flags}: the port has no {module} yet "
                    f"({where}); run the JAX package's CLI for this")
    return None


def parse_args(argv: list[str]) -> Args:
    a = Args()
    i = 0

    def nxt():
        nonlocal i
        i += 1
        if i >= len(argv):
            raise SystemExit(f"missing value for {argv[i - 1]}")
        return argv[i]

    while i < len(argv):
        arg = argv[i]
        if arg in ("-h", "--help"):
            print(usage())
            raise SystemExit(0)
        elif arg in ("-m", "--model"):
            a.model_path = nxt()
        elif arg in ("-p", "--prompt"):
            a.prompt = nxt()
        elif arg == "--prompt_file":
            a.prompt = open(nxt(), encoding="utf-8").read().rstrip("\n")
        elif arg in ("-s", "--system"):
            a.system = nxt()
        elif arg == "--sys_file":
            a.system = open(nxt(), encoding="utf-8").read().rstrip("\n")
        elif arg == "--ai_prefix":
            a.ai_prefix = nxt()
        elif arg == "--reversed_role":
            a.reversed_role = True
        elif arg == "--embedding_model":
            a.embedding_model_path = nxt()
        elif arg == "--reranker_model":
            a.reranker_model_path = nxt()
        elif arg == "--vector_store":
            a.vector_stores.setdefault(a.cur_vs_name, []).append(nxt())
        elif arg == "--set_vs_name":
            a.cur_vs_name = nxt()
        elif arg == "--rag_post_extending":
            a.rag_post_extending = int(nxt())
        elif arg == "--emb_rank_query_sep":
            a.emb_rank_query_sep = nxt()
        elif arg == "--kv":
            # the rest of argv as key/value pairs (chatllm.cpp src/main.cpp:405-412)
            while i + 2 < len(argv):
                a.additional[argv[i + 1]] = argv[i + 2]
                i += 2
        elif arg == "--init_vs":
            a.init_vs = nxt()
        elif arg == "--merge_vs":
            a.merge_vs = nxt()
        elif arg == "--distance_strategy":
            a.distance_strategy = nxt()
        elif arg == "--retrieve_top_n":
            a.retrieve_top_n = int(nxt())
        elif arg == "--rerank_top_n":
            a.rerank_top_n = int(nxt())
        elif arg == "--rerank_score_thres":
            a.rerank_score_thres = float(nxt())
        elif arg == "--rag_template":
            a.rag_template = nxt()
        elif arg == "--rag_context_sep":
            a.rag_context_sep = nxt()
        elif arg == "--retrieve_rewrite_template":
            a.retrieve_rewrite_template = nxt()
        elif arg == "--hide_reference":
            a.hide_reference = True
        elif arg == "--rag_dump":
            a.rag_dump = True
        elif arg == "--thought_tags":
            a.thought_tags = (nxt(), nxt())
        elif arg == "--multimedia_file_tags":
            a.multimedia_file_tags = (nxt(), nxt())
        elif arg == "--tts_export":
            a.tts_export = nxt()
        elif arg == "--lens":
            a.lens_layers = nxt()
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                a.lens_fn = nxt()
        elif arg == "--max_proj_length":
            a.max_proj_length = int(nxt())
        elif arg == "--dump_dot":
            a.dump_dot = nxt()
        elif arg in ("-i", "--interactive"):
            a.interactive = True
        elif arg == "--multi":
            a.multi_line = True
        elif arg == "--hide_banner":
            a.show_banner = False
        elif arg in ("-l", "--max_length"):
            a.max_length = int(nxt())
        elif arg in ("-c", "--max_context_length"):
            a.max_context_length = int(nxt())
        elif arg == "--extending":
            a.extending = nxt()
        elif arg == "--sampling":
            a.sampling = nxt()
        elif arg in ("-k", "--top_k"):
            a.top_k = int(nxt())
        elif arg in ("-q", "--top_p"):
            a.top_p = float(nxt())
        elif arg == "--tfs_z":
            a.tfs_z = float(nxt())
        elif arg in ("-t", "--temp"):
            a.temp = float(nxt())
        elif arg == "--presence_penalty":
            a.presence_penalty = float(nxt())
        elif arg == "--repeat_penalty":
            a.repeat_penalty = float(nxt())
        elif arg == "--frequency_penalty":
            a.frequency_penalty = float(nxt())
        elif arg == "--penalty_window":
            a.penalty_window = int(nxt())
        elif arg == "--seed":
            a.seed = int(nxt())
        elif arg == "--test":
            a.test_fn = nxt()
        elif arg == "--load_session":
            a.load_session = nxt()
        elif arg == "--save_session":
            a.save_session = nxt()
        elif arg == "--cache_dtype":
            v = nxt()
            a.cache_dtype = _CACHE_DTYPES.get(v, v)
        elif arg == "--compute_dtype":
            v = nxt()
            a.compute_dtype = _DTYPES.get(v, v)
        elif arg == "--weight_dtype":
            v = nxt()
            a.weight_dtype = _DTYPES.get(v, v)
        elif arg == "--re_quantize":
            a.re_quantize = nxt()
        elif arg == "--mla_cache":
            a.mla_cache = nxt()    # speed | memory (latent MLA cache)
        elif arg == "--batch_size":
            a.batch_size = int(nxt())
        elif arg == "--max_new_tokens":
            a.max_new_tokens = int(nxt())
        elif arg == "--show":
            a.show = True
        elif arg == "--show_devices":
            a.show_devices = True
        elif arg == "--show_kernel_dispatch":
            a.show_kernel_dispatch = True
        elif arg == "--detect_thoughts":
            a.detect_thoughts = True
        elif arg == "--single_turn":
            a.single_turn = True
        elif arg == "--log_level":
            a.log_level = int(nxt())
        elif arg == "--beam_size":
            a.beam_size = int(nxt())
        elif arg == "--tokenize":
            a.tokenize = True
        elif arg == "--profile":
            a.profile_dir = nxt()
        elif arg == "--format":
            a.format = nxt()
        elif arg == "--set":
            k = nxt()
            a.additional[k] = nxt()
        elif arg == "--dump_tensor":
            a.dump_tensors.add(nxt())
        elif arg.startswith("+"):
            a.additional[arg[1:]] = "1"
        elif arg == "-Os":
            # prefer memory over speed (chatllm.cpp opt_speed=false,
            # src/main.cpp:368): smaller prefill chunks
            a.opt_speed = False
        elif arg == "--layer_spec":
            a.layer_spec = nxt()
        elif arg == "--coordinator":
            a.coordinator = nxt()
        elif arg == "--num_processes":
            a.num_processes = int(nxt())
        elif arg == "--process_id":
            a.process_id = int(nxt())
        elif arg in ("--rpc_endpoints", "--serve_rpc"):
            nxt()
            a.serve_rpc = True
        elif arg in ("--threads", "-n", "--flash_attn", "-fa", "--ggml_dir",
                     "-ngl", "--n_gpu_layers", "-mgl", "--model_gpu_layers"):
            # accepted for compatibility with the reference's command lines;
            # they set nothing here
            if arg not in ("--flash_attn", "-fa"):
                nxt()
        elif arg == "--device":
            a.device = nxt()
        else:
            print(f"warning: unknown option {arg}", file=sys.stderr)
        i += 1
    return a


def usage() -> str:
    return (
        "usage: chatllm_tpu_torch [-m MODEL] [-i] [-p PROMPT] [options]\n"
        "The PyTorch/CUDA port of chatllm_tpu (chatllm.cpp capabilities).\n"
        "Options mirror the reference CLI: -m/--model, -i/--interactive,\n"
        "-p/--prompt, -s/--system, -l/--max_length, --extending restart|shift|none,\n"
        "--sampling top_p|tfs|greedy, -k/--top_k, -q/--top_p, -t/--temp, --tfs_z,\n"
        "--repeat_penalty, --frequency_penalty, --presence_penalty, --seed,\n"
        "--test FILE, --save_session/--load_session FILE, --cache_dtype bf16|f32|q8_0,\n"
        "--re_quantize TYPE, --layer_spec SPEC, --format chat|completion|qa,\n"
        "--max_new_tokens, --show, --tokenize, --set K V, +flag, --device cuda|cpu\n"
    )


def build_gen_config(a: Args):
    from .runtime.generate import GenerationConfig

    # `-t 0` also selects greedy (chatllm.cpp src/main.cpp --temp handling)
    sampling = "greedy" if a.temp <= 0 else a.sampling
    return GenerationConfig(
        max_length=a.max_length,
        max_new_tokens=a.max_new_tokens,
        max_context_length=a.max_context_length,
        do_sample=sampling != "greedy",
        top_k=a.top_k, top_p=a.top_p, temperature=a.temp, tfs_z=a.tfs_z,
        sampling=sampling,
        repeat_penalty=a.repeat_penalty,
        frequency_penalty=a.frequency_penalty,
        presence_penalty=a.presence_penalty,
        penalty_window=a.penalty_window,
        seed=a.seed if a.seed >= 0 else 0,
        batch_size=a.batch_size,
    )


BANNER = r"""    ________          __  __    __    __  ___
   / ____/ /_  ____ _/ /_/ /   / /   /  |/  /_______  __  __
  / /   / __ \/ __ `/ __/ /   / /   / /|_/ // __/ _ \/ / / /
 / /___/ / / / /_/ / /_/ /___/ /___/ /  / // /_/ /_/ / /_/ /
 \____/_/ /_/\__,_/\__/_____/_____/_/  /_(_)__/ .___/\__,_/
You are served by chatllm_tpu (TPU-native)   /_/
"""


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    if any(x.startswith(":") for x in argv):
        raise SystemExit("chatllm_tpu_torch: a :model_id argument: the port has no "
                         "tools/model_downloader.py yet (ROADMAP.md section 1, M18); "
                         "pass -m with a GGMM file")
    a = parse_args(argv)
    msg = unported(a)
    if msg:
        raise SystemExit(msg)

    if not a.model_path:
        print(usage())
        return 1

    if a.show:
        from .ggmm.reader import GGMMFile

        print(GGMMFile.open(a.model_path).describe())
        return 0

    if a.dump_tensors:
        from .ggmm.reader import GGMMFile

        gf = GGMMFile.open(a.model_path)
        for name in a.dump_tensors:
            t = gf.tensor_f32(name)
            print(f"{name}: shape={list(t.shape)}\n{t}")
        return 0

    from .models import RuntimeConfig, load_model
    from .runtime.pipeline import ExtendingMethod, Pipeline
    from .runtime.streamer import TextStreamer, ThoughtChunkInterceptor

    rt = RuntimeConfig(cache_dtype=a.cache_dtype, compute_dtype=a.compute_dtype,
                       weight_dtype=a.weight_dtype, max_length=a.max_length,
                       re_quantize=a.re_quantize, mla_cache=a.mla_cache,
                       layer_spec=a.layer_spec, additional=dict(a.additional))
    model = load_model(a.model_path, rt, device=a.device)
    pipe = Pipeline(model, extending=ExtendingMethod(a.extending))
    pipe.gen_config = build_gen_config(a)
    if not a.opt_speed:
        model.engine.prefill_chunk = 512        # -Os: memory over speed
    if a.ai_prefix:
        pipe.ai_prefix = a.ai_prefix
    if a.reversed_role:
        pipe.reversed_role = True
    if a.format == "qa":
        # QA format (chatllm.cpp src/chat.cpp:822): each round encodes only
        # the last user message
        pipe.qa_format = True
    if a.system is not None:
        model.tokenizer.sys_prompt = a.system
    for k, v in a.additional.items():
        setter = getattr(model, "set_additional_args", None)
        if setter:
            setter({k: v})

    streamer = TextStreamer(model.tokenizer)
    if a.detect_thoughts or a.thought_tags:
        tags = (a.thought_tags,) if a.thought_tags else (("<think>", "</think>"),)
        streamer.set_interceptor(ThoughtChunkInterceptor(tags=tags))

    if a.tokenize:
        print(model.tokenizer.encode(a.prompt))
        return 0

    if a.multimedia_file_tags:
        # {{image:/path}} prompt tags (chatllm.cpp main.cpp:260-262): a tagged
        # prompt goes through the model's one-shot multimodal chat
        import re

        o, c = (re.escape(t) for t in a.multimedia_file_tags)
        m = re.search(o + r"(image|video|audio):(.+?)" + c, a.prompt)
        if m is not None:
            kind, path = m.group(1), m.group(2)
            question = (a.prompt[:m.start()] + a.prompt[m.end():]).strip()
            fn = {"image": "chat_image", "video": "chat_video", "audio": "chat_audio"}[kind]
            if not hasattr(model, fn):
                raise SystemExit(
                    f"chatllm_tpu_torch: --multimedia_file_tags: model has no {fn}() (the "
                    "port has no video or audio tower yet and takes images through "
                    "InternVL only: ROADMAP.md section 1, M17)")
            print(f"You  > {a.prompt}")
            print("A.I. > ", end="", flush=True)
            getattr(model, fn)(path, question, pipe.gen_config, streamer)
            print()
            return 0

    if a.load_session:
        pipe.load_session(a.load_session)

    if a.test_fn:
        # replay harness: each line is one user turn (chatllm.cpp --test,
        # src/main.cpp:714-737)
        for line in open(a.test_fn, encoding="utf-8"):
            line = line.rstrip("\n")
            if not line:
                continue
            print(f"You  > {line}")
            print("A.I. > ", end="", flush=True)
            pipe.chat(line, streamer)
            print()
        print(pipe.show_statistics())
        return 0

    if a.interactive:
        if a.show_banner:
            print(BANNER)
        while True:
            try:
                line = input("You  > ")
            except (EOFError, KeyboardInterrupt):
                break
            if a.multi_line:
                lines = [line]
                while not lines[-1].endswith("\\."):
                    try:
                        lines.append(input("     > "))
                    except EOFError:
                        break
                lines[-1] = lines[-1].removesuffix("\\.")
                line = "\n".join(lines)
            if not line.strip():
                continue
            print("A.I. > ", end="", flush=True)
            pipe.chat(line, streamer)
            print()
            if a.single_turn:
                pipe.restart()
                pipe.history.clear()
        print()
        print(pipe.show_statistics())
    else:
        print(f"You  > {a.prompt}")
        print("A.I. > ", end="", flush=True)
        # --format completion: raw continuation, no chat template
        run = (lambda: pipe.text_completion(a.prompt, streamer)
               ) if a.format == "completion" else (
               lambda: pipe.chat(a.prompt, streamer))
        if a.profile_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if model.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                run()
            os.makedirs(a.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(a.profile_dir, "trace.json"))
        else:
            run()
        print()
        print(pipe.show_statistics())

    if a.save_session:
        pipe.save_session(a.save_session)
    if a.show_kernel_dispatch:
        # which quantized-matmul and attention call sites took the kernels
        from .ops.qmm import kernel_dispatch_stats

        print("kernel dispatch (per traced call site):")
        for k, v in sorted(kernel_dispatch_stats().items()):
            print(f"  {k:28s} {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
