"""CLI entry point (flag subset of the JAX package's `main.py`, same
spellings and the same transcript format).

    python -m chatllm_tpu_torch.main -m model.bin -p "hi"      # one-shot
    python -m chatllm_tpu_torch.main -m model.bin -i           # interactive

Runs on the card; `--device cpu` runs on the CPU instead.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass


@dataclass
class Args:
    model_path: str = ""
    prompt: str = "你好"
    interactive: bool = False
    temp: float = 0.7
    max_new_tokens: int = -1
    max_length: int = -1
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    mla_cache: str = "speed"
    device: str = "cuda"


_DTYPES = {"f16": "bfloat16", "bf16": "bfloat16", "f32": "float32"}
_CACHE_DTYPES = {**_DTYPES, "q8_0": "int8"}     # q8_0: int8 K/V + f32 scales


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
        elif arg in ("-i", "--interactive"):
            a.interactive = True
        elif arg in ("-t", "--temp"):
            a.temp = float(nxt())
        elif arg == "--max_new_tokens":
            a.max_new_tokens = int(nxt())
        elif arg in ("-l", "--max_length"):
            a.max_length = int(nxt())
        elif arg == "--compute_dtype":
            v = nxt()
            a.compute_dtype = _DTYPES.get(v, v)
        elif arg == "--cache_dtype":
            v = nxt()
            a.cache_dtype = _CACHE_DTYPES.get(v, v)
        elif arg == "--mla_cache":
            a.mla_cache = nxt()    # speed | memory (latent MLA cache)
        elif arg == "--device":
            a.device = nxt()
        else:
            print(f"warning: unknown option {arg}", file=sys.stderr)
        i += 1
    return a


def usage() -> str:
    return (
        "usage: chatllm_tpu_torch [-m MODEL] [-i] [-p PROMPT] [options]\n"
        "Options: -m/--model, -p/--prompt, -i/--interactive, -t/--temp,\n"
        "--max_new_tokens, -l/--max_length, --compute_dtype bf16|f32,\n"
        "--cache_dtype bf16|f32|q8_0, --mla_cache speed|memory, --device cuda|cpu\n"
    )


def build_gen_config(a: Args):
    from .runtime.generate import GenerationConfig

    # `-t 0` selects greedy (reference src/main.cpp --temp handling)
    sampling = "greedy" if a.temp <= 0 else "top_p"
    return GenerationConfig(max_length=a.max_length, max_new_tokens=a.max_new_tokens,
                            max_context_length=512, do_sample=sampling != "greedy",
                            temperature=a.temp, sampling=sampling)


def main(argv=None) -> int:
    a = parse_args(list(argv if argv is not None else sys.argv[1:]))
    if not a.model_path:
        print(usage())
        return 1

    from .models import RuntimeConfig, load_model
    from .runtime.pipeline import Pipeline
    from .runtime.streamer import TextStreamer

    rt = RuntimeConfig(cache_dtype=a.cache_dtype, compute_dtype=a.compute_dtype,
                       max_length=a.max_length, mla_cache=a.mla_cache)
    model = load_model(a.model_path, rt, device=a.device)
    pipe = Pipeline(model)
    pipe.gen_config = build_gen_config(a)
    streamer = TextStreamer(model.tokenizer)

    if a.interactive:
        while True:
            try:
                line = input("You  > ")
            except (EOFError, KeyboardInterrupt):
                break
            if not line.strip():
                continue
            print("A.I. > ", end="", flush=True)
            pipe.chat(line, streamer)
            print()
        print()
    else:
        print(f"You  > {a.prompt}")
        print("A.I. > ", end="", flush=True)
        pipe.chat(a.prompt, streamer)
        print()
    print(pipe.show_statistics())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
