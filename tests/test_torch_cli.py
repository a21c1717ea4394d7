"""The port's CLI against the JAX package's: `parse_args` gives the same value
for every `Args` field the two share and `build_gen_config` the same
GenerationConfig over a list of command lines; greedy transcripts of both
`main`s are equal on a tiny Llama-3 GGMM (f32 weights) for the chat modes,
the context-extending methods, sessions, `--re_quantize`, `--layer_spec`,
`--tokenize`, `--show` and `--dump_tensor`; every flag whose module the port
does not have exits with a message naming it.  Sampled decoding matches
only in distribution (the RNGs differ), so the sampling flags are held by
config equality here and by same-seed reruns."""
import contextlib
import dataclasses
import io
import sys

import pytest

import conftest  # noqa: F401
import torch_one_thread  # noqa: F401  (one intra-op thread: see its docstring)

import chatllm_tpu.main as jmain
import chatllm_tpu_torch.main as tmain
from test_torch_pipeline import SYS, TURNS, write

PORT_ONLY = {"device", "serve_rpc"}


@pytest.fixture(scope="module", autouse=True)
def shared_jax_engines():
    """The JAX CLI loads its model anew in every `main`.  Each load of the
    same file with the same options gets the engine of the first, so that
    its compiled prefill buckets and decode blocks serve every call of the
    module (the engine holds the same parameters' values; `-Os` sets its
    `prefill_chunk`, which every load puts back to the default)."""
    import chatllm_tpu.models as jmodels

    load, engines = jmodels.load_model, {}

    def shared(path, *args, **kw):
        model = load(path, *args, **kw)
        eng = engines.setdefault((str(path), repr(args), repr(kw)), model.engine)
        eng.__dict__.pop("prefill_chunk", None)
        model._engine = eng
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodels, "load_model", shared)
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    turns = d / "turns.txt"
    turns.write_text("\n".join(TURNS) + "\n", encoding="utf-8")
    sysf = d / "sys.txt"
    sysf.write_text(SYS + "\n", encoding="utf-8")
    return {"model": write("llama3", d / "llama3.bin"), "turns": str(turns),
            "sys": str(sysf), "dir": d}


PARSE_CASES = {
    "empty": [],
    "sampling": ["-m", "x", "-p", "hi", "-s", "sys", "-t", "0.5", "-k", "5", "-q", "0.8",
                 "--sampling", "tfs", "--tfs_z", "0.9"],
    "penalties": ["--repeat_penalty", "1.1", "--frequency_penalty", "0.2",
                  "--presence_penalty", "0.3", "--penalty_window", "64", "--seed", "7"],
    "greedy": ["-t", "0", "--seed", "-1", "--sampling", "top_p"],
    "context": ["--extending", "shift", "-l", "256", "-c", "128", "--test", "t.txt",
                "--save_session", "a", "--load_session", "b"],
    "load": ["--re_quantize", "q8_0", "--layer_spec", "0:2,1:2", "--cache_dtype", "q8_0",
             "--compute_dtype", "f32", "--weight_dtype", "bf16", "--mla_cache", "memory"],
    "modes": ["--format", "qa", "--ai_prefix", "Sure", "--reversed_role", "--detect_thoughts",
              "--thought_tags", "<a>", "</a>"],
    "interactive": ["-i", "--multi", "--single_turn", "--hide_banner", "--max_new_tokens", "9",
                    "--batch_size", "32", "-Os"],
    "tools": ["--tokenize", "--show", "--show_kernel_dispatch", "--dump_tensor", "a",
              "--dump_tensor", "b", "--profile", "d", "--log_level", "2"],
    "additional": ["--set", "k", "v", "+flag", "--kv", "a", "1", "b", "2"],
    "compat": ["--threads", "4", "-n", "2", "-fa", "-ngl", "10", "--ggml_dir", "g",
               "-mgl", "1", "--max_proj_length", "99", "--beam_size", "1"],
    "rag": ["--embedding_model", "e", "--reranker_model", "r", "--vector_store", "v1",
            "--set_vs_name", "n", "--vector_store", "v2", "--retrieve_top_n", "3",
            "--rerank_top_n", "2", "--rerank_score_thres", "0.5", "--rag_template", "t",
            "--rag_context_sep", "s", "--retrieve_rewrite_template", "w", "--hide_reference",
            "--rag_dump", "--rag_post_extending", "4", "--emb_rank_query_sep", "q",
            "--init_vs", "i", "--merge_vs", "m", "--distance_strategy", "euclidean"],
    "other_modules": ["--lens", "all", "f.bin", "--tts_export", "o.wav",
                      "--multimedia_file_tags", "{{", "}}", "--dump_dot", "g"],
    "multi_host": ["--coordinator", "h:1", "--num_processes", "2", "--process_id", "1"],
}


@pytest.mark.parametrize("name", list(PARSE_CASES))
def test_parse_args_matches_jax(name):
    argv = PARSE_CASES[name]
    j, t = jmain.parse_args(list(argv)), tmain.parse_args(list(argv))
    jf = {f.name for f in dataclasses.fields(j)}
    assert {f.name for f in dataclasses.fields(t)} - jf == PORT_ONLY
    for f in jf:
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(tmain.build_gen_config(t)) == \
        dataclasses.asdict(jmain.build_gen_config(j))


def test_prompt_and_sys_files_match_jax(files):
    argv = ["--prompt_file", files["turns"], "--sys_file", files["sys"]]
    j, t = jmain.parse_args(argv), tmain.parse_args(argv)
    assert (t.prompt, t.system) == (j.prompt, j.system) and t.system == SYS


def _run(mod, argv, stdin=""):
    buf = io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(buf):
            assert mod.main(argv) == 0
    finally:
        sys.stdin = old
    return [ln for ln in buf.getvalue().splitlines() if "eval time:" not in ln]


def transcripts(argv, stdin=""):
    """(JAX, port) transcripts, the perf lines left out."""
    return _run(jmain, argv, stdin), _run(tmain, argv + ["--device", "cpu"], stdin)


GREEDY = ["-t", "0", "--max_new_tokens", "10", "--compute_dtype", "f32"]
TRANSCRIPT_CASES = {
    "test_shift_q8": ["--test", "{turns}", "-l", "256", "--extending", "shift", "-s", SYS,
                      "--cache_dtype", "q8_0"],
    "test_restart_bf16": ["--test", "{turns}", "-l", "256", "--extending", "restart",
                          "--sys_file", "{sys}", "--cache_dtype", "bf16"],
    "test_none_f32": ["--test", "{turns}", "--extending", "none", "--cache_dtype", "f32"],
    "format_completion": ["-p", "Once upon a time", "--format", "completion"],
    "format_qa": ["--test", "{turns}", "--format", "qa", "--cache_dtype", "f32"],
    "reversed_role": ["-p", "Hello, assistant.", "--reversed_role", "--cache_dtype", "f32"],
    "ai_prefix_thoughts": ["-p", "Hello there.", "--ai_prefix", "Sure! ", "--detect_thoughts",
                           "--cache_dtype", "f32"],
    "os_and_system": ["-p", "Hi.", "-Os", "-s", SYS, "--batch_size", "16"],
    "re_quantize_q4_k": ["-p", "Hi.", "--re_quantize", "q4_k", "--cache_dtype", "f32"],
    "layer_spec": ["-p", "Hi.", "--layer_spec", "0:2,1:2", "--cache_dtype", "f32"],
    "tokenize": ["-p", "Tokenize me, please: 1 2 3", "--tokenize"],
    "show": ["--show"],
    "dump_tensor": ["--dump_tensor", "model.norm.weight"],
    "set_and_kv": ["-p", "Hi.", "--set", "k", "v", "+flag", "--cache_dtype", "f32"],
}


@pytest.mark.parametrize("name", list(TRANSCRIPT_CASES))
def test_transcript_matches_jax(files, name):
    argv = ["-m", files["model"]] + GREEDY + [
        a.format(**files) for a in TRANSCRIPT_CASES[name]]
    j, t = transcripts(argv)
    assert t == j
    assert len(t) > 0


def test_interactive_transcript_matches_jax(files):
    """-i with --multi and --single_turn, the turns read from stdin."""
    argv = ["-m", files["model"], "-i", "--multi", "--single_turn"] + GREEDY
    stdin = "first line\\\nsecond line\\.\nanother turn\\.\n"
    j, t = transcripts(argv, stdin)
    assert t == j and "chatllm_tpu" in "\n".join(t)


def test_session_transcripts_match_jax(files, tmp_path):
    """--save_session after a one-shot chat, then --load_session with one
    more prompt: the same transcripts in both packages, and each package
    continues the other's session as its own."""
    base = ["-m", files["model"], "--extending", "shift", "-l", "256", "-s", SYS,
            "--cache_dtype", "q8_0"] + GREEDY
    js, ts = str(tmp_path / "jax.session"), str(tmp_path / "port.session")
    first = ["-p", TURNS[0]]
    assert _run(jmain, base + first + ["--save_session", js]) == \
        _run(tmain, base + first + ["--save_session", ts, "--device", "cpu"])
    nxt = ["-p", TURNS[1]]
    want = _run(jmain, base + nxt + ["--load_session", js])
    for sess in (js, ts):
        assert _run(tmain, base + nxt + ["--load_session", sess, "--device", "cpu"]) == want
    assert _run(jmain, base + nxt + ["--load_session", ts]) == want


def test_test_mode_saves_no_session(files, tmp_path):
    """--test returns after its turns, before --save_session, in both
    packages."""
    for mod, extra in ((jmain, []), (tmain, ["--device", "cpu"])):
        path = tmp_path / f"{mod.__name__}.session"
        _run(mod, ["-m", files["model"], "--test", files["turns"], "--save_session", str(path),
                   "--cache_dtype", "f32"] + GREEDY + extra)
        assert not path.exists()


def test_sampled_chat_repeats_with_its_seed(files):
    argv = ["-m", files["model"], "-p", "Hello.", "-t", "0.8", "-k", "40", "-q", "0.9",
            "--seed", "7", "--repeat_penalty", "1.1", "--penalty_window", "64",
            "--max_new_tokens", "12", "--device", "cpu"]
    assert _run(tmain, argv) == _run(tmain, argv)
    tfs = argv + ["--sampling", "tfs", "--tfs_z", "0.9"]
    assert _run(tmain, tfs) == _run(tmain, tfs)


def test_profile_writes_a_trace(files, tmp_path):
    argv = ["-m", files["model"], "-p", "Hi."] + GREEDY + ["--device", "cpu"]
    plain = _run(tmain, argv)
    assert _run(tmain, argv + ["--profile", str(tmp_path / "prof")]) == plain
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


UNPORTED_CASES = {
    "embedding_model": (["--embedding_model", "e.bin"], "rag/"),
    "vector_store": (["--vector_store", "v.vsdb"], "rag/"),
    "init_vs": (["--init_vs", "plain.txt"], "rag/"),
    "merge_vs": (["--merge_vs", "out.vsdb"], "rag/"),
    "rerank_top_n": (["--rerank_top_n", "3"], "rag/"),
    "beam_size": (["--beam_size", "4"], "runtime/beam.py"),
    "tts_export": (["--tts_export", "o.wav"], "TTS"),
    "lens": (["--lens", "all"], "tools/lens.py"),
    # images are ported (tests/test_torch_internvl.py); a video tag exits
    "multimedia_file_tags": (["--multimedia_file_tags", "{{", "}}", "-p",
                              "{{video:clip.mp4}} what happens?"], "chat_video"),
    "dump_dot": (["--dump_dot", "g.txt"], "dump"),
    "show_devices": (["--show_devices"], "parallel/mesh.py"),
    "coordinator": (["--coordinator", "h:1"], "parallel/distributed.py"),
    "num_processes": (["--num_processes", "2"], "parallel/distributed.py"),
    "rpc_endpoints": (["--rpc_endpoints", "h:1"], "parallel/distributed.py"),
    "model_id": ([":llama3.1:8b"], "tools/model_downloader.py"),
}


@pytest.mark.parametrize("name", list(UNPORTED_CASES))
def test_unported_flag_exits_naming_its_module(files, name):
    argv, module = UNPORTED_CASES[name]
    with pytest.raises(SystemExit) as e:
        tmain.main(["-m", files["model"], "-p", "hi", "--device", "cpu"] + argv)
    assert module in str(e.value) and "ROADMAP.md" in str(e.value)


def test_no_model_prints_usage():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tmain.main([]) == 1
    assert buf.getvalue().startswith("usage: chatllm_tpu_torch")
