"""The PyTorch port (chatllm_tpu_torch) and chip_smoke.py stand alone: they
import neither JAX nor anything of the JAX package nor the root
`experiments/`, and the port's entry points run on the card unless the
caller asks for the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chatllm_tpu_torch
import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
# PIL too: the card's machine has none (runtime/vision.py decodes and resizes
# images with numpy and the standard library)
FORBIDDEN = ("jax", "jaxlib", "flax", "chatllm_tpu", "experiments", "PIL")
NEW_MODULES = ("bench", "experiments", "experiments.gemv_probe2", "models.qwen",
               "ops.cuda.bw_probe", "ops.cuda.qmm_decode", "experiments.gemv_probe",
               "experiments.gemv_model_bench", "experiments.gemv_unpack",
               "experiments.qmm_m32", "experiments.timing",
               "experiments.qmm_unpack_variants", "experiments.bhsd_decode",
               "nn.vit", "models.internvl", "runtime.vision", "models.llama",
               "models.deepseek", "models.synthetic", "models.mistral", "models.gemma",
               "models.misc_wave2", "models.glm", "runtime.fuse")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        chatllm_tpu_torch.__path__, "chatllm_tpu_torch."))


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax():
    mods = _port_modules()
    assert "chatllm_tpu_torch.ops.cuda.gemv_kernel" in mods
    assert [m for m in NEW_MODULES if f"chatllm_tpu_torch.{m}" not in mods] == []
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    loaded = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, f"port imports pulled in {bad}"


def test_sources_import_no_jax():
    """Function-level imports too: scan every import statement."""
    files = list((ROOT / "chatllm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    rel = {str(f.relative_to(ROOT / "chatllm_tpu_torch").with_suffix("")).replace("/", ".")
           for f in files[:-1]}
    assert [m for m in NEW_MODULES if m not in rel and m + ".__init__" not in rel] == []
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{f.name}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid here")
    import chip_smoke
    from chatllm_tpu_torch.main import main
    from chatllm_tpu_torch.models import load_model
    from chatllm_tpu_torch.models.synthetic import build_synthetic_params, tiny_config
    from chatllm_tpu_torch.runtime.generate import InferenceEngine

    path = chip_smoke.write_llama3_ggmm(tmp_path / "m.bin", layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(str(path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-m", str(path), "-p", "hi"])
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(cfg, build_synthetic_params(cfg))
    assert load_model(str(path), device="cpu").device.type == "cpu"


def test_internvl_entry_points_default_to_the_card(tmp_path):
    """An InternVL file loads on the card unless the CPU is asked for, and
    the CLI's image route resolves the card first."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid here")
    import chip_smoke
    from chatllm_tpu_torch.main import main
    from chatllm_tpu_torch.models import load_model

    path = chip_smoke.write_internvl_ggmm(tmp_path / "ivl.bin", layers=1, vis_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(str(path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-m", str(path), "--multimedia_file_tags", "{{", "}}", "-p",
              "{{image:x.png}} hi"])
    model = load_model(str(path), device="cpu")
    assert model.device.type == "cpu" and model.vis_params["embed"]["pos"].device.type == "cpu"


@pytest.mark.parametrize("family", list(chip_smoke.FAMILIES))
def test_family_entry_points_default_to_the_card(tmp_path, family):
    """Each family's GGMM, written by chip_smoke's writer (the port's), loads
    on the card unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid here")
    from chatllm_tpu_torch.models import load_model

    path = chip_smoke.write_family_ggmm(tmp_path / "m.bin", family)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(str(path))
    assert load_model(str(path), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("probe", ["qmm_unpack_variants", "bhsd_decode"])
def test_probe_entry_points_default_to_the_card(probe):
    """E6's and E7's mains resolve the card before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid here")
    import importlib

    mod = importlib.import_module(f"chatllm_tpu_torch.experiments.{probe}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


def test_server_entry_point_needs_a_card_unless_told(tmp_path):
    """`python -m chatllm_tpu_torch.serve.server` resolves the card; it
    raises without CUDA unless `--device cpu` is given."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid here")
    import chip_smoke
    from chatllm_tpu_torch.serve import server

    path = chip_smoke.write_llama3_ggmm(tmp_path / "m.bin", layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.main(["-m", str(path), "--port", "0"])
    served = []
    orig = server.serve
    try:
        server.serve = lambda model, **kw: served.append((model.device.type, kw["device"]))
        assert server.main(["-m", str(path), "--slots", "2", "--device", "cpu"]) == 0
    finally:
        server.serve = orig
    assert served == [("cpu", "cpu")]


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_phase_selector():
    """`--phases` picks phases in the script's order (build and kernels run
    anyway); no argument picks every phase but the opt-in fused_decode, which
    brings graph_decode; an unknown name stops the run before any work, as
    does the card's absence with a selection.  Only a run of every default
    phase ends with the "ok" line."""
    assert chip_smoke.parse_phases([]) == chip_smoke.DEFAULT_PHASES
    assert set(chip_smoke.PHASES) - set(chip_smoke.DEFAULT_PHASES) == {"fused_decode"}
    assert chip_smoke.parse_phases(["--phases", "families,build,glm4_9b,graph_decode"]) == (
        "graph_decode", "glm4_9b", "families")
    assert chip_smoke.parse_phases(["--phases", "fused_decode,glm4_9b"]) == (
        "graph_decode", "fused_decode", "glm4_9b")
    dev = {"platform": "gpu", "kind": "card", "count": 1}
    assert chip_smoke.last_line(chip_smoke.DEFAULT_PHASES, dev) == {"ok": True, "device": dev}
    assert chip_smoke.last_line(chip_smoke.PHASES, dev)["ok"] is True
    part = chip_smoke.last_line(("glm4_9b",), dev)
    assert "ok" not in part and part["phases_passed"] == ["build", "kernels", "glm4_9b"]
    assert set(chip_smoke.LLAMA_PHASES) >= {"llama3_8b", "graph_decode", "pipeline"}
    with pytest.raises(SystemExit, match="unknown phases"):
        chip_smoke.parse_phases(["--phases", "glm4_9b,nope"])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--phases", "glm4_9b"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
