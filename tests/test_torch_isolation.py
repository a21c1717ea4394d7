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

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "chatllm_tpu", "experiments")
NEW_MODULES = ("bench", "experiments", "experiments.gemv_probe2", "models.qwen",
               "ops.cuda.bw_probe", "ops.cuda.qmm_decode", "experiments.gemv_probe",
               "experiments.gemv_model_bench", "experiments.gemv_unpack",
               "experiments.qmm_m32", "experiments.timing",
               "experiments.qmm_unpack_variants", "experiments.bhsd_decode")


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
