"""The port stands alone: no module of ``repro_torch``, no port example and
nothing that ``chip_smoke.py`` imports brings in JAX or the JAX package, and entry
points never fall back to the CPU quietly when CUDA is absent."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = (sorted(PORT.rglob("*.py")) + sorted((ROOT / "examples").glob("torch_*.py"))
              + [ROOT / "chip_smoke.py"])


def _modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'jaxlib', 'ml_dtypes', 'repro')\n"
        "             or n.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "print(json.dumps(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_nor_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "ml_dtypes", "repro"), (path, name)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_calls_no_library_attention_nor_compile(path):
    text = path.read_text()
    assert "torch.compile" not in text
    uses = text.count("scaled_dot_product_attention")
    if path.name == "chip_smoke.py":  # the yardstick timing only
        assert uses == 1
    else:
        assert uses == 0


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--arch", "h2o-danube-1.8b", "--smoke", "--gen", "2"])


def test_trainer_raises_without_cuda_unless_asked_for_cpu(monkeypatch):
    from repro_torch.launch import steps, train
    from repro_torch.configs import get_smoke_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "bert-large", "--smoke", "--steps", "1", "--batch", "2",
                    "--seq", "8", "--data-parallel", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steps.make_train_step(get_smoke_config("bert-large"), comm="ring", dp=2)
    out = train.main(["--arch", "bert-large", "--smoke", "--steps", "1", "--batch", "2",
                      "--seq", "8", "--data-parallel", "2", "--device", "cpu"])
    assert out["device"] == "cpu" and out["steps"] == 1


def test_int8_kernels_on_cuda_tensors_never_fall_back(monkeypatch, tmp_path):
    """A tensor on the card goes to the kernel: where the kernel cannot be
    built the wrapper raises, and nothing falls back to the plain version."""
    from repro_torch.kernels import build, ops

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)  # nothing built there
    monkeypatch.setattr(ops, "_device_of", lambda *ts: "cuda")  # as if on the card
    monkeypatch.delitem(build._LOADED, "grad_compress", raising=False)
    ops._quant_lib.cache_clear()
    launches = dict(ops.LAUNCHES)
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ops.quantize_int8(torch.ones(300))
        q = torch.zeros(256, dtype=torch.int8)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ops.dequantize_int8(q, torch.ones(1), 256)
    finally:
        ops._quant_lib.cache_clear()
    assert ops.LAUNCHES == launches
