"""Nothing the harness runs loads JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is not ``repro``), and the entry point prints
no result where it cannot run."""

import json
import subprocess
import sys

from smallcells import ROOT

LOAD_ALL = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import bench.harness, bench.reference, bench.data, bench.flops, bench.trace, bench.faults
import bench.run, bench.control
import bench.drivers.train, bench.drivers.prefill
from bench import harness
import json
b = harness.manifest()
for m in b["per_layer"]:
    harness.reader(m["name"])
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(extra: str = "") -> set:
    code = LOAD_ALL.format(root=str(ROOT), src=str(ROOT / "src"), extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_and_no_jax_package():
    # what a run loads: the harness, the readers, and the port's modules it drives
    mods = loaded("import repro_torch.launch.steps, repro_torch.launch.train\n"
                  "import repro_torch.launch.mesh, repro_torch.optim.adamw")
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}, mods & {"jax", "jaxlib", "flax",
                                                                   "repro"}


def test_the_reference_side_loads_no_program():
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import bench.reference, bench.data, bench.flops, bench.harness, json\n"
            "for c in bench.harness.manifest()['configs']:\n"
            "    bench.harness.model_parts(c)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_compare_whole(monkeypatch):
    from bench import harness
    monkeypatch.setitem(sys.modules, "reprox", sys)
    monkeypatch.setitem(sys.modules, "repro_torch.fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core.fake", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_no_result_without_a_card(tmp_path):
    # the sandbox has no CUDA card: exit non-zero, nothing on stdout
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "bert-large.train-b256-s128", "--seed", str(2**31 + 1),
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT)
    import torch
    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_in_a_directory_of_only_the_benchmark(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "h2o-danube-1.8b.prefill-b2-s4608", "--seed", "7", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
