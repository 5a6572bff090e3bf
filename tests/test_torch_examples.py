"""The port's example twins against the JAX package's examples.

  * ``examples/torch_serve_decode.py`` serves danube, deepseek-v2-lite and
    zamba2 at their smoke configs through ``launch.serve``, whose
    ``generate`` (the loop the example serves with) in fp32, on the port's
    params (seed 0) carried to JAX and the same numpy prompt, gives the
    greedy tokens of JAX's prompt replay and decode loop, token for token;
  * ``examples/torch_quickstart.py`` and ``examples/torch_train_bert_lumorph.py``
    against ``examples/quickstart.py`` and ``examples/train_bert_lumorph.py``,
    run in one JAX subprocess on 8 fake devices: the rack, schedule, price
    and recovery lines print the same text; every training run starts from
    the port's seed-0 params (carried to JAX) in fp32, and its first and
    final losses agree within 2e-5 relative; the restart resumes at the
    checkpoint's step.
  * ``examples/torch_simulate_rack.py``, ``torch_morph_rack.py`` and
    ``torch_multi_tenant_rack.py`` (host code) against their JAX examples,
    both run in this process: they print the same text, but for the
    temporary path ``simulate_rack`` saves its trace to, which is masked.

No test draws at random: prompts come from a seeded numpy generator.
"""

import contextlib
import importlib.util
import io
import json
import os
import pickle
import re
import runpy
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SERVE_ARCHS = ("h2o-danube-1.8b", "deepseek-v2-lite-16b", "zamba2-1.2b")
LOSS_RTOL = 2e-5  # fp32, the same carried-over state and batches


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fp32_smoke(arch):
    return get_smoke_config(arch).replace(compute_dtype="float32")


JAX_EXAMPLES = r"""
import contextlib, io, json, os, pickle, runpy, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch import steps, train

with open({params!r}, "rb") as f:
    port_params = pickle.load(f)
_init = steps.init_sharded_state
def init_from_port(cfg, policy, rng, init_ef=False):  # the port's seed-0 params
    params, opt = _init(cfg, policy, rng, init_ef)
    params = jax.tree.map(lambda p, a: jax.device_put(jnp.asarray(a, p.dtype), p.sharding),
                          params, port_params)
    return params, opt
steps.init_sharded_state = init_from_port
train.get_smoke_config = lambda arch: get_smoke_config(arch).replace(compute_dtype="float32")
runs = []
_main = train.main
def recorded(argv=None):
    runs.append(_main(argv))
    return runs[-1]
train.main = recorded
out = {{}}
for name in ("quickstart", "train_bert_lumorph"):
    runs.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join({examples!r}, name + ".py"), run_name="__main__")
    out[name] = {{"runs": list(runs), "stdout": buf.getvalue()}}
with open({path!r}, "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_examples(tmp_path_factory):
    """Starts the JAX examples with the module's first test, from the port's
    seed-0 bert-large params, so that they overlap the serving tests."""
    tmp = tmp_path_factory.mktemp("examples")
    params = ttf.init_params(torch.Generator(device="cpu").manual_seed(0),
                             _fp32_smoke("bert-large"))
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(tree_map(lambda t: t.numpy(), params), f)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    code = JAX_EXAMPLES.format(src=str(ROOT / "src"), params=str(tmp / "params.pkl"),
                               examples=str(ROOT / "examples"), path=str(tmp / "jax.json"))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=tmp)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_examples(_jax_examples):
    proc, tmp = _jax_examples
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return json.loads((tmp / "jax.json").read_text())


@pytest.fixture
def one_thread():
    """The smoke models' ops are tiny: one intra-op thread keeps them from
    contending with the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serve_decode_example_serves_three_cache_families(capsys, one_thread):
    out = _example("torch_serve_decode").main(["--device", "cpu"])
    assert list(out) == list(SERVE_ARCHS)
    for arch, res in out.items():
        assert res["finite"] and res["generated_shape"] == [4, 16], arch
        assert res["device"] == "cpu" and res["ttft_s"] > 0 and res["tpot_s"] > 0
    assert capsys.readouterr().out.count('"generated_shape": [4, 16]') == 3


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_decode_gives_jax_greedy_tokens(arch, one_thread):
    b, s, gen = 2, 6, 8
    tcfg, jcfg = _fp32_smoke(arch), jax_smoke_config(arch).replace(compute_dtype="float32")
    tparams = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size, (b, s)).astype(np.int64)
    toks = serve.generate(tparams, torch.from_numpy(prompt), tcfg, gen,
                          torch.device("cpu")).tokens
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    caches = jtf.init_caches(jcfg, b, s + gen)
    for t in range(s):
        logits, caches = jtf.decode_step(params, caches, jnp.asarray(prompt[:, t:t + 1],
                                                                     jnp.int32),
                                         jnp.int32(t), jcfg)
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    ref = [cur]
    for i in range(gen - 1):
        logits, caches = jtf.decode_step(params, caches, cur, jnp.int32(s + i), jcfg)
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        ref.append(cur)
    assert toks.shape == (b, gen)
    assert np.asarray(jnp.concatenate(ref, axis=1)).tolist() == toks.tolist()


# ---------------------------------------------------------------------------
# the training twins
# ---------------------------------------------------------------------------

def _close(a: float, b: float) -> bool:
    return abs(a - b) <= LOSS_RTOL * abs(b)


def _fp32_train(monkeypatch):
    monkeypatch.setattr(ttrain, "get_smoke_config", _fp32_smoke)


def test_quickstart_twin_matches_jax(jax_examples, monkeypatch, capsys, one_thread):
    _fp32_train(monkeypatch)
    out = _example("torch_quickstart").main(["--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    jax_lines = jax_examples["quickstart"]["stdout"].splitlines()
    assert printed[:4] == jax_lines[:4]  # tenants, the schedule, its price
    assert out["exact"] == {"ring": True, "lumorph2": True, "lumorph4": True}
    assert [ln.endswith("== psum: True") for ln in jax_lines[4:7]] == [True] * 3
    (jrun,) = jax_examples["quickstart"]["runs"]
    run = out["train"]
    assert run["steps"] == jrun["steps"] == 10 and run["comm"] == "lumorph4"
    for key in ("first_loss", "final_loss"):
        assert _close(run[key], jrun[key]), (key, run[key], jrun[key])


def test_train_bert_lumorph_twin_matches_jax(jax_examples, monkeypatch, capsys, tmp_path,
                                             one_thread):
    _fp32_train(monkeypatch)
    out = _example("torch_train_bert_lumorph").main(["--device", "cpu",
                                                     "--ckpt-dir", str(tmp_path / "ckpt")])
    printed = capsys.readouterr().out
    jax_out = jax_examples["train_bert_lumorph"]
    j1, j3 = jax_out["runs"]
    assert out["phase1"]["steps"] == j1["steps"] == 20
    assert out["phase3"]["steps"] == j3["steps"] == 10  # resumed at the step-20 checkpoint
    assert "[train] restored checkpoint at step 20" in printed
    for mine, ref in ((out["phase1"], j1), (out["phase3"], j3)):
        for key in ("first_loss", "final_loss"):
            assert np.isfinite(mine[key])
            assert _close(mine[key], ref[key]), (key, mine[key], ref[key])
    recovery = [ln for ln in printed.splitlines()
                if ln.startswith(("slice before", "recovery"))]
    jax_recovery = [ln for ln in jax_out["stdout"].splitlines()
                    if ln.startswith(("slice before", "recovery"))]
    assert len(recovery) == 3 and recovery == jax_recovery
    assert out["phase2"]["dp"] == 8 and out["phase2"]["reason"] == "full"


# ---------------------------------------------------------------------------
# the rack simulator twins
# ---------------------------------------------------------------------------

def _printed(path: Path) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(path), run_name="__main__")
    return re.sub(r"saved to \S+\)", "saved to <path>)", buf.getvalue())


@pytest.mark.parametrize("name", ["simulate_rack", "morph_rack", "multi_tenant_rack"])
def test_rack_twin_prints_what_jax_prints(name, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # simulate_rack's trace file
    port = _printed(ROOT / "examples" / f"torch_{name}.py")
    assert port == _printed(ROOT / "examples" / f"{name}.py")
    assert len(port.splitlines()) >= 10
    if name == "multi_tenant_rack":
        assert "exact=True" in port
