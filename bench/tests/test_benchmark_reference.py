"""The plain reference against ``repro_torch`` at smoke sizes on the CPU, in
fp32: each configuration's forward (its model parts', found by name) and the
dense decoder's loss, and three training steps' readings through the
harness's own set-up (the port's AdamW against the reference's)."""

import pytest
import torch
from smallcells import ROOT, small_cell, small_config

from bench import data, harness, reference
from bench.drivers import train

CONFIGS = [c["name"] for c in harness.manifest()["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_and_loss_match_the_port(name):
    from repro_torch.models import transformer as tf
    cfg = small_config(name)
    parts = harness.model_parts(cfg)
    mc = harness.program_config(cfg, compute_dtype="float32")
    w = data.make_weights(cfg, 2**31 + 77, "cpu", parts.weight_shapes(cfg))
    tok = data.tokens(cfg, "zipf", 2**31 + 77, 0, 3, 40)
    logits, _ = tf.forward_logits(w, {"tokens": tok}, mc)
    assert torch.allclose(logits, parts.forward(w, tok, cfg), atol=2e-5, rtol=1e-5)
    if parts.forward is reference.forward:  # the train driver's loss: the dense decoder's
        assert float(tf.loss_fn(w, {"tokens": tok}, mc)) == pytest.approx(
            float(reference.loss(w, tok, cfg)), rel=1e-6)


def test_query_blocks_across_the_window_change_nothing():
    cfg = small_config("h2o-danube-1.8b")
    w = data.make_weights(cfg, 2**31 + 78, "cpu")
    tok = data.tokens(cfg, "uniform", 2**31 + 78, 0, 2, 40)
    assert cfg["sliding_window"] < 40
    whole = reference.forward(w, tok, cfg)
    assert torch.allclose(reference.forward(w, tok, cfg, q_rows=7), whole, atol=2e-5, rtol=1e-5)


def test_the_ports_training_steps_match_the_reference_in_fp32():
    cell = small_cell("bert-large.train-b256-s128", compute_dtype="float32")
    run = harness.Run(cell=cell, seed=2**31 + 3, seconds=0.0, trace=False, t0=0.0,
                      device=torch.device("cpu"))
    su = train.Setup(run)
    gaps = train.compare(su.free(), su.reference())
    assert gaps["loss_gap"] < 1e-6 and gaps["grad_gap"] < 1e-4 and gaps["update_gap"] < 1e-3


def test_reference_imports_nothing_of_the_programs():
    import ast
    bench = ROOT / "bench"
    files = [bench / f for f in ("reference.py", "data.py", "flops.py")]
    for f in files + sorted((bench / "references").glob("*.py")):
        tree = ast.parse(f.read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, (f, names)
