"""The plain reference against ``repro_torch`` at smoke sizes on the CPU, in
fp32: the forward's logits and loss, and three training steps' readings
through the harness's own set-up (the port's AdamW against the reference's)."""

import json

import pytest
import torch
from smallcells import ROOT, SMALL, small_cell

from bench import data, harness, reference
from bench.drivers import train


@pytest.mark.parametrize("name", sorted(SMALL))
def test_forward_and_loss_match_the_port(name):
    from repro_torch.models import transformer as tf
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    cfg.update(SMALL[name])
    mc = harness.program_config(cfg, compute_dtype="float32")
    w = data.make_weights(cfg, 2**31 + 77, "cpu")
    tok = data.tokens(cfg, "zipf", 2**31 + 77, 0, 3, 40)
    logits, _ = tf.forward_logits(w, {"tokens": tok}, mc)
    ref = reference.forward(w, tok, cfg, q_rows=7)  # query blocks cross the window
    assert torch.allclose(logits, ref, atol=2e-5, rtol=1e-5)
    assert float(tf.loss_fn(w, {"tokens": tok}, mc)) == pytest.approx(
        float(reference.loss(w, tok, cfg)), rel=1e-6)


def test_the_ports_training_steps_match_the_reference_in_fp32():
    cell = small_cell("bert-large.train-b256-s128", compute_dtype="float32")
    run = harness.Run(cell=cell, seed=2**31 + 3, seconds=0.0, trace=False, t0=0.0,
                      device=torch.device("cpu"))
    su = train.Setup(run)
    gaps = train.compare(su.free(), su.reference())
    assert gaps["loss_gap"] < 1e-6 and gaps["grad_gap"] < 1e-4 and gaps["update_gap"] < 1e-3


def test_reference_imports_nothing_of_the_programs():
    import ast
    for f in ("reference.py", "data.py", "flops.py"):
        tree = ast.parse((ROOT / "bench" / f).read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, (f, names)
