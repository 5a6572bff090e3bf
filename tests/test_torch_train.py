"""The port's data-parallel training path against the JAX package, on the
bert-large smoke config:

  * config, ``cross_entropy``, ``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad`` in fp32 (1e-5 relative), attention gradients on
    the dense and chunked paths, ``batch_at`` tokens, AdamW over 5 steps;
  * the trainer twin of tests/test_train_integration.py on CPU virtual
    ranks (LUMORPH comm against the library reduction);
  * a cross-framework run: the JAX trainer on 4 fake devices and the port on
    4 virtual ranks from the same carried-over state (``bridge``), 4 steps,
    with the per-rank state under ``--compress`` read per device, monolithic
    and with ``--overlap 4`` (losses and bucket logs); and ``--comm auto`` on
    2, 4 and 8 devices and ranks (bucket logs entry for entry, losses);
  * checkpoints: the port's twins of tests/test_checkpoint.py, files byte for
    byte equal to the JAX package's, a JAX trainer's checkpoint (device 0's
    copy of the replicas) restored into the port, and a port checkpoint
    restored by JAX.

The JAX trainer runs in one subprocess (``XLA_FLAGS`` stays out of the
pytest process) that writes one pickle and one checkpoint under
``tmp_path``.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import checkpoint as tck  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from jax_twin import assert_converts  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

ARCH = "bert-large"
SRC = str(Path(__file__).resolve().parents[1] / "src")
STEPS, BATCH, SEQ, DP = 4, 4, 32, 4
AUTO_DPS, AUTO_BATCH = (2, 4, 8), 8  # --comm auto: 8 rows split over every width
BUCKET = 1 << 16  # 16,384 fp32 per bucket: the smoke gradient spans several
BUCKET_OVL = 1 << 17  # fewer, larger buckets under --overlap 4: its programs compile slower


def _rel(got, expect) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    e = np.asarray(expect, np.float32)
    return float(np.abs(g - e).max() / (np.abs(e).max() + 1e-12))


def _setup(**overrides):
    jcfg = jax_smoke_config(ARCH).replace(compute_dtype="float32", **overrides)
    tcfg = get_smoke_config(ARCH).replace(compute_dtype="float32", **overrides)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, bridge.params_from_numpy(jax.tree.map(np.asarray, params))


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


# ---------------------------------------------------------------------------
# modules against their JAX counterparts
# ---------------------------------------------------------------------------

def test_bert_config_converts_field_for_field():
    for jcfg, tcfg in ((jax_smoke_config(ARCH), get_smoke_config(ARCH)),
                       (jax_get_config(ARCH), get_config(ARCH))):
        assert_converts(tcfg, jcfg)
    full = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0), jax_get_config(ARCH)))
    shapes = [x.shape for x in jax.tree.leaves(full)]
    assert len(shapes) == 13 and sum(int(np.prod(s)) for s in shapes) == 333_344_768
    own = bridge.flatten_with_paths(ttf.init_params(torch.Generator().manual_seed(0),
                                                    get_smoke_config(ARCH)))
    _, _, params, _ = _setup()
    assert [(k, tuple(t.shape)) for k, t in own] == \
        [(k, tuple(np.shape(a))) for k, a in bridge.flatten_with_paths(params)]


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    expect = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                   None if mask is None else jnp.asarray(mask))
    got = tlayers.cross_entropy(torch.from_numpy(logits).bfloat16(), torch.from_numpy(targets),
                                None if mask is None else torch.from_numpy(mask))
    expect_bf = jlayers.cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16),
                                      jnp.asarray(targets),
                                      None if mask is None else jnp.asarray(mask))
    assert got.dtype == torch.float32 and _rel(got, expect_bf) < 1e-6
    got32 = tlayers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                  None if mask is None else torch.from_numpy(mask))
    assert _rel(got32, expect) < 1e-6


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_leaf_match_jax(remat):
    jcfg, tcfg, params, tparams = _setup(remat=remat)
    toks = _tokens(2, 24, jcfg.vocab_size)
    loss, grads = jax.value_and_grad(lambda p: jtf.loss_fn(p, {"tokens": jnp.asarray(toks)},
                                                          jcfg))(params)
    plist = [t.requires_grad_() for t in leaves(tparams)]
    tloss = ttf.loss_fn(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    tgrads = torch.autograd.grad(tloss, plist)
    assert _rel(tloss, loss) < 1e-5
    jg = bridge.flatten_with_paths(jax.tree.map(np.asarray, grads))
    assert len(jg) == len(tgrads) == 13
    for (path, g), tg in zip(jg, tgrads):
        assert tg.shape == g.shape and _rel(tg, g) < 1e-5, path


@pytest.mark.parametrize("chunked", [False, True])
def test_attention_gradients_match_jax(chunked):
    """Autograd through ``attention_forward`` (dense, and chunked with a
    ragged last chunk) against ``jax.grad``; GQA via danube's smoke heads."""
    jcfg = jax_smoke_config("h2o-danube-1.8b").replace(compute_dtype="float32", attn_chunk=7,
                                                      dense_attn_limit=1 if chunked else 1 << 30)
    tcfg = get_smoke_config("h2o-danube-1.8b").replace(compute_dtype="float32", attn_chunk=7,
                                                       dense_attn_limit=1 if chunked else 1 << 30)
    p = jattn.init_attention(jax.random.PRNGKey(1), 64, 4, 2, 16)
    x = np.random.default_rng(2).standard_normal((2, 20, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))

    def jloss(p, x):
        y = jattn.attention_forward(p, x, jnp.asarray(pos), jcfg)
        return jnp.sum(y * jnp.cos(y))

    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p))
    for t in tp.values():
        t.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    y = tattn.attention_forward(tp, tx, torch.from_numpy(pos.copy()), tcfg)
    tl = torch.sum(y * torch.cos(y))
    tl.backward()
    assert _rel(tl, jl) < 1e-5
    assert _rel(tx.grad, jgx) < 1e-5
    for k in tp:
        assert _rel(tp[k].grad, jgp[k]) < 1e-5, k


def test_batch_at_tokens_identical():
    for cfg_j, cfg_t in ((jax_smoke_config(ARCH), get_smoke_config(ARCH)),
                         (jax_get_config(ARCH), get_config(ARCH))):
        data_j = jpipe.DataConfig(seed=3, global_batch=8, seq_len=128, host_id=1, n_hosts=2)
        data_t = tpipe.DataConfig(seed=3, global_batch=8, seq_len=128, host_id=1, n_hosts=2)
        for (sj, bj), (st, bt) in zip(jpipe.stream(cfg_j, data_j, 5), tpipe.stream(cfg_t, data_t, 5)):
            assert sj == st
            assert bt["tokens"].dtype == torch.int32 and bt["tokens"].shape == (4, 128)
            np.testing.assert_array_equal(bt["tokens"].numpy(), np.asarray(bj["tokens"]))
            if sj == 7:
                break


def test_adamw_matches_jax_over_five_steps():
    cfg_j = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    cfg_t = tadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    rng = np.random.default_rng(4)
    shapes = {"w": (5, 7), "b": [(3,), (2, 2)]}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    params = {"w": mk(shapes["w"]), "b": [mk(s) for s in shapes["b"]]}
    grads = [{"w": mk(shapes["w"]) * 3, "b": [mk(s) for s in shapes["b"]]} for _ in range(5)]
    jp, js = jax.tree.map(jnp.asarray, params), jadamw.init_opt_state(jax.tree.map(jnp.asarray, params))
    tp = bridge.params_from_numpy(params)
    ts = tadamw.init_opt_state(tp)
    # the same five steps on two virtual ranks: the per-rank form equals the single one
    rp = bridge.params_from_numpy(jax.tree.map(lambda a: np.stack([a, a]), params))
    rs = tadamw.init_opt_state(rp, lead=(2,))
    for g in grads:
        jp, js = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), js, cfg_j)
        tp, ts = tadamw.adamw_update(tp, bridge.params_from_numpy(g), ts, cfg_t)
        rg = bridge.params_from_numpy(jax.tree.map(lambda a: np.stack([a, a * 0.5]), g))
        rp, rs = tadamw.adamw_update(rp, rg, rs, cfg_t)
        for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            for (path, a), t in zip(bridge.flatten_with_paths(jax.tree.map(np.asarray, tree_j)),
                                    leaves(tree_t)):
                np.testing.assert_allclose(t.numpy(), a, rtol=1e-6, atol=1e-7, err_msg=path)
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"])
        for a, t in zip(leaves(rp), leaves(tp)):
            torch.testing.assert_close(a[0], t, rtol=0, atol=0)
    lr_j = [float(jadamw.lr_at(cfg_j, jnp.int32(s))) for s in range(8)]
    lr_t = tadamw.lr_at(cfg_t, torch.arange(8, dtype=torch.int32))
    assert lr_t.dtype == torch.float32
    np.testing.assert_allclose(lr_t.numpy(), lr_j, rtol=1e-6)


# ---------------------------------------------------------------------------
# the trainer on CPU virtual ranks (twin of tests/test_train_integration.py)
# ---------------------------------------------------------------------------

def _train(*extra):
    return ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
                        "--seq", "32", "--data-parallel", "4", "--log-every", "100", *extra])


def test_lumorph_comm_matches_library_reduction():
    common = ["--steps", "4", "--wire-dtype", "float32"]
    base = _train(*common, "--comm", "xla")
    assert base["steps"] == 4 and base["device"] == "cpu" and base["step_s"] > 0
    for comm in ("ring", "lumorph2", "lumorph4"):
        out = _train(*common, "--comm", comm)
        assert out["final_loss"] == pytest.approx(base["final_loss"], rel=1e-4), comm
    bf = _train("--steps", "4", "--comm", "lumorph4")  # bf16 wire
    assert bf["final_loss"] == pytest.approx(base["final_loss"], rel=2e-2)


def test_compressed_training_tracks():
    base = _train("--steps", "6", "--comm", "lumorph2")
    comp = _train("--steps", "6", "--comm", "lumorph2", "--compress")
    assert comp["final_loss"] == pytest.approx(base["final_loss"], rel=0.05)
    assert comp["final_loss"] != base["final_loss"]


def test_microbatches_accumulate_the_same_gradient():
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    batch = tpipe.batch_at(0, cfg, tpipe.DataConfig(global_batch=8, seq_len=16))
    out = []
    for mb in (1, 2):
        params, opt = tsteps.init_train_state(cfg, 2, 0, "cpu")
        step = tsteps.make_train_step(cfg, comm="ring", dp=2, microbatches=mb,
                                      wire_dtype=torch.float32, device="cpu")
        out.append(step(params, opt, batch))
    assert float(out[0][2]) == pytest.approx(float(out[1][2]), rel=1e-6)
    for a, b in zip(leaves(out[0][0]), leaves(out[1][0])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flags,item,ranks", [
    (["--mesh", "single"], r"single production mesh \{'data': 16, 'model': 16\} is valid", 256),
    (["--mesh", "multi"], r"multi production mesh \{'pod': 2, 'data': 16, 'model': 16\}", 512),
])
def test_unported_flags_exit_naming_their_item(flags, item, ranks):
    """``--mesh single|multi`` makes and checks the production mesh's policy,
    then stops: running on it needs 256 or 512 ranks, one per card."""
    with pytest.raises(SystemExit, match=item) as exc:
        _train("--steps", "1", *flags)
    assert f"training on it needs {ranks} ranks, one per card" in str(exc.value)


def test_overlap_needs_a_lumorph_comm():
    with pytest.raises(SystemExit, match="not xla"):
        _train("--steps", "1", "--comm", "xla", "--overlap", "2")


def test_overlap_training_tracks_monolithic():
    common = ["--steps", "4", "--wire-dtype", "float32", "--comm", "lumorph4"]
    base = _train(*common)
    ovl = _train(*common, "--overlap", "4")
    assert ovl["overlap"] == 4
    assert ovl["final_loss"] == pytest.approx(base["final_loss"], rel=1e-4)


# ---------------------------------------------------------------------------
# cross-framework: the JAX trainer and the port from one carried-over state
# ---------------------------------------------------------------------------

JAX_TRAIN = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={max_dp}"
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp
from repro import compat
from repro.checkpoint import checkpoint as ckpt_lib
from repro.configs import get_smoke_config
from repro.data.pipeline import DataConfig, stream
from repro.launch import steps
from repro.optim.adamw import AdamWConfig
from repro.sharding.policy import make_policy
from repro_torch.bridge import per_rank_from_shards


def make_host_mesh(data, model):  # the first data·model of the fake devices
    return compat.make_mesh((data, model), ("data", "model"),
                            devices=jax.devices()[:data * model])

logs = []
_all_reduce_grads = steps.grad_comm.all_reduce_grads
def _logged(*args, **kwargs):  # the bucket log, which the jitted step drops
    red, ef, log = _all_reduce_grads(*args, **kwargs)
    logs.append(log)
    return red, ef, log
steps.grad_comm.all_reduce_grads = _logged

cfg = get_smoke_config("bert-large").replace(compute_dtype="float32")
mesh = make_host_mesh(data={dp}, model=1)
policy = make_policy(cfg, mesh)
devices = list(mesh.devices.flatten())  # rank order along "data"
opt = AdamWConfig(total_steps={steps}, warmup_steps=1)
out = {{}}
for name, comm, compress, overlap in (("fp32", "lumorph4", False, 1),
                                      ("int8", "lumorph2", True, 1),
                                      ("fp32-ovl4", "lumorph4", False, 4),
                                      ("int8-ovl4", "lumorph2", True, 4)):
    bucket = {bucket} if overlap == 1 else {bucket_ovl}
    step = steps.make_train_step(cfg, policy, opt, comm=comm, bucket_bytes=bucket,
                                 compress=compress, wire_dtype=jnp.float32,
                                 overlap_chunks=overlap)
    params, opt_state = steps.init_sharded_state(cfg, policy, jax.random.PRNGKey(0),
                                                 init_ef=compress)
    init = per_rank_from_shards((params, opt_state), devices)
    losses = []
    for i, batch in stream(cfg, DataConfig(seed=0, global_batch={batch}, seq_len={seq})):
        if i >= {steps}:
            break
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    out[name] = dict(init=init, losses=losses, log=[[int(b), a] for b, a in logs[-1]],
                     final=per_rank_from_shards((params, opt_state), devices))
    if name == "int8":  # the replicas differ per device: which copy does a checkpoint hold?
        ckpt_lib.save({ckpt!r}, {steps}, (params, opt_state))
for dp in {auto_dps}:  # --comm auto: the α–β model picks each bucket's schedule
    mesh = make_host_mesh(data=dp, model=1)
    policy = make_policy(cfg, mesh)
    devices = list(mesh.devices.flatten())
    step = steps.make_train_step(cfg, policy, opt, comm="auto", bucket_bytes={bucket},
                                 wire_dtype=jnp.float32)
    params, opt_state = steps.init_sharded_state(cfg, policy, jax.random.PRNGKey(0))
    init = per_rank_from_shards((params, opt_state), devices)
    losses = []
    for i, batch in stream(cfg, DataConfig(seed=0, global_batch={auto_batch}, seq_len={seq})):
        if i >= {steps}:
            break
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    out[f"auto-{{dp}}"] = dict(init=init, losses=losses, log=[[int(b), a] for b, a in logs[-1]])
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_trainer(tmp_path_factory):
    """Starts the JAX runs with the module's first test, so that they overlap
    the tests before the ones that read them."""
    tmp = tmp_path_factory.mktemp("train")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    code = JAX_TRAIN.format(dp=DP, max_dp=max(AUTO_DPS), src=SRC, steps=STEPS, bucket=BUCKET,
                            bucket_ovl=BUCKET_OVL, batch=BATCH, seq=SEQ,
                            auto_dps=AUTO_DPS, auto_batch=AUTO_BATCH,
                            path=str(tmp / "jax_runs.pkl"), ckpt=str(tmp / "ckpt"))
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_runs(_jax_trainer):
    proc, tmp = _jax_trainer
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "jax_runs.pkl", "rb") as f:  # written by the subprocess just above
        runs = pickle.load(f)
    runs["ckpt"] = tmp / "ckpt"
    return runs


def _port_run(run, comm, compress, overlap=1, dp=DP, batch=BATCH):
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    params, opt_state = bridge.train_state_from_numpy(*run["init"])
    assert opt_state["step"].shape == (dp,) and opt_state["step"].dtype == torch.int32
    assert ("ef" in opt_state) == compress
    step = tsteps.make_train_step(
        cfg, tadamw.AdamWConfig(total_steps=STEPS, warmup_steps=1), comm=comm, dp=dp,
        bucket_bytes=BUCKET if overlap == 1 else BUCKET_OVL, compress=compress,
        wire_dtype=torch.float32, overlap_chunks=overlap, device="cpu")
    data = tpipe.DataConfig(seed=0, global_batch=batch, seq_len=SEQ)
    losses = []
    for i, batch in tpipe.stream(cfg, data):
        if i >= STEPS:
            break
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return params, opt_state, losses, step.bucket_log


def test_port_tracks_jax_trainer_from_the_same_state(jax_runs):
    run = jax_runs["fp32"]
    params, opt_state, losses, log = _port_run(run, "lumorph4", False)
    assert len(log) > 3 and {a for _, a in log} == {"lumorph4"}
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-4)
    jparams, jopt = run["final"]
    for (path, a), t in zip(bridge.flatten_with_paths(jparams), leaves(params)):
        np.testing.assert_allclose(t.numpy(), a, rtol=0, atol=1e-5, err_msg=path)
    assert np.array_equal(opt_state["step"].numpy(), jopt["step"])


def test_compressed_port_tracks_jax_per_rank(jax_runs):
    """Under int8 the JAX replicas end apart, device by device; the port's
    ranks track each device's copy."""
    run = jax_runs["int8"]
    params, opt_state, losses, log = _port_run(run, "lumorph2", True)
    assert {a for _, a in log} == {"lumorph2+int8"}
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-4)
    jparams, jopt = run["final"]
    spread_j = spread_t = 0.0
    for (path, a), t in zip(bridge.flatten_with_paths(jparams), leaves(params)):
        t = t.numpy()
        spread_j = max(spread_j, float(np.abs(a - a[:1]).max()))
        spread_t = max(spread_t, float(np.abs(t - t[:1]).max()))
        np.testing.assert_allclose(t, a, rtol=0, atol=2e-5, err_msg=path)
    assert spread_j > 0 and spread_t > 0  # the replicas differ, in both
    # error feedback: equal but where the two frameworks' gradients, a few ulps
    # apart, round to neighbouring int8 levels, which moves the residual by one
    # quantization step (at most about twice the largest residual)
    for (path, a), t in zip(bridge.flatten_with_paths(jopt["ef"]), leaves(opt_state["ef"])):
        diff = np.abs(t.numpy() - a)
        assert np.mean(diff > 1e-6) < 1e-3, path
        assert diff.max() <= 2.5 * np.abs(a).max(), path


@pytest.mark.parametrize("name,comm,compress", [("fp32-ovl4", "lumorph4", False),
                                                ("int8-ovl4", "lumorph2", True)])
def test_overlap_port_tracks_jax_trainer(jax_runs, name, comm, compress):
    """``--overlap 4`` from the carried-over state: the losses track the JAX
    trainer's within 1e-4, and the bucket logs are equal, ``+ovl4`` included."""
    run = jax_runs[name]
    params, opt_state, losses, log = _port_run(run, comm, compress, overlap=4)
    assert [list(e) for e in log] == run["log"] and len(log) > 1
    assert {a for _, a in log} == {comm + ("+int8" if compress else "") + "+ovl4"}
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-4)
    jparams, _ = run["final"]
    for (path, a), t in zip(bridge.flatten_with_paths(jparams), leaves(params)):
        np.testing.assert_allclose(t.numpy(), a, rtol=0, atol=2e-5, err_msg=path)


@pytest.mark.parametrize("dp", AUTO_DPS)
def test_auto_comm_port_tracks_jax_trainer(jax_runs, dp):
    """``--comm auto`` from the carried-over state: the bucket logs (bytes and
    the α–β model's pick per bucket) are equal entry for entry, and the
    losses track the JAX trainer's within 1e-4. At 4 ranks every bucket
    picks LUMORPH-4, so the port's auto run and its forced ``lumorph4`` run
    end equal, bit for bit."""
    run = jax_runs[f"auto-{dp}"]
    params, opt_state, losses, log = _port_run(run, "auto", False, dp=dp, batch=AUTO_BATCH)
    assert [list(e) for e in log] == run["log"] and len(log) > 3
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-4)
    if dp == 4:
        assert {a for _, a in log} == {"lumorph4"}
        forced, forced_opt, forced_losses, _ = _port_run(run, "lumorph4", False, dp=dp,
                                                         batch=AUTO_BATCH)
        assert forced_losses == losses
        for a, b in zip(leaves((params, opt_state)), leaves((forced, forced_opt))):
            assert torch.equal(a, b)


def test_auto_comm_trains_with_compress_and_overlap():
    """``--comm auto`` with ``--compress`` and ``--overlap``: the compressed
    path runs LUMORPH-2 whatever the log names, as in JAX, so auto with
    ``--compress`` ends on ``lumorph2 --compress``'s loss exactly."""
    common = ["--steps", "3", "--compress"]
    auto = _train(*common, "--comm", "auto")
    l2 = _train(*common, "--comm", "lumorph2")
    assert auto["comm"] == "auto" and auto["final_loss"] == l2["final_loss"]
    ovl = _train("--steps", "3", "--comm", "auto", "--overlap", "2", "--wire-dtype", "float32")
    l4 = _train("--steps", "3", "--comm", "lumorph4", "--overlap", "2", "--wire-dtype",
                "float32")
    assert ovl["final_loss"] == l4["final_loss"]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(seed=0):
    """The shape of tests/test_checkpoint.py's state, as tensors."""
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 8, generator=gen), "b": torch.zeros(8)},
            "opt": {"m": torch.ones(4, 8), "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    s = _state()
    tck.save(tmp_path, 7, s)
    restored, step = tck.restore(tmp_path, tree_map(torch.zeros_like, s))
    assert step == 7
    for a, b in zip(leaves(s), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_latest_and_retention(tmp_path):
    s = _state()
    for step in (10, 20, 30, 40):
        tck.save(tmp_path, step, s, keep=2)
    assert tck.latest_step(tmp_path) == 40
    assert sorted(d.name for d in Path(tmp_path).iterdir()) == \
        ["step_0000000030", "step_0000000040"]


def test_checkpoint_incomplete_ignored(tmp_path):
    """A crash mid-write leaves a .tmp dir, and a dir may lack its manifest:
    neither is ever the latest."""
    tck.save(tmp_path, 5, _state())
    bad = Path(tmp_path) / "step_0000000009.tmp"
    bad.mkdir()
    (bad / "leaf_00000.npy").write_bytes(b"junk")
    (Path(tmp_path) / "step_0000000011").mkdir()
    assert tck.latest_step(tmp_path) == 5
    assert tck.restore(tmp_path, _state())[1] == 5


def test_checkpoint_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tck.restore(tmp_path, _state())
    tck.save(tmp_path, 1, {"params": _state()["params"]})
    with pytest.raises(KeyError, match="opt/m"):
        tck.restore(tmp_path, _state())


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    tck.save(tmp_path, 1, _state())
    wrong = _state()
    wrong["params"]["w"] = torch.zeros(5, 8)
    with pytest.raises(ValueError, match="params/w"):
        tck.restore(tmp_path, wrong)


def _mixed_state():
    """fp32, bf16, int32 leaves (a bf16 value with every exponent pattern)."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    return {"a": [w, (w * 1e3).astype(np.float32)],
            "b": {"h": rng.integers(0, 65535, (2, 7), dtype=np.uint16), "step": np.int32(9)}}


def test_checkpoint_files_byte_identical_to_jax(tmp_path):
    """For the same state the two packages write the same bytes, bf16 included."""
    import ml_dtypes
    ref = _mixed_state()
    jstate = {"a": [jnp.asarray(x) for x in ref["a"]],
              "b": {"h": jnp.asarray(ref["b"]["h"].view(ml_dtypes.bfloat16)),
                    "step": jnp.int32(9)}}
    tstate = {"a": [torch.from_numpy(x) for x in ref["a"]],
              "b": {"h": torch.from_numpy(ref["b"]["h"].view(np.int16)).view(torch.bfloat16),
                    "step": torch.tensor(9, dtype=torch.int32)}}
    jdir, tdir = jck.save(tmp_path / "jax", 3, jstate), tck.save(tmp_path / "port", 3, tstate)
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir()) and len(names) == 5
    for n in names:
        assert (jdir / n).read_bytes() == (tdir / n).read_bytes(), n
    manifest = json.loads((tdir / "manifest.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == ["float32", "float32", "bfloat16", "int32"]
    # a JAX-written bf16 leaf restores into the port bit for bit
    got, step = tck.restore(tmp_path / "jax", tree_map(torch.zeros_like, tstate))
    assert step == 3
    for a, b in zip(leaves(got), leaves(tstate)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype ==
                                                  torch.bfloat16 else a,
                                                  b.view(torch.int16) if b.dtype ==
                                                  torch.bfloat16 else b)
    # the JAX package cannot read a bf16 leaf back, not even its own (numpy
    # loads '<V2', which jnp.asarray will not cast): ROADMAP Queue 3
    with pytest.raises((ValueError, TypeError)):
        jck.restore(tmp_path / "jax", jstate)


def test_port_checkpoint_restores_into_jax(tmp_path):
    """A port trainer state (rank 0's copy) restores into the JAX trainer's
    state tree bit for bit."""
    cfg = get_smoke_config(ARCH)
    params, opt = tsteps.init_train_state(cfg, 2, 3, "cpu", init_ef=True)
    state = tree_map(lambda t: t[0], (params, opt))
    tck.save(tmp_path, 2, state)
    jparams = jtf.init_params(jax.random.PRNGKey(1), jax_smoke_config(ARCH))
    jopt = jadamw.init_opt_state(jparams)
    jopt["ef"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
    restored, step = jck.restore(tmp_path, (jparams, jopt))
    assert step == 2
    got = bridge.flatten_with_paths(jax.tree.map(np.asarray, restored))
    want = bridge.flatten_with_paths(state)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, t) in zip(got, want):
        assert a.dtype == t.numpy().dtype and np.array_equal(a, t.numpy()), k


def test_jax_trainer_checkpoint_holds_device0_and_restores_into_port(jax_runs):
    """The JAX trainer's checkpoint under --compress holds device 0's copy of
    the per-device replicas (``jax.device_get``); the port's trainer writes
    rank 0 for the same reason. Restored into the port, bit for bit."""
    jparams, jopt = jax_runs["int8"]["final"]
    cfg = get_smoke_config(ARCH).replace(compute_dtype="float32")
    params, opt = tsteps.init_train_state(cfg, DP, 0, "cpu", init_ef=True)
    (rp, ro), step = tck.restore(jax_runs["ckpt"], tree_map(lambda t: t[0], (params, opt)))
    assert step == STEPS
    differs = False
    for (path, a), t in zip(bridge.flatten_with_paths((jparams, jopt)), leaves((rp, ro))):
        assert np.array_equal(t.numpy(), a[0]), path
        differs |= not np.array_equal(a[0], a[1])
    assert differs  # the devices' copies differ, and the file holds device 0's


def test_train_restart_continues(tmp_path):
    """A killed-and-restarted trainer resumes from the checkpoint and the data
    stream position; with every rank equal (no compression) the resumed run
    repeats the uninterrupted one exactly."""
    common = ["--comm", "lumorph4", "--overlap", "4", "--ckpt-dir", str(tmp_path),
              "--ckpt-every", "3"]
    full = _train("--steps", "6", *common)
    assert tck.latest_step(tmp_path) == 6 and full["steps"] == 6
    shutil.rmtree(tmp_path / "step_0000000006")
    resumed = _train("--steps", "6", *common)
    assert resumed["steps"] == 3 and resumed["final_loss"] == full["final_loss"]
    more = _train("--steps", "8", *common)
    assert more["steps"] == 2  # resumed at 6, ran 6..7
