"""The module spans of a profiled train step (``repro_torch.spans``), on the
CPU: bert-large's smoke config with each block recomputed, under
``torch.profiler``. Where each span opens, how often, how the ``.bwd`` spans
and the recomputations nest; that without a profiler the step adds no
autograd node and gives the same numbers; and that the prefill and the
decode mark nothing."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves

MODULES = ("embed", "norm", "attention", "ffn", "unembed", "loss")
STAGES = ("forward_backward", "grad_comm", "adamw", "forward", "backward")


def bert():
    cfg = get_smoke_config("bert-large")
    assert cfg.remat and cfg.n_layers >= 2
    return cfg


def batch(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                                    dtype=torch.int32)}


def train_state(cfg):
    params, opt = steps.init_train_state(cfg, 1, 0, "cpu")
    step = steps.make_train_step(cfg, AdamWConfig(), comm="xla", dp=1, device="cpu")
    return step, params, opt


def spans_of(prof) -> list[tuple[str, float, float]]:
    """The ``train/`` spans of a profile: name, start, end (µs)."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("train/")), key=lambda s: s[1])


def inside(span, outer) -> bool:
    return outer[1] <= span[1] and span[2] <= outer[2]


@pytest.fixture(scope="module")
def traced():
    """bert's smoke step, warm, then one step under the profiler: its spans."""
    cfg = bert()
    step, params, opt = train_state(cfg)
    params, opt, _ = step(params, opt, batch(cfg))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, batch(cfg, 1))
    return cfg, spans_of(prof)


def named(spans, name):
    return [s for s in spans if s[0] == f"train/{name}"]


def outside_recompute(spans, name):
    rec = named(spans, "recompute")
    return [s for s in named(spans, name) if not any(inside(s, r) for r in rec)]


def test_each_span_fires_once_per_module_call(traced):
    cfg, spans = traced
    n = cfg.n_layers
    want = {"norm": 2 * n + 1, "attention": n, "ffn": n, "embed": 1, "unembed": 1, "loss": 1}
    assert {m: len(outside_recompute(spans, m)) for m in MODULES} == want
    assert {s: len(named(spans, s)) for s in STAGES} == dict.fromkeys(STAGES, 1)
    assert len(named(spans, "recompute")) == n


def test_each_recompute_holds_one_blocks_spans(traced):
    _, spans = traced
    for r in named(spans, "recompute"):
        held = [s[0].split("/", 1)[1] for s in spans if s is not r and inside(s, r)]
        assert sorted(held) == ["attention", "ffn", "norm", "norm"]


def test_each_bwd_span_pairs_its_forward(traced):
    _, spans = traced
    for m in MODULES:
        assert len(named(spans, f"{m}.bwd")) == len(outside_recompute(spans, m)), m


def test_bwd_spans_are_disjoint_and_hold_the_recomputes(traced):
    cfg, spans = traced
    bwd = [s for s in spans if s[0].endswith(".bwd")]
    for a, b in zip(bwd, bwd[1:]):
        assert a[2] <= b[1], (a, b)
    backward = named(spans, "backward")[0]
    assert all(inside(s, backward) for s in bwd)
    # the backward reaches the blocks last to first; each block's recomputation runs
    # when its MLP's backward first needs a saved tensor
    ffn_bwd, rec = named(spans, "ffn.bwd"), named(spans, "recompute")
    assert len(ffn_bwd) == len(rec) == cfg.n_layers
    for r, f in zip(rec, ffn_bwd):
        assert inside(r, f), (r, f)
    # the gradient leaves the loss, the unembedding and the last norm first, the
    # embedding last
    order = [s[0] for s in bwd]
    assert order[:3] == ["train/loss.bwd", "train/unembed.bwd", "train/norm.bwd"]
    assert order[-1] == "train/embed.bwd"


def graph_nodes(t: torch.Tensor) -> list[str]:
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo += [f for f, _ in node.next_functions]
    return names


def marks(names: list[str]) -> int:
    return sum(n.startswith(("_OpenBackward", "_CloseBackward")) for n in names)


def test_no_mark_node_without_a_profiler():
    cfg = bert()
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    params = {**params, "embed": params["embed"].requires_grad_()}
    from repro_torch import spans
    with spans.namespace("train"):
        plain = graph_nodes(tf.loss_fn(params, batch(cfg), cfg))
        with profile(activities=[ProfilerActivity.CPU]):
            marked = graph_nodes(tf.loss_fn(params, batch(cfg), cfg))
    assert marks(plain) == 0
    # two a module call: the embedding, 2L + 1 norms, L attentions and MLPs, the
    # unembedding and the loss
    assert marks(marked) == 2 * (1 + (2 * cfg.n_layers + 1) + 2 * cfg.n_layers + 2)
    assert len(marked) - marks(marked) == len(plain)


def test_profiled_steps_equal_plain_steps():
    cfg = bert()
    out = []
    for traced in (False, True):
        step, params, opt = train_state(cfg)
        with profile(activities=[ProfilerActivity.CPU]) if traced else _nothing():
            for i in range(2):
                params, opt, loss = step(params, opt, batch(cfg, i))
        out.append((leaves(params), leaves(opt), loss))
    (p0, o0, l0), (p1, o1, l1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0 + o0, p1 + o1))


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("arch", ["bert-large", "h2o-danube-1.8b"])
def test_prefill_and_decode_mark_nothing(arch):
    cfg = get_smoke_config(arch)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    prefill = steps.make_prefill(cfg, "cpu")
    decode = steps.make_decode_step(cfg, "cpu")
    tokens = batch(cfg)["tokens"][:2, :8]
    caches = tf.init_caches(cfg, 2, 16, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prefill(params, {"tokens": tokens})
        decode(params, caches, tokens[:, :1], 0)
    assert spans_of(prof) == []
    assert not any(e.name.startswith("train/") for e in prof.events())


def test_loss_outside_a_step_marks_nothing():
    cfg = bert()
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tf.loss_fn(params, batch(cfg), cfg)
    assert spans_of(prof) == []
