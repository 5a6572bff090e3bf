"""The plain reference: a dense decoder in fp32 PyTorch, written from the
configuration file, with no kernel, cache or batching of the program's.

It imports neither JAX nor anything of the programs under test. It takes the
weights that ``bench.data.make_weights`` draws from the seed (the layout of
``init_params``, each leaf as stored, upcast to fp32 where a layer uses it),
the token batches, and the optimizer's settings, and works everything out
again from them:

* ``forward``: embeddings (no positions unless ``use_rope``: interleaved
  lane pairs, theta from the file), per layer ``x + attn(norm1(x))`` then
  ``x + mlp(norm2(x))`` (causal attention, the sliding window where the file
  has one, grouped KV heads: query head ``h`` reads KV head
  ``h // (H / KV)``), the final norm, the head (the embedding's transpose when
  tied). LayerNorm at eps 1e-5 with weight and bias; RMSNorm at eps 1e-6
  with scale ``1 + w``; GELU in its tanh form; SwiGLU ``silu(x wg) * (x wi)``.
* ``train``: the next-token cross-entropy over every position's successor,
  its gradient accumulated over blocks of rows (averaged over ranks with a
  plain ``all_reduce`` where the cell has several), and AdamW as the
  configuration of the optimizer states it: global-norm clipping, linear
  warmup then cosine decay, bias-corrected moments, decoupled weight decay.
* ``served_gaps``: the logits of each prompt, query block by query block.

``Precision`` is how every matmul's operands enter it: ``FP32`` as they are
(TF32 off), ``FP8`` rounded to float8 e4m3 with one scale per tensor (the
precision below bf16, the benchmark's control).
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@contextmanager
def exact_fp32():
    """fp32 matmuls without TF32 while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _round_fp8(x: Tensor) -> Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Rounds to float8 e4m3 going forward, and the gradient coming back."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


class Precision:
    name = "fp32"

    def operand(self, x: Tensor) -> Tensor:
        return x

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return self.operand(a) @ self.operand(b)


class _Fp8Precision(Precision):
    name = "fp8"

    def operand(self, x: Tensor) -> Tensor:
        return _Fp8.apply(x)


FP32 = Precision()
FP8 = _Fp8Precision()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _norm(cfg: dict, p: dict, x: Tensor) -> Tensor:
    if cfg["norm"] == "rmsnorm":
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * (1.0 + p["w"])
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["w"] + p["b"]


def _rope(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """x [B, S, H, D]: lanes (2i, 2i+1) turned by pos · theta^(-2i/D)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos.float()[:, None] * inv  # [S, D/2]
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    pairs = x.unflatten(-1, (d // 2, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).flatten(-2)


def _layer(p: dict, i: int) -> dict:
    """Layer ``i`` of a stacked segment, in fp32."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i].float() for k, v in p.items()}


def _attention(cfg: dict, p: dict, x: Tensor, prec: Precision, q_rows: int) -> Tensor:
    b, s, d = x.shape
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = prec.mm(x, p["wq"].reshape(d, h * hd)).view(b, s, h, hd)
    k = prec.mm(x, p["wk"].reshape(d, kv * hd)).view(b, s, kv, hd)
    v = prec.mm(x, p["wv"].reshape(d, kv * hd)).view(b, s, kv, hd)
    pos = torch.arange(s, device=x.device)
    if cfg.get("use_rope"):
        q, k = _rope(q, pos, cfg["rope_theta"]), _rope(k, pos, cfg["rope_theta"])
    group = h // kv
    k = k.repeat_interleave(group, dim=2).transpose(1, 2)  # [B, H, S, D]
    v = v.repeat_interleave(group, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    window = cfg.get("sliding_window")
    outs = []
    for q0 in range(0, s, q_rows):
        q1 = min(q0 + q_rows, s)
        k0 = max(0, q0 - window + 1) if window else 0
        qi, kj = pos[q0:q1, None], pos[None, k0:q1]
        keep = kj <= qi
        if window:
            keep = keep & (qi - kj < window)
        scores = prec.mm(q[:, :, q0:q1], k[:, :, k0:q1].transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(prec.mm(probs, v[:, :, k0:q1]))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, h * hd)
    return prec.mm(o, p["wo"].reshape(h * hd, d))


def _mlp(cfg: dict, p: dict, x: Tensor, prec: Precision) -> Tensor:
    if cfg["mlp_style"] == "swiglu":
        hid = F.silu(prec.mm(x, p["wg"])) * prec.mm(x, p["wi"])
    else:
        hid = F.gelu(prec.mm(x, p["wi"]), approximate="tanh")
    return prec.mm(hid, p["wo"])


def hidden(w: dict, tok: Tensor, cfg: dict, prec: Precision = FP32,
           q_rows: int = 1 << 30) -> Tensor:
    """The final normed hidden states [B, S, d] of ``tok`` [B, S]."""
    x = w["embed"][tok.long()].float()
    seg = w["segments"][0]
    for i in range(cfg["n_layers"]):
        p = _layer(seg, i)
        x = x + _attention(cfg, p["attn"], _norm(cfg, p["ln1"], x), prec, q_rows)
        x = x + _mlp(cfg, p["mlp"], _norm(cfg, p["ln2"], x), prec)
    return _norm(cfg, w["final_norm"], x)


def head(w: dict, x: Tensor, cfg: dict, prec: Precision = FP32) -> Tensor:
    table = w["embed"].t() if cfg["tie_embeddings"] else w["lm_head"]
    return prec.mm(x, table.float())


def forward(w: dict, tok: Tensor, cfg: dict, prec: Precision = FP32,
            q_rows: int = 1 << 30) -> Tensor:
    """Logits [B, S, V] in fp32."""
    return head(w, hidden(w, tok, cfg, prec, q_rows), cfg, prec)


def loss(w: dict, tok: Tensor, cfg: dict, prec: Precision = FP32) -> Tensor:
    logits = forward(w, tok, cfg, prec)
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v), tok[:, 1:].reshape(-1).long())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def lr_at(opt: dict, step: int) -> float:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_ratio · lr``."""
    warm, total = opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return opt["lr"] * step / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return opt["lr"] * (opt["min_lr_ratio"]
                        + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * t)))


def gradient(w: dict, batch: Tensor, cfg: dict, rows: int, prec: Precision = FP32,
             ranks=None) -> tuple[float, list[Tensor]]:
    """The mean loss over ``batch`` [B, S] and its gradient per leaf, summed
    block by block of ``rows`` rows. ``ranks`` (``(n, sum_over_ranks)``,
    each rank holding its own rows) makes both the mean over every rank's."""
    leaves = [t.detach().requires_grad_() for t in _leaves(w)]
    tree = _rebuild(w, iter(leaves))
    grads = [torch.zeros_like(t) for t in leaves]
    total = torch.zeros((), dtype=torch.float64, device=batch.device)
    b = batch.shape[0]
    for r0 in range(0, b, rows):
        part = batch[r0:r0 + rows]
        frac = part.shape[0] / b
        lo = loss(tree, part, cfg, prec) * frac
        for acc, g in zip(grads, torch.autograd.grad(lo, leaves)):
            acc += g
        total += lo.detach().double()
    if ranks is not None:
        n, sum_over_ranks = ranks
        flat = torch.cat([g.reshape(-1) for g in grads] + [total.float().reshape(1)])
        flat = sum_over_ranks(flat) / n
        sizes = [g.numel() for g in grads]
        grads = [t.view_as(g) for t, g in zip(flat[:-1].split(sizes), grads)]
        total = flat[-1].double()
    return float(total), grads


def train(w: dict, batches: list[Tensor], cfg: dict, opt: dict, rows: int,
          prec: Precision = FP32, ranks=None) -> dict:
    """``len(batches)`` AdamW steps from ``w``: each step's loss, the norm of
    each leaf's clipped first gradient, and the norm of each leaf's change
    after the last step."""
    params = [t.detach().clone() for t in _leaves(w)]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first = [], None
    b1, b2 = opt["b1"], opt["b2"]
    for step, batch in enumerate(batches, start=1):
        lo, g = gradient(_rebuild(w, iter(params)), batch, cfg, rows, prec, ranks)
        losses.append(lo)
        gn = math.sqrt(sum(float(x.double().square().sum()) for x in g))
        clip = min(opt["grad_clip"] / max(gn, 1e-9), 1.0)
        g = [x * clip for x in g]
        if first is None:
            first = [float(x.norm()) for x in g]
        lr = lr_at(opt, step)
        for i, (p, gi) in enumerate(zip(params, g)):
            m[i] = b1 * m[i] + (1 - b1) * gi
            v[i] = b2 * v[i] + (1 - b2) * gi * gi
            mhat, vhat = m[i] / (1 - b1 ** step), v[i] / (1 - b2 ** step)
            params[i] = p - lr * (mhat / (vhat.sqrt() + opt["eps"]) + opt["weight_decay"] * p)
        del g
    change = [float((p - p0).norm()) for p, p0 in zip(params, _leaves(w))]
    return {"losses": losses, "grad_norms": first, "change_norms": change}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@torch.no_grad()
def served_gaps(w: dict, prompts: Tensor, served: Tensor, cfg: dict, q_rows: int,
                prec: Precision = FP32, judge: dict | None = None) -> float:
    """The widest gap, over every position of every prompt, by which the
    served token's logit lies below the best logit of ``judge`` (``w`` when
    None) in fp32. With ``served`` None the served tokens are ``prec``'s own
    first choices (the control's reading)."""
    judge = w if judge is None else judge
    widest = 0.0
    for i in range(prompts.shape[0]):
        tok = prompts[i:i + 1]
        ref = forward(judge, tok, cfg, FP32, q_rows)[0]
        pick = (forward(w, tok, cfg, prec, q_rows)[0].argmax(-1) if served is None
                else served[i].long())
        gap = ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]
        widest = max(widest, float(gap.max()))
        del ref
    return widest
