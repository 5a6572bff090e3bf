"""State-space and recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM / sLSTM).

The twin of ``repro.models.ssm``, function for function, as plain
functions on tensors with params as dicts:

  * Mamba2 runs the chunked SSD form for a full sequence (quadratic
    products inside each chunk, then a scan over the chunk states) and the
    O(1) recurrence for decode;
  * mLSTM runs its parallel, stabilized exponential-gating form for a full
    sequence and the matrix-memory recurrence for decode;
  * sLSTM is sequential by nature (a hidden-to-hidden recurrence).

Each ``jax.lax.scan`` of the JAX package is a Python loop here: over the
chunks (Mamba2) and over the time steps (sLSTM). Weights are cast to the
input dtype at each use; the SSD and mLSTM interiors run in fp32. The JAX
package has no Pallas kernel for any of these, so neither has the port.

``init_*`` take an explicit ``torch.Generator`` and stack independent draws
along ``lead`` (a segment's layer axis), as ``layers.init_mlp`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import loop_fold
from repro_torch.models.layers import dense_init, rmsnorm

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# depthwise causal conv (shared by the mamba2 and mLSTM front ends)
# ---------------------------------------------------------------------------

def causal_conv1d(x: Tensor, w: Tensor, b: Tensor | None = None) -> Tensor:
    """x [B,S,C], w [K,C] depthwise causal cross-correlation (K − 1 zeros on
    the left, the kernel not flipped); returns [B,S,C]."""
    k = w.shape[0]
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))
    return F.conv1d(xp, w.t()[:, None, :], b, groups=x.shape[-1]).transpose(1, 2)


def conv_step(x_new: Tensor, conv_state: Tensor, w: Tensor, b: Tensor | None = None
              ) -> tuple[Tensor, Tensor]:
    """One-token causal conv. x_new [B,C]; conv_state [B,K-1,C] (history)."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)  # [B,K,C]
    out = torch.einsum("bkc,kc->bc", window, w)
    if b is not None:
        out = out + b
    return out, window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator, d: int, d_state: int, headdim: int = 64,
                expand: int = 2, conv_k: int = 4, dtype=torch.float32,
                lead: tuple[int, ...] = ()) -> dict:
    d_inner = expand * d
    nheads = d_inner // headdim
    conv_dim = d_inner + 2 * d_state  # x + B + C share the conv
    dev, f32 = gen.device, torch.float32
    a_log = torch.log(torch.linspace(1.0, 16.0, nheads, dtype=f32, device=dev))
    return {
        # in_proj → [z, xBC, dt]
        "w_in": dense_init(gen, (d, 2 * d_inner + 2 * d_state + nheads), dtype=dtype,
                           lead=lead),
        "conv_w": (torch.randn(lead + (conv_k, conv_dim), generator=gen, device=dev)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros(lead + (nheads,), dtype=f32, device=dev),
        "A_log": a_log.expand(lead + (nheads,)).clone(),
        "D": torch.ones(lead + (nheads,), dtype=f32, device=dev),
        "norm_w": torch.zeros(lead + (d_inner,), dtype=f32, device=dev),
        "w_out": dense_init(gen, (d_inner, d), dtype=dtype, lead=lead),
    }


def _mamba2_split(p: dict, x: Tensor, d: int, d_state: int, headdim: int, expand: int):
    d_inner = expand * d
    nheads = d_inner // headdim
    proj = x @ p["w_in"].to(x.dtype)
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner: 2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state:]
    return z, xBC, dt, d_inner, nheads


def mamba2_forward(p: dict, x: Tensor, d_state: int, headdim: int = 64,
                   expand: int = 2, chunk: int = 128) -> Tensor:
    """Training/prefill path: chunked SSD. x [B,S,D] → [B,S,D]."""
    b, s, d = x.shape
    dt_in = x.dtype
    z, xBC, dt, d_inner, nheads = _mamba2_split(p, x, d, d_state, headdim, expand)
    xBC = F.silu(causal_conv1d(xBC, p["conv_w"].to(dt_in), p["conv_b"].to(dt_in)))
    xs = xBC[..., :d_inner].reshape(b, s, nheads, headdim)
    B = xBC[..., d_inner:d_inner + d_state]  # single group, shared over heads
    C = xBC[..., d_inner + d_state:]
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B,S,H]
    A = -torch.exp(p["A_log"])  # [H], negative
    # pad the sequence to a chunk multiple
    pad = (-s) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        B, C, dt = (F.pad(t, (0, 0, 0, pad)) for t in (B, C, dt))
    sp = s + pad
    nc = sp // chunk
    # reshape to chunks: [B, nc, Q, ...]
    xs = xs.reshape(b, nc, chunk, nheads, headdim).float()
    B = B.reshape(b, nc, chunk, d_state).float()
    C = C.reshape(b, nc, chunk, d_state).float()
    dt = dt.reshape(b, nc, chunk, nheads)

    loga = dt * A  # [B,nc,Q,H] log decay per step
    cum = torch.cumsum(loga, dim=2)  # inclusive cumulative log decay
    # intra-chunk: M[t,s] = exp(cum[t]-cum[s]) for t>=s (decay s→t, exclusive of s)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    tri = tri[None, None, :, :, None]
    # mask BEFORE exp: the upper triangle's differences are large and positive,
    # so exp would overflow there (and a backward would meet 0·inf = NaN)
    M = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    G = torch.einsum("bctn,bcsn->bcts", C, B)  # [B,nc,Q,Q]
    W = G[..., None] * M  # [B,nc,Q,Q,H]
    xdt = xs * dt[..., None]  # dt_s B_s x_s (B applied via G)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", W, xdt)
    # chunk end states: S_c = Σ_s exp(cum[Q-1]-cum[s]) dt_s B_s ⊗ x_s → [B,nc,H,P,N]
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [B,nc,Q,H]
    S_c = torch.einsum("bcsh,bcsn,bcshp->bchpn", decay_to_end * dt, B, xs)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B,nc,H] total chunk decay
    # the scan over chunks keeps the state *entering* each chunk, for y_inter
    h = torch.zeros((b, nheads, headdim, d_state), dtype=torch.float32, device=x.device)
    h_in = []
    repeated = loop_fold.FOLD.get()  # a counter's fold of the loop
    if repeated is not None and nc >= 3 and not torch.is_grad_enabled():
        h_in.append(h)
        h = h * chunk_decay[:, 0, :, None, None] + S_c[:, 0]
        h_in.append(h)
        with repeated(nc - 1, [], lambda: []):  # chunk 1 stands for chunks 1 … nc − 1
            h = h * chunk_decay[:, 1, :, None, None] + S_c[:, 1]
        h_in += [h] * (nc - 2)
    else:
        for c in range(nc):
            h_in.append(h)
            h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_in = torch.stack(h_in, dim=1)  # [B,nc,H,P,N]
    y_inter = torch.einsum("bcth,bctn,bchpn->bcthp", torch.exp(cum), C, h_in)
    y = (y_intra + y_inter).reshape(b, sp, nheads, headdim)[:, :s]
    y = y + xs.reshape(b, sp, nheads, headdim)[:, :s] * p["D"][None, None, :, None]
    y = y.reshape(b, s, d_inner).to(dt_in)
    y = y * F.silu(z)  # gated
    y = rmsnorm(y, p["norm_w"])
    return y @ p["w_out"].to(dt_in)


def init_mamba2_state(batch: int, d: int, d_state: int, headdim: int = 64,
                      expand: int = 2, conv_k: int = 4, dtype=torch.float32,
                      device=None) -> dict:
    d_inner = expand * d
    nheads = d_inner // headdim
    return {
        "h": torch.zeros((batch, nheads, headdim, d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, conv_k - 1, d_inner + 2 * d_state), dtype=dtype,
                            device=device),
    }


def mamba2_step(p: dict, x: Tensor, state: dict, d_state: int, headdim: int = 64,
                expand: int = 2) -> tuple[Tensor, dict]:
    """O(1) decode step. x [B,1,D] → ([B,1,D], new state)."""
    b, _, d = x.shape
    dt_in = x.dtype
    z, xBC, dt, d_inner, nheads = _mamba2_split(p, x[:, 0], d, d_state, headdim, expand)
    xBC, conv_state = conv_step(xBC, state["conv"].to(dt_in),
                                p["conv_w"].to(dt_in), p["conv_b"].to(dt_in))
    xBC = F.silu(xBC)
    xs = xBC[..., :d_inner].reshape(b, nheads, headdim).float()
    B = xBC[..., d_inner:d_inner + d_state].float()
    C = xBC[..., d_inner + d_state:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B,H]
    A = -torch.exp(p["A_log"])
    dec = torch.exp(dt * A)  # [B,H]
    h = state["h"] * dec[:, :, None, None] + torch.einsum("bh,bn,bhp->bhpn", dt, B, xs)
    y = torch.einsum("bn,bhpn->bhp", C, h) + xs * p["D"][None, :, None]
    y = y.reshape(b, d_inner).to(dt_in)
    y = y * F.silu(z)
    y = rmsnorm(y, p["norm_w"])
    out = (y @ p["w_out"].to(dt_in))[:, None, :]
    return out, {"h": h, "conv": conv_state.to(state["conv"].dtype)}


# ---------------------------------------------------------------------------
# xLSTM — mLSTM (matrix memory)
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, d: int, n_heads: int, expand: int = 2,
               conv_k: int = 4, dtype=torch.float32, lead: tuple[int, ...] = ()) -> dict:
    d_inner = expand * d
    hd = d_inner // n_heads
    dev, f32 = gen.device, torch.float32
    if_bias = torch.cat([torch.zeros(n_heads, dtype=f32, device=dev),
                         torch.full((n_heads,), 3.0, dtype=f32, device=dev)])
    return {
        "w_up": dense_init(gen, (d, 2 * d_inner), dtype=dtype, lead=lead),  # [x_m, z]
        "conv_w": (torch.randn(lead + (conv_k, d_inner), generator=gen, device=dev)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros(lead + (d_inner,), dtype=dtype, device=dev),
        "wq": dense_init(gen, (d_inner, n_heads, hd), dtype=dtype, lead=lead),
        "wk": dense_init(gen, (d_inner, n_heads, hd), dtype=dtype, lead=lead),
        "wv": dense_init(gen, (d_inner, n_heads, hd), dtype=dtype, lead=lead),
        "w_if": dense_init(gen, (d_inner, 2 * n_heads), scale=0.1, dtype=f32, lead=lead),
        "if_bias": if_bias.expand(lead + (2 * n_heads,)).clone(),
        "norm_w": torch.zeros(lead + (d_inner,), dtype=f32, device=dev),
        "w_down": dense_init(gen, (d_inner, d), dtype=dtype, lead=lead),
    }


def mlstm_forward(p: dict, x: Tensor, n_heads: int, expand: int = 2) -> Tensor:
    """Parallel (quadratic) stabilized mLSTM. x [B,S,D]."""
    b, s, d = x.shape
    dt_in = x.dtype
    d_inner = expand * d
    hd = d_inner // n_heads
    up = x @ p["w_up"].to(dt_in)
    xm, z = up[..., :d_inner], up[..., d_inner:]
    xc = F.silu(causal_conv1d(xm, p["conv_w"].to(dt_in), p["conv_b"].to(dt_in)))
    q = torch.einsum("bsd,dhk->bshk", xc, p["wq"].to(dt_in))
    k = torch.einsum("bsd,dhk->bshk", xc, p["wk"].to(dt_in))
    v = torch.einsum("bsd,dhk->bshk", xm, p["wv"].to(dt_in))
    gif = xc.float() @ p["w_if"] + p["if_bias"]  # [B,S,2H]
    i_raw, f_raw = gif[..., :n_heads], gif[..., n_heads:]
    logf = F.logsigmoid(f_raw)  # [B,S,H]
    cum_f = torch.cumsum(logf, dim=1)
    # D_log[t,s] = F_t − F_s + i_s  (t ≥ s)
    dlog = cum_f[:, :, None, :] - cum_f[:, None, :, :] + i_raw[:, None, :, :]  # [B,T,S,H]
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
    dlog = torch.where(tri[None, :, :, None], dlog, -math.inf)
    m = torch.amax(dlog, dim=2)  # [B,T,H] row stabilizer
    w = torch.exp(dlog - m[:, :, None, :])  # [B,T,S,H]
    scores = torch.einsum("bthk,bshk->btsh", q.float(), k.float()) / math.sqrt(hd)
    sw = scores * w
    denom = torch.maximum(torch.abs(sw.sum(dim=2)), torch.exp(-m))  # [B,T,H]
    h = torch.einsum("btsh,bshk->bthk", sw, v.float()) / denom[..., None]
    h = h.reshape(b, s, d_inner)
    h = rmsnorm(h.to(dt_in), p["norm_w"])
    h = h * F.silu(z)
    return h @ p["w_down"].to(dt_in)


def init_mlstm_state(batch: int, d: int, n_heads: int, expand: int = 2,
                     conv_k: int = 4, dtype=torch.float32, device=None) -> dict:
    d_inner = expand * d
    hd = d_inner // n_heads
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, n_heads, hd, hd), dtype=f32, device=device),
        "n": torch.zeros((batch, n_heads, hd), dtype=f32, device=device),
        "m": torch.full((batch, n_heads), -math.inf, dtype=f32, device=device),
        "conv": torch.zeros((batch, conv_k - 1, d_inner), dtype=dtype, device=device),
    }


def mlstm_step(p: dict, x: Tensor, state: dict, n_heads: int, expand: int = 2
               ) -> tuple[Tensor, dict]:
    """Recurrent mLSTM step. x [B,1,D]. The first step's ``m`` is −inf, so
    its forget term is exp(logf − inf − m_new) = 0 (never −inf − (−inf))."""
    b, _, d = x.shape
    dt_in = x.dtype
    d_inner = expand * d
    hd = d_inner // n_heads
    up = x[:, 0] @ p["w_up"].to(dt_in)
    xm, z = up[..., :d_inner], up[..., d_inner:]
    xc, conv_state = conv_step(xm, state["conv"].to(dt_in),
                               p["conv_w"].to(dt_in), p["conv_b"].to(dt_in))
    xc = F.silu(xc)
    q = torch.einsum("bd,dhk->bhk", xc, p["wq"].to(dt_in)).float()
    k = torch.einsum("bd,dhk->bhk", xc, p["wk"].to(dt_in)).float()
    v = torch.einsum("bd,dhk->bhk", xm, p["wv"].to(dt_in)).float()
    gif = xc.float() @ p["w_if"] + p["if_bias"]
    i_raw, f_raw = gif[..., :n_heads], gif[..., n_heads:]
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + state["m"], i_raw)  # [B,H]
    f_s = torch.exp(logf + state["m"] - m_new)
    i_s = torch.exp(i_raw - m_new)
    C = state["C"] * f_s[..., None, None] + i_s[..., None, None] * torch.einsum(
        "bhk,bhn->bhkn", v, k)
    n = state["n"] * f_s[..., None] + i_s[..., None] * k
    num = torch.einsum("bhkn,bhn->bhk", C, q / math.sqrt(hd))
    den = torch.maximum(torch.abs(torch.einsum("bhn,bhn->bh", n, q / math.sqrt(hd))),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, d_inner)
    h = rmsnorm(h.to(dt_in), p["norm_w"])
    h = h * F.silu(z)
    out = (h @ p["w_down"].to(dt_in))[:, None, :]
    return out, {"C": C, "n": n, "m": m_new, "conv": conv_state.to(state["conv"].dtype)}


# ---------------------------------------------------------------------------
# xLSTM — sLSTM (scalar memory, sequential)
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, d: int, n_heads: int, dtype=torch.float32,
               lead: tuple[int, ...] = ()) -> dict:
    hd = d // n_heads
    dev, f32 = gen.device, torch.float32
    bias = torch.cat([torch.zeros(d, dtype=f32, device=dev),
                      torch.full((d,), 3.0, dtype=f32, device=dev),
                      torch.zeros(2 * d, dtype=f32, device=dev)])
    return {
        # input projections for gates i, f, z, o
        "w_x": dense_init(gen, (d, 4 * d), dtype=dtype, lead=lead),
        # block-diagonal recurrent weights per head: [H, hd, 4*hd]
        "w_h": (torch.randn(lead + (n_heads, hd, 4 * hd), generator=gen, device=dev)
                / math.sqrt(hd)).to(dtype),
        "bias": bias.expand(lead + (4 * d,)).clone(),
        "norm_w": torch.zeros(lead + (d,), dtype=f32, device=dev),
        "w_up": dense_init(gen, (d, 2 * d), dtype=dtype, lead=lead),  # GLU-style post-MLP
        "w_down": dense_init(gen, (d, d), dtype=dtype, lead=lead),
    }


def init_slstm_state(batch: int, d: int, n_heads: int, device=None) -> dict:
    f32 = torch.float32
    return {
        "c": torch.zeros((batch, d), dtype=f32, device=device),
        "n": torch.ones((batch, d), dtype=f32, device=device),  # 1, not 0
        "h": torch.zeros((batch, d), dtype=f32, device=device),
        "m": torch.zeros((batch, d), dtype=f32, device=device),
    }


def _slstm_cell(p: dict, xt: Tensor, st: dict, n_heads: int) -> dict:
    """One sLSTM timestep. xt [B, 4d] (pre-projected input)."""
    b = xt.shape[0]
    d = st["h"].shape[-1]
    hd = d // n_heads
    hh = st["h"].reshape(b, n_heads, hd)
    rec = torch.einsum("bhk,hkj->bhj", hh, p["w_h"].float()).reshape(b, 4 * d)
    g = xt.float() + rec + p["bias"]
    i_raw, f_raw, z_raw, o_raw = torch.split(g, d, dim=-1)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + st["m"], i_raw)
    i_s = torch.exp(i_raw - m_new)
    f_s = torch.exp(logf + st["m"] - m_new)
    c = f_s * st["c"] + i_s * torch.tanh(z_raw)
    n = f_s * st["n"] + i_s
    h = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_out(p: dict, h: Tensor, d: int) -> Tensor:
    """The cell output's norm and GLU-style MLP (gelu, tanh form)."""
    h = rmsnorm(h, p["norm_w"])
    up = h @ p["w_up"].to(h.dtype)
    h = F.gelu(up[..., :d], approximate="tanh") * up[..., d:]
    return h @ p["w_down"].to(h.dtype)


def slstm_forward(p: dict, x: Tensor, n_heads: int) -> Tensor:
    """Sequential sLSTM over time (a Python loop over the steps). x [B,S,D]."""
    b, s, d = x.shape
    dt_in = x.dtype
    xp = x @ p["w_x"].to(dt_in)  # [B,S,4d] (batched input projection)
    cell_p = {**p, "w_h": p["w_h"].float()}  # cast once, not once per step
    st = init_slstm_state(b, d, n_heads, device=x.device)
    repeated = loop_fold.FOLD.get()  # a counter's fold of the loop
    if repeated is not None and s >= 3:
        st = _slstm_cell(cell_p, xp[:, 0], st, n_heads)
        h0, xt = st["h"], xp[:, 1]
        with repeated(s - 1, [xt, *cell_p.values(), *st.values()], lambda: [st["h"]]):
            st = _slstm_cell(cell_p, xt, st, n_heads)
        h = torch.cat([h0[:, None], st["h"][:, None].expand(b, s - 1, d)], dim=1)
        return _slstm_out(p, h.to(dt_in), d)
    hs = []
    for t in range(s):
        st = _slstm_cell(cell_p, xp[:, t], st, n_heads)
        hs.append(st["h"])
    h = torch.stack(hs, dim=1).to(dt_in)  # [B,S,D]
    return _slstm_out(p, h, d)


def slstm_step(p: dict, x: Tensor, state: dict, n_heads: int) -> tuple[Tensor, dict]:
    """One-token sLSTM decode. x [B,1,D]."""
    dt_in = x.dtype
    d = x.shape[-1]
    xt = x[:, 0] @ p["w_x"].to(dt_in)
    st = _slstm_cell(p, xt, state, n_heads)
    return _slstm_out(p, st["h"].to(dt_in), d)[:, None, :], st
