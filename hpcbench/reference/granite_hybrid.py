"""Plain reference of granite-4.0-h-small (``model_type``
granitemoehybrid) as one card of a four-card expert split holds it: a
pre-norm stack of Mamba-2 mixers and NoPE GQA attention layers, each
followed by a MoE over this card's share of the experts plus a shared
expert, then a final norm and the tied head.  Plain torch in float32 with
TF32 off (``decoder.precise``); it imports nothing of the program and
works everything out for itself from the model description of
``configs/granite-4.0-h-small.json`` (``model``).  The weights are
upcast one layer at a time.

What the configuration states, and so the reference computes (``m`` the
model description; L layers of kind ``block_pattern[i % period]``):

- the embedding times ``embedding_multiplier``; every residual branch
  (mixer or attention, then the FFN) times ``residual_multiplier``; RMS
  norms with eps ``rms_norm_eps``; logits = rmsnorm(x) @ embed^T over
  ``logits_scaling``;
- a Mamba-2 mixer: ``in_proj`` to [z, xBC, dt]; the depthwise causal conv
  of width ``conv_width`` with bias over xBC, then silu; x, B, C split
  from it (one B/C group); dt = softplus(dt + dt_bias), A = -exp(A_log);
  per head h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D
  x_t, computed chunk by chunk (``SSD_CHUNK`` positions: the exact
  closed form within a chunk, the state carried between chunks); then
  rmsnorm(y * silu(z)) * w (fp32) and ``out_proj``;
- attention: q, k, v with no positional embedding, scores times
  ``attention_multiplier``, causal; q head h reads kv head h // (n_heads
  / n_kv_heads);
- the MoE: the router's logits over all ``n_experts`` (fp32), the top
  ``top_k`` and softmax over their logits (GraniteMoe's rule); the card
  holds experts [``first``, ``first + held``) (``first`` 0 where the
  model names none) and computes their part of the result only; an expert keeps at most C = max(k, int(T k / E cf)) of
  its assignments, the first in token-major order (t0k0, t0k1, ..., t1k0,
  ...), and drops the rest (the program's departure from the source,
  which routes every token); plus the shared SwiGLU expert of width
  ``shared_ff``, on every token.

The weights (``make_params``) are laid out as the program's parameter
tree, stacked over periods (one repetition of ``block_pattern``):
{"embed", "final_norm", "layers": {"e<i>": {"ln1", "mamba" | "attn",
"ln2", "moe", "shared"}}}.  ``Numerics`` and ``Fp8`` are
``decoder``'s: every matmul of a bf16 weight goes through them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from hpcbench.reference.data import STREAM_WEIGHTS, generator, trunc_normal
from hpcbench.reference.decoder import (Fp8, Numerics, flat, name,  # noqa: F401
                                        precise, rms_norm)

Q_BLOCK = 512            # query rows of one attention block
SSD_CHUNK = 256          # positions of one scan chunk (the source's)


def _dtype(m: dict):
    return getattr(torch, m["dtype"])


def _period(m: dict) -> int:
    return len(m["block_pattern"])


def _inv_softplus_dt(nh: int) -> torch.Tensor:
    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), nh,
                                  dtype=torch.float32))
    return dt + torch.log(-torch.expm1(-dt))


def param_specs(m: dict) -> Dict[tuple, tuple]:
    """{path: (shape, dtype, init)}: init a std (truncated normal), None
    (ones), 0.0 (zeros) or a function of the head count (the mixer's
    dt_bias and A_log, the source's rule with no draw)."""
    P = m["n_layers"] // _period(m)
    d, V = m["d_model"], m["vocab"]
    H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    nh, hd, st = m["mamba_heads"], m["mamba_head_dim"], m["ssm_state"]
    inner = nh * hd
    conv = inner + 2 * m["mamba_groups"] * st
    f, fs = m["d_ff"], m["shared_ff"]
    moe = m["moe"]
    E, held = moe["n_experts"], moe["held"]
    bf, f32 = _dtype(m), torch.float32
    out = {("embed",): ((V, d), bf, 1.0),
           ("final_norm",): ((d,), bf, None)}
    for i, kind in enumerate(m["block_pattern"]):
        e = ("layers", f"e{i}")
        out[e + ("ln1",)] = ((P, d), bf, None)
        if kind == "mamba":
            mx = e + ("mamba",)
            out[mx + ("in_proj",)] = ((P, d, inner + conv + nh), bf,
                                      d ** -0.5)
            out[mx + ("conv",)] = ((P, m["conv_width"], conv), bf,
                                   m["conv_width"] ** -0.5)
            out[mx + ("conv_bias",)] = ((P, conv), bf, 0.0)
            out[mx + ("dt_bias",)] = ((P, nh), f32, _inv_softplus_dt)
            out[mx + ("A_log",)] = ((P, nh), f32, lambda n: torch.log(
                torch.arange(1, n + 1, dtype=torch.float32)))
            out[mx + ("D",)] = ((P, nh), f32, None)
            out[mx + ("norm",)] = ((P, inner), bf, None)
            out[mx + ("out_proj",)] = ((P, inner, d), bf, inner ** -0.5)
        else:
            a = e + ("attn",)
            out[a + ("wq",)] = ((P, d, H, D), bf, d ** -0.5)
            out[a + ("wk",)] = ((P, d, Hkv, D), bf, d ** -0.5)
            out[a + ("wv",)] = ((P, d, Hkv, D), bf, d ** -0.5)
            out[a + ("wo",)] = ((P, H, D, d), bf, (H * D) ** -0.5)
        out[e + ("ln2",)] = ((P, d), bf, None)
        out[e + ("moe", "router")] = ((P, d, E), f32, d ** -0.5)
        out[e + ("moe", "w1")] = ((P, held, d, f), bf, d ** -0.5)
        out[e + ("moe", "w3")] = ((P, held, d, f), bf, d ** -0.5)
        out[e + ("moe", "w2")] = ((P, held, f, d), bf, f ** -0.5)
        out[e + ("shared", "w1")] = ((P, d, fs), bf, d ** -0.5)
        out[e + ("shared", "w3")] = ((P, d, fs), bf, d ** -0.5)
        out[e + ("shared", "w2")] = ((P, fs, d), bf, fs ** -0.5)
    return out


def make_params(m: dict, seed: int, device) -> dict:
    """The seeded weights as the program's tree, on ``device``: every
    drawn leaf from one generator on the device, in the order of
    ``param_specs``, truncated normals (+-2) of std 1/sqrt(fan-in) (the
    conv's fan-in its taps); norms and D ones, the conv's bias zeros,
    dt_bias and A_log by the source's rule."""
    gen = generator(device, seed, STREAM_WEIGHTS)
    tree: dict = {}
    for path, (shape, dtype, init) in param_specs(m).items():
        if init is None:
            leaf = torch.ones(shape, dtype=dtype, device=device)
        elif callable(init):
            leaf = init(shape[-1]).to(device, dtype).expand(shape).clone()
        elif init == 0.0:
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        else:
            leaf = trunc_normal(shape, init, dtype, gen)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def causal_conv(x, w, bias):
    """Depthwise causal conv: x (B, S, C), w (W, C), bias (C,); output t
    is sum_i w[i] x[t - W + 1 + i] + bias, zeros before the start."""
    W = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = bias.expand(x.shape).clone()
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i]
    return out


def ssd(xv, logdecay, Bm, Cm, chunk: int = SSD_CHUNK):
    """The scan of every head from a zero state: xv (B, S, nh, hd) with
    dt folded in, logdecay (B, S, nh), B / C (B, S, st).  Within a chunk
    y_t = sum_{s <= t} exp(cum_t - cum_s) (C_t . B_s) xv_s + exp(cum_t)
    C_t h^T, with h the state entering the chunk; then h = exp(cum_last)
    h + sum_s exp(cum_last - cum_s) xv_s B_s^T.  Returns (y, h_final (B,
    nh, hd, st))."""
    B, S, nh, hd = xv.shape
    st = Bm.shape[-1]
    h = xv.new_zeros((B, nh, hd, st))
    ys = []
    for lo in range(0, S, chunk):
        hi = min(S, lo + chunk)
        c = hi - lo
        x = xv[:, lo:hi]
        cum = torch.cumsum(logdecay[:, lo:hi], dim=1)          # (B, c, nh)
        Bc, Cc = Bm[:, lo:hi], Cm[:, lo:hi]
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # (B,t,s,nh)
        tri = torch.ones((c, c), dtype=torch.bool, device=xv.device).tril()
        seg = seg.masked_fill(~tri[None, :, :, None], float("-inf"))
        g = torch.exp(seg) * (Cc @ Bc.transpose(1, 2))[..., None]
        y = (g.permute(0, 3, 1, 2) @ x.permute(0, 2, 1, 3))    # (B,nh,t,hd)
        y = y + torch.exp(cum).permute(0, 2, 1)[..., None] * (
            Cc[:, None] @ h.transpose(-1, -2))                 # C h^T
        ys.append(y.permute(0, 2, 1, 3))
        w = torch.exp(cum[:, -1:] - cum)                       # (B, c, nh)
        h = h * torch.exp(cum[:, -1])[..., None, None] + (
            (x * w[..., None]).permute(0, 2, 3, 1) @ Bc[:, None])
    return torch.cat(ys, dim=1), h


def mamba2(p: dict, x, m: dict, nx: Numerics) -> tuple:
    """The Mamba-2 mixer over x (B, S, d).  Returns (y, final state)."""
    B, S, _ = x.shape
    nh, hd, st = m["mamba_heads"], m["mamba_head_dim"], m["ssm_state"]
    inner = nh * hd
    z, xbc, dt = nx.mm(x, p["in_proj"]).split(
        [inner, inner + 2 * st, nh], dim=-1)
    xbc = F.silu(causal_conv(xbc, p["conv"], p["conv_bias"]))
    xin, Bm, Cm = xbc.split([inner, st, st], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    xh = xin.reshape(B, S, nh, hd)
    y, h = ssd(xh * dt[..., None], dt * -torch.exp(p["A_log"]), Bm, Cm)
    y = (y + p["D"][:, None] * xh).reshape(B, S, inner)
    y = y * F.silu(z)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True)
                        + m["rms_norm_eps"]) * p["norm"]
    return nx.mm(y, p["out_proj"]), h


def attention(q, k, v, scale: float, nx: Numerics):
    """Causal GQA attention, query rows in blocks of ``Q_BLOCK``, scores
    times ``scale``.  q (B, S, H, D), k/v (B, S, Hkv, D)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    outs = []
    for lo in range(0, S, Q_BLOCK):
        hi = min(S, lo + Q_BLOCK)
        s = nx.mm(qh[:, :, lo:hi], kh[:, :, :hi].transpose(-1, -2)) * scale
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        cols = torch.arange(hi, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        outs.append(nx.mm(torch.softmax(s, dim=-1), vh[:, :, :hi]))
    return torch.cat(outs, dim=2).transpose(1, 2)


def attn_layer(p: dict, x, m: dict, nx: Numerics) -> tuple:
    B, S, d = x.shape
    H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = nx.mm(x, p["wq"].reshape(d, H * D)).view(B, S, H, D)
    k = nx.mm(x, p["wk"].reshape(d, Hkv * D)).view(B, S, Hkv, D)
    v = nx.mm(x, p["wv"].reshape(d, Hkv * D)).view(B, S, Hkv, D)
    o = attention(q, k, v, m["attention_multiplier"], nx)
    return nx.mm(o.reshape(B, S, H * D), p["wo"].reshape(H * D, d)), k, v


def swiglu(x, w1, w3, w2, nx: Numerics):
    return nx.mm(F.silu(nx.mm(x, w1)) * nx.mm(x, w3), w2)


def moe(p: dict, x, m: dict, nx: Numerics):
    """This card's part of the MoE over x (B, S, d)."""
    cfg = m["moe"]
    E, k = cfg["n_experts"], cfg["top_k"]
    first, held = cfg.get("first", 0), cfg["held"]
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    top, eidx = torch.topk(xf @ p["router"], k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    cap = max(k, int(T * k / E * cfg["capacity_factor"]))
    flat_e, flat_g = eidx.reshape(-1), gates.reshape(-1)
    y = torch.zeros_like(xf)
    for e in range(first, first + held):
        idx = torch.nonzero(flat_e == e).squeeze(1)[:cap]
        tok = idx // k
        j = e - first
        ye = swiglu(xf[tok], p["w1"][j], p["w3"][j], p["w2"][j], nx)
        y.index_add_(0, tok, ye * flat_g[idx, None])
    return y.reshape(B, S, d)


def _layer_params(params: dict, i: int, m: dict) -> tuple:
    """(kind, layer i's weights in fp32)."""
    period = _period(m)
    entry = params["layers"][f"e{i % period}"]

    def take(t):
        if isinstance(t, dict):
            return {k: take(v) for k, v in t.items()}
        return t[i // period].float()
    return m["block_pattern"][i % period], take(entry)


@torch.no_grad()
def forward(params: dict, m: dict, tokens, nx: Numerics,
            on_layer: Optional[Callable] = None, last: int = 1):
    """Logits (B, last, V) at the last ``last`` positions of a forward
    over ``tokens`` (B, S), layer by layer; ``on_layer(i, kind, state)``
    sees each layer's cache: (k, v) of an attention layer, the final
    state of a mixer."""
    eps, rm = m["rms_norm_eps"], m["residual_multiplier"]
    x = params["embed"][tokens].float() * m["embedding_multiplier"]
    for i in range(m["n_layers"]):
        kind, p = _layer_params(params, i, m)
        h = rms_norm(x, p["ln1"], eps)
        if kind == "mamba":
            y, state = mamba2(p["mamba"], h, m, nx)
        else:
            y, kk, vv = attn_layer(p["attn"], h, m, nx)
            state = (kk, vv)
        if on_layer is not None:
            on_layer(i, kind, state)
        x = x + y * rm
        h = rms_norm(x, p["ln2"], eps)
        s = p["shared"]
        y = moe(p["moe"], h, m, nx) + swiglu(h, s["w1"], s["w3"], s["w2"],
                                             nx)
        x = x + y * rm
        del p, h, y
    h = rms_norm(x[:, -last:], params["final_norm"].float(), eps)
    return nx.mm(h, params["embed"].float().t()) / m["logits_scaling"]


def prefill(params: dict, m: dict, tokens, nx: Numerics,
            on_layer: Optional[Callable] = None):
    """Last-position logits (B, V) of a prefill of ``tokens``."""
    return forward(params, m, tokens, nx, on_layer)[:, -1]
