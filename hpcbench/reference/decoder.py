"""Plain reference of the decoder both configurations run: a pre-norm
stack of causal GQA attention with rotary positions, each layer followed
by a gated (SwiGLU) MLP or a mixture of experts, then a final norm and an
untied head.  Plain torch in float32 with TF32 off (``precise``); it
imports nothing of the program and works everything (rope tables, masks,
routing, capacity) out for itself from the model description of
``configs/<name>.json`` (``model``).

What the configuration states, and so the reference computes:

- RMS norm with eps ``rms_norm_eps``, times its weight;
- rope on q and k, the two halves of a head rotated, angles
  ``position / rope_theta ** (i / half)``;
- attention scaled by ``head_dim ** -0.5``; q head h reads kv head
  h // (n_heads / n_kv_heads);
- the MoE: fp32 router, softmax, top-k, gates renormalised over the k;
  an expert keeps at most C = max(k, int(T k / E cf)) of its assignments,
  the first in token-major order (t0k0, t0k1, ..., t1k0, ...), and drops
  the rest; the Switch aux loss E * sum_e mean_prob_e * load_e;
- the loss: mean over labelled tokens of (logsumexp - label logit) plus
  ``z_loss`` logsumexp^2, plus ``aux_loss_coef`` times the aux losses
  summed over layers;
- AdamW with global-norm clipping (``adamw_step``): moments in fp32, the
  update in fp32, the new parameter stored in the dtype the configuration
  keeps it in (bf16; the router fp32), decoupled decay on stored leaves
  of two or more dimensions.

The weights (``make_params``) are laid out as the program's parameter
tree, stacked over layers: {"embed", "unembed", "final_norm", "layers":
{"e0": {"ln1", "attn": {"wq", "wk", "wv", "wo"}, "ln2", "ffn" | "moe"}}}.

``Numerics`` computes every matmul of a bf16 weight or activation;
``Fp8`` is the control of the benchmark's comparison: the same reference
with each such matmul's operands rounded to float8 (e4m3 forward, e5m2
gradients, one scale a tensor), the precision below the configuration's
bf16.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hpcbench.reference.data import STREAM_WEIGHTS, generator, trunc_normal

Q_BLOCK = 512            # query rows of one attention block
LOSS_CHUNK = 1024        # positions of one loss chunk


def precise() -> None:
    """float32 matmuls in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------
class Numerics:
    """float32 matmuls."""
    name = "fp32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` with one scale for the tensor, in fp32."""
    if x.numel() == 0:
        return x
    top = torch.finfo(dtype).max
    s = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).to(torch.float32) * s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa = _round(a, torch.float8_e4m3fn)
        qb = _round(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, torch.float8_e5m2)
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            gb = (qa.reshape(-1, qa.shape[-1]).t()
                  @ qg.reshape(-1, qg.shape[-1]))
        else:
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


class Fp8(Numerics):
    """Each matmul's operands rounded to float8."""
    name = "fp8"

    def mm(self, a, b):
        return _Fp8Matmul.apply(a, b)



# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def _dtype(m: dict):
    return getattr(torch, m["dtype"])


def param_specs(m: dict) -> Dict[tuple, tuple]:
    """{path: (shape, dtype, std)}; std None means ones (a norm)."""
    L, d, f = m["n_layers"], m["d_model"], m["d_ff"]
    H, Hkv, D, V = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["vocab"]
    bf = _dtype(m)
    out = {("embed",): ((V, d), bf, 1.0),
           ("unembed",): ((d, V), bf, d ** -0.5),
           ("final_norm",): ((d,), bf, None)}
    e = ("layers", "e0")
    out[e + ("ln1",)] = ((L, d), bf, None)
    out[e + ("ln2",)] = ((L, d), bf, None)
    out[e + ("attn", "wq")] = ((L, d, H, D), bf, d ** -0.5)
    out[e + ("attn", "wk")] = ((L, d, Hkv, D), bf, d ** -0.5)
    out[e + ("attn", "wv")] = ((L, d, Hkv, D), bf, d ** -0.5)
    out[e + ("attn", "wo")] = ((L, H, D, d), bf, (H * D) ** -0.5)
    moe = m.get("moe")
    if moe:
        E = moe["n_experts"]
        out[e + ("moe", "router")] = ((L, d, E), torch.float32, d ** -0.5)
        out[e + ("moe", "w1")] = ((L, E, d, f), bf, d ** -0.5)
        out[e + ("moe", "w3")] = ((L, E, d, f), bf, d ** -0.5)
        out[e + ("moe", "w2")] = ((L, E, f, d), bf, f ** -0.5)
    else:
        out[e + ("ffn", "w1")] = ((L, d, f), bf, d ** -0.5)
        out[e + ("ffn", "w3")] = ((L, d, f), bf, d ** -0.5)
        out[e + ("ffn", "w2")] = ((L, f, d), bf, f ** -0.5)
    return out


def make_params(m: dict, seed: int, device) -> dict:
    """The seeded weights as the program's tree, on ``device``: every
    leaf drawn from one generator on the device, in the order of
    ``param_specs``, truncated normals (+-2) of std 1/sqrt(fan-in), the
    fan-in being the axes the weight contracts over; norms are ones."""
    gen = generator(device, seed, STREAM_WEIGHTS)
    tree: dict = {}
    for path, (shape, dtype, std) in param_specs(m).items():
        if std is None:
            leaf = torch.ones(shape, dtype=dtype, device=device)
        else:
            leaf = trunc_normal(shape, std, dtype, gen)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def flat(tree: dict, prefix: tuple = ()) -> Dict[tuple, torch.Tensor]:
    """{path: leaf} of a nested dict."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def name(path: tuple) -> str:
    return ".".join(path)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope_tables(S: int, D: int, theta: float, device) -> tuple:
    """cos, sin (S, D/2) of the rotary angles, worked out in float64."""
    half = D // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * inv
    return ang.cos().float(), ang.sin().float()


def rope(x, cos, sin):
    """x (B, S, H, D): the two halves of each head rotated."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, nx: Numerics):
    """Causal GQA attention, query rows in blocks of ``Q_BLOCK``.  q
    (B, S, H, D), k/v (B, S, Hkv, D); returns (B, S, H, D)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    outs = []
    for lo in range(0, S, Q_BLOCK):
        hi = min(S, lo + Q_BLOCK)
        s = nx.mm(qh[:, :, lo:hi], kh[:, :, :hi].transpose(-1, -2)) \
            * D ** -0.5
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        cols = torch.arange(hi, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        outs.append(nx.mm(torch.softmax(s, dim=-1), vh[:, :, :hi]))
    return torch.cat(outs, dim=2).transpose(1, 2)


def swiglu(x, w1, w3, w2, nx: Numerics):
    return nx.mm(F.silu(nx.mm(x, w1)) * nx.mm(x, w3), w2)


def moe(p: dict, x, m: dict, nx: Numerics) -> tuple:
    """The MoE FFN over x (B, S, d).  Returns (y, aux)."""
    cfg = m["moe"]
    E, k = cfg["n_experts"], cfg["top_k"]
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    probs = torch.softmax(xf @ p["router"], dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    load = torch.bincount(eidx.reshape(-1), minlength=E).float() / (T * k)
    aux = E * torch.sum(probs.mean(dim=0) * load)
    cap = max(k, int(T * k / E * cfg["capacity_factor"]))
    flat_e = eidx.reshape(-1)
    flat_g = gates.reshape(-1)
    y = torch.zeros_like(xf)
    for e in range(E):
        idx = torch.nonzero(flat_e == e).squeeze(1)[:cap]
        tok = idx // k
        ye = swiglu(xf[tok], p["w1"][e], p["w3"][e], p["w2"][e], nx)
        y = y.index_add(0, tok, ye * flat_g[idx, None])
    return y.reshape(B, S, d), aux


def layer(p: dict, x, m: dict, tables: tuple, nx: Numerics) -> tuple:
    """One decoder layer.  Returns (x, k, v, aux): k after rope."""
    B, S, d = x.shape
    H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps = m["rms_norm_eps"]
    a = p["attn"]
    h = rms_norm(x, p["ln1"], eps)
    q = nx.mm(h, a["wq"].reshape(d, H * D)).view(B, S, H, D)
    k = nx.mm(h, a["wk"].reshape(d, Hkv * D)).view(B, S, Hkv, D)
    v = nx.mm(h, a["wv"].reshape(d, Hkv * D)).view(B, S, Hkv, D)
    q, k = rope(q, *tables), rope(k, *tables)
    o = attention(q, k, v, nx).reshape(B, S, H * D)
    x = x + nx.mm(o, a["wo"].reshape(H * D, d))
    h = rms_norm(x, p["ln2"], eps)
    if "moe" in p:
        y, aux = moe(p["moe"], h, m, nx)
    else:
        f = p["ffn"]
        y, aux = swiglu(h, f["w1"], f["w3"], f["w2"], nx), x.new_zeros(())
    return x + y, k, v, aux


def _layer_params(params: dict, i: int, cast: bool) -> dict:
    def take(t):
        if isinstance(t, dict):
            return {k: take(v) for k, v in t.items()}
        t = t[i]
        return t.float() if cast else t
    return take(params["layers"]["e0"])


@torch.no_grad()
def prefill(params: dict, m: dict, tokens, nx: Numerics,
            on_layer: Optional[Callable] = None):
    """Last-position logits (B, V) of a prefill of ``tokens`` (B, S),
    layer by layer; ``on_layer(i, k, v)`` sees each layer's cache."""
    B, S = tokens.shape
    x = params["embed"][tokens].float()
    tables = rope_tables(S, m["head_dim"], m["rope_theta"], tokens.device)
    for i in range(m["n_layers"]):
        x, k, v, _ = layer(_layer_params(params, i, True), x, m, tables, nx)
        if on_layer is not None:
            on_layer(i, k, v)
    h = rms_norm(x[:, -1], params["final_norm"].float(), m["rms_norm_eps"])
    return nx.mm(h, params["unembed"].float())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _layer_fn(m, tables, nx, x, names, *leaves):
    p: dict = {}
    for path, t in zip(names, leaves):
        node = p
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    x, _, _, aux = layer(p, x, m, tables, nx)
    return x, aux


def _loss_chunk(h, lab, unembed, z, nx):
    logits = nx.mm(h, unembed)
    lse = torch.logsumexp(logits, dim=-1)
    lab_logit = torch.gather(logits, -1, lab[..., None])[..., 0]
    return ((lse - lab_logit) + z * lse.square()).sum()


def loss(weights: Dict[tuple, torch.Tensor], m: dict, tokens, labels,
         nx: Numerics, rows: Optional[int] = None):
    """The training loss at fp32 ``weights`` {path: leaf}; each layer and
    each loss chunk is recomputed in the backward.  ``rows``: only the
    first ``rows`` rows of the batch count (a fault of the check)."""
    if rows is not None:
        tokens, labels = tokens[:rows], labels[:rows]
    B, S = tokens.shape
    tables = rope_tables(S, m["head_dim"], m["rope_theta"], tokens.device)
    x = weights[("embed",)][tokens]
    layer_paths = [p for p in weights if p[:2] == ("layers", "e0")]
    names = [p[2:] for p in layer_paths]
    aux = x.new_zeros(())
    for i in range(m["n_layers"]):
        x, a = checkpoint(_layer_fn, m, tables, nx, x, names,
                          *(weights[p][i] for p in layer_paths),
                          use_reentrant=False)
        aux = aux + a
    h = rms_norm(x, weights[("final_norm",)], m["rms_norm_eps"])
    total = x.new_zeros(())
    for lo in range(0, S, LOSS_CHUNK):
        total = total + checkpoint(
            _loss_chunk, h[:, lo:lo + LOSS_CHUNK],
            labels[:, lo:lo + LOSS_CHUNK], weights[("unembed",)],
            m["z_loss"], nx, use_reentrant=False)
    return total / (B * S) + m["aux_loss_coef"] * aux


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    to ``min_lr_frac`` of it at ``total_steps``."""
    peak, warm = opt["peak_lr"], opt["warmup_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0),
               1.0)
    lo = opt["min_lr_frac"]
    return peak * (lo + (1 - lo) * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw_step(stored: Dict[tuple, torch.Tensor], mu: dict, nu: dict,
               grads: dict, step: int, opt: dict) -> float:
    """One AdamW step in place on the stored parameters and fp32 moments;
    returns the global gradient norm (before clipping)."""
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads.values()))
    scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
    lr = lr_at(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
    for path, p in stored.items():
        g = grads[path] * scale
        mu[path].mul_(b1).add_((1 - b1) * g)
        nu[path].mul_(b2).add_((1 - b2) * g.square())
        delta = (mu[path] / b1c) / ((nu[path] / b2c).sqrt() + opt["eps"])
        p32 = p.float()
        if p.dim() >= 2:
            delta = delta + opt["weight_decay"] * p32
        p.copy_(p32 - lr * delta)
    return gnorm


def train_steps(m: dict, opt: dict, seed: int, batches: list, device,
                nx: Numerics, rows: Optional[int] = None) -> dict:
    """The reference's first ``len(batches)`` steps from the seeded
    weights: {"loss": [each step's], "grad": {leaf: norm of the first
    clipped gradient, from the first moment after step 1}, "change":
    {leaf: norm of stored parameter after the last step minus before the
    first}}, norms in float64."""
    stored = flat(make_params(m, seed, device))
    first = {p: t.clone() for p, t in stored.items()}
    mu = {p: torch.zeros(t.shape, dtype=torch.float32, device=device)
          for p, t in stored.items()}
    nu = {p: torch.zeros_like(v) for p, v in mu.items()}
    out = {"loss": [], "grad": {}, "change": {}}
    for i, (tokens, labels) in enumerate(batches, start=1):
        weights = {p: t.to(torch.float32, copy=True).requires_grad_(True)
                   for p, t in stored.items()}
        with torch.enable_grad():
            total = loss(weights, m, tokens, labels, nx, rows)
            grads = torch.autograd.grad(total, list(weights.values()))
        out["loss"].append(float(total.detach()))
        del weights
        adamw_step(stored, mu, nu, dict(zip(stored, grads)), i, opt)
        del grads
        if i == 1:
            out["grad"] = {name(p): float(v.double().norm()) / (1 - opt["b1"])
                           for p, v in mu.items()}
    out["change"] = {name(p): float((t.double() - first[p].double()).norm())
                     for p, t in stored.items()}
    return out
