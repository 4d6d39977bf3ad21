"""The comparison that decides ``correct``: the numbers taken between
the timed path's outputs and the plain reference, and their limits.

Prefill (per checked batch, the worst over the batches):

- ``kv_err``: the worst over layers and over k / v of
  ||program cache - reference|| / ||reference|| (Frobenius, float64);
- ``logit_err``: the same of the last-position logits;
- ``token_gap``: the widest gap by which the token the program serves
  (its argmax) lies below the reference's best logit.

Training (the reference follows the window's first three steps):

- ``loss_gap``: the worst |loss - reference| / |reference| of the steps;
- ``grad_gap``: the worst leaf's gap between the norm of the first
  gradient as the optimizer got it (the first moment after step 1 over
  1 - b1) and the reference's, over the reference's norm of that leaf or
  of the median leaf, whichever is larger;
- ``change_gap``: the same of the norm of each stored parameter's change
  over the three steps, over the leaves whose reference gradient norm is
  at least ``GRAD_FLOOR`` of the median leaf's (a leaf whose gradient is
  nought to rounding moves under AdamW by round-off alone).

A number that is not finite fails its limit.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

GRAD_FLOOR = 1e-3


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.double(), ref.double()
    den = float(ref.norm())
    return float((a - ref).norm()) / den if den > 0 else float("inf")


def prefill_numbers(params: dict, m: dict, tokens, logits, k_layers,
                    v_layers, nx) -> Dict[str, float]:
    """Numbers of one batch: ``logits`` (B, V) and ``k_layers[i]`` /
    ``v_layers[i]`` (B, S, Hkv, D) are what the program produced for
    ``tokens``; the reference runs layer by layer beside them."""
    from hpcbench.reference import decoder
    worst = [0.0]

    def on_layer(i, k, v):
        worst[0] = max(worst[0], rel_err(k_layers[i], k),
                       rel_err(v_layers[i], v))
    ref = decoder.prefill(params, m, tokens, nx, on_layer)
    served = logits.float().argmax(-1)
    best = ref.max(-1).values
    gap = float((best - ref.gather(-1, served[:, None])[:, 0]).max())
    bad = not bool(torch.isfinite(logits).all())
    return {"kv_err": worst[0],
            "logit_err": float("inf") if bad else rel_err(logits, ref),
            "token_gap": float("inf") if bad else gap}


def worst(batches: list) -> Dict[str, float]:
    """The largest of each number over the batches' dicts."""
    out: Dict[str, float] = {}
    for nums in batches:
        for k, v in nums.items():
            out[k] = max(out.get(k, v), v) if math.isfinite(v) else v
    return out


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> tuple:
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def train_numbers(prog: dict, ref: dict) -> tuple:
    """(numbers, the leaf each leaf-wise number was worst at).  ``prog``
    and ``ref``: {"loss": [...], "grad": {leaf: norm}, "change": {leaf:
    norm}}."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                    ref["loss"]))
    if not all(math.isfinite(x) for x in prog["loss"]):
        loss = float("inf")
    grad, grad_leaf = _leaf_gap(prog["grad"], ref["grad"])
    med = statistics.median(ref["grad"].values())
    keep = {n for n, g in ref["grad"].items() if g >= GRAD_FLOOR * med}
    change, change_leaf = _leaf_gap(prog["change"], ref["change"], keep)
    return ({"loss_gap": loss, "grad_gap": grad, "change_gap": change},
            {"grad_gap": grad_leaf, "change_gap": change_leaf,
             "left_out": sorted(set(ref["grad"]) - keep)})


def judge(numbers: Dict[str, float], limits: Dict[str, dict]
          ) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the limits
    name; a number without a limit is not compared."""
    shown, ok = {}, True
    for name, spec in limits.items():
        value = numbers.get(name)
        limit = spec["limit"]
        shown[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, shown


def describe(shown: Dict[str, dict]) -> list:
    """One line per number: its name, value and limit."""
    return [f"check {name}: {v['value']!r} limit {v['limit']!r}"
            for name, v in shown.items()]
