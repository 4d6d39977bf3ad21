"""Inputs made from ``--seed``: token ids and seeded weights.

Frozen here so that the yardstick does not move with the program.

- Tokens follow the rule of the port's ``data.pipeline.SyntheticLM``: a
  Zipf(1.3) draw ``z`` folded onto the vocabulary as ``(z - 1) % V``.
  Its probabilities are exact: the folded mass of id ``t`` is
  ``V**-a * zeta(a, (t + 1) / V)`` (Hurwitz zeta), so the draw is one
  inverse-CDF lookup on the device, no host numpy.
- Each unit (a prefill batch, a train step) draws from its own generator,
  keyed by (seed, stream, index), so a unit's inputs are a pure function
  of its index and any of them can be made again for the reference.
- Weights are truncated normals (+-2 sigma) with std 1/sqrt(fan-in),
  fan-in being the axes a weight contracts over, drawn on the device in a
  few large calls, in the dtype they are served in.
"""
from __future__ import annotations

import torch

ZIPF_A = 1.3
_MASK63 = (1 << 63) - 1
STREAM_WEIGHTS = 1
STREAM_TOKENS = 2
STREAM_SAMPLE = 3
_CHUNK = 1 << 27          # elements of one fp32 draw (512 MiB)


def mix(*parts: int) -> int:
    """A 63-bit key of the integers ``parts`` (SplitMix64 rounds)."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        z = (z ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
        z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        z ^= z >> 31
    return z & _MASK63


def generator(device, *key: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(*key))
    return gen


class ZipfTokens:
    """Token ids of shape (rows, cols) for unit ``i`` of a seed."""

    def __init__(self, vocab: int, device, a: float = ZIPF_A):
        q = (torch.arange(vocab, dtype=torch.float64, device=device) + 1) \
            / vocab
        pmf = torch.special.zeta(torch.full_like(q, a), q)
        cdf = torch.cumsum(pmf, 0)
        self.cdf = cdf / cdf[-1]
        self.vocab = vocab
        self.device = device

    def draw(self, seed: int, index: int, rows: int, cols: int
             ) -> torch.Tensor:
        gen = generator(self.device, seed, STREAM_TOKENS, index)
        u = torch.rand((rows, cols), generator=gen, dtype=torch.float64,
                       device=self.device)
        ids = torch.searchsorted(self.cdf, u)
        return ids.clamp_(max=self.vocab - 1)


def trunc_normal(shape, std: float, dtype, gen: torch.Generator
                 ) -> torch.Tensor:
    """A tensor of ``shape`` in ``dtype``: truncated normals (+-2) times
    ``std``, drawn in fp32 chunks of at most ``_CHUNK`` elements."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), _CHUNK):
        part = flat[lo:lo + _CHUNK]
        w = torch.empty(part.numel(), dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(w.mul_(std))
    return out
