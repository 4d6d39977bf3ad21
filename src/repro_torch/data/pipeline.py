"""Deterministic sharded synthetic-token data pipeline with host prefetch.

Design points that matter at 1000+ nodes:

- **Statelessness**: the batch for step ``s`` on host ``h`` is a pure
  function of (seed, s, h) — restart/elastic re-mesh needs no pipeline
  state in the checkpoint beyond the step counter.
- **Host sharding**: each host materializes only its slice of the global
  batch; the global batch is recovered by the (pod, data) sharding.
- **Prefetch**: a background thread keeps a bounded queue of ready batches
  (overlap host data work with device compute).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


class SyntheticLM:
    """Zipf-ish token stream; labels = next token; frontend embeds for
    vlm/audio stubs."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0):
        assert shape.global_batch % n_hosts == 0 or shape.global_batch < n_hosts
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.n_hosts = n_hosts
        self.host_id = host_id
        self.local_batch = max(1, shape.global_batch // n_hosts)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host)."""
        cfg, shape = self.cfg, self.shape
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        B, S = self.local_batch, shape.seq_len
        out: Dict[str, np.ndarray] = {}
        # zipf-like marginal over the vocab
        if cfg.frontend == "audio":
            out["embeds"] = rng.standard_normal(
                (B, S, cfg.d_model), np.float32).astype(np.float32)
            labels = rng.integers(0, cfg.vocab, (B, S), np.int32)
            out["labels"] = labels
        elif cfg.frontend == "vlm" and cfg.frontend_tokens:
            F = min(cfg.frontend_tokens, S // 2)
            out["embeds"] = rng.standard_normal(
                (B, F, cfg.d_model), np.float32).astype(np.float32)
            out["tokens"] = self._tokens(rng, B, S - F)
            labels = np.concatenate(
                [np.full((B, F), -100, np.int32),
                 rng.integers(0, cfg.vocab, (B, S - F), np.int32)], axis=1)
            out["labels"] = labels
        else:
            toks = self._tokens(rng, B, S + 1)
            out["tokens"] = toks[:, :-1]
            out["labels"] = toks[:, 1:].astype(np.int32)
        return out

    def _tokens(self, rng, B, S) -> np.ndarray:
        z = rng.zipf(1.3, (B, S)).astype(np.int64)
        return ((z - 1) % self.cfg.vocab).astype(np.int32)


class Prefetcher:
    """Bounded background prefetch queue over ``batch_at``."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-prefetch")
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
                continue

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
