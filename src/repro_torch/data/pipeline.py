"""Deterministic synthetic data (the port of ``repro.data.pipeline``).

Each worker consumes a disjoint shard of the stream; batches come out
stacked with a leading worker axis (W, b, ...).  The generator is the
reference's numpy code, so the port's tokens are bitwise the reference's
for the same (seed, step, worker).

``SyntheticLMDataset`` is a learnable Markov-ish token stream: the next
token is a fixed permutation of the current one, plus noise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    seed: int = 0
    noise: float = 0.1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.perm = rng.permutation(self.vocab_size)

    def batch(self, step: int, worker: int, batch_size: int
              ) -> Dict[str, np.ndarray]:
        """Deterministic (step, worker) -> batch; workers see disjoint data."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + worker)
        first = rng.integers(0, self.vocab_size, size=(batch_size, 1))
        toks = [first]
        for _ in range(self.seq_len - 1):
            nxt = self.perm[toks[-1]]
            flip = rng.random(nxt.shape) < self.noise
            rand = rng.integers(0, self.vocab_size, size=nxt.shape)
            toks.append(np.where(flip, rand, nxt))
        tokens = np.concatenate(toks, axis=1).astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((batch_size, 1), -1, np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}


def worker_batches(dataset, step: int, n_workers: int, per_worker: int, *,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Per-worker batches stacked to leaves (W, b, ...) on ``device``."""
    bs = [dataset.batch(step, w, per_worker) for w in range(n_workers)]
    return {k: torch.from_numpy(np.stack([b[k] for b in bs])).to(device)
            for k in bs[0]}
