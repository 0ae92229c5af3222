"""Deterministic synthetic data (the port of ``repro.data.pipeline``).

Each worker consumes a disjoint shard of the stream; batches come out
stacked with a leading worker axis (W, b, ...).  The generators are the
reference's numpy code, so the port's tokens, images and labels are
bitwise the reference's for the same (seed, step, worker).

* ``SyntheticLMDataset`` is a learnable Markov-ish token stream: the next
  token is a fixed permutation of the current one, plus noise.
* ``SyntheticImageDataset`` is Gaussian class-prototype images (NHWC) for
  the paper's CNN family.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

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


@dataclasses.dataclass
class SyntheticImageDataset:
    n_classes: int
    image_size: int = 32
    channels: int = 3
    seed: int = 0
    noise: float = 0.6

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.prototypes = rng.normal(
            size=(self.n_classes, self.image_size, self.image_size,
                  self.channels)).astype(np.float32)

    def batch(self, step: int, worker: int, batch_size: int
              ) -> Dict[str, np.ndarray]:
        """(images (b, H, W, C) f32, labels (b,) int32) for (step, worker)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + worker)
        y = rng.integers(0, self.n_classes, size=(batch_size,))
        x = self.prototypes[y] + self.noise * rng.normal(
            size=(batch_size, self.image_size, self.image_size,
                  self.channels)).astype(np.float32)
        return {"images": x.astype(np.float32), "labels": y.astype(np.int32)}


def worker_batches(dataset, step: int, n_workers: int, per_worker: int, *,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Per-worker batches stacked to leaves (W, b, ...) on ``device``."""
    bs = [dataset.batch(step, w, per_worker) for w in range(n_workers)]
    return {k: torch.from_numpy(np.stack([b[k] for b in bs])).to(device)
            for k in bs[0]}


def prefetch(iterator: Iterator, size: int = 2):
    """Yield ``iterator``'s items, produced ``size`` ahead on a daemon
    thread (numpy's generators release the GIL while they fill arrays, so
    the next batch is drawn while the caller steps).  An exception the
    iterator raises is raised again in the caller."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
        except Exception as e:  # handed over: the caller raises it
            q.put(_Raised(e))
            return
        q.put(stop)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            return
        if isinstance(item, _Raised):
            raise item.error
        yield item


@dataclasses.dataclass
class _Raised:
    error: Exception
