"""The Engine's training loop (the port of ``repro.launch.engine.Engine``
without the mesh, checkpoint, elastic and measured-skew branches).

PyTorch runs eagerly, so there is nothing to jit: ``fit`` calls the
algorithm's ``step`` directly.  The loop stays on the device's queue:
metrics are fetched to the host only on ``log_every`` boundaries (and
the last step), with one device-to-host copy for the whole dict.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import torch

Tree = Any


def fetch_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Device metrics -> host floats, in one copy."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].float().reshape(()) for k in keys])
        out.update(zip(keys, vals.tolist()))
    return out


class Engine:
    """Runs one (model, algorithm) pair's step loop."""

    def __init__(self, model, alg):
        self.model = model
        self.alg = alg

    def fit(self, state, batch_fn: Callable[[int], Tree], *, steps: int,
            log_every: int = 10) -> Tuple[Any, list, float]:
        """Run steps ``0 .. steps-1``; returns (state, metric history,
        wall seconds).  Each history entry carries ``wall_s``, the seconds
        since the loop started, read after that step's metrics reached the
        host."""
        history = []
        t0 = time.perf_counter()
        for it in range(steps):
            batch = batch_fn(it)
            state, metrics = self.alg.step(state, batch,
                                           loss_fn=self.model.loss)
            if it % log_every == 0 or it == steps - 1:
                m = fetch_metrics(metrics)
                m["step"] = it
                m["wall_s"] = time.perf_counter() - t0
                history.append(m)
                print(f"[train] step {it:5d} loss={m['loss']:.4f} "
                      f"lr={m['lr']:.4f} |D|={m['distance_norm']:.2e} "
                      f"lam={m['lambda']:.3f}")
        return state, history, time.perf_counter() - t0
