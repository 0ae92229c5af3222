"""The Engine's training loop and one-shot generation (the port of
``repro.launch.engine.Engine`` without the mesh, checkpoint and elastic
branches).

PyTorch runs eagerly, so there is nothing to jit: ``fit`` calls the
algorithm's ``step`` directly.  The loop stays on the device's queue:
metrics are fetched to the host only on ``log_every`` boundaries (and
the last step), with one device-to-host copy for the whole dict.  Only
``measure_skew`` synchronises every step, because it times them.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.serve.oneshot import OneShotGenerator

Tree = Any

# the metrics a step line shows, where the algorithm reports them
_SHOWN = ("loss", "lr", "distance_norm", "lambda")


def fetch_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Device metrics -> host floats, in one copy."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].float().reshape(()) for k in keys])
        out.update(zip(keys, vals.tolist()))
    return out


def _synchronize(metrics: Dict[str, Any]) -> None:
    """Wait for the device work behind a step's metrics."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


class Engine:
    """Runs one (model, algorithm) pair's step loop, or generates from a
    model (the algorithm is then not needed)."""

    def __init__(self, model, alg=None):
        self.model = model
        self.alg = alg
        self._oneshot: Optional[OneShotGenerator] = None

    def fit(self, state, batch_fn: Callable[[int], Tree], *, steps: int,
            log_every: int = 10, measure_skew: bool = False,
            skew_probe: Optional[Callable[[int, float], Any]] = None,
            skew_warmup: int = 1) -> Tuple[Any, list, float]:
        """Run steps ``0 .. steps-1``; returns (state, metric history,
        wall seconds).  Each history entry carries ``wall_s``, the seconds
        since the loop started, read after that step's metrics reached the
        host.

        ``measure_skew=True`` drives a stateful staleness policy from
        measured step times: each step is synchronised and timed, and
        every worker's virtual clock advances by the steps it would have
        completed free-running within the step (``max(durs) / durs[w]``;
        a non-positive duration is a stalled worker) before the counters
        go to ``alg.observe_progress``.  In the one-process simulation
        every worker shares the measured time (skew 0);
        ``skew_probe(it, dt) -> per-worker durations`` plugs in real
        ones.  On a revoked step (``ssp_admit == 0``) the clocks collapse
        to the leader, as the policy's counters do.  The first
        ``skew_warmup`` steps do not advance the clocks (a first step's
        time is set-up, not worker speed)."""
        stateful = hasattr(self.alg, "observe_progress") and not getattr(
            getattr(self.alg, "staleness", None), "stateless", True)
        measuring = measure_skew and stateful
        n_workers = self.alg.n_workers if measuring else 0
        vprogress = [0.0] * n_workers   # free-running step counts
        warm_until = max(int(skew_warmup), 0)
        history = []
        t0 = time.perf_counter()
        for it in range(steps):
            batch = batch_fn(it)
            ts = time.perf_counter()
            state, metrics = self.alg.step(state, batch,
                                           loss_fn=self.model.loss)
            if measuring:
                _synchronize(metrics)
                dt = time.perf_counter() - ts
                if it >= warm_until:
                    durs = list(skew_probe(it, dt)) \
                        if skew_probe is not None else [dt] * n_workers
                    if len(durs) != n_workers:
                        raise ValueError(f"skew_probe gave {len(durs)} "
                                         f"durations for {n_workers} workers")
                    if metrics.get("ssp_admit", 1.0) == 0.0:
                        # the revoked step's pull resolved the skew
                        vprogress = [max(vprogress)] * n_workers
                    wall = max(durs)
                    vprogress = [p + (wall / d if d > 0 else 0.0)
                                 for p, d in zip(vprogress, durs)]
                progress = [int(p) for p in vprogress]
                state = self.alg.observe_progress(state, progress)
            if it % log_every == 0 or it == steps - 1:
                m = fetch_metrics(metrics)
                m["step"] = it
                m["wall_s"] = time.perf_counter() - t0
                if measuring:
                    m["measured_skew"] = max(progress) - min(progress)
                history.append(m)
                print(f"[train] step {it:5d} " + " ".join(
                    f"{k}={m[k]:.4g}" for k in _SHOWN if k in m))
        return state, history, time.perf_counter() - t0

    def generate(self, params, prompts: torch.Tensor, *, gen: int,
                 sampler: Optional[str] = None, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 cache_len: Optional[int] = None) -> torch.Tensor:
        """prompts: (B, P) int -> (B, gen) generated ids on the prompts'
        device.  The one-shot case of the serve subsystem
        (`repro_torch.serve.oneshot.OneShotGenerator`): one prefill, then
        the decode loop over the dense layout.  ``sampler`` is a `SAMPLERS`
        name; by default greedy at ``temperature <= 0`` and categorical
        above, drawing from ``generator``.  For request streams (continuous
        batching, paged KV) use `repro_torch.serve.scheduler.Scheduler`."""
        if self._oneshot is None:
            self._oneshot = OneShotGenerator(self.model)
        return self._oneshot(params, prompts, gen=gen, sampler=sampler,
                             temperature=temperature, generator=generator,
                             cache_len=cache_len)
