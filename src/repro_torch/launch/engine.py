"""The Engine: the training loop, checkpoints with the metadata that
rebuilds their algorithm, and one-shot generation (the port of
``repro.launch.engine.Engine`` without the mesh branches).

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

from repro_torch.checkpoint import (checkpoint_meta, restore_pytree,
                                    save_pytree)
from repro_torch.core import registry
from repro_torch.core.types import DCS3GDConfig
from repro_torch.serve.oneshot import OneShotGenerator

Tree = Any

# checkpoint metadata keys describing the algorithm that produced a state
CKPT_ALGO_KEYS = ("algo", "reducer", "reducer_opts", "local_optimizer",
                  "n_workers", "staleness", "ssp_threshold", "buckets",
                  "overlap")

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

    def fit(self, state, batch_fn: Callable[..., Tree], *, steps: int,
            start: int = 0, log_every: int = 10, measure_skew: bool = False,
            skew_probe: Optional[Callable[[int, float], Any]] = None,
            skew_warmup: int = 1, membership=None
            ) -> Tuple[Any, list, float]:
        """Run steps ``start .. steps-1``; returns (state, metric history,
        wall seconds).  Each history entry carries ``wall_s``, the seconds
        since the loop started, read after that step's metrics reached the
        host.  A resumed run passes the checkpoint's step as ``start``:
        ``batch_fn`` is called with each step's index and the schedules
        follow ``state.step``.

        ``measure_skew=True`` drives a stateful staleness policy (and the
        ejection policy of an elastic run) from measured step times: each
        step is synchronised and timed, and every worker's virtual clock
        advances by the steps it would have completed free-running within
        the step (``max(durs) / durs[w]``; a non-positive duration is a
        stalled worker) before the counters go to ``alg.observe_progress``
        and the controller.  In the one-process simulation every worker
        shares the measured time (skew 0); ``skew_probe(it, dt) ->
        per-worker durations`` plugs in real ones.  On a revoked step
        (``ssp_admit == 0``) the clocks collapse to the leader, as the
        policy's counters do.  The first ``skew_warmup`` steps, and as many
        after each membership transition, do not advance the clocks (such
        a step's time is set-up, not worker speed).

        ``membership`` (a `repro_torch.cluster.Membership`) makes the run
        elastic: scripted faults and queued ejections are polled before
        every step and applied as a collapse-to-consensus resize
        (``alg.resize_state`` + `rebuild_algorithm`), after which the loop
        steps with the controller's rebuilt algorithm.  Elastic runs call
        ``batch_fn(it, n_workers)``, so the batch follows the live worker
        count; a scripted slowdown multiplies the measured durations."""
        elastic = membership is not None
        if elastic:
            self.alg = membership.alg
        cur_w = getattr(self.alg, "n_workers", 1)

        def stateful_policy():
            return hasattr(self.alg, "observe_progress") and not getattr(
                getattr(self.alg, "staleness", None), "stateless", True)

        stateful = stateful_policy()
        measuring = measure_skew and (stateful or elastic)
        n_workers = cur_w if measuring else 0
        vprogress = [0.0] * n_workers   # free-running step counts
        warmup = max(int(skew_warmup), 0)
        warm_until = start + warmup     # steps below this: set-up time
        history = []
        t0 = time.perf_counter()
        for it in range(start, steps):
            if elastic:
                events = membership.poll(it)
                if events:
                    state, changed = membership.apply(events, state,
                                                      step=it)
                    if changed:
                        self.alg = membership.alg
                        cur_w = membership.n_workers
                        stateful = stateful_policy()
                        n_workers = cur_w if measuring else 0
                        # the transition is a barrier: everyone leaves it
                        # at the leader's virtual clock
                        vprogress = [max(vprogress, default=0.0)] \
                            * n_workers
                        warm_until = it + warmup
            batch = batch_fn(it, cur_w) if elastic else batch_fn(it)
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
                    slow = membership.slowdown_factors(it) if elastic \
                        else None
                    if slow is not None:
                        durs = [d * f for d, f in zip(durs, slow)]
                    if metrics.get("ssp_admit", 1.0) == 0.0:
                        # the revoked step's pull resolved the skew
                        vprogress = [max(vprogress)] * n_workers
                    wall = max(durs)
                    vprogress = [p + (wall / d if d > 0 else 0.0)
                                 for p, d in zip(vprogress, durs)]
                progress = [int(p) for p in vprogress]
                if stateful:
                    state = self.alg.observe_progress(state, progress)
                if elastic:
                    membership.observe_progress(it, vprogress)
            if it % log_every == 0 or it == steps - 1:
                m = fetch_metrics(metrics)
                m["step"] = it
                m["wall_s"] = time.perf_counter() - t0
                if measuring:
                    m["measured_skew"] = max(progress) - min(progress)
                if elastic:
                    m["n_workers"] = cur_w
                history.append(m)
                print(f"[train] step {it:5d} " + " ".join(
                    f"{k}={m[k]:.4g}" for k in _SHOWN if k in m))
        return state, history, time.perf_counter() - t0

    # -- checkpoints with the algorithm's metadata ---------------------------

    def ckpt_meta(self) -> dict:
        """What a restore site needs to rebuild the algorithm that trained
        a state: its name and worker count, the reducer with its
        hyper-parameters (a gossip ring or a topk density rebuilt with
        the defaults would resume another topology), the local optimizer,
        the staleness policy and its threshold, and the bucket count and
        overlap flag, which decide the structure of ``comm``."""
        alg = self.alg
        return {
            "algo": alg.name,
            "n_workers": getattr(alg, "n_workers", None),
            "reducer": getattr(getattr(alg, "reducer", None), "name", None),
            "reducer_opts": getattr(
                getattr(alg, "reducer", None), "hparams", None),
            "local_optimizer": getattr(
                getattr(alg, "local_optimizer", None), "name", None),
            "staleness": getattr(
                getattr(alg, "staleness", None), "name", None),
            "ssp_threshold": getattr(
                getattr(alg, "staleness", None), "threshold", None),
            "buckets": getattr(alg, "buckets", None),
            "overlap": getattr(alg, "overlap", None),
        }

    def save(self, path, state, *, step: Optional[int] = None):
        """Save ``state`` with the metadata `algorithm_for_checkpoint`
        reads; returns the path written."""
        return save_pytree(path, state, step=step,
                           extra_meta=self.ckpt_meta())

    def restore(self, path, state):
        """``path``'s state in the structure (and on the devices) of the
        template ``state``."""
        return restore_pytree(path, state)

    def generate(self, params, prompts: torch.Tensor, *, gen: int,
                 sampler: Optional[str] = None, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 cache_len: Optional[int] = None,
                 extra_batch: Optional[dict] = None) -> torch.Tensor:
        """prompts: (B, P) int -> (B, gen) generated ids on the prompts'
        device.  The one-shot case of the serve subsystem
        (`repro_torch.serve.oneshot.OneShotGenerator`): one prefill, then
        the decode loop over the dense layout.  ``sampler`` is a `SAMPLERS`
        name; by default greedy at ``temperature <= 0`` and categorical
        above, drawing from ``generator``.  ``extra_batch``: a VLM's
        ``patches`` and ``mrope_positions``, an encoder-decoder's
        ``frames``.  For request streams (continuous batching, paged KV)
        use `repro_torch.serve.scheduler.Scheduler`."""
        if self._oneshot is None:
            self._oneshot = OneShotGenerator(self.model)
        return self._oneshot(params, prompts, gen=gen, sampler=sampler,
                             temperature=temperature, generator=generator,
                             cache_len=cache_len, extra_batch=extra_batch)


# ---------------------------------------------------------------------------
# rebuilding the algorithm a checkpoint was trained with
# ---------------------------------------------------------------------------


def algorithm_for_checkpoint(path, *, algo: str = "dc_s3gd",
                             n_workers: int = 1,
                             local_optimizer: str = "momentum",
                             reducer: str = "mean_allreduce",
                             reducer_opts: Optional[dict] = None,
                             staleness: str = "fixed",
                             ssp_threshold: int = 4, buckets: int = 0,
                             overlap: bool = False,
                             dc_cfg: Optional[DCS3GDConfig] = None
                             ) -> Tuple[Any, dict]:
    """The `DistributedOptimizer` that trained a checkpoint, and the
    resolved ``{algo, n_workers, local_optimizer, reducer, reducer_opts,
    staleness, ssp_threshold, buckets, overlap}``.

    Metadata recorded by `Engine.save` wins; the keyword arguments are
    fallbacks for checkpoints written without it.  ``reducer_opts`` (the
    reducer's recorded ``hparams``) rebuild the exact topology or
    compressor."""
    meta = checkpoint_meta(path)
    resolved = {"algo": algo, "n_workers": n_workers,
                "local_optimizer": local_optimizer, "reducer": reducer,
                "reducer_opts": reducer_opts,
                "staleness": staleness, "ssp_threshold": ssp_threshold,
                "buckets": buckets, "overlap": overlap}
    for k in CKPT_ALGO_KEYS:
        if meta.get(k) is not None:
            resolved[k] = meta[k]
    cfg = dc_cfg if dc_cfg is not None else \
        DCS3GDConfig(local_optimizer=resolved["local_optimizer"],
                     ssp_threshold=int(resolved["ssp_threshold"]))
    red = registry.make_reducer(resolved["reducer"], cfg,
                                **(resolved["reducer_opts"] or {}))
    alg = registry.make(resolved["algo"], cfg,
                        n_workers=int(resolved["n_workers"]),
                        local_optimizer=resolved["local_optimizer"],
                        reducer=red, staleness=resolved["staleness"],
                        buckets=int(resolved["buckets"] or 0),
                        overlap=bool(resolved["overlap"] or False))
    return alg, resolved
