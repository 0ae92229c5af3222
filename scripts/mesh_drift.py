#!/usr/bin/env python3
"""The step-by-step drift of elastic CNN runs on two gloo ranks from their
one-process runs, on one NVIDIA GPU.

    python3 scripts/mesh_drift.py [--per 2] [--runs "fixed 8"] [--probe]
        [--device cuda|cpu] [--out chiprun_out/mesh_drift.json]

``chip_smoke.py``'s phase 19 (b) build (ResNet-18's layout, 32 x 32
images, 64 a worker, 4 buckets, ``stale`` on the fused tail, TF32 off,
cuDNN deterministic), ``4 * per`` steps of each run:

- ``relayout 8-6-3-4``: phase 19 (b)'s "elastic 8-6-3-4" case, each
  membership on the mesh ``launch.mesh.mesh_for_spec`` lays it on: 8
  workers (4 rows a rank), 6 (3), 3 on rank 0 alone (rank 1 outside the
  mesh), 4 (2 a rank, rank 1 rejoined through ``hand_over``);
- ``fixed 8-6-4-4``: 8 -> 6 -> 4 -> 4 (a leave and a join) on the fixed
  (2, 1) mesh: the same resizes, no sub-mesh and no hand-over;
- ``fixed 8``: W = 8 throughout on the (2, 1) mesh, no resize.

After every step rank 0 holds the gathered state to the one-process
run's at that step, per part (params, opt, comm), each leaf at its part's
largest magnitude (``chip_smoke._state_err(whole=True)``, the measure
phase 19 (b) holds at ``MESH_TOL``), and the loss's relative distance;
in the relayout run also the state right after each resize, before the
next step, to the one-process run's right after the same resize.
Two spawned ranks share the card.  Prints one line per step with the
card's name and power limit, writes the table as JSON to ``--out``; needs
a CUDA device (``--device cpu``: two gloo ranks on the CPU, no kernel
built) and imports nothing of JAX.

``--probe`` also asks where the drift comes from, on rank 0, per run:

- ``nudge``: the one-process run again from weights one ulp up
  (``nextafter`` toward +inf), its move from the one-process run at each
  step, per part at the part's scale: the model's own growth of a
  rounding-sized difference.  ``nonzero`` keeps the exact zeros (the
  residual scales' init, which both compared runs share exactly),
  ``all`` moves them too (off ReLU's kink: every dead shortcut sits at
  it while a scale is 0);
- ``worst``: at each step the leaf and coordinate furthest from the
  one-process run (its part's scale), with both values;
- ``relu_flips``: at each step, the ReLU inputs (every worker's batch
  through its own weights, as the step takes them) whose sign differs
  between the ranks' weights and the one-process run's, and the smallest
  such input; the ResNet has no BatchNorm and no max-pool, so ReLU is
  its only kink;
- ``convs_equal``: whether every convolution (input and weight shapes,
  stride, padding, strides of the input) the ranks ran is one that the
  one-process run ran too, and cuDNN's ``deterministic`` / ``benchmark``
  flags in both.

With ``--probe`` the script also applies the nudge rule, step by step:
each part's drift at step t is held to twice the ``nonzero`` nudge's
move at step t, or to ``MESH_TOL`` where the nudge moves less
(`nudge_verdict`); it prints the steps that break it and exits 1 if any
does.  The rule is for the runs that leave ``MESH_TOL`` (``fixed 8``
from step 5): phase 19 (b)'s three steps stay within ``MESH_TOL``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

DEVICE = ["cuda"]   # set once per process from --device


def _runs(per: int) -> dict:
    """name -> (the membership events, whether each membership takes its
    own mesh)."""
    relayout = (
        [{"step": per, "kind": "leave", "worker": w} for w in ("w1", "w5")]
        + [{"step": 2 * per, "kind": "leave", "worker": w}
           for w in ("w2", "w4", "w6")]
        + [{"step": 3 * per, "kind": "join", "count": 1}])
    fixed = (
        [{"step": per, "kind": "leave", "worker": w} for w in ("w1", "w5")]
        + [{"step": 2 * per, "kind": "leave", "worker": w}
           for w in ("w2", "w6")]
        + [{"step": 3 * per, "kind": "leave", "worker": "w3"},
           {"step": 3 * per, "kind": "join", "count": 1}])
    return {"relayout 8-6-3-4": (relayout, True),
            "fixed 8-6-4-4": (fixed, False),
            "fixed 8": ([], False)}


def _host(tree):
    from repro_torch import tree as T
    return T.map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x,
                 tree)


def _comparable(state):
    return state._replace(comm={k: v for k, v in state.comm.items()
                                if k != "pipeline"})


def _nudged(state, zeros: bool):
    """``state`` with every parameter one ulp up (``zeros``: the exact
    zeros too, the residual scales' init)."""
    from repro_torch import tree as T

    def up(x):
        y = torch.nextafter(x, torch.full_like(x, float("inf")))
        return y if zeros else torch.where(x == 0, x, y)
    return state._replace(params=T.map(up, state.params))


class _Convs:
    """Records the signature of every ``F.conv2d`` call inside: input and
    weight shapes, stride, padding, the input's strides."""

    def __init__(self):
        self.seen = set()

    def __enter__(self):
        import torch.nn.functional as F
        self._orig = F.conv2d

        def rec(x, w, *a, **k):
            self.seen.add((tuple(x.shape), tuple(w.shape), tuple(x.stride()),
                           repr(a), repr(sorted(k.items()))))
            return self._orig(x, w, *a, **k)
        F.conv2d = rec
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F
        F.conv2d = self._orig


def _one_process(events, steps: int, nudge=None) -> tuple:
    """(host state, loss, W) after each step of the one-process run, and
    the host state right after each resize, by step; ``nudge``: from
    weights one ulp up, "all" of them or the "nonzero" ones."""
    import chip_smoke as cs
    from repro_torch.cluster import FaultSchedule, Membership
    from repro_torch.launch.engine import Engine
    after = {}

    class Kept(Membership):
        def apply(self, polled, st, *, step, workers=None):
            st, changed = super().apply(polled, st, step=step,
                                        workers=workers)
            if changed:
                after[step] = _comparable(_host(st))
            return st, changed

    model, alg, state, batch_fn, _ = cs._wa_cnn_build(
        "stale", {"device": DEVICE[0]}, None, {}, cs.CNN_W, steps)
    if nudge:
        state = _nudged(state, zeros=nudge == "all")
    engine = Engine(model, alg)
    membership = Kept(alg, faults=FaultSchedule.from_json(
        {"seed": 0, "events": events}))
    out = []
    for t in range(steps):
        state, h, _ = engine.fit(state, batch_fn, steps=t + 1, start=t,
                                 log_every=1, membership=membership)
        out.append((_comparable(_host(engine.gather_state(state))),
                    h[-1]["loss"], membership.n_workers))
    return out, after


def _mesh_run(events, relayout: bool, steps: int, ref, smi: str,
              keep: list = None) -> list:
    """The run over the two ranks, step by step; on rank 0 each step's
    drift from ``ref`` (`_one_process`'s; None on rank 1), and across
    meshes each resize's too (the gathered state right after it, before
    the next step); ``keep`` (rank 0) gathers each step's host state."""
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.cluster import FaultSchedule, Membership
    from repro_torch.launch import mesh as M
    from repro_torch.launch.engine import Engine
    from repro_torch.models.cnn import init_resnet
    model, alg, _, batch_fn, _ = cs._wa_cnn_build(
        "stale", {"device": DEVICE[0]}, None, {}, cs.CNN_W, steps)
    batch_fn = cs._in_order(batch_fn)
    membership = Membership(alg, faults=FaultSchedule.from_json(
        {"seed": 0, "events": events}))
    dev = DEVICE[0]
    mesh = M.mesh_for_spec(membership.spec, device_type=dev) \
        if relayout else M.make_debug_mesh(cs.MESH_RANKS, 1, device_type=dev)
    engine = Engine(model, alg, mesh=mesh)
    state = engine.init_state(init_resnet(
        torch.Generator(device=dev).manual_seed(0), **cs.RESNET18))
    bounds = {e["step"] for e in events} if relayout else set()
    rows = []
    for t in range(steps):
        if t in bounds:
            membership.sync()
            polled = membership.poll(t)
            mesh = M.mesh_for_spec(membership.preview(polled),
                                   device_type=dev)
            state, _ = membership.apply(polled, state, step=t,
                                        workers=M.make_workers(mesh))
            engine = Engine(model, membership.alg, mesh=mesh)
            full = engine.gather_state(state)
            dist.barrier()
            if dist.get_rank() == 0:
                err = cs._state_err(_comparable(full), ref[1][t],
                                    whole=True)
                rows.append({"after_resize_at": t, "W": membership.n_workers,
                             "holds": M.holds_rows(mesh), **err})
                print(f"[drift] resize before step {t} to W="
                      f"{membership.n_workers}: params / opt / comm "
                      f"{err['params']:.3g} / {err['opt']:.3g} / "
                      f"{err['comm']:.3g} of a part's scale [{smi}]",
                      flush=True)
        state, h, _ = engine.fit(state, batch_fn, steps=t + 1, start=t,
                                 log_every=1, membership=membership)
        full = engine.gather_state(state)
        dist.barrier()
        if dist.get_rank() != 0:
            continue
        one, loss, w = ref[0][t]
        if keep is not None:
            keep.append(_comparable(_host(full)))
        err = cs._state_err(_comparable(full), one, whole=True)
        row = {"step": t, "W": membership.n_workers, "W_ref": w,
               "holds": M.holds_rows(mesh), **err,
               "loss_rel": abs(h[-1]["loss"] - loss) / abs(loss)}
        rows.append(row)
        print(f"[drift] step {t} W={row['W']}: params / opt / comm "
              f"{err['params']:.3g} / {err['opt']:.3g} / {err['comm']:.3g}"
              f" of a part's scale, loss {row['loss_rel']:.3g} relative "
              f"[{smi}]", flush=True)
    return rows


def _paths(tree, prefix=""):
    """(path, tensor) of every tensor leaf of a state part."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")


def _worst(a, b) -> dict:
    """The leaf and coordinate of ``a`` furthest from ``b`` at its part's
    scale (the largest magnitude in ``b``'s part), with both values."""
    best = {"err": 0.0}
    for part in ("params", "opt", "comm"):
        pa, pb = dict(_paths(getattr(a, part))), \
            list(_paths(getattr(b, part)))
        scale = max((float(y.abs().max()) for _, y in pb if y.numel()),
                    default=0.0)
        for path, y in pb:
            x = pa[path]
            if not y.numel() or not scale:
                continue
            d = (x.float() - y.float()).abs()
            i = int(d.argmax())
            e = float(d.flatten()[i]) / scale
            if e > best["err"]:
                best = {"err": e, "leaf": part + path,
                        "index": list(map(int, torch.unravel_index(
                            torch.tensor(i), y.shape))),
                        "ranks": float(x.flatten()[i]),
                        "one_process": float(y.flatten()[i])}
    return best


def _relu_inputs(params: dict, images: torch.Tensor) -> list:
    """Every ReLU input of ``resnet_apply`` on ``images``."""
    from repro_torch.models.cnn import resnet_apply
    seen, orig = [], torch.relu

    def rec(x):
        seen.append(x.detach())
        return orig(x)
    torch.relu = rec
    try:
        with torch.no_grad():
            resnet_apply(params, images)
    finally:
        torch.relu = orig
    return seen


def _relu_flips(ds, steps: int, mine: list, ref: list) -> list:
    """Per step t the ReLU inputs whose sign differs between the ranks'
    weights and the one-process run's, each worker's step-t batch through
    its own weights as they enter step t (W = 8 runs: ``mine`` / ``ref``
    the states after each step)."""
    import chip_smoke as cs
    from repro_torch import tree as T
    from repro_torch.data.pipeline import worker_batches
    out = []
    for t in range(1, steps):
        a, b = mine[t - 1].params, ref[t - 1][0].params
        W = T.leaves(b)[0].shape[0]
        batch = worker_batches(ds, t, W, cs.CNN_PER_WORKER,
                               device=DEVICE[0])
        flips, least, total = 0, float("inf"), 0
        for i in range(W):
            za = _relu_inputs(T.map(lambda x: x[i].to(DEVICE[0]), a),
                              batch["images"][i])
            zb = _relu_inputs(T.map(lambda x: x[i].to(DEVICE[0]), b),
                              batch["images"][i])
            for x, y in zip(za, zb):
                f = (x > 0) != (y > 0)
                total += y.numel()
                if f.any():
                    flips += int(f.sum())
                    least = min(least, float(y[f].abs().min()))
        out.append({"step": t, "flips": flips, "of": total,
                    "least_abs_input": None if not flips else least})
    return out


def _rank(rank: int, store: str, out: str, per: int, smi: str,
          names: list, probe: bool, device: str) -> None:
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.examples import cnn_paper_repro  # noqa: F401
    DEVICE[0] = device
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=cs.MESH_RANKS)
    res = {}
    try:
        with cs._cudnn_deterministic():
            for name, (events, relayout) in _runs(per).items():
                if names and name not in names:
                    continue
                steps = 4 * per
                one_convs, mesh_convs = _Convs(), _Convs()
                ref = None
                if rank == 0:
                    with one_convs:
                        ref = _one_process(events, steps)
                dist.barrier()
                if rank == 0:
                    print(f"[drift] {name}, {per} steps a membership",
                          flush=True)
                keep = [] if probe and rank == 0 else None
                with mesh_convs:
                    rows = _mesh_run(events, relayout, steps, ref, smi, keep)
                res[name] = rows
                if probe and rank == 0:
                    res[name] = {"rows": rows, **_probe(
                        name, events, steps, ref, keep, one_convs,
                        mesh_convs, smi)}
                del ref
                if device == "cuda":
                    torch.cuda.empty_cache()
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _probe(name, events, steps, ref, keep, one_convs, mesh_convs,
           smi) -> dict:
    """`--probe`'s measurements of one run, on rank 0 (module docstring)."""
    import chip_smoke as cs
    nudge = {}
    for which in ("nonzero", "all"):
        nudged, _ = _one_process(events, steps, nudge=which)
        nudge[which] = [cs._state_err(n[0], r[0], whole=True)
                        for n, r in zip(nudged, ref[0])]
        del nudged
    worst = [_worst(m, r[0]) for m, r in zip(keep, ref[0])]
    flips = []
    if not events:
        _, _, _, _, ds = cs._wa_cnn_build(
            "stale", {"device": DEVICE[0]}, None, {}, cs.CNN_W, 1)
        flips = _relu_flips(ds, steps, keep, ref[0])
    for t, (n, z, w) in enumerate(zip(nudge["nonzero"], nudge["all"],
                                      worst)):
        f = next((x for x in flips if x["step"] == t), None)
        print(f"[probe] {name} step {t}: nudge params / opt / comm "
              f"{n['params']:.3g} / {n['opt']:.3g} / {n['comm']:.3g} "
              f"(zeros too: {max(z.values()):.3g}); "
              f"worst {w.get('leaf')} {w.get('index')} {w['err']:.3g}"
              + (f"; relu flips {f['flips']} of {f['of']} (least |z| "
                 f"{f['least_abs_input']})" if f else "") + f" [{smi}]",
              flush=True)
    equal = mesh_convs.seen <= one_convs.seen
    print(f"[probe] {name}: the ranks' {len(mesh_convs.seen)} conv "
          f"signatures are {'all' if equal else 'NOT all'} among the one "
          f"process's {len(one_convs.seen)}; cudnn deterministic "
          f"{torch.backends.cudnn.deterministic}, benchmark "
          f"{torch.backends.cudnn.benchmark}", flush=True)
    return {"nudge": nudge, "worst": worst, "relu_flips": flips,
            "convs_equal": equal,
            "convs": [len(one_convs.seen), len(mesh_convs.seen)]}


def nudge_verdict(got: dict, tol: float) -> list:
    """The nudge rule over one `--probe` run (``{"rows", "nudge", ...}``):
    the (step, part, drift, bound) where a step's drift passes
    ``max(tol, 2 * move)``, the move being the ``nonzero`` nudge's at
    that step."""
    broken = []
    rows = [r for r in got["rows"] if "step" in r]
    for r, move in zip(rows, got["nudge"]["nonzero"]):
        for part in ("params", "opt", "comm"):
            bound = max(tol, 2 * move[part])
            if r[part] > bound:
                broken.append((r["step"], part, r[part], bound))
    return broken


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per", type=int, default=2,
                    help="steps a membership (4 memberships)")
    ap.add_argument("--runs", default="",
                    help="comma-separated run names (default: all three)")
    ap.add_argument("--probe", action="store_true",
                    help="nudge, worst coordinate, ReLU flips, convolutions")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "mesh_drift.json")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mesh_drift: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    if args.device == "cuda":
        smi = cs.card()
        cs.phase_build(smi)
    else:
        smi = "cpu"
    names = [n.strip() for n in args.runs.split(",") if n.strip()]
    res, codes = cs._join_pair(cs._start_pair(
        _rank, extra=(args.per, smi, names, args.probe, args.device)),
        limit=3000)
    if res is None:
        print(f"mesh_drift: ranks exited {codes}", file=sys.stderr)
        return 1
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "per": args.per,
                                    "runs": res[0]}, indent=1))
    worst = {}
    for name, got in res[0].items():
        rows = got["rows"] if isinstance(got, dict) else got
        worst[name] = max(max(r["params"], r["opt"], r["comm"])
                          for r in rows if "step" in r)
    broken = {name: nudge_verdict(got, cs.MESH_TOL)
              for name, got in res[0].items() if isinstance(got, dict)}
    for name, b in broken.items():
        print(f"[nudge] {name}: each step within twice the nudge's move "
              f"(at least MESH_TOL) {'yes' if not b else b} [{smi}]")
    print(json.dumps({"worst": worst, "card": smi}))
    return 1 if any(broken.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
