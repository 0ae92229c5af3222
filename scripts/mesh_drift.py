#!/usr/bin/env python3
"""The step-by-step drift of elastic CNN runs on two gloo ranks from their
one-process runs, on one NVIDIA GPU.

    python3 scripts/mesh_drift.py [--per 2] [--out chiprun_out/mesh_drift.json]

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
a CUDA device and imports nothing of JAX.
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


def _one_process(events, steps: int) -> tuple:
    """(host state, loss, W) after each step of the one-process run, and
    the host state right after each resize, by step."""
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
        "stale", {}, None, {}, cs.CNN_W, steps)
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


def _mesh_run(events, relayout: bool, steps: int, ref, smi: str) -> list:
    """The run over the two ranks, step by step; on rank 0 each step's
    drift from ``ref`` (`_one_process`'s; None on rank 1), and across
    meshes each resize's too (the gathered state right after it, before
    the next step)."""
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.cluster import FaultSchedule, Membership
    from repro_torch.launch import mesh as M
    from repro_torch.launch.engine import Engine
    from repro_torch.models.cnn import init_resnet
    model, alg, _, batch_fn, _ = cs._wa_cnn_build(
        "stale", {}, None, {}, cs.CNN_W, steps)
    batch_fn = cs._in_order(batch_fn)
    membership = Membership(alg, faults=FaultSchedule.from_json(
        {"seed": 0, "events": events}))
    mesh = M.mesh_for_spec(membership.spec, device_type="cuda") \
        if relayout else M.make_debug_mesh(cs.MESH_RANKS, 1,
                                           device_type="cuda")
    engine = Engine(model, alg, mesh=mesh)
    state = engine.init_state(init_resnet(
        torch.Generator(device="cuda").manual_seed(0), **cs.RESNET18))
    bounds = {e["step"] for e in events} if relayout else set()
    rows = []
    for t in range(steps):
        if t in bounds:
            membership.sync()
            polled = membership.poll(t)
            mesh = M.mesh_for_spec(membership.preview(polled),
                                   device_type="cuda")
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


def _rank(rank: int, store: str, out: str, per: int, smi: str) -> None:
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.examples import cnn_paper_repro  # noqa: F401
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=cs.MESH_RANKS)
    res = {}
    try:
        with cs._cudnn_deterministic():
            for name, (events, relayout) in _runs(per).items():
                steps = 4 * per
                ref = _one_process(events, steps) if rank == 0 else None
                dist.barrier()
                if rank == 0:
                    print(f"[drift] {name}, {per} steps a membership",
                          flush=True)
                res[name] = _mesh_run(events, relayout, steps, ref, smi)
                del ref
                torch.cuda.empty_cache()
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per", type=int, default=2,
                    help="steps a membership (4 memberships)")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "mesh_drift.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_drift: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    smi = cs.card()
    cs.phase_build(smi)
    res, codes = cs._join_pair(cs._start_pair(_rank,
                                              extra=(args.per, smi)))
    if res is None:
        print(f"mesh_drift: ranks exited {codes}", file=sys.stderr)
        return 1
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "per": args.per,
                                    "runs": res[0]}, indent=1))
    worst = {name: max(max(r["params"], r["opt"], r["comm"]) for r in rows
                       if "step" in r)
             for name, rows in res[0].items()}
    print(json.dumps({"worst": worst, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
