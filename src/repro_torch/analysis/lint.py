"""Pass-based analyzer over traced train steps (the port of
``repro.analysis.lint``).

The reference audits what XLA will run: each grid point (algo x reducer x
buckets x overlap) is lowered and its StableHLO read.  The port runs
eagerly, so each point's step runs once under an op trace
(`repro_torch.launch.engine.Engine.trace_train_step`) and six passes
check the invariants DC-S3GD's correctness story rests on, redesigned
over what a trace and the live tensors show:

* ``donation`` — with the caller dropping it, no tensor of the old
  `TrainState` outlives the step (weak references); on the card the
  memory allocated after the step is no more than before it plus the
  step's metrics;
* ``host-sync`` — no ``_local_scalar_dense`` (``.item()``), data-dependent
  shape op or device-to-host copy inside the step; on the card the step
  also runs under ``torch.cuda.set_sync_debug_mode("error")``;
* ``recompile`` — `Engine.retrace_stats` (the bucket-plan and kernel
  build caches) does not move after a fit loop's first step;
* ``dtype-drift`` — the state's leaf dtypes survive the step, and every
  float down-cast goes to f32, to the model's compute dtype inside its
  ``model`` scope, or to ``comm_dtype`` inside the ``wire`` scope;
* ``fence`` — under ``overlap`` the step issues one reduce, at its tail,
  with the op sequence of the inline step's reduce, and reads every
  buffer the previous issue landed;
* ``wire-accounting`` — the traced ``comm_dtype`` casts in the wire scope
  equal the reducer's ``wire_model(...)["cast_bytes"]``, and
  ``wire_bytes`` equals ``wire_model``'s ``accounted_bytes``.

Layer 2 (`repro_torch.analysis.astlint`) lints the source tree.  Findings
serialize through `repro_torch.analysis.report` and gate against the
port's committed, empty baseline
(``src/repro_torch/analysis/lint_baseline.json``)::

    python -m repro_torch.analysis.lint                 # grid + AST, card
    python -m repro_torch.analysis.lint --model transformer \\
        --use-kernels --select dc_s3gd/mean_allreduce/b4
    python -m repro_torch.analysis.lint --device cpu \\
        --baseline src/repro_torch/analysis/lint_baseline.json
    python -m repro_torch.analysis.lint --device cpu --select topk \\
        --json r.json
    python -m repro_torch.analysis.lint --list          # the grid

The grid's steps run on the card, as every entry point of the port does,
unless ``--device cpu`` asks for the CPU; without a card the default
raises.  Exit status 1 on any finding not in the baseline.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import sys
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Iterator, List, Optional, Sequence

import torch

from repro_torch import tree as T
from repro_torch.analysis.optrace import SYNC_OPS, OpTrace
from repro_torch.analysis.report import (Finding, findings_report,
                                         load_baseline, new_findings,
                                         render_findings)
from repro_torch.core import quant as Q
from repro_torch.core import registry
from repro_torch.core.types import DCS3GDConfig
from repro_torch.launch.engine import Engine

Tree = Any
BASELINE = Path(__file__).resolve().parent / "lint_baseline.json"

# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

ALGOS = ("dc_s3gd", "ssgd")
DENSE_REDUCERS = ("mean_allreduce", "gossip", "hierarchical")
COMPRESSED_REDUCERS = ("topk", "topk_exact", "randk", "powersgd")
BUCKET_SETTINGS = (0, 4)
N_WORKERS = 2


@dataclass(frozen=True)
class GridPoint:
    algo: str
    reducer: str
    buckets: int
    overlap: bool
    wire: str = "bfloat16"   # comm_dtype of the audited step

    @property
    def name(self) -> str:
        base = (f"{self.algo}/{self.reducer}/b{self.buckets}/"
                f"{'ov' if self.overlap else 'in'}")
        return base if self.wire == "bfloat16" else f"{base}/{self.wire}"


def iter_grid() -> Iterator[GridPoint]:
    """Every valid grid point, the reference's: compressed reducers need
    the bucketed wire; the overlap pipeline needs buckets > 0 and a
    stale-family algorithm (ssgd's constructor rejects it).  Plus one
    int8-wire point for the quantized byte model."""
    for algo in ALGOS:
        for reducer in DENSE_REDUCERS + COMPRESSED_REDUCERS:
            for buckets in BUCKET_SETTINGS:
                if reducer in COMPRESSED_REDUCERS and not buckets:
                    continue
                for overlap in (False, True):
                    # grid enumeration, not dispatch: ssgd's constructor
                    # itself rejects overlap=True
                    if overlap and (algo == "ssgd"  # lint: allow(algo-branch)
                                    or not buckets):
                        continue
                    yield GridPoint(algo, reducer, buckets, overlap)
    yield GridPoint("dc_s3gd", "topk", 4, False, wire="int8")


# ---------------------------------------------------------------------------
# the step under audit
# ---------------------------------------------------------------------------


class _ToyModel:
    """A many-leaf quadratic: bucketing, the state and the wire are all
    exercised without a transformer.  f32 throughout, so any float
    down-cast in the step is the comm_dtype wire cast or a finding."""

    cfg = None
    N_LEAVES = 6
    DIM = 16

    def init(self, generator: torch.Generator) -> Tree:
        return {f"w{i}": torch.randn((self.DIM, self.DIM),
                                     generator=generator,
                                     device=generator.device) * 0.02
                for i in range(self.N_LEAVES)}

    def loss(self, params: Tree, batch: Tree) -> torch.Tensor:
        acc = 0.0
        for k in sorted(params):
            acc = acc + ((batch["x"] @ params[k]) ** 2).mean()
        return acc


def _transformer_setup(device: torch.device):
    """qwen3-0.6b: on the card at its published widths cut to 4 layers,
    4 x 256 tokens a worker (the training cell); on the CPU the reduced
    config, 2 x 32 tokens a worker."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import SyntheticLMDataset, worker_batches
    from repro_torch.models.transformer import Model

    cfg = get_config("qwen3-0.6b")
    if device.type == "cuda":
        # the card's own size, the training cell's, and the Model's own
        # blocks (the reference's 16-wide ones are its CPU smoke's)
        cfg, seq, per_worker = dataclasses.replace(cfg, n_layers=4), 256, 4
        model = Model(cfg, remat=False, loss_chunk=256)
    else:
        # the reference's lint model (src/repro/analysis/lint.py)
        cfg, seq, per_worker = reduced(cfg), 32, 2
        model = Model(cfg, remat=False, q_chunk=16, kv_chunk=16,
                      scan_chunk=16, loss_chunk=64)
    data = SyntheticLMDataset(cfg.vocab_size, seq, seed=0)
    return model, worker_batches(data, 0, N_WORKERS, per_worker,
                                 device=device)


# dtype name -> bytes of the floats and the quantized wire formats
_FLOATS = {"float64": 8, "float32": 4, "float16": 2, "bfloat16": 2}
_QUANT = {"int8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1}
_WIRE = {**_FLOATS, **_QUANT}


def _dtype_name(comm_dtype: str) -> str:
    if Q.is_quantized(comm_dtype):
        return str(Q.qinfo(comm_dtype)[0]).replace("torch.", "")
    return str(Q.float_wire(comm_dtype)).replace("torch.", "")


def _state_tensors(tree: Tree) -> List[torch.Tensor]:
    return [x for x in T.leaves(tree) if isinstance(x, torch.Tensor)]


class Program:
    """One grid point's algorithm, model, batch and lazily traced step.

    ``trace`` is the first step from a fresh state, run under an op trace
    that watches the buffers an overlap pipeline landed at ``init``;
    ``state_in`` / ``state_out`` are the dtypes-and-structure views the
    passes compare (the tensors themselves are not kept)."""

    def __init__(self, point: GridPoint, *, device, model: str = "toy",
                 use_kernels: bool = False):
        self.point = point
        self.name = point.name
        self.model_kind = model
        self.device = torch.device(device)
        self.use_kernels = use_kernels
        self.cfg = DCS3GDConfig(comm_dtype=point.wire, learning_rate=0.05,
                                momentum=0.9, lambda0=0.2, warmup_steps=1,
                                total_steps=4)
        self.alg = registry.make(point.algo, self.cfg, n_workers=N_WORKERS,
                                 reducer=point.reducer, buckets=point.buckets,
                                 overlap=point.overlap,
                                 use_kernels=use_kernels)
        if model == "toy":
            self.model = _ToyModel()
            self.batch = {"x": torch.ones((N_WORKERS, 2, _ToyModel.DIM),
                                          device=self.device)}
        else:
            self.model, self.batch = _transformer_setup(self.device)
        self.engine = Engine(self.model, self.alg)
        self.n_workers = N_WORKERS
        self.comm = _dtype_name(self.cfg.comm_dtype)
        self._trace: Optional[OpTrace] = None

    def fresh_state(self):
        gen = torch.Generator(device=self.device).manual_seed(0)
        return self.alg.init(self.model.init(gen))

    def batch_fn(self, it: int) -> Tree:
        """The batch a fit loop is driven with: constant shapes (a steady
        loop) unless a fixture overrides it."""
        return self.batch

    def _run_traced(self) -> None:
        state = self.fresh_state()
        landed = {}
        if "pipeline" in state.comm:
            landed = {f"landed[{b}]": r for b, r in
                      enumerate(state.comm["pipeline"]["reduced"])}
        self.state_in = [(x.dtype, tuple(x.shape))
                         for x in _state_tensors(state)]
        self.treedef_in = T.flatten(state)[1]
        self.sync_error = None
        sync = torch.cuda.set_sync_debug_mode \
            if self.device.type == "cuda" else None
        if sync is not None:
            sync("error")
        try:
            tr, new_state, _ = self.engine.trace_train_step(
                state, self.batch, watch=landed)
        except RuntimeError as e:
            if sync is None or "synchroniz" not in str(e):
                raise
            self.sync_error = str(e).splitlines()[0]
            sync(0)
            tr, new_state, _ = self.engine.trace_train_step(
                self.fresh_state(), self.batch, watch=landed)
        finally:
            if sync is not None:
                sync(0)
        tr.meta["landed"] = sorted(landed)
        self.state_out = [(x.dtype, tuple(x.shape))
                          for x in _state_tensors(new_state)]
        self.treedef_out = T.flatten(new_state)[1]
        self._trace = tr

    @property
    def trace(self) -> OpTrace:
        if self._trace is None:
            self._run_traced()
        return self._trace

    @property
    def wire_sizes(self) -> List[int]:
        return self.trace.meta["wire"]["sizes"]

    def inline_sibling(self) -> "Program":
        assert self.point.overlap, self.name
        return Program(GridPoint(self.point.algo, self.point.reducer,
                                 self.point.buckets, False,
                                 wire=self.point.wire),
                       model=self.model_kind, device=self.device,
                       use_kernels=self.use_kernels)


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------


class DonationPass:
    """The step must not keep the state it was given alive: a step (or a
    cache beside it) that holds the old `TrainState` doubles the state's
    memory, invisible to every numeric test.  Weak references to every
    tensor of the old state must die once the caller drops it, unless
    the new state holds the same storage; on the card, the memory
    allocated after the step may exceed the memory before it by the
    step's metrics only (each a 512 B allocator block).  The audited step
    is a steady one, the second from a fresh state."""

    name = "donation"
    BLOCK = 512

    def run(self, prog: Program) -> List[Finding]:
        # the audited step is the second: what a first call allocates for
        # good (kernel libraries, tables cached on the device) is not state
        state = prog.fresh_state()
        state, _ = prog.alg.step(state, prog.batch, loss_fn=prog.model.loss)
        refs = [weakref.ref(t) for t in _state_tensors(state)]
        cuda = prog.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(prog.device)
            before = torch.cuda.memory_allocated(prog.device)
        state, metrics = prog.alg.step(state, prog.batch,
                                       loss_fn=prog.model.loss)
        gc.collect()
        kept = {t.untyped_storage().data_ptr()
                for t in _state_tensors(state)}
        leaked = [t for t in (r() for r in refs) if t is not None
                  and t.untyped_storage().data_ptr() not in kept]
        out = []
        if leaked:
            nb = sum(t.numel() * t.element_size() for t in leaked)
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op="weakref",
                message=f"{len(leaked)}/{len(refs)} tensors ({nb} B) of "
                        f"the old TrainState outlive the step after the "
                        f"caller dropped it"))
        if cuda:
            del leaked
            torch.cuda.synchronize(prog.device)
            after = torch.cuda.memory_allocated(prog.device)
            carried = self.BLOCK * sum(
                -(-t.numel() * t.element_size() // self.BLOCK)
                for t in metrics.values() if isinstance(t, torch.Tensor))
            if after > before + carried:
                out.append(Finding(
                    pass_name=self.name, severity="error",
                    program=prog.name, op="memory_allocated",
                    message=f"the step leaves {after - before} B more "
                            f"allocated than before it; its metrics "
                            f"account for {carried} B"))
        return out


class HostSyncPass:
    """No host transfer inside the step: ``.item()`` (``_local_scalar_
    dense``), an op whose output shape depends on the data, or a copy to
    the CPU waits for the device every step and serializes the dispatch
    queue the overlap design depends on.  On the card the traced step
    runs under ``torch.cuda.set_sync_debug_mode("error")`` too."""

    name = "host-sync"

    def run(self, prog: Program) -> List[Finding]:
        tr = prog.trace
        dev = tr.meta["device"]
        out = []
        counts = {}
        for o in tr.ops:
            short = o.name.split(".")[1] if o.kind == "aten" else ""
            to_cpu = short in ("_to_copy", "copy_") and o.inputs \
                and o.outputs and dev != "cpu" \
                and o.outputs[0][2] == "cpu" and any(
                    i[2] != "cpu" for i in o.inputs)
            if (short in SYNC_OPS and o.inputs and o.inputs[0][2] == dev) \
                    or to_cpu:
                key = "device->cpu copy" if to_cpu else o.name
                counts[key] = counts.get(key, 0) + 1
        for op, n in sorted(counts.items()):
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op=op,
                message=f"{n} host-transfer op(s) ({op}) inside the train "
                        f"step — every step waits for the device"))
        if prog.sync_error:
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op="sync_debug_mode",
                message=f"the step synchronized under "
                        f"set_sync_debug_mode('error'): {prog.sync_error}"))
        return out


class RetracePass:
    """A steady ``Engine.fit`` loop must not grow the caches behind its
    step (the eager counterpart of the reference's retrace: a plan keyed
    on something that changes every step rebuilds it every step).
    `Engine.retrace_stats` after the loop's first step must equal the
    stats after its third, with no algorithm rebuild.  Restricted to the
    cheap mean_allreduce points, as the reference's."""

    name = "recompile"
    STEPS = 3

    def applies(self, point: GridPoint) -> bool:
        return point.reducer == "mean_allreduce"

    def run(self, prog: Program) -> List[Finding]:
        if not self.applies(prog.point):
            return []
        state = prog.fresh_state()
        with contextlib.redirect_stdout(io.StringIO()):
            state, _, _ = prog.engine.fit(state, prog.batch_fn, steps=1,
                                          log_every=100)
            first = prog.engine.retrace_stats()
            prog.engine.fit(state, prog.batch_fn, steps=self.STEPS,
                            start=1, log_every=100)
        last = prog.engine.retrace_stats()
        out = []
        for key in ("plan_cache_size", "kernel_builds"):
            if last[key] != first[key]:
                out.append(Finding(
                    pass_name=self.name, severity="error",
                    program=prog.name, op=key,
                    message=f"{key} grew from {first[key]} after step 1 "
                            f"to {last[key]} after {self.STEPS} "
                            f"constant-shape steps (expected steady)"))
        if last["fit_rejits"]:
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op="rejit",
                message=f"fit loop rebuilt its algorithm "
                        f"{last['fit_rejits']} time(s) without an elastic "
                        f"transition"))
        return out


def _in_wire(op) -> bool:
    return op.in_scope("wire")


class DtypeDriftPass:
    """Two prongs.  Structural: the state's leaf dtypes after the step
    equal those before it (a reducer or optimizer that silently adopts a
    narrower dtype corrupts the carried params, slots, ``delta_prev`` or
    residuals cumulatively).  Cast census: every float down-cast in the
    step goes to f32, to the model's compute dtype inside the ``model``
    scope, or to the declared ``comm_dtype`` inside the ``wire`` scope,
    where the reducers put the simulated wire; a quantize cast is legal
    only as the comm_dtype inside the wire scope."""

    name = "dtype-drift"

    def run(self, prog: Program) -> List[Finding]:
        tr = prog.trace
        out = []
        if prog.treedef_in != prog.treedef_out \
                or len(prog.state_in) != len(prog.state_out):
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op="state-structure",
                message="the state's tree structure changes across the "
                        "step"))
        for i, ((a, _), (b, _)) in enumerate(zip(prog.state_in,
                                                 prog.state_out)):
            if a != b:
                out.append(Finding(
                    pass_name=self.name, severity="error",
                    program=prog.name, op="state-leaf",
                    location=f"leaf[{i}]",
                    message=f"state leaf dtype drifts across the step: "
                            f"{str(a).replace('torch.', '')} in, "
                            f"{str(b).replace('torch.', '')} out"))
        comm = prog.comm
        compute = tr.meta.get("compute_dtype")
        for c, op in tr.casts():
            where = "/".join(op.scope)
            if c.src not in _FLOATS:
                continue
            if c.dst in _QUANT:
                if c.dst == comm and not _in_wire(op):
                    out.append(Finding(
                        pass_name=self.name, severity="error",
                        program=prog.name, op=f"convert->{c.dst}",
                        location=where,
                        message=f"quantize cast {c.src}->{c.dst} "
                                f"({c.elements} elements) outside the "
                                f"'wire' scope — a wire quantization "
                                f"leaked into compute"))
                continue
            if c.dst not in _FLOATS or _FLOATS[c.dst] >= _FLOATS[c.src] \
                    or c.dst == "float32":
                continue  # up-casts, same width and f32 lose nothing new
            model_cast = c.dst == compute and op.in_scope("model")
            if c.dst == comm and not _in_wire(op) and not model_cast:
                out.append(Finding(
                    pass_name=self.name, severity="error",
                    program=prog.name, op=f"convert->{c.dst}",
                    location=where,
                    message=f"comm_dtype down-cast {c.src}->{c.dst} "
                            f"({c.elements} elements) outside the 'wire' "
                            f"scope — a wire cast leaked into compute"))
            elif c.dst != comm and not model_cast:
                out.append(Finding(
                    pass_name=self.name, severity="error",
                    program=prog.name, op=f"convert->{c.dst}",
                    location=where,
                    message=f"unexpected down-cast {c.src}->{c.dst} "
                            f"({c.elements} elements) — not the declared "
                            f"comm_dtype and not the compute dtype"))
        return out


class FencePass:
    """Overlap steps must keep the pipeline's contract (the seam the
    bitwise-equal-to-inline guarantee rests on): the step issues exactly
    one reduce, at its tail (after the model's forward and backward), with
    the same op sequence as the inline sibling's reduce (the pipeline
    moves the reduce, it never duplicates or drops one), and it reads
    every buffer the previous issue landed."""

    name = "fence"

    def run(self, prog: Program) -> List[Finding]:
        if not prog.point.overlap:
            return []
        tr = prog.trace
        out = []
        wires = [i for n, i in tr.regions if n == "wire"]
        models = [i for n, i in tr.regions if n == "model"]
        if len(wires) != 1:
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op="issue",
                message=f"overlap step entered the wire {len(wires)} "
                        f"times (expected one issue per step)"))
        elif models and wires[0] < models[-1]:
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op="issue",
                message="overlap step reduces before its forward and "
                        "backward pass: the reduce was not moved to the "
                        "tail"))
        unread = [lab for lab in tr.meta.get("landed", ())
                  if not any(lab in o.reads for o in tr.ops)]
        if unread:
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op="consume",
                message=f"the step never reads {len(unread)} landed "
                        f"buffer(s) {unread}: the pipeline is unfenced "
                        f"(the landed reduce is dropped)"))
        inline = prog.inline_sibling().trace
        pipe = [o.name for o in tr.ops if _in_wire(o)]
        ref = [o.name for o in inline.ops if _in_wire(o)]
        if pipe != ref:
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op="reduce",
                message=f"pipelined step runs {len(pipe)} wire ops vs "
                        f"{len(ref)} inline — the overlap schedule "
                        f"duplicated or dropped a collective"))
        return out


class WireAccountingPass:
    """The hand-written wire accounting against the traced step: the
    comm_dtype down-cast bytes in the ``wire`` scope must equal the
    reducer's ``wire_model()["cast_bytes"]``, and ``Reducer.wire_bytes``
    (the bench column) the same model's separately written
    ``accounted_bytes``; a compressed reducer may not account more than
    the dense payload.  Skipped on an f32 wire (no cast to count)."""

    name = "wire-accounting"

    def run(self, prog: Program) -> List[Finding]:
        red = getattr(prog.alg, "reducer", None)
        if red is None or not hasattr(red, "wire_model"):
            return []
        it = Q.wire_itemsize(prog.cfg.comm_dtype)
        if it == 4:
            return []
        sizes = prog.wire_sizes
        model = red.wire_model(sizes, prog.n_workers)
        observed = sum(
            c.elements * _WIRE[c.dst] for c, op in prog.trace.casts("wire")
            if c.dst == prog.comm and c.src in _FLOATS
            and _WIRE[c.dst] < _FLOATS[c.src])
        out = []
        if observed != int(model["cast_bytes"]):
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op="cast-census",
                message=f"traced wire-scope comm_dtype casts move "
                        f"{observed} bytes but the reducer's wire_model "
                        f"predicts {int(model['cast_bytes'])} — the step "
                        f"and the model drifted apart"))
        accounted = int(red.wire_bytes(sizes))
        if accounted != int(model["accounted_bytes"]):
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op="wire-bytes",
                message=f"Reducer.wire_bytes says {accounted} B/step but "
                        f"wire_model accounts {int(model['accounted_bytes'])}"
                        f" — the bench column no longer matches the hand "
                        f"accounting"))
        dense = sum(sizes) * it
        if not getattr(red, "stateless", True) and accounted > dense:
            out.append(Finding(
                pass_name=self.name, severity="error", program=prog.name,
                op="compression",
                message=f"compressed reducer accounts {accounted} B/step "
                        f"> dense payload {dense} B — compression that "
                        f"inflates the wire"))
        return out


PASSES = (DonationPass(), HostSyncPass(), RetracePass(), DtypeDriftPass(),
          FencePass(), WireAccountingPass())


# ---------------------------------------------------------------------------
# runners + CLI
# ---------------------------------------------------------------------------


def run_point(prog: Program, passes: Sequence = PASSES) -> List[Finding]:
    findings: List[Finding] = []
    for p in passes:
        findings.extend(p.run(prog))
    return findings


def run_grid(points: Optional[Sequence[GridPoint]] = None, *,
             device, model: str = "toy", use_kernels: bool = False,
             passes: Sequence = PASSES, verbose: bool = False
             ) -> List[Finding]:
    findings: List[Finding] = []
    for point in (points if points is not None else iter_grid()):
        prog = Program(point, model=model, device=device,
                       use_kernels=use_kernels)
        got = run_point(prog, passes)
        findings.extend(got)
        if verbose:
            print(f"[lint] {point.name:40s} "
                  f"{'OK' if not got else f'{len(got)} finding(s)'}",
                  file=sys.stderr)
        del prog
    return findings


def run_ast(src_root=None) -> List[Finding]:
    from repro_torch.analysis import astlint
    root = Path(__file__).resolve().parents[1] if src_root is None \
        else src_root
    return astlint.lint_paths(root)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.lint",
        description="analyzer over traced train steps (layer 1) and the "
                    "port's source tree (layer 2)")
    ap.add_argument("--select", default="",
                    help="substring filter on grid-point names "
                         "(e.g. 'topk', 'dc_s3gd', '/ov')")
    ap.add_argument("--model", choices=("toy", "transformer"),
                    default="toy")
    ap.add_argument("--device", default="cuda",
                    help="torch device the grid's steps run on (default "
                         "cuda; cpu on request)")
    ap.add_argument("--use-kernels", action="store_true",
                    help="run the fused update tail and topk's compression "
                         "through the kernels")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="write the repro.lint/v1 report here")
    ap.add_argument("--baseline", default=None,
                    help="committed baseline report; only NEW findings "
                         "gate the exit status")
    ap.add_argument("--write-baseline", dest="write_baseline",
                    default=None,
                    help="write the current findings as a baseline report "
                         "and exit 0")
    ap.add_argument("--no-ast", action="store_true",
                    help="skip the AST layer")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the traced-step layer")
    ap.add_argument("--src", default=None,
                    help="source root for the AST layer (default: the "
                         "repro_torch package)")
    ap.add_argument("--list", action="store_true",
                    help="print the grid and exit")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    points = [p for p in iter_grid() if args.select in p.name]
    if args.list:
        for p in points:
            print(p.name)
        return 0
    from repro_torch.launch.train import resolve_device
    device = torch.device(args.device) if args.no_trace \
        else resolve_device(args.device)

    findings: List[Finding] = []
    if not args.no_trace:
        findings.extend(run_grid(points, model=args.model, device=device,
                                 use_kernels=args.use_kernels,
                                 verbose=not args.quiet))
    if not args.no_ast:
        findings.extend(run_ast(args.src))

    meta = {"grid": [p.name for p in points], "model": args.model,
            "ast": not args.no_ast, "torch": torch.__version__,
            "device": device.type, "use_kernels": args.use_kernels}
    report = findings_report(findings, meta)
    if args.write_baseline:
        Path(args.write_baseline).write_text(json.dumps(report, indent=2)
                                             + "\n")
        print(f"wrote baseline with {len(findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0
    if args.json_path:
        Path(args.json_path).write_text(json.dumps(report, indent=2) + "\n")
    baseline = load_baseline(args.baseline) if args.baseline else set()
    fresh = new_findings(findings, baseline)
    suppressed = len(findings) - len(fresh)
    print(render_findings(fresh))
    if suppressed:
        print(f"({suppressed} baseline finding(s) suppressed)")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
