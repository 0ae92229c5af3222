"""AST-level lint of the port's source tree (`repro_torch.analysis.lint`
layer 2; the port of ``repro.analysis.astlint``).

Where layer 1 audits a *traced train step*, this layer enforces the
source-level rules the ROADMAP states, over ``src/repro_torch``:

* ``ast.algo-branch`` — no algorithm-name branching (``if algo ==
  "dc_s3gd"`` / ``algo in ("ssgd", ...)`` / ``match algo``) outside
  ``core/registry.py``: call sites construct algorithms from config
  strings through the registry, never special-case one.
* ``ast.algo-import`` — no direct imports of algorithm modules
  (``repro_torch.core.dc_s3gd`` / ``ssgd`` / ``dc_asgd``) outside
  ``core/``; the registry's lazy provider list is the only sanctioned
  coupling.
* ``ast.wallclock-cluster`` — no wall-clock reads (``time.time`` /
  ``time.perf_counter`` / ``datetime.now``) inside ``cluster/``:
  membership transitions must be deterministic and replayable; timing
  lives behind the Engine's ``measure_skew`` seam.
* ``ast.host-pull-in-traced`` — no ``.item()`` / ``.tolist()`` /
  ``.cpu()`` / ``np.asarray`` / ``np.array`` inside the step's packages
  (``core``, ``parallel``, ``optim``): on a device tensor each one
  waits for the card, a host sync inside the step.
* ``ast.trainstate-mutation`` — no attribute assignment to a
  ``TrainState``'s fields (``x.params = ...`` etc.): the state is a
  frozen NamedTuple; mutation "working" means ``x`` was silently a
  different object.

Suppression: append ``# lint: allow(rule-name)`` to the flagged line,
with a justification in a nearby comment.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

from repro_torch.analysis.report import Finding

# the registered algorithm names (`repro_torch.core.registry`); a string
# comparison against one of these outside the registry is a branch the
# "no `if algo == ...`" rule exists to prevent
ALGO_NAMES = frozenset({"dc_s3gd", "ssgd", "stale", "dc_asgd"})

# algorithm provider modules nothing outside core/ may import
ALGO_MODULES = ("repro_torch.core.dc_s3gd", "repro_torch.core.ssgd",
                "repro_torch.core.dc_asgd")

# frozen TrainState fields (repro_torch.core.api)
STATE_FIELDS = frozenset({"params", "opt", "comm", "step"})

WALLCLOCK_CALLS = frozenset({
    ("time", "time"), ("time", "perf_counter"), ("time", "monotonic"),
    ("time", "time_ns"), ("datetime", "now"), ("datetime", "utcnow"),
})

HOST_PULL_CALLS = frozenset({
    ("np", "asarray"), ("np", "array"), ("numpy", "asarray"),
    ("numpy", "array"),
})
# tensor methods that copy a device value to the host
HOST_PULL_METHODS = frozenset({"item", "tolist", "cpu"})

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([\w\-., ]+)\)")


def _allowed_rules(line: str) -> frozenset:
    m = _ALLOW_RE.search(line)
    if not m:
        return frozenset()
    return frozenset(r.strip() for r in m.group(1).split(","))


def _dotted(node: ast.AST) -> Optional[tuple]:
    """``a.b.c`` -> ('a', 'b', 'c'); None for anything dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


class _FileLinter(ast.NodeVisitor):
    def __init__(self, rel: str, lines: Sequence[str]):
        self.rel = rel
        self.lines = lines
        self.findings: List[Finding] = []
        self.in_registry = rel.replace("\\", "/").endswith(
            "core/registry.py")
        self.in_core = "/core/" in ("/" + rel.replace("\\", "/"))
        self.in_cluster = "/cluster/" in ("/" + rel.replace("\\", "/"))
        self.in_traced_pkg = any(
            f"/{pkg}/" in ("/" + rel.replace("\\", "/"))
            for pkg in ("core", "parallel", "optim"))

    def _emit(self, rule: str, node: ast.AST, message: str,
              severity: str = "error") -> None:
        line = self.lines[node.lineno - 1] \
            if 0 < node.lineno <= len(self.lines) else ""
        if rule in _allowed_rules(line) or "*" in _allowed_rules(line):
            return
        self.findings.append(Finding(
            pass_name=f"ast.{rule}", severity=severity, message=message,
            location=f"{self.rel}:{node.lineno}"))

    # -- algo-branch --------------------------------------------------------

    def _algo_consts(self, nodes: Iterable[ast.AST]) -> List[str]:
        hits = []
        for n in nodes:
            if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                    and n.value in ALGO_NAMES:
                hits.append(n.value)
            elif isinstance(n, (ast.Tuple, ast.List, ast.Set)):
                hits.extend(self._algo_consts(n.elts))
        return hits

    def visit_Compare(self, node: ast.Compare) -> None:
        if not self.in_registry:
            hits = self._algo_consts([node.left, *node.comparators])
            if hits:
                self._emit(
                    "algo-branch", node,
                    f"comparison against algorithm name(s) "
                    f"{sorted(set(hits))} — construct through "
                    f"the registry instead of branching")
        self.generic_visit(node)

    def visit_Match(self, node: ast.Match) -> None:
        if not self.in_registry:
            consts = [c.pattern.value for case in node.cases
                      for c in ast.walk(case.pattern)
                      if isinstance(c, ast.MatchValue)
                      and isinstance(c.pattern, ast.Constant)
                      and isinstance(c.pattern.value, str)
                      and c.pattern.value in ALGO_NAMES]
            if consts:
                self._emit(
                    "algo-branch", node,
                    f"match over algorithm name(s) {sorted(set(consts))} "
                    f"— construct through the registry instead")
        self.generic_visit(node)

    # -- algo-import --------------------------------------------------------

    def _check_import(self, node: ast.AST, module: str) -> None:
        if self.in_core:
            return
        for mod in ALGO_MODULES:
            if module == mod or module.startswith(mod + "."):
                self._emit(
                    "algo-import", node,
                    f"direct import of algorithm module {module!r} — "
                    f"only core/registry.py may couple to providers")

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._check_import(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and not node.level:
            self._check_import(node, node.module)
        self.generic_visit(node)

    # -- wallclock-cluster / host-pull-in-traced ----------------------------

    def visit_Call(self, node: ast.Call) -> None:
        if self.in_traced_pkg and isinstance(node.func, ast.Attribute) \
                and node.func.attr in HOST_PULL_METHODS:
            self._emit(
                "host-pull-in-traced", node,
                f"host pull .{node.func.attr}() inside a train-step "
                f"package — on a device tensor it waits for the card (a "
                f"host sync inside the step)")
        dotted = _dotted(node.func)
        if dotted and len(dotted) >= 2:
            tail = (dotted[-2], dotted[-1])
            if self.in_cluster and tail in WALLCLOCK_CALLS:
                self._emit(
                    "wallclock-cluster", node,
                    f"wall-clock read {'.'.join(dotted)} in a "
                    f"deterministic cluster path — timing belongs "
                    f"behind Engine(measure_skew)/skew_probe")
            if self.in_traced_pkg and tail in HOST_PULL_CALLS:
                self._emit(
                    "host-pull-in-traced", node,
                    f"host pull {'.'.join(dotted)} inside a train-step "
                    f"package — keep device values on the device (a host "
                    f"sync in the step serializes dispatch)")
        self.generic_visit(node)

    # -- trainstate-mutation ------------------------------------------------

    def _check_target(self, tgt: ast.AST) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for t in tgt.elts:
                self._check_target(t)
            return
        if isinstance(tgt, ast.Attribute) and tgt.attr in STATE_FIELDS:
            base = tgt.value
            if isinstance(base, ast.Name) and base.id in ("self", "cls"):
                return
            self._emit(
                "trainstate-mutation", tgt,
                f"attribute assignment to .{tgt.attr} — TrainState is a "
                f"frozen NamedTuple; build a new state with ._replace / "
                f"the TrainState constructor")

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._check_target(tgt)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target)
        self.generic_visit(node)


def lint_file(path: Path, root: Path) -> List[Finding]:
    rel = str(path.relative_to(root))
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:  # pragma: no cover - repo code always parses
        return [Finding(pass_name="ast.parse", severity="error",
                        message=f"syntax error: {e.msg}",
                        location=f"{rel}:{e.lineno or 0}")]
    linter = _FileLinter(rel, src.splitlines())
    linter.visit(tree)
    return linter.findings


def lint_paths(root) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` (normally ``src/repro_torch``);
    findings carry ``location = relpath:line``."""
    root = Path(root)
    findings: List[Finding] = []
    for path in sorted(root.rglob("*.py")):
        findings.extend(lint_file(path, root))
    return findings
