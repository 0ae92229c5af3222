"""The findings half of the reference's report module
(``repro.analysis.report``, lines 1-135): the one record type both lint
layers emit and its ``repro.lint/v1`` JSON schema.

`repro_torch.analysis.lint` (passes over a traced train step) and
`repro_torch.analysis.astlint` (rules over the source tree) emit
`Finding` records; `findings_report` / `parse_report` serialize them, and
a committed baseline (``src/repro_torch/analysis/lint_baseline.json``,
empty) is matched by `Finding.key`: only findings outside it fail the
CLI.  The same findings give the same JSON as the reference's.  The
dry-run tables wait for the port's dry-run launcher.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# lint findings: the one record type both analyzer layers emit
# ---------------------------------------------------------------------------

LINT_SCHEMA = "repro.lint/v1"

SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Finding:
    """One analyzer finding.

    ``pass_name`` is the emitting pass (``donation``, ``ast.algo-branch``,
    ...); ``program`` identifies what was audited (a grid-point id like
    ``dc_s3gd/topk/b4/ov`` for the traced-step passes, a source path
    for AST passes); ``op``/``location`` pin the finding to an op kind
    resp. a scope string or ``file:line``."""

    pass_name: str
    severity: str
    message: str
    program: str = ""
    op: str = ""
    location: str = ""

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity

    @property
    def key(self) -> str:
        """Stable identity used for baseline matching: everything except
        the free-text message tail (messages may carry measured numbers
        that drift without the finding being new)."""
        return "::".join((self.pass_name, self.program, self.op,
                          self.location))

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(**{k: d.get(k, "") for k in
                      ("pass_name", "severity", "message", "program",
                       "op", "location")})


def findings_report(findings: Sequence[Finding],
                    meta: Optional[dict] = None) -> dict:
    """The ``repro.lint/v1`` JSON document (round-trips via
    `parse_report`): findings sorted most-severe first, per-severity
    counts, and the caller's run metadata (grid, model, versions)."""
    order = {s: i for i, s in enumerate(SEVERITIES)}
    ranked = sorted(findings,
                    key=lambda f: (order[f.severity], f.pass_name,
                                   f.program, f.location))
    counts: Dict[str, int] = {s: 0 for s in SEVERITIES}
    for f in findings:
        counts[f.severity] += 1
    return {
        "schema": LINT_SCHEMA,
        "meta": dict(meta or {}),
        "counts": counts,
        "findings": [f.to_dict() for f in ranked],
    }


def parse_report(doc: dict) -> Tuple[List[Finding], dict]:
    """Inverse of `findings_report`; raises on a schema mismatch."""
    if doc.get("schema") != LINT_SCHEMA:
        raise ValueError(f"not a {LINT_SCHEMA} report: "
                         f"schema={doc.get('schema')!r}")
    return [Finding.from_dict(d) for d in doc.get("findings", [])], \
        dict(doc.get("meta", {}))


def load_baseline(path) -> Set[str]:
    """Baseline keys from a committed report file; a missing file is an
    empty baseline (everything is new)."""
    p = Path(path)
    if not p.exists():
        return set()
    findings, _ = parse_report(json.loads(p.read_text()))
    return {f.key for f in findings}


def new_findings(findings: Iterable[Finding],
                 baseline: Set[str]) -> List[Finding]:
    """Findings not covered by the baseline — the set a CI gate fails
    on."""
    return [f for f in findings if f.key not in baseline]


def render_findings(findings: Sequence[Finding]) -> str:
    """Console rendering: one line per finding, most-severe first."""
    if not findings:
        return "no findings"
    doc = findings_report(findings)
    lines = []
    for d in doc["findings"]:
        where = d["program"] or d["location"] or "-"
        if d["program"] and d["location"]:
            where = f"{d['program']} @ {d['location']}"
        lines.append(f"[{d['severity']:7s}] {d['pass_name']:22s} "
                     f"{where}: {d['message']}")
    return "\n".join(lines)
