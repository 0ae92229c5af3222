"""The reference's report module (``repro.analysis.report``): the one
record type both lint layers emit and its ``repro.lint/v1`` JSON schema,
and the dry-run tables over the records `repro_torch.launch.dryrun`
writes (``experiments/dryrun_torch``).

`repro_torch.analysis.lint` (passes over a traced train step) and
`repro_torch.analysis.astlint` (rules over the source tree) emit
`Finding` records; `findings_report` / `parse_report` serialize them, and
a committed baseline (``src/repro_torch/analysis/lint_baseline.json``,
empty) is matched by `Finding.key`: only findings outside it fail the
CLI.  The same findings give the same JSON as the reference's.

    PYTHONPATH=src python -m repro_torch.analysis.report [DIR]
"""
from __future__ import annotations

import glob
import json
import sys
from collections import defaultdict
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


# ---------------------------------------------------------------------------
# dry-run tables
# ---------------------------------------------------------------------------

DRYRUN_DIR = "experiments/dryrun_torch"


def load(mesh: str, directory: str = DRYRUN_DIR) -> dict:
    """{(arch, shape): record} of one mesh's dry-run records."""
    out = {}
    for f in sorted(glob.glob(f"{directory}/*__{mesh}__*.json")):
        r = json.loads(Path(f).read_text())
        out[(r["arch"], r["shape"])] = r
    return out


def fmt_mem(b) -> str:
    """GiB with one decimal; ``-`` for a null (a record without the
    number)."""
    return "-" if b is None else f"{b/2**30:.1f}"


def roofline_table(mesh: str, directory: str = DRYRUN_DIR) -> str:
    rows = load(mesh, directory)
    lines = [
        f"### Mesh `{mesh}` "
        f"({'512 GPUs (2,16,16)' if mesh == 'multipod' else '256 GPUs (16,16)'})",
        "",
        "| arch | shape | compute (ms) | memory (ms) | collective (ms, "
        "NVLink / network) | bottleneck | useful-FLOPs | args GiB/dev | "
        "temp GiB/dev | trace s |",
        "|---|---|---:|---:|---:|---|---:|---:|---:|---:|",
    ]
    for (arch, shape), r in sorted(rows.items()):
        if r["status"] != "ok":
            lines.append(f"| {arch} | {shape} | - | - | - | *{r['status']}:"
                         f" {r['reason'][:60]}* | - | - | - | - |")
            continue
        ro, m = r["roofline"], r["memory"]
        lines.append(
            f"| {arch} | {shape} | {ro['compute_s']*1e3:.1f} | "
            f"{ro['memory_s']*1e3:.1f} | {ro['collective_s']*1e3:.1f} / "
            f"{ro.get('collective_net_s', 0.0)*1e3:.1f} | "
            f"**{ro['bottleneck']}** | {ro['useful_flops_ratio']:.2f} | "
            f"{fmt_mem(m['argument_bytes'])} | {fmt_mem(m['temp_bytes'])} | "
            f"{r['compile_s']:.0f} |")
    return "\n".join(lines)


def dryrun_summary(mesh: str, directory: str = DRYRUN_DIR) -> str:
    rows = load(mesh, directory)
    n = defaultdict(int)
    by_bound = defaultdict(int)
    for r in rows.values():
        n[r["status"]] += 1
        if r["status"] == "ok":
            by_bound[r["roofline"]["bottleneck"]] += 1
    return (f"mesh `{mesh}`: {n['ok']} built + traced OK, {n['skipped']} "
            f"noted skips, {n['fail']} failed; bottleneck split: "
            f"{dict(by_bound)}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    directory = argv[0] if argv else DRYRUN_DIR
    for mesh in ("pod", "multipod"):
        print(dryrun_summary(mesh, directory))
        print()
        print(roofline_table(mesh, directory))
        print()


if __name__ == "__main__":
    main()
