# Port of src/repro/analysis/findings.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Findings, waivers and the machine-readable ``repro-lint`` report.

A :class:`Finding` is one violated invariant at one source location (or one
audited entry point).  Findings from both analyzer layers — the AST
architecture linter (:mod:`repro_torch.analysis.rules`) and the jaxpr/HLO dispatch
auditor (:mod:`repro_torch.analysis.dispatch`) — share this shape, so CI gates on
ONE report.

Waivers are explicit, committed and line-addressed: the file (default
``LINT_WAIVERS`` at the repo root) holds one ``rule:path`` or
``rule:path:line`` pattern per line.  An empty waiver file is the intended
steady state — the acceptance bar for every PR that touches the hot path.

The report itself is strict JSON (``allow_nan=False``, sorted keys, no
timestamps): regenerating it on an unchanged tree is byte-stable, so the
artifact can be committed and schema-checked by ``benchmarks/run.py
--check`` exactly like the BENCH files.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

REPORT_SCHEMA = "repro-lint-report/v1"
DEFAULT_WAIVER_FILE = "LINT_WAIVERS"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant: a lint rule (or audit contract) ``rule`` at
    ``path:line`` with a human-readable ``message``."""
    rule: str
    path: str               # repo-relative, posix separators
    line: int               # 1-based; 0 for whole-file / entry-point findings
    message: str
    severity: str = "error"

    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.line}"

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def load_waivers(path: Optional[str]) -> List[str]:
    """Waiver patterns from ``path``: one ``rule:path[:line]`` per line,
    ``#`` comments and blanks ignored.  A missing file is an empty list —
    same contract as an empty file."""
    if path is None or not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if line:
                out.append(line)
    return out


def is_waived(finding: Finding, waivers: Sequence[str]) -> bool:
    """A waiver matches a finding exactly (``rule:path:line``) or for a
    whole file (``rule:path``)."""
    return (finding.key() in waivers
            or f"{finding.rule}:{finding.path}" in waivers)


def split_waived(findings: Sequence[Finding], waivers: Sequence[str]):
    """-> (active, waived) partitions, both sorted for stable reports."""
    active = [f for f in findings if not is_waived(f, waivers)]
    waived = [f for f in findings if is_waived(f, waivers)]
    order = lambda f: (f.path, f.line, f.rule)          # noqa: E731
    return sorted(active, key=order), sorted(waived, key=order)


@dataclasses.dataclass
class Report:
    """The full ``repro-lint`` result: both layers, waivers applied."""
    roots: List[str]
    rules: List[str]
    findings: List[Finding] = dataclasses.field(default_factory=list)
    waived: List[Finding] = dataclasses.field(default_factory=list)
    waiver_file: str = DEFAULT_WAIVER_FILE
    files_scanned: int = 0
    audit: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.findings and not self.audit.get("findings")

    def to_dict(self) -> Dict[str, object]:
        return {
            "schema": REPORT_SCHEMA,
            "roots": list(self.roots),
            "rules": sorted(self.rules),
            "findings": [f.as_dict() for f in self.findings],
            "waived": [f.as_dict() for f in self.waived],
            "waiver_file": self.waiver_file,
            "counts": {
                "files_scanned": self.files_scanned,
                "findings": len(self.findings),
                "waived": len(self.waived),
            },
            "audit": self.audit,
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True,
                      allow_nan=False)
            f.write("\n")
