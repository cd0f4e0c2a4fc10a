# Port of src/repro/analysis/lint.py: the same walk over the port's tree
# (``src/repro_torch``), with the port's own waiver file.
"""The architecture-lint pass: walk the tree, apply every registered rule,
partition findings against the waiver file, return a :class:`Report`.

Paths in findings are always repo-relative posix paths — the report must be
byte-stable across machines so it can be committed and schema-checked.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis import rules as R
from repro_torch.analysis.findings import (Finding, Report, load_waivers,
                                           split_waived)

DEFAULT_ROOTS = ("src/repro_torch",)
# the port's waiver file, beside the reference's LINT_WAIVERS
DEFAULT_WAIVER_FILE = "LINT_WAIVERS_torch"
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}


def find_repo_root(start: Optional[str] = None) -> str:
    """Nearest ancestor holding ``src/repro_torch`` (falls back to the
    package's own checkout when run from elsewhere)."""
    here = os.path.abspath(start or os.getcwd())
    probe = here
    while True:
        if os.path.isdir(os.path.join(probe, "src", "repro_torch")):
            return probe
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    # package layout: <root>/src/repro_torch/analysis/lint.py
    return os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        "..", "..", ".."))


def iter_py_files(repo_root: str,
                  roots: Sequence[str] = DEFAULT_ROOTS) -> Iterable[str]:
    """Repo-relative posix paths of every .py file under ``roots``, sorted
    for deterministic reports."""
    out: List[str] = []
    for root in roots:
        base = os.path.join(repo_root, root)
        if os.path.isfile(base) and base.endswith(".py"):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn),
                                          repo_root)
                    out.append(rel.replace(os.sep, "/"))
    return sorted(out)


def lint_file(relpath: str, source: str,
              active_rules=None) -> List[Finding]:
    """Apply every (scoped) rule to one module's source."""
    active_rules = active_rules if active_rules is not None else R.all_rules()
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as e:
        return [Finding(rule="parse-error", path=relpath,
                        line=e.lineno or 0, message=str(e.msg))]
    findings: List[Finding] = []
    for rule in active_rules:
        if rule.applies_to(relpath):
            findings.extend(rule.check(tree, relpath, source))
    return findings


def run_lint(repo_root: Optional[str] = None,
             roots: Sequence[str] = DEFAULT_ROOTS,
             rule_ids: Optional[Sequence[str]] = None,
             waiver_file: Optional[str] = None) -> Report:
    """Lint every Python file under ``roots`` and return the report with
    waivers applied (``waiver_file`` defaults to ``LINT_WAIVERS_torch`` at
    the repo root; absent == empty)."""
    repo_root = repo_root or find_repo_root()
    active = (tuple(R.get_rule(i) for i in rule_ids)
              if rule_ids is not None else R.all_rules())
    waiver_path = (waiver_file if waiver_file is not None
                   else os.path.join(repo_root, DEFAULT_WAIVER_FILE))
    waivers = load_waivers(waiver_path)

    findings: List[Finding] = []
    files = list(iter_py_files(repo_root, roots))
    for rel in files:
        with open(os.path.join(repo_root, rel)) as f:
            findings.extend(lint_file(rel, f.read(), active))
    active_findings, waived = split_waived(findings, waivers)
    return Report(roots=list(roots), rules=[r.id for r in active],
                  findings=active_findings, waived=waived,
                  waiver_file=os.path.basename(waiver_path),
                  files_scanned=len(files))
