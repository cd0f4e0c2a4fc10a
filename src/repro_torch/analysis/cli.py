# Port of src/repro/analysis/cli.py: the port's lint over src/repro_torch and
# its entry-point audit (no compiled-HLO walk: the port has no compiler).
"""``repro-torch-lint``: the port's static invariant analyzer.

Quickstart::

  # architecture lint only (fast, runs nothing)
  PYTHONPATH=src python -m repro_torch.analysis --strict

  # lint + one watched call of every registered entry point at reduced
  # geometry on the card: launches a call, syncs, memory in place, uint8
  PYTHONPATH=src python -m repro_torch.analysis --strict --audit

  # the same audit on the CPU, writing the machine-readable report (no
  # launch or allocation check: the counters count the card's launches)
  PYTHONPATH=src python -m repro_torch.analysis --strict --audit \
      --device cpu --report LINT_REPORT_torch.json

The audit runs on the card unless ``--device`` names another device, as
every entry point of the port does; without a card and without
``--device cpu`` it raises.  Exit
status: 0 when clean (waived findings don't fail), 1 when any active
finding survives — with ``--strict`` this is a hard CI gate.  The waiver
file (``LINT_WAIVERS_torch`` at the repo root) is expected to be EMPTY; a
waiver is a visible, committed debt marker, not an escape hatch.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from repro_torch.analysis import lint as L
from repro_torch.analysis.findings import Finding


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="Static invariant analyzer of the port: AST "
                    "architecture lint + an audit of one watched call of "
                    "every registered entry point.")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on any active (unwaived) finding")
    p.add_argument("--audit", action="store_true",
                   help="also audit every registered entry point (one "
                        "watched call each at reduced geometry)")
    p.add_argument("--device", default=None,
                   help="the device the audit runs on (default: cuda; "
                        "cpu leaves out launches a call and the memory "
                        "check)")
    p.add_argument("--report", metavar="PATH",
                   help="write the strict-JSON findings report here")
    p.add_argument("--waivers", metavar="PATH",
                   help=f"waiver file (default: {L.DEFAULT_WAIVER_FILE} at "
                        f"the repo root; missing == empty)")
    p.add_argument("--root", metavar="DIR",
                   help="repo root (default: auto-detected)")
    p.add_argument("--rules", nargs="*", metavar="RULE",
                   help="restrict the lint pass to these rule ids")
    p.add_argument("roots", nargs="*", default=None,
                   help=f"directories to lint (default: "
                        f"{' '.join(L.DEFAULT_ROOTS)})")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    repo_root = os.path.abspath(args.root) if args.root else L.find_repo_root()
    roots = tuple(args.roots) if args.roots else L.DEFAULT_ROOTS

    report = L.run_lint(repo_root=repo_root, roots=roots,
                        rule_ids=args.rules, waiver_file=args.waivers)

    audit_findings: List[Finding] = []
    if args.audit:
        from repro_torch.analysis import dispatch as D
        from repro_torch.analysis import entrypoints as E
        targets, engine = E.default_targets(device=args.device)
        buckets = E.prefill_buckets(engine)
        extra = D.audit_bucket_stability(engine, buckets)
        report.audit = D.run_audit(targets, device=engine.device,
                                   extra_findings=extra)
        report.audit["prefill_buckets"] = buckets
        audit_findings = [Finding(**f) for f in report.audit["findings"]]

    for f in report.findings + audit_findings:
        print(f"LINT FAIL {f}")
    for f in report.waived:
        print(f"LINT WAIVED {f}")
    n_audited = len(report.audit.get("targets", []))
    print(f"repro-torch-lint: {report.files_scanned} files, "
          f"{len(report.rules)} rules, {n_audited} entry points audited; "
          f"{len(report.findings) + len(audit_findings)} finding(s), "
          f"{len(report.waived)} waived")

    if args.report:
        report.write(args.report)
        print(f"report -> {args.report}")

    failed = bool(report.findings or audit_findings)
    if args.strict and report.waived:
        # strict mode enforces the empty-waiver acceptance bar: a waiver is
        # tolerated debt locally, never a green CI
        print(f"LINT FAIL --strict forbids waivers "
              f"({len(report.waived)} active in {report.waiver_file})")
        failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
