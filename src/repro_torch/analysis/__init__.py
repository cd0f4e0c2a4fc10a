# Port of src/repro/analysis/__init__.py: the same exports.
"""repro-torch-lint: static invariant analysis of the port's hot path and
its movement architecture.

Two layers over one findings/report shape:

* :mod:`repro_torch.analysis.rules` + :mod:`repro_torch.analysis.lint` —
  the AST architecture linter over ``src/repro_torch`` (movement only via
  ``plan()``, no host syncs in the tick loop, virtual-clock determinism,
  strict JSON, import-time registries), behind the repo's fourth rule
  registry.
* :mod:`repro_torch.analysis.dispatch` +
  :mod:`repro_torch.analysis.entrypoints` — the entry-point auditor: one
  watched call of every registered entry point, held to the contract the
  reference documents (state written in place, no device->host sync,
  uint8 page paths bit-exact, and on the card the launches a call of each
  kernel).

:mod:`repro_torch.analysis.testlib` is the reference's shared runtime
asserter, copied (the port's Engine keeps ``decode_dispatches`` and
``host_transfers``).  Console entry point: ``repro-torch-lint`` (or
``python -m repro_torch.analysis``).
"""
from repro_torch.analysis.dispatch import (AuditTarget, EntryContract,
                                           audit_bucket_stability,
                                           audit_target, run_audit)
from repro_torch.analysis.entrypoints import default_targets, prefill_buckets
from repro_torch.analysis.findings import (Finding, Report, is_waived,
                                           load_waivers, split_waived)
from repro_torch.analysis.lint import lint_file, run_lint
from repro_torch.analysis.rules import (LintRule, all_rules, get_rule,
                                        register_rule, rule_ids)
from repro_torch.analysis import testlib

__all__ = [
    "AuditTarget", "EntryContract", "Finding", "LintRule", "Report",
    "all_rules", "audit_bucket_stability", "audit_target",
    "default_targets", "get_rule", "is_waived", "lint_file",
    "load_waivers", "prefill_buckets", "register_rule", "rule_ids",
    "run_audit", "run_lint", "split_waived", "testlib",
]
