"""Static analysis for the port's tuning stack (``tune lint``).

The PyTorch port's own copy of ``repro.analysis``: the same checks over
``src/repro_torch``, the port's hardware profiles (``cpu_interpret``,
``gpu_sm``, ``h100``, ``tpu_v5e``) and its own pinned fixtures
(``tests/fixtures/analysis_fingerprints_torch.json``,
``analysis_baseline_torch.json``), so neither package's pins or
suppressions touch the other's lint.

Two halves, one report:

  * **semantic invariants** (:mod:`repro_torch.analysis.invariants`) — plan
    soundness, model agreement, feasibility, and dead knobs for every
    ``known_ops()`` op under every registered hardware profile, plus
    version-drift fingerprints (:mod:`repro_torch.analysis.fingerprints`) for
    the persisted contracts;
  * **repo-convention AST lint** (:mod:`repro_torch.analysis.astlint`) — pure
    stdlib ``ast`` rules over ``src/repro_torch`` enforcing the conventions the
    stack's tests rely on (injectable clocks, the O_APPEND journal
    helper, no retired shims or deprecated aliases, vector-objective
    overrides, no mutable defaults).

Everything is pure inspection: no kernel executes and no file is written
(except ``--write-fingerprints``).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.analysis.astlint import RULES, LintContext, lint_source, lint_tree
from repro_torch.analysis.findings import (Finding, apply_baseline, load_baseline,
                                     report_dict)
from repro_torch.analysis.fingerprints import (CONTRACTS, check_fingerprints,
                                         current_fingerprints,
                                         default_fixture_path,
                                         write_fingerprints)
from repro_torch.analysis.invariants import (check_dead_knobs, check_invariants,
                                       check_space, find_dead_knobs,
                                       suite_grid)

__all__ = [
    "Finding", "RULES", "LintContext", "CONTRACTS",
    "lint_source", "lint_tree",
    "apply_baseline", "load_baseline", "report_dict",
    "check_fingerprints", "current_fingerprints", "default_fixture_path",
    "write_fingerprints",
    "check_dead_knobs", "check_invariants", "check_space", "find_dead_knobs",
    "suite_grid",
    "run_lint",
]


def run_lint(pkg_root: Optional[str] = None,
             fingerprint_path: Optional[str] = None,
             invariants: bool = True) -> List[Finding]:
    """The full pass: AST lint + fingerprints + semantic invariants.

    ``invariants=False`` skips the (comparatively slow) op x profile
    sweep — the mode pre-commit hooks want; CI and the bench gate run
    everything.
    """
    findings = lint_tree(pkg_root)
    findings += check_fingerprints(fingerprint_path
                                   or default_fixture_path())
    if invariants:
        findings += check_invariants()
    return findings
