"""Findings, reports, and the baseline suppression file.

The PyTorch port's own copy of ``repro.analysis.findings``.

Every check in ``repro_torch.analysis`` — AST lint rules, plan-invariant
verification, version-drift fingerprints — reports problems as
:class:`Finding` records.  A finding's :meth:`~Finding.key` is stable
across unrelated edits (it hashes the rule, the location, and the message
but **not** the line number), so a baseline file keeps suppressing the
same finding while surrounding code moves.

The baseline workflow:

  * ``tune lint`` exits non-zero on any finding not listed in the
    baseline;
  * an intentionally accepted finding is added to the baseline JSON
    (``{"version": 1, "suppress": ["<key>", ...]}``) with a review;
  * the shipped tree keeps an **empty** baseline
    (``tests/fixtures/analysis_baseline_torch.json``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

BASELINE_VERSION = 1
REPORT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One problem surfaced by a static check.

    ``rule`` is namespaced (``ast.raw-clock``, ``invariant.stage-product``,
    ``fingerprint.feature_columns``); ``path`` is repo-relative for AST
    findings and a logical location (``op/profile``) for semantic ones;
    ``line`` is 0 when no source line applies.
    """

    rule: str
    path: str
    message: str
    line: int = 0

    def key(self) -> str:
        """Stable identity for baselining: rule + path + message digest.

        The line number is deliberately excluded — suppressions must
        survive unrelated edits shifting code up or down.
        """
        digest = hashlib.sha256(self.message.encode()).hexdigest()[:12]
        return f"{self.rule}:{self.path}:{digest}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "key": self.key()}


def report_dict(findings: Sequence[Finding],
                suppressed: Sequence[Finding] = ()) -> Dict:
    """The ``--json`` report: every finding plus baseline accounting."""
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "version": REPORT_VERSION,
        "findings": [f.to_dict() for f in findings],
        "suppressed": [f.to_dict() for f in suppressed],
        "counts": counts,
        "total": len(findings),
    }


def load_baseline(path: Optional[str]) -> List[str]:
    """Suppression keys from a baseline file; [] when absent."""
    if not path or not os.path.exists(path):
        return []
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict) or "suppress" not in raw:
        raise ValueError(f"baseline {path!r}: expected "
                         '{"version": 1, "suppress": [...]}')
    return [str(k) for k in raw["suppress"]]


def apply_baseline(findings: Iterable[Finding], suppress: Sequence[str]
                   ) -> tuple:
    """Split findings into (fresh, suppressed) against baseline keys."""
    keys = set(suppress)
    fresh: List[Finding] = []
    quiet: List[Finding] = []
    for f in findings:
        (quiet if f.key() in keys else fresh).append(f)
    return fresh, quiet
