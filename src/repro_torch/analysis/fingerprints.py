"""Version-drift fingerprints for the stack's persisted contracts.

Four contracts outlive any single process — ML feature columns, journal
headers, DB entry keys/fields, and the serialized Measurement layout.
Each carries a ``*_VERSION`` constant whose bump invalidates stale
artifacts *loudly*; what nothing enforced until now is the bump itself:
edit ``FEATURE_NAMES`` without touching ``FEATURE_VERSION`` and every
trained forest silently mis-predicts, reshape the journal header and
every sweep resumes against garbage.

This module pins a content hash of each contract next to its version in
``tests/fixtures/analysis_fingerprints_torch.json`` — the port's own
fixture, found from ``repro_torch.__file__`` and never the JAX package's
``analysis_fingerprints.json``, so neither package's pins can flip the
other's lint.  The port's contracts are copies of the JAX package's, so
its pins equal that file's:

  * hash changed, version unchanged  -> lint error ("bump the version");
  * version changed (fixture stale)  -> lint error ("refresh the fixture
    with ``tune lint --write-fingerprints`` in the same change");
  * both match                       -> silence.

Adding a contract: extend :data:`CONTRACTS` with ``name -> provider``
where the provider returns ``(version, payload)`` — the payload is any
JSON-serializable description of the layout — then refresh the fixture.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.findings import Finding

FINGERPRINT_FIXTURE = os.path.join("tests", "fixtures",
                                   "analysis_fingerprints_torch.json")


def _feature_columns() -> Tuple[int, object]:
    from repro_torch.tuning.ml.features import FEATURE_NAMES, FEATURE_VERSION
    return FEATURE_VERSION, list(FEATURE_NAMES)


def _journal_header() -> Tuple[int, object]:
    from repro_torch.tuning.sweep import HEADER_FIELDS, JOURNAL_VERSION
    return JOURNAL_VERSION, list(HEADER_FIELDS)


def _db_entry() -> Tuple[int, object]:
    from repro_torch.tuning.db import ENTRY_FIELDS, KEY_FORMATS, SCHEMA_VERSION
    return SCHEMA_VERSION, {"key_formats": list(KEY_FORMATS),
                            "entry_fields": list(ENTRY_FIELDS)}


def _measurement() -> Tuple[int, object]:
    from repro_torch.core.objective import MEASUREMENT_FIELDS, MEASUREMENT_VERSION
    return MEASUREMENT_VERSION, list(MEASUREMENT_FIELDS)


CONTRACTS: Dict[str, Callable[[], Tuple[int, object]]] = {
    "feature_columns": _feature_columns,
    "journal_header": _journal_header,
    "db_entry": _db_entry,
    "measurement": _measurement,
}


def _digest(payload: object) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def current_fingerprints() -> Dict[str, Dict]:
    """``{contract: {"version": int, "hash": sha256}}`` for the live code."""
    out: Dict[str, Dict] = {}
    for name, provider in sorted(CONTRACTS.items()):
        version, payload = provider()
        out[name] = {"version": int(version), "hash": _digest(payload)}
    return out


def default_fixture_path(root: Optional[str] = None) -> str:
    """``tests/fixtures/analysis_fingerprints_torch.json`` under the repo
    root."""
    if root is None:
        import repro_torch
        # src/repro_torch/__init__.py -> src/repro_torch -> src -> repo root
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__))))
    return os.path.join(root, FINGERPRINT_FIXTURE)


def write_fingerprints(path: str) -> Dict[str, Dict]:
    """Refresh the pinned fixture from the live code (returns what it wrote).

    Only legitimate when every changed contract also bumped its version —
    which is exactly what the next lint run verifies against the new pin.
    """
    pins = current_fingerprints()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(pins, f, indent=1, sort_keys=True)
        f.write("\n")
    return pins


def check_fingerprints(path: str) -> List[Finding]:
    """Compare the live contracts against the pinned fixture."""
    loc = os.path.relpath(path) if os.path.isabs(path) else path
    if not os.path.exists(path):
        return [Finding(rule="fingerprint.missing-fixture", path=loc,
                        message="pinned fingerprint fixture not found; "
                                "generate it with `tune lint "
                                "--write-fingerprints`")]
    with open(path) as f:
        pinned = json.load(f)
    live = current_fingerprints()
    findings: List[Finding] = []
    for name, cur in live.items():
        pin = pinned.get(name)
        if pin is None:
            findings.append(Finding(
                rule=f"fingerprint.{name}", path=loc,
                message=f"contract {name!r} is not pinned; refresh the "
                        f"fixture with --write-fingerprints"))
            continue
        if cur["version"] != pin.get("version"):
            findings.append(Finding(
                rule=f"fingerprint.{name}", path=loc,
                message=f"{name}: version {cur['version']} != pinned "
                        f"{pin.get('version')} — the fixture is stale; "
                        f"refresh it with --write-fingerprints in the same "
                        f"change"))
        elif cur["hash"] != pin.get("hash"):
            findings.append(Finding(
                rule=f"fingerprint.{name}", path=loc,
                message=f"{name}: contract content changed but its version "
                        f"constant did not — bump the matching *_VERSION "
                        f"(artifacts recorded under version "
                        f"{cur['version']} would silently go stale), then "
                        f"refresh the fixture with --write-fingerprints"))
    for name in pinned:
        if name not in live:
            findings.append(Finding(
                rule=f"fingerprint.{name}", path=loc,
                message=f"fixture pins unknown contract {name!r}; refresh "
                        f"it with --write-fingerprints"))
    return findings
