"""Versioned, thread-safe JSON config store (the offline -> online handoff).

The PyTorch port's own copy of ``repro.tuning.db``: same schema, same
keys, same migrations, so the port reads a file the JAX package wrote and
resolves the identical config for the same workload and profile.

Schema 4 stamps every entry with its metric vector and the policy it was
tuned under:

    {"schema": 4,
     "entries": {"<platform>|<workload-key>": {"config": {...},
                                               "time_s": ..., "method": ...,
                                               "evaluations": ...,
                                               "profile": "<profile-name>",
                                               "policy": "latency",
                                               "metrics": {"time_s": ...,
                                                           "energy_j": ...}}}}

The platform prefix in the key namespaces devices; the per-entry
``profile`` field makes the device explicit and lets ``lookup`` refuse an
entry whose profile disagrees with the session's (a config tuned for one
device must never silently resolve under another).
Non-latency winners key under ``<platform>|policy=<key>|<workload-key>``
— latency keys are unchanged from schema 3, so every existing entry keeps
resolving, and an energy-tuned config never answers a latency lookup (or
vice versa).  ``lookup`` double-checks the per-entry ``policy`` stamp.

Legacy files migrate transparently: schema-1 files were a flat
``{key: entry}`` mapping; schema-2 entries lack the ``profile`` field and
are defaulted to their key's platform prefix; schema-3 entries lack
``policy``/``metrics`` and load as latency winners with a ``time_s``-only
metric vector. A key with no platform prefix at all is re-keyed under
``tpu_v5e`` — every pre-profile entry was tuned on the v5e model, and
without the rewrite such entries could never resolve (``lookup`` always
prefixes the session platform). The next ``store`` persists the new
envelope. Unknown top-level envelope keys (annotations from other tools,
future-schema side-channels) are preserved across load/flush rather than
dropped. Writes are atomic (tmp file + ``os.replace``) and serialized by
a lock, so concurrent ``store`` calls from threads never corrupt the
file.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Mapping, Optional

SCHEMA_VERSION = 4

# the only policy that existed before schema 4; also the keyless default
DEFAULT_POLICY = "latency"

# every entry written before the profile field existed was tuned against
# the v5e machine model
LEGACY_PROFILE = "tpu_v5e"

DEFAULT_DB_PATH = os.environ.get(
    "REPRO_TORCH_TUNING_DB",
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                 "tuning_db_torch.json"))

# the entry-key shapes, as format templates: latency keys keep the schema-3
# shape so pre-policy entries resolve; non-latency winners carry the policy
# segment.  ``repro_torch.analysis`` fingerprints these against
# SCHEMA_VERSION — reshaping a key without bumping the schema orphans every
# stored winner.
KEY_FORMATS = ("{platform}|{workload_key}",
               "{platform}|policy={policy}|{workload_key}")

# per-entry field layout (same contract, same fingerprint)
ENTRY_FIELDS = ("config", "time_s", "method", "evaluations", "profile",
                "policy", "metrics")


def make_entry(cfg: Dict, time_s: float, method: str, evaluations: int,
               profile: str, policy: str,
               metrics: Mapping[str, float]) -> Dict:
    """One schema-4 DB entry; the single construction site for
    ``ENTRY_FIELDS``."""
    return {"config": dict(cfg), "time_s": time_s, "method": method,
            "evaluations": evaluations, "profile": profile,
            "policy": policy, "metrics": dict(metrics)}


def _migrate_entry(key: str, entry: Dict) -> Dict:
    """Schema <=3 -> 4: stamp profile, policy, and the metric vector.

    Pre-vector entries were all tuned for latency; their scalar ``time_s``
    becomes a ``time_s``-only metric vector.
    """
    if not isinstance(entry, dict):
        return entry
    out = dict(entry)
    if "profile" not in out:
        out["profile"] = key.split("|", 1)[0] if "|" in key else LEGACY_PROFILE
    if "policy" not in out:
        out["policy"] = DEFAULT_POLICY
    if not isinstance(out.get("metrics"), dict):
        out["metrics"] = {"time_s": out.get("time_s")}
    return out


def _migrate_key(key: str) -> str:
    """Bare pre-platform keys re-key under the legacy device so ``lookup``
    (which always prefixes the session platform) can actually find them."""
    return key if "|" in key else f"{LEGACY_PROFILE}|{key}"


class TuningDB:
    """JSON-backed config store; thread-safe; content-addressed by workload key."""

    def __init__(self, path: Optional[str] = None, platform: str = "h100"):
        self.path = os.path.abspath(path or DEFAULT_DB_PATH)
        self.platform = platform
        self._lock = threading.Lock()
        self._data: Dict[str, Dict] = {}
        self._extra: Dict[str, object] = {}   # unknown envelope keys, kept
        self._loaded = False

    # -- persistence ---------------------------------------------------------

    def _load(self) -> None:
        if self._loaded:
            return
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    raw = json.load(f)
            except (json.JSONDecodeError, OSError):
                raw = {}
            if isinstance(raw, dict) and "schema" in raw:
                entries = dict(raw.get("entries") or {})
                try:
                    schema = int(raw.get("schema") or 0)
                except (TypeError, ValueError):
                    schema = 0
                if schema < SCHEMA_VERSION:
                    entries = {_migrate_key(k): _migrate_entry(k, v)
                               for k, v in entries.items()}
                self._data = entries
                # preserve unknown envelope keys (annotations written by
                # other tools, future-schema side-channels): they round-trip
                # through the next flush instead of being dropped
                self._extra = {k: v for k, v in raw.items()
                               if k not in ("schema", "entries")}
            else:
                # legacy flat {key: entry} file (schema 1)
                raw = raw if isinstance(raw, dict) else {}
                self._data = {_migrate_key(k): _migrate_entry(k, v)
                              for k, v in raw.items()}
        self._loaded = True

    def _flush_locked(self) -> None:
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        payload = {**self._extra, "schema": SCHEMA_VERSION,
                   "entries": self._data}
        tmp = f"{self.path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    # -- access --------------------------------------------------------------

    def _key(self, wl, policy: Optional[str] = None) -> str:
        pol = policy or DEFAULT_POLICY
        if pol == DEFAULT_POLICY:
            return KEY_FORMATS[0].format(platform=self.platform,
                                         workload_key=wl.key)
        return KEY_FORMATS[1].format(platform=self.platform, policy=pol,
                                     workload_key=wl.key)

    def lookup(self, wl, policy: Optional[str] = None) -> Optional[Dict]:
        pol = policy or DEFAULT_POLICY
        with self._lock:
            self._load()
            entry = self._data.get(self._key(wl, pol))
            if not entry:
                return None
            # defense in depth on top of the key prefix: an entry stamped
            # for another device never resolves here (e.g. a file edited by
            # hand, or a legacy entry migrated under a foreign prefix) —
            # and same for the policy stamp
            if entry.get("profile", self.platform) != self.platform:
                return None
            if entry.get("policy", DEFAULT_POLICY) != pol:
                return None
            return dict(entry["config"])

    def store(self, wl, cfg: Dict, time_s: float, method: str,
              evaluations: int = 0, *,
              metrics: Optional[Mapping[str, float]] = None,
              policy: Optional[str] = None) -> None:
        pol = policy or DEFAULT_POLICY
        vec = {k: float(v) for k, v in (metrics or {}).items()}
        vec.setdefault("time_s", float(time_s))
        with self._lock:
            self._load()
            self._data[self._key(wl, pol)] = make_entry(
                cfg, time_s, method, evaluations, self.platform, pol, vec)
            self._flush_locked()

    def entries(self) -> Dict[str, Dict]:
        with self._lock:
            self._load()
            return dict(self._data)

    def __len__(self) -> int:
        with self._lock:
            self._load()
            return len(self._data)
