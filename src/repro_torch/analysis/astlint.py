"""Repo-convention lint: pure ``ast`` rules over ``src/repro_torch``.

The PyTorch port's own copy of ``repro.analysis.astlint``: every rule with
its scope, over the port's package, whose layout (``serve/``, ``tuning/``,
``launch/serve.py``) is the JAX package's.

Each rule encodes a convention the test suite or a past PR established
but nothing previously enforced:

  * ``ast.retired-shim-import`` — ``repro_torch.core.tuner`` and
    ``repro_torch.hw.tpu`` are the port's names for the JAX package's
    retired shims (``repro.core.tuner``, ``repro.hw.tpu``, which raise
    ImportError at import time); the port has neither module, so importing
    them is always a bug.
  * ``ast.deprecated-alias`` — ``TPUCostModelObjective`` is a
    backwards-compat alias of ``CostModelObjective``; only its definition
    site (core/objective.py) and the compat re-export (core/__init__.py)
    may reference it.
  * ``ast.deprecated-spec-kwarg`` — ``spec=`` is a deprecated alias of
    ``profile=`` on the space/plan/objective entry points; call sites
    must pass ``profile=``.
  * ``ast.raw-clock`` — measurement paths (``serve/``, ``tuning/``,
    ``launch/serve.py``) must use the injectable clock
    (``ServeEngine.step_timer`` / the online tuner's ``StepTimer``) so
    tests can fake time; calling ``time.time()`` / ``time.perf_counter()``
    directly makes the path untestable.  The ``serve/`` scope covers the
    whole serving package — the optimized engine, the replay
    :mod:`~repro_torch.serve.reference` baseline, and the
    :mod:`~repro_torch.serve.trace` generator — where the only blessed clock
    use is the bare ``time.perf_counter`` *reference* as the
    ``step_timer`` default (a call would be flagged).
  * ``ast.objective-batch-eval`` — vector objectives override
    ``batch_eval_metrics`` (``batch_eval`` derives from it); overriding
    only ``batch_eval`` silently drops the energy/VMEM columns.
  * ``ast.mutable-default`` — classic Python footgun; ruff's B006
    equivalent, enforced here so the rule also runs where ruff is not
    installed.
  * ``ast.journal-open-append`` — journal/trace appends must go through
    ``repro_torch.tuning.sweep.append_journal_lines`` (single ``os.write`` on an
    ``O_APPEND`` descriptor, torn-tail termination); a buffered
    ``open(path, "a")`` can interleave with concurrent writers and leaves
    multi-line tears.

Adding a rule: write a generator taking a :class:`LintContext` and
yielding :class:`~repro_torch.analysis.findings.Finding`, decorate it with
``@rule("name")``.  A source line containing ``lint: allow[<name>]``
suppresses that rule on that line (use sparingly; prefer fixing).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Dict, Iterable, Iterator, List, Optional

from repro_torch.analysis.findings import Finding

# -- registry ---------------------------------------------------------------

RULES: Dict[str, Callable[["LintContext"], Iterable[Finding]]] = {}


def rule(name: str):
    """Register an AST lint rule under ``ast.<name>``."""
    def deco(fn):
        RULES[name] = fn
        return fn
    return deco


@dataclasses.dataclass
class LintContext:
    """Everything a rule may inspect for one file."""

    relpath: str          # path relative to the repro_torch package root
    tree: ast.AST
    lines: List[str]      # raw source lines (1-indexed via line numbers)

    def allowed(self, rule_name: str, lineno: int) -> bool:
        """True when the line opts out via ``lint: allow[<rule>]``."""
        if 1 <= lineno <= len(self.lines):
            return f"lint: allow[{rule_name}]" in self.lines[lineno - 1]
        return False

    def finding(self, rule_name: str, node: ast.AST, message: str
                ) -> Iterator[Finding]:
        lineno = getattr(node, "lineno", 0)
        if not self.allowed(rule_name, lineno):
            yield Finding(rule=f"ast.{rule_name}", path=self.relpath,
                          line=lineno, message=message)


# -- shared AST helpers -----------------------------------------------------

def _call_name(node: ast.Call) -> str:
    """Trailing name of the called expression (``a.b.c()`` -> ``c``)."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` attribute chain as a string ('' for anything else)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# -- rules ------------------------------------------------------------------

RETIRED_MODULES = ("repro_torch.core.tuner", "repro_torch.hw.tpu")


@rule("retired-shim-import")
def _retired_shim_import(ctx: LintContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        names: List[str] = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
            names += [f"{node.module}.{a.name}" for a in node.names]
        for name in names:
            for retired in RETIRED_MODULES:
                if name == retired or name.startswith(retired + "."):
                    yield from ctx.finding(
                        "retired-shim-import", node,
                        f"import of retired shim {retired!r} (it raises "
                        f"ImportError; see its module docstring for the "
                        f"replacement)")


DEPRECATED_ALIAS = "TPUCostModelObjective"
# definition site + the compat re-export keep the alias importable
_ALIAS_ALLOWED_FILES = ("core/objective.py", "core/__init__.py")


@rule("deprecated-alias")
def _deprecated_alias(ctx: LintContext) -> Iterator[Finding]:
    if ctx.relpath in _ALIAS_ALLOWED_FILES:
        return
    for node in ast.walk(ctx.tree):
        hit = None
        if isinstance(node, ast.ImportFrom):
            if any(a.name == DEPRECATED_ALIAS for a in node.names):
                hit = node
        elif isinstance(node, ast.Name) and node.id == DEPRECATED_ALIAS:
            hit = node
        elif isinstance(node, ast.Attribute) and node.attr == DEPRECATED_ALIAS:
            hit = node
        if hit is not None:
            yield from ctx.finding(
                "deprecated-alias", hit,
                f"{DEPRECATED_ALIAS} is a deprecated alias; use "
                f"CostModelObjective (profile-parameterized)")


# entry points whose ``spec=`` kwarg is the deprecated profile alias; other
# functions (e.g. distributed_tuning.micro_step_overhead_s) use ``spec`` as
# their canonical parameter name and are not targeted
SPEC_KWARG_TARGETS = ("build_space", "plan_for", "build_plan",
                      "CostModelObjective", "TPUCostModelObjective")


@rule("deprecated-spec-kwarg")
def _deprecated_spec_kwarg(ctx: LintContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _call_name(node)
        if callee not in SPEC_KWARG_TARGETS:
            continue
        for kw in node.keywords:
            if kw.arg == "spec":
                yield from ctx.finding(
                    "deprecated-spec-kwarg", node,
                    f"{callee}(spec=...) is deprecated; pass profile=...")


RAW_CLOCKS = ("time.time", "time.perf_counter", "perf_counter")
# measurement paths that must use the injectable clock
_CLOCK_SCOPED = re.compile(r"^(serve|tuning)/|^launch/serve\.py$")


@rule("raw-clock")
def _raw_clock(ctx: LintContext) -> Iterator[Finding]:
    if not _CLOCK_SCOPED.search(ctx.relpath):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name in RAW_CLOCKS:
            yield from ctx.finding(
                "raw-clock", node,
                f"direct {name}() call on a measurement path; use the "
                f"injectable clock (ServeEngine.step_timer / StepTimer) so "
                f"tests can fake time")


@rule("objective-batch-eval")
def _objective_batch_eval(ctx: LintContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        bases = {b.attr if isinstance(b, ast.Attribute) else
                 getattr(b, "id", "") for b in node.bases}
        if not any(b.endswith("Objective") for b in bases):
            continue
        methods = {n.name for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if "batch_eval" in methods and "batch_eval_metrics" not in methods:
            yield from ctx.finding(
                "objective-batch-eval", node,
                f"{node.name} overrides batch_eval without "
                f"batch_eval_metrics: the vector path (energy/VMEM columns) "
                f"silently falls back to the base loop — override "
                f"batch_eval_metrics instead (batch_eval derives from it)")


_MUTABLE_CALLS = ("list", "dict", "set")


@rule("mutable-default")
def _mutable_default(ctx: LintContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            bad = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call) and not d.args and not d.keywords
                and isinstance(d.func, ast.Name)
                and d.func.id in _MUTABLE_CALLS)
            if bad:
                yield from ctx.finding(
                    "mutable-default", d,
                    f"mutable default argument in {node.name}(); defaults "
                    f"are evaluated once and shared across calls — default "
                    f"to None and construct inside the body")


@rule("journal-open-append")
def _journal_open_append(ctx: LintContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or _call_name(node) != "open":
            continue
        if isinstance(node.func, ast.Attribute):
            continue   # os.open etc. — the helper itself
        mode = None
        if len(node.args) >= 2:
            mode = node.args[1]
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str) \
                and "a" in mode.value:
            yield from ctx.finding(
                "journal-open-append", node,
                'buffered open(..., "a") append; use '
                "repro_torch.tuning.sweep.append_journal_lines (O_APPEND + single "
                "os.write + torn-tail termination) so concurrent writers "
                "never interleave mid-line")


# -- runner -----------------------------------------------------------------

def lint_source(relpath: str, source: str,
                rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint one file's source text; ``relpath`` is package-relative."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(rule="ast.syntax-error", path=relpath,
                        line=e.lineno or 0, message=str(e.msg))]
    ctx = LintContext(relpath=relpath.replace(os.sep, "/"), tree=tree,
                      lines=source.splitlines())
    out: List[Finding] = []
    for name, fn in sorted(RULES.items()):
        if rules is not None and name not in rules:
            continue
        out.extend(fn(ctx))
    return out


def lint_tree(pkg_root: Optional[str] = None,
              rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint every ``*.py`` under the repro_torch package root."""
    if pkg_root is None:
        import repro_torch
        pkg_root = os.path.dirname(os.path.abspath(repro_torch.__file__))
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, pkg_root)
            with open(full, encoding="utf-8") as f:
                findings.extend(lint_source(rel, f.read(), rules=rules))
    return findings
