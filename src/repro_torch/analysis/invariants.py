"""Zero-execution semantic checks over every op x profile x workload.

The PyTorch port's own copy of ``repro.analysis.invariants``, run over the
port's profiles: ``cpu_interpret``, ``gpu_sm``, ``h100`` and ``tpu_v5e``.

The paper's analytical methodology works because plan and space
invariants are knowable *without running a kernel*: the
:class:`~repro_torch.kernels.blocks.plan.StagePlan` is a pure function of
(workload, config, profile).  This module exploits that to verify, for
every ``known_ops()`` op under every registered
:class:`~repro_torch.hw.profiles.HardwareProfile`:

  * **plan soundness** — :meth:`StagePlan.check` per valid config (stage
    radix product == tile, positive grids/blocks, per-launch VMEM within
    the physical pool, scratch holds its block, pass count == launch
    count + the chain's torch passes);
  * **model agreement** — ``core.analytical.resources()`` reports the
    same pass count / VMEM / grid the plan carries, and every
    ``RESOURCE_KEYS`` quantity is present and finite;
  * **feasibility** — each valid space contains at least one config whose
    plan fits ``vmem_budget`` (the tuner always has a lawful choice;
    over-budget candidates are allowed — they are the analytical tier-0
    stratum — but an all-over-budget space would force one);
  * **dead knobs** — a knob is dead when, aggregated over the whole
    checked workload grid, varying it never changes the launch list, the
    noise-free modeled cost, or the analytical guideline key.  A dead
    knob multiplies sweep cost and injects duplicate-label noise into the
    ML dataset for nothing (an ``unroll`` once dead in the linrec space
    was pruned from it; the detector re-discovers that class of bug).

Workloads come from the ML suite grid (train + holdout sizes per op) —
the same sizes every sweep, dataset build, and CI evaluation uses.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.core.analytical import RESOURCE_KEYS, score
from repro_torch.core.objective import CostModelObjective
from repro_torch.core.space import SearchSpace, Workload, build_space
from repro_torch.hw.profiles import get_profile, profiles
from repro_torch.kernels.blocks.plan import plan_for
from repro_torch.tuning.registry import known_ops
from repro_torch.tuning.sweep import config_key


def suite_grid(op: str) -> List[Workload]:
    """The canonical per-op workload grid (every suite variant x size)."""
    from repro_torch.tuning.ml.dataset import SUITE, suite_workloads
    if op not in SUITE:
        return []
    return suite_workloads("train", ops=[op]) \
        + suite_workloads("holdout", ops=[op])


def _finite(x) -> bool:
    return x == x and x not in (float("inf"), float("-inf"))


def check_space(space: SearchSpace) -> List[Finding]:
    """Plan soundness + model agreement + feasibility for one space."""
    wl, spec = space.workload, space.spec
    where = f"{spec.name}/{wl.key}"
    cands = space.enumerate_valid()
    findings: List[Finding] = []
    if not cands:
        return [Finding(rule="invariant.empty-space", path=where,
                        message="valid space is empty: no tuner can answer")]
    feasible = False
    for cfg in cands:
        plan = plan_for(wl, cfg, profile=spec)
        for violation in plan.check(spec):
            findings.append(Finding(
                rule="invariant.plan", path=where,
                message=f"config {config_key(cfg)}: {violation}"))
        res = plan.resources()
        for key in RESOURCE_KEYS:
            if key not in res or not _finite(res[key]):
                findings.append(Finding(
                    rule="invariant.resources", path=where,
                    message=f"config {config_key(cfg)}: resources[{key!r}] "
                            f"missing or non-finite "
                            f"(got {res.get(key)!r})"))
        if res.get("passes") != float(plan.passes) \
                or res.get("vmem") != float(plan.vmem_bytes) \
                or res.get("grid") != float(plan.grid_size):
            findings.append(Finding(
                rule="invariant.resources", path=where,
                message=f"config {config_key(cfg)}: resources() disagrees "
                        f"with the plan (passes {res.get('passes')} vs "
                        f"{plan.passes}, vmem {res.get('vmem')} vs "
                        f"{plan.vmem_bytes}, grid {res.get('grid')} vs "
                        f"{plan.grid_size})"))
        if plan.vmem_bytes <= spec.vmem_budget:
            feasible = True
    if not feasible:
        findings.append(Finding(
            rule="invariant.no-feasible-config", path=where,
            message=f"every valid config exceeds vmem_budget "
                    f"{spec.vmem_budget}: the whole space is analytical "
                    f"tier 0"))
    return findings


# -- dead knobs -------------------------------------------------------------

def _signatures(space: SearchSpace) -> List[Tuple]:
    """Per-candidate decision signature: everything any tuner can see.

    (launch list, chain pass accounting, noise-free modeled cost,
    analytical guideline key) — a knob that never moves any component can
    never change any methodology's decision, online or offline.  The pass
    accounting (``passes``/``xla_passes``) covers chain knobs like
    ``fuse`` whose effect can be to *relabel* a launch list (fold a torch
    link into a kernel) without changing the kernel launches themselves.
    """
    spec = space.spec
    obj = CostModelObjective(spec, noise=0.0)
    cands = space.enumerate_valid()
    costs = obj.batch_eval(space, cands, assume_valid=True)
    sigs: List[Tuple] = []
    for cfg, cost in zip(cands, costs):
        plan = plan_for(space.workload, cfg, profile=spec)
        key = score(space, cfg, res=plan.resources()).key()
        sigs.append((tuple(plan.launches), plan.passes, plan.xla_passes,
                     float(cost), key))
    return sigs


def find_dead_knobs(spaces: Sequence[SearchSpace]) -> List[str]:
    """Knobs dead across ALL given spaces (aggregate, not per-workload).

    For each space, candidates are grouped by the values of every *other*
    knob; the knob is live in that space when some group shows different
    signatures across the knob's values.  A knob legitimately inert at
    one size (e.g. ``unroll`` below the ILP knee) must be live *somewhere*
    on the grid; a knob live nowhere is dead.
    """
    alive: Dict[str, bool] = {}
    for space in spaces:
        cands = space.enumerate_valid()
        if not cands:
            continue
        sigs = _signatures(space)
        for ps in space.params:
            name = ps.name
            if len(ps.domain) < 2 or alive.get(name):
                continue
            groups: Dict[Tuple, List[Tuple]] = {}
            for cfg, sig in zip(cands, sigs):
                ctx = tuple(sorted((k, v) for k, v in cfg.items()
                                   if k != name))
                groups.setdefault(ctx, []).append((cfg.get(name), sig))
            for group in groups.values():
                if len({v for v, _ in group}) > 1:
                    alive.setdefault(name, False)
                    if len({s for _, s in group}) > 1:
                        alive[name] = True
                        break
    return sorted(name for name, live in alive.items() if not live)


def check_dead_knobs(op: str, spaces: Sequence[SearchSpace]
                     ) -> List[Finding]:
    """Findings for knobs dead across the whole grid of one op."""
    return [Finding(
        rule="invariant.dead-knob", path=op,
        message=f"knob {name!r} never changes the launch list, the "
                f"modeled cost, or the analytical rank anywhere on the "
                f"suite grid — prune it from the space (it doubles sweep "
                f"cost and duplicates ML labels for nothing)")
        for name in find_dead_knobs(spaces)]


# -- top-level runner -------------------------------------------------------

def check_invariants(ops: Optional[Iterable[str]] = None,
                     profile_names: Optional[Iterable[str]] = None,
                     max_sizes: Optional[int] = None) -> List[Finding]:
    """Run every semantic check over ops x profiles x the suite grid.

    ``max_sizes`` truncates the per-(op, variant) size list — used by
    fast test paths; the dead-knob aggregation always sees whatever grid
    the invariant sweep saw, so a truncated grid may over-report dead
    knobs (full-grid runs are the authority, and what CI gates on).
    """
    findings: List[Finding] = []
    op_list = list(ops) if ops is not None else known_ops()
    prof_list = list(profile_names) if profile_names is not None \
        else profiles()
    for op in op_list:
        grid = suite_grid(op)
        if max_sizes is not None:
            seen: Dict[str, int] = {}
            trimmed = []
            for wl in grid:
                seen[wl.variant] = seen.get(wl.variant, 0) + 1
                if seen[wl.variant] <= max_sizes:
                    trimmed.append(wl)
            grid = trimmed
        op_spaces: List[SearchSpace] = []
        for pname in prof_list:
            prof = get_profile(pname)
            for wl in grid:
                space = build_space(wl, prof)
                findings.extend(check_space(space))
                op_spaces.append(space)
        findings.extend(check_dead_knobs(op, op_spaces))
    return findings
