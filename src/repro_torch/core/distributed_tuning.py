"""Beyond-paper: the paper's tuning methodologies applied to DISTRIBUTED
configuration (sharding strategy, remat, microbatching) with dry-run
roofline terms as the objective (``repro.core.distributed_tuning``).

The paper tunes (S, P, L, r, shuffle) per kernel against wall-clock; at
pod scale the analogous knobs are per-(arch x shape) distribution choices
and the "device" is the step placed on the production mesh.  The
objective is the dominant roofline term from ``launch.roofline`` — the
dry-run of the cell on a fake world of the mesh's size — so the same
BayesianTuner / ExhaustiveSearch machinery drives the search.

Space (discrete, enumerable — like the paper's):
    activation_strategy: tp | sp             (residual sharding)
    micro_steps:         1 | 2 | 4 | 8       (gradient accumulation)
    remat:               full | none
    moe_group_size:      512 | 1024 | 2048   (MoE cells only)

The device constants (memory size, bandwidth) come from a hardware profile:
the active one (``h100`` by default: 80 GiB, 3.35e12 B/s), or ``tpu_v5e``
for JAX's numbers (16 GiB, 819e9 B/s).  ``tune_distributed`` keeps one
fake world for all its evaluations.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.bayesian import BayesianTuner, TuneResult
from repro_torch.core.exhaustive import ExhaustiveSearch
from repro_torch.core.objective import Measurement, Objective, PENALTY_TIME
from repro_torch.core.space import Config, ParamSpec, SearchSpace, Workload
from repro_torch.hw.profiles import H100, HardwareProfile, active_profile


def distributed_space(arch: str, shape: str, is_moe: bool = False,
                      is_train: bool = True) -> SearchSpace:
    wl = Workload(op="distributed", n=0, batch=0, variant=f"{arch}|{shape}")
    params = [
        ParamSpec("sp", (0, 1)),                       # activation_strategy
        ParamSpec("micro_steps", (1, 2, 4, 8) if is_train else (1,)),
        ParamSpec("remat", (0, 1) if is_train else (1,)),  # 1 = full
        ParamSpec("moe_group", (512, 1024, 2048) if is_moe else (1024,)),
    ]
    return SearchSpace(wl, params, constraints=())


# device memory of the default profile (the objective reads its own
# profile's ``hbm_bytes``)
HBM_BYTES = H100.hbm_bytes

# per-extra-micro-step dispatch + accumulation-barrier cost (the step is
# re-dispatched and the accumulator flushed once per micro step)
MICRO_STEP_SYNC_S = 20e-6


def micro_step_overhead_s(micro_steps: int, grad_bytes_per_dev: float,
                          spec: Optional[HardwareProfile] = None) -> float:
    """Cost of gradient accumulation the roofline cannot see.

    The op-level roofline already counts the micro steps' compute and
    weight re-reads, but its fused-elementwise bytes model treats the f32
    gradient-accumulator ``g_acc + g`` as free — in reality every extra
    micro step pays a full read-modify-write of the per-device gradient
    shard through HBM, plus a dispatch/sync.  Charging it here is what
    makes ``micro_steps`` a real trade-off (smaller activation footprint vs
    accumulation traffic) instead of a free knob.
    """
    spec = spec or active_profile()
    extra = max(int(micro_steps), 1) - 1
    if extra == 0:
        return 0.0
    rmw = 2.0 * max(grad_bytes_per_dev, 0.0) / spec.hbm_bandwidth
    return extra * (rmw + MICRO_STEP_SYNC_S)


def step_time_from_record(rec: Dict, cfg: Config,
                          grad_bytes_per_dev: float = 0.0,
                          spec: Optional[HardwareProfile] = None) -> float:
    """Full-step objective time for ``cfg`` given one roofline record."""
    return float(rec["step_time_bound_s"]) + micro_step_overhead_s(
        cfg.get("micro_steps", 1), grad_bytes_per_dev, spec)


class CompiledRooflineObjective(Objective):
    """Dry-run the cell under the candidate distribution config and return
    the dominant roofline term (seconds); OOM (peak > the device's memory)
    and dry-run failures get the penalty clamp, exactly like the paper's
    invalid-configuration handling."""

    def __init__(self, multi_pod: bool = False, hbm_guard: bool = True,
                 profile: Optional[HardwareProfile] = None):
        self.multi_pod = multi_pod
        self.hbm_guard = hbm_guard
        self.profile = profile or active_profile()

    def __call__(self, space: SearchSpace, cfg: Config) -> Measurement:
        import dataclasses as dc

        from repro_torch.configs.base import get_arch
        # looked up at call time, so a caller may swap analyze_cell
        from repro_torch.launch import roofline
        from repro_torch.train.step import TrainHParams

        arch, shape = space.workload.variant.split("|")
        base = get_arch(arch)
        arch_cfg = dc.replace(
            base,
            activation_strategy="sp" if cfg["sp"] else "tp",
            remat="full" if cfg["remat"] else "none",
            moe_group_size=cfg["moe_group"],
        )
        hp = TrainHParams(micro_steps=cfg["micro_steps"])
        try:
            rec = roofline.analyze_cell(arch, shape, multi_pod=self.multi_pod,
                                        arch_cfg=arch_cfg, hp=hp,
                                        profile=self.profile)
        except Exception:
            return Measurement(PENALTY_TIME, False)
        if rec.get("status") != "ok":
            return Measurement(PENALTY_TIME, False)
        peak = rec["per_device"]["peak_bytes"]
        hbm = self.profile.hbm_bytes
        if self.hbm_guard and peak > hbm:
            # infeasible on real hardware -> penalty, scaled so "close"
            # configs still order (helps the surrogate learn the cliff)
            return Measurement(PENALTY_TIME * (peak / hbm), False,
                               meta={"peak_bytes": peak})
        from repro_torch.launch.params import total_param_count
        chips = max(int(rec.get("chips", 1)), 1)
        grad_bytes_dev = 4.0 * total_param_count(arch_cfg) / chips
        t = step_time_from_record(rec, cfg, grad_bytes_dev, self.profile)
        return Measurement(
            t, True,
            meta={"peak_bytes": peak, **rec["roofline"],
                  "dominant": rec["dominant"],
                  "micro_overhead_s": t - rec["step_time_bound_s"]})

    def signature(self) -> str:
        return f"{type(self).__name__}[{self.profile.name}]"


def tune_distributed(arch: str, shape: str, method: str = "bayesian",
                     multi_pod: bool = False, max_evals: int = 12,
                     seed: int = 0,
                     profile: Optional[HardwareProfile] = None
                     ) -> TuneResult:
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.mesh import fake_world

    base = get_arch(arch)
    space = distributed_space(arch, shape, is_moe=base.family == "moe",
                              is_train=shape.startswith("train"))
    objective = CompiledRooflineObjective(multi_pod=multi_pod,
                                          profile=profile)
    if method == "bayesian":
        tuner = BayesianTuner(max_evals=max_evals, seed=seed, n_init=3)
    elif method == "exhaustive":
        tuner = ExhaustiveSearch()
    else:
        raise ValueError(method)
    # one fake world for every evaluation (each dry-run reuses it)
    with fake_world(512 if multi_pod else 256):
        return tuner.tune(space, objective)
