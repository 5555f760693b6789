"""Building-block layer: the planner (pure Python), the plain in-kernel
primitives (torch) and the staged-execution driver.

    from repro_torch.kernels.blocks.plan import StagePlan, plan_for
    from repro_torch.kernels.blocks import primitives, driver
"""
from repro_torch.kernels.blocks.plan import (DEFAULT_SEQ_LIMIT, Launch,
                                             StagePlan, build_plan, plan_for,
                                             stage_radices, stage_strides)

__all__ = ["DEFAULT_SEQ_LIMIT", "Launch", "StagePlan", "build_plan",
           "plan_for", "stage_radices", "stage_strides"]
