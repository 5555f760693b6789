"""repro_torch.serve — continuous-batching serving on the port's models.

:class:`ServeEngine` is the production path: batched chunk prefill, a
fused decode step over device-resident token state, and budgeted deque
admission.  :class:`ReferenceEngine` preserves the per-token replay
baseline the engine is differentially tested against;
:mod:`repro_torch.serve.trace` generates the seeded multi-tenant request
streams.  The port of ``repro.serve``.
"""
from repro_torch.serve.engine import (FINISH_LENGTH, FINISH_STOP, Request,
                                      ServeEngine, StepRecord)
from repro_torch.serve.reference import ReferenceEngine
from repro_torch.serve.trace import (TenantSpec, TraceRequest,
                                     default_tenants, synthetic_trace,
                                     trace_summary)

__all__ = [
    "FINISH_LENGTH", "FINISH_STOP", "Request", "ServeEngine", "StepRecord",
    "ReferenceEngine", "TenantSpec", "TraceRequest", "default_tenants",
    "synthetic_trace", "trace_summary",
]
