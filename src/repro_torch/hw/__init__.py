"""Hardware layer: parametric machine models (see repro_torch.hw.profiles)."""
from repro_torch.hw.profiles import (  # noqa: F401
    CPU_INTERPRET,
    GPU_SM,
    H100,
    TPU_V5E,
    HardwareProfile,
    active_profile,
    get_profile,
    profiles,
    register_profile,
)

__all__ = [
    "HardwareProfile", "TPU_V5E", "GPU_SM", "CPU_INTERPRET", "H100",
    "register_profile", "get_profile", "profiles", "active_profile",
]
