"""The bloom clock wired into a process: ``ClockRuntime``."""
from repro_torch.runtime.clock_runtime import ClockConfig, ClockRuntime, LineageStatus

__all__ = ["ClockConfig", "ClockRuntime", "LineageStatus"]
