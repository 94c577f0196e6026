"""The bloom clock wired into a process: ``ClockRuntime``."""
from repro_torch.runtime.clock_runtime import (CheckpointLineage, ClockConfig,
                                             ClockRuntime, LineageStatus)

__all__ = ["CheckpointLineage", "ClockConfig", "ClockRuntime", "LineageStatus"]
