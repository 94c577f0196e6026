"""Model serving: ``ServingEngine``, batched prefill and decode with
clock-stamped sessions and clock-gated migration."""
from repro_torch.serving.engine import ServeConfig, ServingEngine

__all__ = ["ServeConfig", "ServingEngine"]
