"""Data: the synthetic token stream with bloom-clock batch stamping."""
from repro_torch.data.pipeline import DataConfig, SyntheticLM, batch_event_id

__all__ = ["DataConfig", "SyntheticLM", "batch_event_id"]
