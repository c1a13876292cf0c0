"""Data pipeline: deterministic, sharded, resumable synthetic LM stream."""

from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: F401
