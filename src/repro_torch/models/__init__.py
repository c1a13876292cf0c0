"""Model zoo of the port: the dense decoder family, the VLM splice and
the MoE family."""

from repro_torch.models.model_zoo import build_model  # noqa: F401
