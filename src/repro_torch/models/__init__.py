"""Model zoo of the port: the dense decoder family, the VLM splice, the
MoE family, the hybrid family, the xLSTM family and the
encoder-decoder family."""

from repro_torch.models.model_zoo import build_model  # noqa: F401
