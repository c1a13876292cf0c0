"""Request-level serving of the port: the continuous-batching engine
(``engine``), the deterministic slot scheduler (``scheduler``) and the
dense slot KV cache (``slots``)."""

from repro_torch.serve.engine import (  # noqa: F401
    EngineConfig,
    InferenceEngine,
    TokenEvent,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    Request,
    RequestHandle,
    SamplingParams,
    SlotScheduler,
)
from repro_torch.serve.slots import SlotKVCache  # noqa: F401
