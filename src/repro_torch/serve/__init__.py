"""Request-level serving of the port: the continuous-batching engine
(``engine``), the deterministic slot scheduler (``scheduler``), the dense
slot KV cache (``slots``, the default layout and the paged layout's
bitwise oracle), the paged KV layout (``paging``: a page pool addressed
through per-request page tables) and the radix prefix cache (``prefix``:
shared prompt prefixes admitted by reference)."""

from repro_torch.serve.engine import (  # noqa: F401
    EngineConfig,
    InferenceEngine,
    TokenEvent,
)
from repro_torch.serve.paging import (  # noqa: F401
    PageAllocator,
    PagedKVCache,
)
from repro_torch.serve.prefix import RadixPrefixTree  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    Request,
    RequestHandle,
    SamplingParams,
    SlotScheduler,
)
from repro_torch.serve.slots import SlotKVCache  # noqa: F401
