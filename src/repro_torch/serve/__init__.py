"""Serving: the static-batch ``Engine`` and continuous batching
(``ContinuousEngine`` over the slotted and paged KV pools)."""
from repro_torch.serve.engine import (  # noqa: F401
    ContinuousEngine,
    Engine,
    PoolConfig,
    ServeConfig,
    completed_lengths,
)
from repro_torch.serve.kv_cache import PagedKVCache, SlotKVCache  # noqa: F401
from repro_torch.serve.metrics import (  # noqa: F401
    LatencyHistogram,
    ServeMetrics,
    render_prometheus,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    Request,
    RequestState,
    Scheduler,
)
