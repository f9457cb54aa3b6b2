"""Serving: the static-batch ``Engine``, continuous batching
(``ContinuousEngine`` over the slotted and paged KV pools), the
multi-replica router, self-healing (fault classification, retry/backoff,
health probes, re-admission, fault injection), the asyncio front-end, and
a stdlib HTTP shim over it."""
from repro_torch.serve.cluster import (  # noqa: F401
    ClusterRequest,
    EngineReplica,
    EngineRouter,
    least_depth,
)
from repro_torch.serve.faults import (  # noqa: F401
    FaultClock,
    FaultInjector,
    FaultSpec,
)
from repro_torch.serve.health import (  # noqa: F401
    ClusterHealth,
    FatalError,
    HealthConfig,
    ReplicaHungError,
    ReplicaStragglerError,
    RetryPolicy,
    TransientError,
    classify_failure,
)
from repro_torch.serve.engine import (  # noqa: F401
    ContinuousEngine,
    Engine,
    PoolConfig,
    ServeConfig,
    completed_lengths,
)
from repro_torch.serve.frontend import (  # noqa: F401
    AsyncFrontend,
    RequestHandle,
    RequestResult,
)
from repro_torch.serve.http import (  # noqa: F401
    HttpFrontend,
    request_from_payload,
)
from repro_torch.serve.kv_cache import PagedKVCache, SlotKVCache  # noqa: F401
from repro_torch.serve.metrics import (  # noqa: F401
    ClusterMetrics,
    LatencyHistogram,
    ServeMetrics,
    render_prometheus,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    Request,
    RequestState,
    Scheduler,
)
