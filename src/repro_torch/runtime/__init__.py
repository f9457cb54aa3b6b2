"""Runtime services shared by training and serving.

The port of ``repro/runtime/__init__.py``.  The fault-tolerance primitives
here are used in two places: the training driver (``run_with_restarts``
around a checkpointed step function) and the serving cluster
(``repro_torch.serve.health.ClusterHealth`` builds its per-step watchdog
on ``HeartbeatMonitor`` and its straggler quarantine on
``StragglerDetector``), so they are exported at package level.
"""
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    HeartbeatMonitor,
    StragglerDetector,
    WorkerFailure,
    run_with_restarts,
)
