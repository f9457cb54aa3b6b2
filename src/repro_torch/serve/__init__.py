"""Serving: the static-batch ``Engine``."""
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
