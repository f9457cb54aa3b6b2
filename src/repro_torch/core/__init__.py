"""Core surface of the port: the op registry and the epilogue activations."""
from repro_torch.core.dispatch import register, resolve, use  # noqa: F401
