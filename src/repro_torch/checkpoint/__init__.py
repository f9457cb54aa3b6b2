"""Checkpoints of the train state, in the reference's on-disk layout."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
