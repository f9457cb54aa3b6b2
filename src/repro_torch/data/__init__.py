"""The synthetic token stream of the reference, for training."""
