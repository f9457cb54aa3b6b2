"""Entry points: meshes, the training launcher (one device or a data x
model mesh of ranks) and the per-shard plans of a cell (dryrun)."""
