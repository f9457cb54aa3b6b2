"""Sharding: per-shard problem shapes (``local``), the parameter, batch,
cache and activation rules (``rules``) and activation constraints
(``annotate``), as in the reference's ``repro/sharding``."""
