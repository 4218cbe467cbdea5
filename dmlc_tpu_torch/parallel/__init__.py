"""Parallel execution: the batched inference engine, single-device attention,
and the partition-rule engine with its meshes (sharded serving)."""
