"""Parallel execution: the batched inference engine, the partition-rule
engine with its meshes (sharded serving), the train step, and sequence
(ring, ring-flash, Ulysses), pipeline and expert parallelism over a mesh."""
