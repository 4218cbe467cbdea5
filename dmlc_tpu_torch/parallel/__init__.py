"""Parallel execution: the batched inference engine and single-device attention."""
