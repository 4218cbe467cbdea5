"""Parallel execution: the batched inference engine."""
