"""Host utilities: metrics, tracing, hot-path marker, synthetic corpus, device choice."""
