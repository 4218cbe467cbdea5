"""The cluster pieces the serving path needs: trace context and RPC error types."""
