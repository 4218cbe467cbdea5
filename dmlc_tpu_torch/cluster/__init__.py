"""The cluster pieces the serving paths need: trace context, deadlines,
tenants and RPC error types."""
