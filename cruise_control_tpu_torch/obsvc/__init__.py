"""Observability: the span tracer, the self-healing audit log, the operation
log and the execution flight recorder (the rest of the JAX package's
``obsvc/`` waits for the port's platform layers)."""
