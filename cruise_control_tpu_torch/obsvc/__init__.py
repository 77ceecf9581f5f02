"""Observability: the span tracer (the rest of the JAX package's ``obsvc/``
waits for the port's platform layers)."""
