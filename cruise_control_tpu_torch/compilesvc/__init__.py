"""Shape buckets: the canonical padded shapes that decide when the resident
model must fully re-freeze (torch compiles nothing per shape; the rest of
the JAX package's ``compilesvc/`` waits for the port's platform layers)."""
