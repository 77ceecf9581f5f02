"""Resources, exceptions and proposal types (host-side)."""
