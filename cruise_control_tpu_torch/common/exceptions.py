"""Framework exception hierarchy (reference: exception/*.java)."""


class CruiseControlError(Exception):
    """Base class for all framework errors."""


class OptimizationFailureError(CruiseControlError):
    """A hard goal could not be satisfied (reference: OptimizationFailureException)."""
