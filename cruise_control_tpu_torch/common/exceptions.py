"""Framework exception hierarchy (reference: exception/*.java)."""


class CruiseControlError(Exception):
    """Base class for all framework errors."""


class OptimizationFailureError(CruiseControlError):
    """A hard goal could not be satisfied (reference: OptimizationFailureException)."""


class NotEnoughValidWindowsError(CruiseControlError):
    """Load completeness requirements unmet (reference: NotEnoughValidWindowsException)."""


class OngoingExecutionError(CruiseControlError):
    """An execution is already in progress (reference: OngoingExecutionException)."""


class SamplingError(CruiseControlError):
    """Metric sampling failed (reference: MetricSamplingException)."""


class ConfigError(CruiseControlError):
    """Invalid configuration (reference: ConfigException)."""


class UserRequestError(CruiseControlError):
    """Bad user request (reference: UserRequestException)."""
