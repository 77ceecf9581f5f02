"""Typed configuration system (the JAX package's ``config``).

Reference: core ``common/config/ConfigDef.java`` / ``AbstractConfig.java``
(Kafka-style typed definitions with defaults and validators, reflective
plugin loading) and ``config/KafkaCruiseControlConfig.java`` +
``config/constants/*`` (~270 keys split per subsystem).
"""

from cruise_control_tpu_torch.config.config_def import (
    ConfigDef,
    ConfigType,
    in_validator,
    range_validator,
)
from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig

__all__ = ["ConfigDef", "ConfigType", "CruiseControlConfig",
           "range_validator", "in_validator"]
