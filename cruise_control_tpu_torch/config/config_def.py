"""ConfigDef: typed config definitions with defaults and validators.

Reference: core ``common/config/ConfigDef.java`` — ``define(name, type,
default, validator, importance, doc)``, type coercion (STRING/INT/LONG/
DOUBLE/BOOLEAN/LIST/CLASS), unknown-key tolerance, and ``AbstractConfig``'s
``getConfiguredInstance`` reflective plugin loading (here: dotted-path or
registry-name resolution).
"""

from __future__ import annotations

import enum
import importlib
import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from cruise_control_tpu_torch.common.exceptions import ConfigError

# ``${env:VAR}`` value indirection: secrets (TLS keystore passwords, webhook
# tokens) stay out of properties files and are pulled from the process
# environment when the config is loaded.
_ENV_REF = re.compile(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)\}")


def resolve_env_refs(raw: Any) -> Any:
    """Substitute every ``${env:VAR}`` occurrence in a string value with the
    environment variable's current value.  Non-strings and strings without a
    reference pass through untouched; referencing an unset variable is a
    ConfigError (a silently-empty secret is worse than a startup failure)."""
    if not isinstance(raw, str) or "${env:" not in raw:
        return raw

    def _sub(m: "re.Match[str]") -> str:
        var = m.group(1)
        if var not in os.environ:
            raise ConfigError(
                f"config value references ${{env:{var}}} but {var} is not "
                "set in the environment")
        return os.environ[var]

    return _ENV_REF.sub(_sub, raw)


class ConfigType(enum.Enum):
    STRING = "string"
    INT = "int"
    LONG = "long"
    DOUBLE = "double"
    BOOLEAN = "boolean"
    LIST = "list"          # comma-separated string → List[str]
    CLASS = "class"        # dotted path resolved at get time


_NO_DEFAULT = object()


def range_validator(lo=None, hi=None) -> Callable[[str, Any], None]:
    def check(name, value):
        if lo is not None and value < lo:
            raise ConfigError(f"{name}={value} below minimum {lo}")
        if hi is not None and value > hi:
            raise ConfigError(f"{name}={value} above maximum {hi}")
    return check


def in_validator(*allowed) -> Callable[[str, Any], None]:
    def check(name, value):
        if value not in allowed:
            raise ConfigError(f"{name}={value!r} not one of {allowed}")
    return check


@dataclass
class ConfigKey:
    name: str
    config_type: ConfigType
    default: Any = _NO_DEFAULT
    validator: Optional[Callable[[str, Any], None]] = None
    doc: str = ""

    @property
    def has_default(self) -> bool:
        return self.default is not _NO_DEFAULT


class ConfigDef:
    def __init__(self):
        self._keys: Dict[str, ConfigKey] = {}

    def define(self, name: str, config_type: ConfigType, default: Any = _NO_DEFAULT,
               validator: Optional[Callable[[str, Any], None]] = None,
               doc: str = "") -> "ConfigDef":
        if name in self._keys:
            raise ConfigError(f"duplicate config key {name}")
        self._keys[name] = ConfigKey(name, config_type, default, validator, doc)
        return self

    def keys(self) -> Dict[str, ConfigKey]:
        return dict(self._keys)

    def merge(self, other: "ConfigDef") -> "ConfigDef":
        for k in other._keys.values():
            if k.name not in self._keys:
                self._keys[k.name] = k
        return self

    # --------------------------------------------------------------- parse

    def parse(self, props: Dict[str, Any]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, key in self._keys.items():
            if name in props:
                value = self._coerce(key, props[name])
            elif key.has_default:
                # Defaults go through the same coercion so a LIST default
                # given as a comma string becomes a list.
                value = (None if key.default is None
                         else self._coerce(key, key.default))
            else:
                raise ConfigError(f"missing required config {name}")
            if key.validator is not None and value is not None:
                key.validator(name, value)
            out[name] = value
        return out

    @staticmethod
    def _coerce(key: ConfigKey, raw: Any) -> Any:
        t = key.config_type
        try:
            if raw is None:
                return None
            # Programmatic overrides get the same ${env:VAR} indirection as
            # properties files (load_properties already resolved those).
            raw = resolve_env_refs(raw)
            if t is ConfigType.STRING or t is ConfigType.CLASS:
                return str(raw)
            if t in (ConfigType.INT, ConfigType.LONG):
                return int(raw)
            if t is ConfigType.DOUBLE:
                return float(raw)
            if t is ConfigType.BOOLEAN:
                if isinstance(raw, bool):
                    return raw
                return str(raw).strip().lower() in ("true", "1", "yes")
            if t is ConfigType.LIST:
                if isinstance(raw, (list, tuple)):
                    return [str(x) for x in raw]
                return [s.strip() for s in str(raw).split(",") if s.strip()]
        except (TypeError, ValueError) as e:
            raise ConfigError(f"bad value for {key.name}: {raw!r} ({e})") from None
        raise ConfigError(f"unknown config type {t}")


def load_properties(path: str) -> Dict[str, str]:
    """Java-style ``key=value`` properties file (# comments, blank lines)."""
    props: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("!"):
                continue
            if "=" in line:
                k, _, v = line.partition("=")
                props[k.strip()] = resolve_env_refs(v.strip())
    return props


def get_configured_instance(dotted_or_name: str, registry: Optional[Dict] = None,
                            config=None, **kwargs):
    """Reflective plugin loading (AbstractConfig.getConfiguredInstance).

    When ``config`` is given, it is passed to the plugin iff its constructor
    can receive it — a declared ``config`` parameter or a ``**kwargs``
    catch-all (the Kafka-style ``def __init__(self, **configs)`` shape) —
    mirroring the reference's configure(configs) contract without breaking
    plugins that take no configuration."""
    if registry and dotted_or_name in registry:
        cls = registry[dotted_or_name]
    else:
        bare = dotted_or_name.rsplit(".", 1)
        if len(bare) != 2:
            raise ConfigError(f"unknown plugin {dotted_or_name}")
        mod, name = bare
        try:
            cls = getattr(importlib.import_module(mod), name)
        except (ImportError, AttributeError) as e:
            raise ConfigError(
                f"cannot instantiate {dotted_or_name}: {e}") from None
    if config is not None and cls.__init__ is not object.__init__:
        # (object.__init__'s signature advertises *args/**kwargs but a
        # class without its own __init__ takes no arguments at all.)
        import inspect
        try:
            params = inspect.signature(cls.__init__).parameters.values()
        except (TypeError, ValueError):
            params = ()
        if any(p.kind is p.VAR_KEYWORD or p.name == "config"
               for p in params):
            kwargs["config"] = config
    return cls(**kwargs)
